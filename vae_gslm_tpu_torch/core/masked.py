"""Masked sequence container (port of ``vae_gslm_tpu/core/masked.py``).

A padded batch ``value`` with an int32 per-example ``lengths`` vector;
the bool mask is built on demand.  ``time_axis=1`` is ``(B, T, ...)``
(the layout at every public function) and ``time_axis=2`` is
``(B, C, T)`` (inside the convolution stacks, which run NCW).
Stacked micro-batches (``stack``/``micro``) carry a leading
accumulation axis on both ``value`` and ``lengths``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Masked:
    value: Tensor
    lengths: Tensor
    time_axis: int = 1

    def __post_init__(self):
        if self.time_axis not in (1, 2):
            raise ValueError("only B T ... or B C T layouts are supported")

    @classmethod
    def full(cls, value: Tensor, time_axis: int = 1) -> "Masked":
        b, t = value.shape[0], value.shape[time_axis]
        lengths = torch.full((b,), t, dtype=torch.int32,
                             device=value.device)
        return cls(value, lengths, time_axis)

    @classmethod
    def from_lengths(cls, value: Tensor, lengths, time_axis: int = 1
                     ) -> "Masked":
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=value.device)
        return cls(value, lengths, time_axis)

    @property
    def time(self) -> int:
        return self.value.shape[self.time_axis]

    def mask(self) -> Tensor:
        """Dense bool mask ``(B, T)``; True = valid."""
        pos = torch.arange(self.time, device=self.value.device)
        return pos[None, :] < self.lengths[:, None]

    def expanded_mask(self) -> Tensor:
        m = self.mask()
        if self.time_axis == 1:
            return m.reshape(m.shape + (1,) * (self.value.dim() - 2))
        return m[:, None, :]

    def apply_mask(self, fill: float = 0.0) -> "Masked":
        value = torch.where(self.expanded_mask(), self.value,
                            torch.tensor(fill, dtype=self.value.dtype,
                                         device=self.value.device))
        return dataclasses.replace(self, value=value)

    def transpose(self) -> "Masked":
        """Swap between ``B T C`` and ``B C T``."""
        return Masked(self.value.transpose(1, 2), self.lengths,
                      3 - self.time_axis)

    def cat(self, other: Union[Tensor, "Masked"]) -> "Masked":
        """Concatenate along the channel (non-time) axis."""
        o = other.value if isinstance(other, Masked) else other
        axis = -1 if self.time_axis == 1 else 1
        value = torch.cat([self.value, o.to(self.value.dtype)], dim=axis)
        return Masked(value, self.lengths, self.time_axis)

    def split(self, n: int) -> Tuple["Masked", "Masked"]:
        return (Masked(self.value[..., :n], self.lengths, self.time_axis),
                Masked(self.value[..., n:], self.lengths, self.time_axis))

    def flatten(self) -> "Masked":
        """Trailing feature axes into one: ``(B, T, -1)``."""
        b, t = self.value.shape[:2]
        return Masked(self.value.reshape(b, t, -1), self.lengths, 1)

    def expand_dim(self) -> "Masked":
        return Masked(self.value[..., None], self.lengths, self.time_axis)

    def shift_right(self, init: Tensor) -> "Masked":
        """Prepend ``init`` (B, n, C) along time and drop the last n
        frames; lengths unchanged (AR teacher forcing)."""
        n = init.shape[1]
        value = torch.cat([init.to(self.value.dtype), self.value[:, :-n]],
                          dim=1)
        return Masked(value, self.lengths, 1)

    def push(self, other: Tensor) -> "Masked":
        """Prepend ``other`` along time (n frames on ``time_axis``);
        lengths grow by n."""
        value = torch.cat([other.to(self.value.dtype), self.value],
                          dim=self.time_axis)
        return Masked(value, self.lengths + other.shape[self.time_axis],
                      self.time_axis)

    def pop(self, n: int = 1) -> "Masked":
        """Drop the last n frames; lengths shrink by n."""
        value = self.value.narrow(self.time_axis, 0,
                                  self.value.shape[self.time_axis] - n)
        return Masked(value, self.lengths - n, self.time_axis)

    def pop_left(self, n: int = 1) -> "Masked":
        """Drop the first n frames; lengths shrink by n."""
        value = self.value.narrow(self.time_axis, n,
                                  self.value.shape[self.time_axis] - n)
        return Masked(value, self.lengths - n, self.time_axis)

    def mean(self) -> Tensor:
        """Masked mean over (batch, time), averaged over channels: the
        masked sum, divided by the channel count, then by the total
        valid length."""
        x = self.flatten().apply_mask()
        return x.value.sum() / x.value.shape[-1] / self.lengths.sum()

    def time_mean(self) -> Tensor:
        """Per-example masked mean over time: ``(B, C)``."""
        x = self.flatten().apply_mask()
        return x.value.sum(1) / self.lengths[:, None]

    def abs(self) -> "Masked":
        return dataclasses.replace(self, value=self.value.abs())

    def __add__(self, other):
        o = other.value if isinstance(other, Masked) else other
        return dataclasses.replace(self, value=self.value + o)

    def __mul__(self, other):
        o = other.value if isinstance(other, Masked) else other
        return dataclasses.replace(self, value=self.value * o)

    # -- stacked micro-batches: (A, B, ...) values, (A, B) lengths ---------
    @classmethod
    def stack(cls, items: Sequence["Masked"]) -> "Masked":
        return cls(torch.stack([m.value for m in items]),
                   torch.stack([m.lengths for m in items]),
                   items[0].time_axis)

    def micro(self, i: int) -> "Masked":
        """Micro-batch ``i`` of a stacked batch."""
        return Masked(self.value[i], self.lengths[i], self.time_axis)


def resize_length(lengths: Tensor, ratio: float) -> Tensor:
    """ceil(length * ratio), computed in float32 like the JAX package."""
    return torch.ceil(lengths.to(torch.float32) * ratio).to(torch.int32)
