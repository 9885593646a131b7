"""Masked sequence container (port of ``vae_gslm_tpu/core/masked.py``).

A padded batch ``value`` with an int32 per-example ``lengths`` vector;
the bool mask is built on demand.  ``time_axis=1`` is ``(B, T, ...)``
(the layout at every public function) and ``time_axis=2`` is
``(B, C, T)`` (inside the convolution stacks, which run NCW).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

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

    def __add__(self, other):
        o = other.value if isinstance(other, Masked) else other
        return dataclasses.replace(self, value=self.value + o)


def resize_length(lengths: Tensor, ratio: float) -> Tensor:
    """ceil(length * ratio), computed in float32 like the JAX package."""
    return torch.ceil(lengths.to(torch.float32) * ratio).to(torch.int32)
