"""Normalisation layers (port of ``vae_gslm_tpu/nn/norms.py``).

Statistics run in float32 and the result is cast back to the input
dtype.  Every norm normalises over one feature axis: ``dim=-1`` for
``(B, T, C)`` inputs and ``dim=1`` inside the NCW convolution stacks.
``InstanceNorm`` is the reference's per-frame channel normalisation
with unbiased variance.  ``GroupNorm`` takes, as JAX does, its
statistics over (T, C/G) per example and group, padded frames included
(no mask).  Parameter names follow the reference state dict (``scale``
for RMSNorm, ``weight``/``bias`` otherwise).
"""
from __future__ import annotations

import torch
from torch import nn

from ..hparams.hp import Hparams


def _along(p: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reshape a per-channel vector to broadcast along ``dim`` of x."""
    dim = dim % x.dim()
    return p.reshape((-1,) + (1,) * (x.dim() - 1 - dim))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(dim=dim, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * _along(self.scale, x, dim)
        return y.to(x.dtype)


class InstanceNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=dim, keepdim=True)
        n = xf.shape[dim]
        var = (xf - mean).square().sum(dim=dim, keepdim=True) / max(n - 1, 1)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = _along(self.weight, x, dim) * y + _along(self.bias, x, dim)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=dim, keepdim=True)
        var = (xf - mean).square().mean(dim=dim, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = _along(self.weight, x, dim) * y + _along(self.bias, x, dim)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """Group norm over the channel axis ``dim`` of a (B, T, C) or NCW
    (B, C, T) value: the statistics of each example's group of C/G
    channels run over those channels and every frame."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        if dim % num_groups:
            raise ValueError(f"{dim} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        xf = x.float().movedim(dim, -1)            # (B, ..., C)
        b, c = xf.shape[0], xf.shape[-1]
        xg = xf.reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(xf.shape)
        y = (self.weight * y + self.bias).movedim(-1, dim)
        return y.to(x.dtype)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return x


def get_norm(dim: int, hp: Hparams) -> nn.Module:
    ident = hp.identifier
    if ident == "LayerNorm":
        return LayerNorm(dim, eps=hp.eps)
    if ident == "GroupNorm":
        return GroupNorm(hp.num_groups, dim, eps=hp.eps)
    if ident == "RMSNorm":
        return RMSNorm(dim, eps=hp.eps)
    if ident == "InstanceNorm":
        return InstanceNorm(dim, eps=hp.eps)
    if ident == "Identity":
        return Identity()
    raise ValueError(f"{ident} is not a known normalization")
