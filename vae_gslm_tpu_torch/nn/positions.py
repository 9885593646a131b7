"""Positional encodings (port of ``vae_gslm_tpu/nn/positions.py``):
SinCos, ALiBi, the T5 relative bias and Rotary.

ALiBi is the reference's symmetric-|distance| form with negative
slopes.  The fixed tables (ALiBi's slopes, SinCos's ``p``, Rotary's
``freqs`` and xpos ``scale``) are non-persistent buffers: they are
recomputed, never loaded, as the JAX converter does.  The T5 bias table
is a parameter.  Rotary rotates interleaved pairs of the whole feature
axis it is given (the trunk hands it (B, T, C) projections, not heads).
The factory accepts the reference's ``"Rotery"`` spelling.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..hparams.hp import Hparams


def alibi_slopes(nheads: int) -> list:
    """Slope schedule (reference ``position/alibi.py:19-29``)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(nheads).is_integer():
        return pow2_slopes(nheads)
    closest = 2 ** math.floor(math.log2(nheads))
    return (pow2_slopes(closest)
            + alibi_slopes(2 * closest)[0::2][: nheads - closest])


class ALiBi(nn.Module):
    def __init__(self, nheads: int, maxpos: int = 10000):
        super().__init__()
        self.register_buffer(
            "slopes", -torch.tensor(alibi_slopes(nheads),
                                    dtype=torch.float32),
            persistent=False)
        self.nheads = nheads
        self.maxpos = maxpos

    def bias(self, q_pos: torch.Tensor, k_pos: torch.Tensor
             ) -> torch.Tensor:
        """(H, Tq, Tk) from absolute position vectors."""
        dist = (k_pos[None, :] - q_pos[:, None]).abs().float()
        return self.slopes[:, None, None] * dist[None]


def sincos_table(ndim: int, maxpos: int) -> torch.Tensor:
    pos = torch.arange(maxpos, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, ndim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / ndim))
    angles = pos * div
    p = torch.zeros(maxpos, ndim)
    p[:, 0::2] = torch.sin(angles)
    p[:, 1::2] = torch.cos(angles)
    return p


class SinCos(nn.Module):
    """Absolute sinusoidal embedding: ``forward`` adds it to the input,
    ``get(t)`` indexes rows (the diffusion time embedding).  ``scaled``
    learns one factor on the table (``scalar``)."""

    def __init__(self, ndim: int, maxpos: int = 10000,
                 fixed_pos: bool = False, scaled: bool = False):
        super().__init__()
        self.register_buffer("p", sincos_table(ndim, maxpos),
                             persistent=False)
        self.scalar = nn.Parameter(torch.ones(1)) if scaled else None
        self.fixed_pos = fixed_pos

    def reset_parameters(self, generator=None) -> None:
        if self.scalar is not None:
            nn.init.ones_(self.scalar)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """x (B, T, C) plus the rows of positions [offset, offset + T);
        a start past the table is clamped so the T rows fit, as JAX's
        ``dynamic_slice`` does."""
        t = x.shape[1]
        if offset == 0:
            p = self.p if self.fixed_pos else self.p[:t]
        else:
            start = min(max(int(offset), 0), self.p.shape[0] - t)
            p = self.p[start:start + t]
        s = self.scalar if self.scalar is not None else 1.0
        return x + (s * p[None]).to(x.dtype)

    def get(self, t: torch.Tensor) -> torch.Tensor:
        return self.p[t.long()]


class T5RPE(nn.Module):
    """Bucketed learned relative bias (reference ``position/t5.py``):
    ``forward(tq, tk)`` is the (H, Tq, Tk) bias of the table (buckets,
    H)."""

    def __init__(self, nheads: int, bidirectional: bool,
                 num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.nheads = nheads
        self.table = nn.Parameter(torch.empty(num_buckets, nheads))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.table.normal_(generator=generator)

    def set_uniform(self, std: float, generator=None) -> None:
        with torch.no_grad():
            self.table.uniform_(-std, std, generator=generator)

    def bucket(self, rel: torch.Tensor) -> torch.Tensor:
        num_buckets = self.num_buckets
        ret = torch.zeros_like(rel)
        if self.bidirectional:
            num_buckets //= 2
            ret = ret + (rel > 0).long() * num_buckets
            rel = rel.abs()
        else:
            rel = -rel.clamp(max=0)
        max_exact = num_buckets // 2
        large = max_exact + (
            torch.log(rel.float() / max_exact + 1e-20)
            / math.log(self.max_distance / max_exact)
            * (num_buckets - max_exact)).long()
        large = large.clamp(max=num_buckets - 1)
        return ret + torch.where(rel < max_exact, rel, large)

    def forward(self, tq: int, tk: int) -> torch.Tensor:
        dev = self.table.device
        rel = (torch.arange(tk, device=dev)[None, :]
               - torch.arange(tq, device=dev)[:, None])
        return self.table[self.bucket(rel)].permute(2, 0, 1)


class Rotary(nn.Module):
    """Rotary embedding over interleaved pairs of the whole feature axis
    (reference ``position/rotary.py:59-165``): NTK
    ``theta_rescale_factor``, position ``interpolate_factor`` and xpos
    (q scaled by ``scale ** power``, k by ``scale ** -power``, ``power =
    (pos - T // 2) / scale_base`` over the T frames of the call)."""

    def __init__(self, dim: int, theta: float = 10000.0,
                 use_xpos: bool = False, xpos_scale_base: float = 512.0,
                 interpolate_factor: float = 1.0,
                 theta_rescale_factor: float = 1.0):
        super().__init__()
        if interpolate_factor < 1.0:
            raise ValueError("interpolate_factor must be >= 1")
        theta = theta * theta_rescale_factor ** (dim / (dim - 2))
        half = torch.arange(0, dim, 2, dtype=torch.float32)
        self.register_buffer("freqs", 1.0 / (theta ** (half / dim)),
                             persistent=False)
        self.register_buffer(
            "scale", (half + 0.4 * dim) / (1.4 * dim) if use_xpos else None,
            persistent=False)
        self.dim = dim
        self.use_xpos = use_xpos
        self.scale_base = xpos_scale_base
        self.interpolate_factor = interpolate_factor

    def forward(self, x: torch.Tensor, offset: int = 0,
                scale_power: int = 0) -> torch.Tensor:
        """x (B, T, C) rotated at positions [offset, offset + T);
        ``scale_power`` +1 for queries and -1 for keys under xpos."""
        t = x.shape[1]
        pos = (torch.arange(t, dtype=torch.float32, device=x.device)
               + offset) / self.interpolate_factor
        ang = pos[:, None] * self.freqs[None, :]           # (T, C/2)
        cos, sin = torch.cos(ang), torch.sin(ang)
        if self.use_xpos and scale_power != 0:
            power = (pos - t // 2) / self.scale_base
            s = self.scale[None, :] ** (scale_power * power[:, None])
            cos, sin = cos * s, sin * s
        x1, x2 = x[..., 0::2], x[..., 1::2]
        y = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return y.reshape(x.shape).to(x.dtype)

    def rotate_qk(self, q: torch.Tensor, k: torch.Tensor, offset: int = 0):
        if self.use_xpos:
            return (self(q, offset, scale_power=1),
                    self(k, offset, scale_power=-1))
        return self(q, offset), self(k, offset)


def get_positional_encoding(name: str, hp: Hparams,
                            ndim: Optional[int] = None,
                            nheads: Optional[int] = None) -> nn.Module:
    """The reference factory (``position/embedding.py:9-40``), its
    ``"Rotery"`` key included."""
    if name == "SinCos":
        return SinCos(ndim, hp.get("maxpos", 10000),
                      hp.get("fixed_pos", False), hp.get("scaled", False))
    if name in ("Rotary", "Rotery"):
        return Rotary(ndim, theta=hp.get("theta", 10000),
                      use_xpos=hp.get("use_xpos", False),
                      xpos_scale_base=hp.get("xpos_scale_base", 512),
                      interpolate_factor=hp.get("interpolate_factor", 1.0),
                      theta_rescale_factor=hp.get("theta_rescale_factor",
                                                  1.0))
    if name == "ALiBi":
        return ALiBi(nheads, hp.get("maxpos", 10000))
    if name == "T5RPE":
        hp.check_arg_in_hparams("bidirectional", "num_buckets",
                                "max_distance")
        return T5RPE(nheads, hp.bidirectional, hp.num_buckets,
                     hp.max_distance)
    raise ValueError(f"{name} is not a valid PE type.")

