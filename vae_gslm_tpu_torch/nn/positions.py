"""Positional encodings on the speech path (port of the ALiBi and
SinCos parts of ``vae_gslm_tpu/nn/positions.py``).

ALiBi is the reference's symmetric-|distance| form with negative
slopes.  Both tables are non-persistent buffers: they are recomputed,
never loaded, as the JAX converter does.
"""
from __future__ import annotations

import math

import torch
from torch import nn


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
    """Sinusoidal table; ``get(t)`` indexes rows (the diffusion time
    embedding)."""

    def __init__(self, ndim: int, maxpos: int = 10000):
        super().__init__()
        self.register_buffer("p", sincos_table(ndim, maxpos),
                             persistent=False)

    def get(self, t: torch.Tensor) -> torch.Tensor:
        return self.p[t.long()]
