"""Vector quantizers (port of ``vae_gslm_tpu/nn/vq.py``).

``SimpleVectorQuantizer`` is the native backend of the reference's
'VQ'/'RVQ' identifiers (the reference wrapped a third-party package):
L2-nearest codes, the straight-through estimator and the commit and
codebook losses.  ``SimpleBestRQ`` is the frozen random-projection
quantizer: its projection and codebooks are buffers, not parameters.
The nearest-centroid search is the matmul-argmin form (||x||^2 + ||c||^2
- 2 x . c^T); JAX leaves its matrix product to XLA, so the port's is a
plain ``torch.matmul``.  No kernel runs here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..core.losses import masked_loss
from ..core.masked import Masked
from ..hparams.hp import Hparams


class VQOutput(NamedTuple):
    quantized: Masked
    indices: Masked
    loss: Optional[torch.Tensor]


def nearest_centroid(x: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """argmin_k ||x - c_k|| over the last axis of x, by the matmul form
    in float32."""
    x = x.float()
    c = codebooks.float()
    x_pow = x.square().sum(-1, keepdim=True)
    c_pow = c.square().sum(-1)
    dist2 = x_pow + c_pow - 2.0 * torch.matmul(x, c.t())
    return torch.argmin(dist2, dim=-1)


class SimpleVectorQuantizer(nn.Module):
    """L2-nearest codes, straight-through gradients and the commit and
    codebook losses (``reference vq.py:45-89``): the loss is the sum over
    valid frames of ``commit_w mean((sg(c) - x)^2) + codebook_w mean((c -
    sg(x))^2)``, through ``masked_loss``."""

    def __init__(self, dim: int, codebook_size: int,
                 codebook_loss_weight: float, commit_loss_weight: float):
        super().__init__()
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebooks = nn.Parameter(torch.empty(codebook_size, dim))
        self.codebook_loss_weight = codebook_loss_weight
        self.commit_loss_weight = commit_loss_weight

    def reset_parameters(self, generator=None) -> None:
        """Uniform in [-1, 1), as JAX draws them."""
        with torch.no_grad():
            self.codebooks.uniform_(-1.0, 1.0, generator=generator)

    def forward(self, x: Masked) -> VQOutput:
        xv = x.value.float()
        cb = self.codebooks
        ind = nearest_centroid(xv.detach(), cb.detach())
        cq = cb[ind]
        quantized = xv + (cq - xv).detach()
        commit = (cq.detach() - xv).square().mean(-1) \
            * self.commit_loss_weight
        codebook = (cq - xv.detach()).square().mean(-1) \
            * self.codebook_loss_weight
        loss = masked_loss(Masked(commit[..., None], x.lengths, 1),
                           Masked(codebook[..., None], x.lengths, 1),
                           fn=lambda a, b: a + b)
        return VQOutput(
            quantized=Masked(quantized, x.lengths, 1).apply_mask(),
            indices=Masked(ind, x.lengths, 1).apply_mask(),
            loss=loss)

    def get_output(self, ind: torch.Tensor) -> torch.Tensor:
        return self.codebooks[ind]


class SimpleBestRQ(nn.Module):
    """Random-projection quantizer (``reference vq.py:92-119``): x times a
    frozen Xavier-normal projection, both it and the normal codebooks
    normalized to unit length, then the nearest code.  The projection and
    codebooks are buffers: they are saved and loaded, never trained."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.dim = dim
        self.codebook_size = codebook_size
        self.register_buffer("codebooks", torch.empty(codebook_size, dim))
        self.register_buffer("projection", torch.empty(dim, dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.codebooks.normal_(generator=generator)
            self.projection.normal_(generator=generator)
            self.projection.mul_(math.sqrt(2.0 / (self.dim + self.dim)))

    def forward(self, x: Masked) -> Masked:
        xv = x.value.float() @ self.projection
        xv = xv / xv.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        codes = self.codebooks
        codes = codes / codes.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        ind = nearest_centroid(xv, codes)
        return Masked(ind, x.lengths, 1).apply_mask()


def get_vector_quantizer(hp: Hparams) -> nn.Module:
    """The quantizer of ``hp.identifier``, by JAX's identifiers."""
    ident = hp.identifier
    if ident in ("VectorQuantize", "SimpleVectorQuantizer", "VQ"):
        return SimpleVectorQuantizer(
            hp.dim, hp.codebook_size, hp.get("codebook_loss_weight", 1.0),
            hp.get("commit_loss_weight", 0.25))
    if ident in ("SimpleBestRQ", "BestRQ"):
        return SimpleBestRQ(hp.dim, hp.codebook_size)
    raise ValueError(f"{ident} is not a supported quantizer")
