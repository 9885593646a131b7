"""Attention pieces on the hybrid decode path (port of the int8 cache
and the attention core of ``vae_gslm_tpu/nn/attention.py``).

The per-layer ``SelfAttention`` module (training, per-layer decode)
waits for a later slice: the stacked prefill and the hybrid step in
``nn/transformer.py`` read the projections' weights directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.precision import get_policy

NEG_INF = -1e30


def quantize_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis, clipped to +-127;
    ``torch.round`` rounds half to even like ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale[..., 0]


@dataclasses.dataclass
class LayerKVCache:
    """Stacked KV cache ``(L, B, H, maxT, D)``; the int8 form keeps
    float32 per-row scales ``(L, B, H, maxT)``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, nheads, c // nheads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], mask: torch.Tensor
           ) -> torch.Tensor:
    """Masked multi-head attention core, float32 softmax.

    q: (B, Tq, H, D); k, v: (B, Tk, H, D); bias (H, Tq, Tk) or None;
    mask (B, 1, Tq, Tk) bool.  Inputs are rounded to the compute dtype
    and multiplied in float32, which is what the JAX package's
    ``preferred_element_type=float32`` products compute."""
    dt = get_policy().compute_dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(dt).float(),
                          k.to(dt).float()) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    logits = torch.where(mask, logits, torch.tensor(NEG_INF,
                                                    device=logits.device))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dt).float(),
                       v.to(dt).float())
    return out.to(dt)
