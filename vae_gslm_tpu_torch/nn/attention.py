"""Self-attention (port of ``vae_gslm_tpu/nn/attention.py``): the int8
cache of the stacked decode paths, the dense attention core, and the
``SelfAttention`` module's full-sequence (training) call.

The stacked prefill and the hybrid and mega steps in
``nn/transformer.py`` read ``SelfAttention``'s projection weights
directly; its per-layer decode step and ``CrossAttention`` wait for a
later slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.masked import Masked
from ..core.precision import get_policy
from ..hparams.hp import Hparams
from ..ops.flash_attention import flash_attention_bhtd, flash_attention_packed
from ..parallel import tp
from .linear import Dense
from .positions import ALiBi

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


class SelfAttention(nn.Module):
    """Masked (optionally causal) self-attention with a fused qkv
    projection (state-dict names ``in_proj``/``out_proj``).

    The full-sequence call takes the fused branch, as JAX does, when the
    layer is causal and uses ALiBi or no position bias (and
    ``use_flash`` is not switched off): ``flash_attention_packed`` over
    views of the packed projection, on the card K3/K3b inside the packed
    envelope and K4 (T <= 1024, unpackable heads) or K5 (T > 1024)
    outside it.  Inside ``parallel/tp.py::flash_mesh`` of more than one
    rank (JAX's mesh branch, :288-302) it takes ``flash_attention_bhtd``
    on (B, H, T, D) views of the projection instead: K4 and K4b at T <=
    1024, K4/K5 and K5b past it.  Otherwise the dense ``attend`` with the
    ALiBi bias and masks."""

    def __init__(self, dim: int, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("nheads", "causal")
        if dim % hp.nheads:
            raise ValueError("dim must be a multiple of nheads")
        self.nheads = hp.nheads
        self.dim = dim
        self.head_dim = dim // hp.nheads
        self.causal = hp.causal
        self.use_flash = bool(hp.get("use_flash", True))
        bias = bool(hp.get("bias", None))
        self.in_proj = Dense(dim, dim * 3, bias=bias)
        self.out_proj = Dense(dim, dim, bias=bias)

    def forward(self, x: Masked, rpe: Optional[ALiBi] = None) -> Masked:
        """x: (B, T, C) frames; ``rpe`` the stack's shared ALiBi or None.
        Returns the masked output (B, T, C)."""
        q, k, v = self.in_proj(x.value).chunk(3, dim=-1)
        if self.use_flash and self.causal:
            slopes = rpe.slopes if rpe is not None else None
            if tp.active_flash_mesh():
                b, t, _ = q.shape
                qh, kh, vh = (y.view(b, t, self.nheads, self.head_dim)
                              .transpose(1, 2) for y in (q, k, v))
                out = flash_attention_bhtd(qh, kh, vh, x.lengths, slopes,
                                           True).transpose(1, 2).reshape(
                                               b, t, self.dim)
            else:
                out = flash_attention_packed(q, k, v, x.lengths, slopes,
                                             True, self.nheads)
        else:
            t = q.shape[1]
            pos = torch.arange(t, device=q.device)
            mask = (pos[None, :] < x.lengths[:, None])[:, None, None, :]
            if self.causal:
                mask = mask & (pos[None, :] <= pos[:, None])[None, None]
            else:
                mask = mask.expand(q.shape[0], 1, t, t)
            bias = rpe.bias(pos, pos) if rpe is not None else None
            out = merge_heads(attend(split_heads(q, self.nheads),
                                     split_heads(k, self.nheads),
                                     split_heads(v, self.nheads), bias,
                                     mask))
        return Masked(self.out_proj(out), x.lengths, 1).apply_mask()
