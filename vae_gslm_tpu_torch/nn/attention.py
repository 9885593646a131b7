"""Self- and cross-attention (port of ``vae_gslm_tpu/nn/attention.py``):
the KV caches, the dense attention core, the ``SelfAttention`` module's
full-sequence (training) call and its per-layer decode step, and
``CrossAttention`` over an encoder memory.

The stacked prefill and the hybrid and mega steps in
``nn/transformer.py`` read ``SelfAttention``'s projection weights
directly; ``SelfAttention.decode_step`` is the per-layer path's
attention (``decode_attention``, or K6 ``flash_decode_int8`` on request).
Positions reach attention as JAX's do: Rotary and SinCos act on q and k
(at the frames' absolute positions, so the cache holds rotated keys),
ALiBi and the T5 table as a bias on the logits.  The caches are updated
in place (the JAX functions return new arrays).
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
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention_bhtd, flash_attention_packed
from ..ops.flash_decode import flash_decode_int8
from ..parallel import tp
from .linear import Dense
from .positions import ALiBi, Rotary, SinCos, T5RPE, get_positional_encoding

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
    """KV cache.  The stacked decode paths hold one for the whole stack,
    ``(L, B, H, maxT, D)``; the per-layer path one per layer in JAX's base
    layout, ``(B, H, maxT, D)`` (JAX's lane-packed ``(maxT, D, B*H)``
    layout, which fills a TPU's 128 lanes, is not ported).  The int8
    form keeps float32 per-row scales, ``(L, B, H, maxT)`` or ``(B, H,
    maxT)``; a float cache holds the rows in its dtype."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, batch: int, max_len: int, nheads: int, head_dim: int,
              dtype=torch.float32, device=None) -> "LayerKVCache":
        """A per-layer cache of zeros (JAX's ``LayerKVCache.zeros``)."""
        shape = (batch, nheads, max_len, head_dim)
        if dtype != torch.int8:
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        sshape = shape[:-1]
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(sshape, device=device),
                   torch.zeros(sshape, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def write(self, pos: int, k: torch.Tensor, v: torch.Tensor
              ) -> "LayerKVCache":
        """Write new keys/values (B, S, H, D) at positions [pos, pos+S) of
        a per-layer cache, in place (int8 through ``quantize_i8``)."""
        s = k.shape[1]
        for dst, sdst, new in ((self.k, self.k_scale, k),
                               (self.v, self.v_scale, v)):
            new = new.transpose(1, 2)                       # (B, H, S, D)
            sc = None
            if self.quantized:
                new, sc = quantize_i8(new)
                sdst[:, :, pos:pos + s] = sc
            dst[:, :, pos:pos + s] = new
        return self

    def dense_kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, H, D) views for the prefill: the int8 rows dequantized to
        bfloat16, as JAX's ``dense_kv``."""
        k, v = self.k, self.v
        if self.quantized:
            k = (k.float() * self.k_scale[..., None]).to(torch.bfloat16)
            v = (v.float() * self.v_scale[..., None]).to(torch.bfloat16)
        return k.transpose(1, 2), v.transpose(1, 2)


def split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, nheads, c // nheads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], mask: torch.Tensor,
           return_attn: bool = False):
    """Masked multi-head attention core, float32 softmax.

    q: (B, Tq, H, D); k, v: (B, Tk, H, D); bias (H, Tq, Tk) or None;
    mask (B, 1, Tq, Tk) bool.  Inputs are rounded to the compute dtype
    and multiplied in float32, which is what the JAX package's
    ``preferred_element_type=float32`` products compute.  Returns the
    output (B, Tq, H, D), with ``return_attn`` also the float32 weights
    (B, H, Tq, Tk)."""
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
                       v.to(dt).float()).to(dt)
    return (out, weights) if return_attn else out


class SelfAttention(nn.Module):
    """Masked (optionally causal) self-attention with a fused qkv
    projection (state-dict names ``in_proj``/``out_proj``).

    The full-sequence call takes the fused branch, as JAX does, when the
    layer is causal, ``use_flash`` is not switched off and no bias is
    added to the logits (ALiBi's slopes go to the kernels; Rotary and
    SinCos have already moved q and k; the T5 table is a bias):
    ``flash_attention_packed`` over the packed projections, on the card
    K3/K3b inside the packed envelope and K4 (T <= 1024, unpackable heads)
    or K5 (T > 1024) outside it.  Inside ``parallel/tp.py::flash_mesh`` of
    more than one rank (JAX's mesh branch, :288-302) it takes
    ``flash_attention_bhtd`` on (B, H, T, D) views of the projection
    instead: K4 and K4b at T <= 1024, K4/K5 and K5b past it.  Otherwise
    the dense ``attend`` with the ALiBi or T5 bias and the masks."""

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

    def _qkv(self, xv: torch.Tensor, rpe, offset: int = 0):
        """The projections; Rotary/SinCos act on q and k at positions
        [offset, offset + T)."""
        q, k, v = self.in_proj(xv).chunk(3, dim=-1)
        if isinstance(rpe, Rotary):
            q, k = rpe.rotate_qk(q, k, offset)
        elif isinstance(rpe, SinCos):
            q, k = rpe(q, offset), rpe(k, offset)
        return q, k, v

    def forward(self, x: Masked, rpe=None,
                bias: Optional[torch.Tensor] = None) -> Masked:
        """x: (B, T, C) frames; ``rpe`` the stack's shared position module
        or None; ``bias`` a (H, T, T) logit bias computed once for the
        stack (the T5 table's; computed here when a T5 ``rpe`` comes
        without it).  Returns the masked output (B, T, C)."""
        q, k, v = self._qkv(x.value, rpe)
        t = q.shape[1]
        if isinstance(rpe, T5RPE) and bias is None:
            bias = rpe(t, t)
        if self.use_flash and self.causal and bias is None:
            slopes = rpe.slopes if isinstance(rpe, ALiBi) else None
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
            pos = torch.arange(t, device=q.device)
            mask = (pos[None, :] < x.lengths[:, None])[:, None, None, :]
            if self.causal:
                mask = mask & (pos[None, :] <= pos[:, None])[None, None]
            else:
                mask = mask.expand(q.shape[0], 1, t, t)
            if isinstance(rpe, ALiBi):
                bias = rpe.bias(pos, pos)
            out = merge_heads(attend(split_heads(q, self.nheads),
                                     split_heads(k, self.nheads),
                                     split_heads(v, self.nheads), bias,
                                     mask))
        return Masked(self.out_proj(out), x.lengths, 1).apply_mask()

    # -- per-layer static-cache decode -------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=None) -> LayerKVCache:
        """This layer's cache; ``dtype`` None is the policy's compute
        dtype, as in JAX."""
        return LayerKVCache.zeros(batch, max_len, self.nheads, self.head_dim,
                                  dtype or get_policy().compute_dtype,
                                  device=self.in_proj.weight.device)

    @torch.no_grad()
    def decode_step(self, xv: torch.Tensor, cache: LayerKVCache, pos: int,
                    rpe=None,
                    window: Optional[int] = None,
                    return_attn: bool = False, flash: bool = False):
        """New frames xv (B, S, C) at absolute positions [pos, pos+S) over
        the per-layer cache (written in place first).  S == 1 goes through
        ``decode_attention`` (attending over ``cache[:window]``), or with
        ``flash`` through K6 ``flash_decode_int8`` (an int8 cache whose
        length is a multiple of 256; no window, no weights); S > 1 is the
        dense prefill over the whole cache through ``attend``.  Rotary
        and SinCos act on q and k at [pos, pos+S) before the cache write;
        only ALiBi adds a bias here (JAX adds no T5 bias at decode).
        Returns ``(out (B, S, C), cache)``, with ``return_attn`` also the
        float32 weights (B, H, S, maxT)."""
        s = xv.shape[1]
        q, k, v = self._qkv(xv, rpe, pos)
        qh = split_heads(q, self.nheads)
        cache.write(pos, split_heads(k, self.nheads),
                    split_heads(v, self.nheads))
        slopes = rpe.slopes if isinstance(rpe, ALiBi) else None
        if s == 1:
            w = None
            if flash:
                if return_attn or not cache.quantized:
                    raise ValueError(
                        "flash_decode_int8 takes an int8 cache and "
                        "returns no weights")
                if slopes is None:
                    slopes = torch.zeros(self.nheads, device=xv.device)
                out = flash_decode_int8(
                    qh[:, 0], cache.k, cache.v, cache.k_scale, cache.v_scale,
                    pos, slopes).to(qh.dtype)
            else:
                out = decode_attention(
                    qh[:, 0], cache.k, cache.v, pos, slopes, window=window,
                    k_scale=cache.k_scale, v_scale=cache.v_scale,
                    return_weights=return_attn)
                if return_attn:
                    out, w = out
            out = self.out_proj(out.reshape(out.shape[0], 1, self.dim))
            if return_attn:
                return out, cache, w[:, :, None]             # (B, H, 1, T)
            return out, cache
        max_len = cache.max_len
        dev = xv.device
        k_pos = torch.arange(max_len, device=dev)
        q_pos = pos + torch.arange(s, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None].expand(
            xv.shape[0], 1, s, max_len)
        bias = rpe.bias(q_pos, k_pos) if slopes is not None else None
        kc, vc = cache.dense_kv()                           # (B, T, H, D)
        out, attn = attend(qh, kc, vc, bias, mask, return_attn=True)
        out = self.out_proj(merge_heads(out))
        if return_attn:
            return out, cache, attn                          # (B, H, S, T)
        return out, cache


class CrossAttention(nn.Module):
    """Attention of frames over an encoder memory (reference
    ``attention.py:101-172``): ``q_proj`` on the frames, a fused
    ``kv_proj`` on the memory, the memory's padding masked, no causal
    mask; an optional SinCos/Rotary ``rpe`` acts on q, k or both
    (``target`` "source", "memory" or unset)."""

    def __init__(self, dim: int, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("nheads")
        if dim % hp.nheads:
            raise ValueError("dim must be a multiple of nheads")
        self.nheads = hp.nheads
        self.dim = dim
        self.head_dim = dim // hp.nheads
        bias = bool(hp.get("bias", None))
        self.q_proj = Dense(dim, dim, bias=bias)
        self.kv_proj = Dense(dim, dim * 2, bias=bias)
        self.out_proj = Dense(dim, dim, bias=bias)
        self.rpe, self.rpe_target = None, None
        if hp.has("rpe"):
            rpe_id = hp.rpe.identifier
            if rpe_id not in ("SinCos", "Rotary"):
                raise ValueError(f"cross-attention positions: SinCos or "
                                 f"Rotary, not {rpe_id}")
            self.rpe = get_positional_encoding(rpe_id, hp.rpe, dim,
                                               self.nheads)
            self.rpe_target = hp.rpe.get("target", None)

    def forward(self, q: Masked, kv: Masked, return_attn: bool = False):
        """Frames q (B, Tq, C) over the memory kv (B, Tk, C); returns the
        masked output, with ``return_attn`` also the float32 weights (B,
        H, Tq, Tk)."""
        qv = self.q_proj(q.value)
        kk, vv = self.kv_proj(kv.value).chunk(2, dim=-1)
        if self.rpe is not None:
            if self.rpe_target != "memory":
                qv = self.rpe(qv)
            if self.rpe_target != "source":
                kk = self.rpe(kk)
        tq, tk = qv.shape[1], kk.shape[1]
        pad = torch.arange(tk, device=kk.device)[None, :] \
            < kv.lengths[:, None]
        mask = pad[:, None, None, :].expand(qv.shape[0], 1, tq, tk)
        res = attend(split_heads(qv, self.nheads),
                     split_heads(kk, self.nheads),
                     split_heads(vv, self.nheads), None, mask,
                     return_attn=return_attn)
        out, attn = res if return_attn else (res, None)
        out = Masked(self.out_proj(merge_heads(out)), q.lengths,
                     1).apply_mask()
        return (out, attn) if return_attn else out
