"""Single-query decode attention over a per-layer KV cache (port of
``vae_gslm_tpu/ops/decode_attention.py``, plain XLA there, so torch ops
here).

The cache is JAX's base layout ``(B, H, T, D)``; JAX's lane-packed
``(T, D, B * H)`` form (``decode_attention_packed``), which fills a TPU's
128 lanes, is not ported.  A static ``window`` attends over the cache prefix ``[:window]`` only (the
sampler's segmented scan); ALiBi adds ``slope * |t - pos|``; keys past
``pos`` are masked; the softmax is float32.

The int8 branch follows JAX's: q is quantized to int8 per (b, h) and
multiplied with the int8 keys.  JAX sums that product in int32; here it
is a float32 product of the int8 values, which is exact (every partial
sum is an integer below 64 * 127**2 < 2**24, and int8 values fit TF32's
mantissa too), so the logits equal JAX's bit for bit on either device.
The per-key V scale is folded into the weights, which are rounded to
bfloat16 before the V product, as JAX does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _quantize_q(q: torch.Tensor):
    """JAX's int8 query: ``(int8 values as float32, float32 scale)``, the
    amax divided by 127 in q's dtype as JAX does; the divisions are by
    tensors (CUDA multiplies by a Python scalar's reciprocal)."""
    amax = q.abs().amax(dim=-1, keepdim=True)
    q_scale = (amax / torch.tensor(127.0, dtype=amax.dtype,
                                   device=q.device)).float()
    qi = torch.round(q.float() / q_scale.clamp(min=1e-8))
    return qi.to(torch.int8).float(), q_scale


def decode_logits(q: torch.Tensor, k_cache: torch.Tensor, pos: int,
                  slopes: Optional[torch.Tensor],
                  k_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked float32 logits (B, H, T) of ``decode_attention`` over a
    cache already cut to its window."""
    t = k_cache.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if k_scale is not None:
        qi, q_scale = _quantize_q(q)
        logits = torch.matmul(qi[:, :, None], k_cache.float().transpose(
            -1, -2))[:, :, 0]
        logits = logits * (q_scale * k_scale.float() * scale)
    else:
        logits = torch.matmul(q.float()[:, :, None], k_cache.float()
                              .transpose(-1, -2))[:, :, 0] * scale
    k_pos = torch.arange(t, device=q.device)
    if slopes is not None:
        dist = (k_pos - pos).abs().float()
        logits = logits + slopes.float()[None, :, None] * dist[None, None]
    return torch.where(k_pos[None, None] <= pos, logits,
                       torch.tensor(NEG_INF, device=q.device))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int,
                     slopes: Optional[torch.Tensor],
                     window: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     return_weights: bool = False):
    """q (B, H, D); caches (B, H, T, D) (int8 with ``k_scale``/
    ``v_scale`` (B, H, T) float32, or a float dtype); ``pos`` the query's
    absolute position (keys <= pos are valid), a host int; slopes (H,)
    negative ALiBi slopes or None; ``window`` a static prefix length
    (> pos).  Returns (B, H, D) in q's dtype, or with ``return_weights``
    ``(out, weights (B, H, T))`` zero-padded to the full cache length."""
    t_full = k_cache.shape[2]
    if window is not None and window < t_full:
        k_cache, v_cache = k_cache[:, :, :window], v_cache[:, :, :window]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, :, :window], v_scale[:, :, :window]
    w = torch.softmax(decode_logits(q, k_cache, pos, slopes, k_scale),
                      dim=-1)
    if v_scale is not None:
        wv = (w * v_scale.float()).to(torch.bfloat16).float()
    else:
        wv = w.to(v_cache.dtype).float()
    out = torch.matmul(wv[:, :, None], v_cache.float())[:, :, 0].to(q.dtype)
    if return_weights:
        t = k_cache.shape[2]
        return out, torch.nn.functional.pad(w, (0, t_full - t))
    return out

