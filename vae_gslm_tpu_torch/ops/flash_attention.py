"""Packed causal ALiBi self-attention for training (port of
``flash_attention_packed`` in ``vae_gslm_tpu/ops/flash_attention.py``).

q, k, v: ``(B, T, H*D)`` in the projection's packed layout (views into
the fused qkv projection are fine: the last axis must be contiguous);
lengths ``(B,)`` valid key counts; slopes ``(H,)`` negative ALiBi
slopes or None.  The TPU kernels this replaces are K3
``_flash_forward_full_packed`` (:230) and K3b ``_flash_backward_packed``
(:359); on the card ``csrc/flash_attention.cu`` computes them, tiled.

Numerics (JAX's ``_attention_reference`` and the TPU kernels):
``s = (q . k) / sqrt(D) + slope * |k - q|`` in float32, ``-1e30`` where
the key is at or past ``lengths[b]`` or after the query; the softmax is
normalized before P.V and rounded to V's dtype; the forward also returns
``lse = m + log(sum exp(s - m))`` as ``(B, H, T)`` float32 (the port's
own layout).  The backward recomputes ``p = exp(s - lse)``; with
``delta = rowsum(dO * O)``: ``ds = p (dO.v - delta)`` rounded to q's
dtype, ``dq = (ds . k) / sqrt(D)``, ``dv = round(p)^T . dO``,
``dk = (ds^T . q) / sqrt(D)``.  The plain versions compute in float32
(float64 for float64 inputs, for ``gradcheck``).

``flash_attention_packed`` is a ``torch.autograd.Function``.  On CPU
tensors it runs the plain versions; on CUDA tensors it always launches
the kernels, and raises outside their envelope (T <= 1024, head_dim 64,
float32 or bfloat16): those shapes are K4/K5's, not ported yet.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
MAX_T = 1024
HEAD_DIM = 64


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _heads(x: torch.Tensor, nheads: int, dt: torch.dtype) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D) in ``dt``."""
    b, t, hd = x.shape
    return x.reshape(b, t, nheads, hd // nheads).transpose(1, 2).to(dt)


def _packed(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _logits(q, k, lengths, slopes, causal: bool, nheads: int):
    """Masked logits (B, H, T, T) and the accumulation dtype."""
    dt = _acc_dtype(q)
    qh, kh = _heads(q, nheads, dt), _heads(k, nheads, dt)
    t, d = qh.shape[2], qh.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(d))
    pos = torch.arange(t, device=q.device)
    if slopes is not None:
        dist = (pos[None, :] - pos[:, None]).abs().to(dt)
        s = s + slopes.to(dt)[:, None, None] * dist[None]
    mask = pos[None, None, None, :] < lengths.to(q.device)[:, None, None,
                                                           None]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    return torch.where(mask, s, torch.tensor(NEG_INF, dtype=dt,
                                             device=q.device)), dt


def flash_forward_packed_plain(q, k, v, lengths, slopes, causal: bool,
                               nheads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: (o (B, T, H*D) in q's dtype,
    lse (B, H, T) in the accumulation dtype)."""
    s, dt = _logits(q, k, lengths, slopes, causal, nheads)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    w = (e / denom).to(v.dtype).to(dt)
    out = torch.einsum("bhqk,bhkd->bhqd", w, _heads(v, nheads, dt))
    return _packed(out).to(q.dtype), (m + torch.log(denom))[..., 0]


def _delta(g: torch.Tensor, o: torch.Tensor, nheads: int) -> torch.Tensor:
    """rowsum(dO * O) per head as (B, H, T), float32 (float64 inputs:
    float64)."""
    dt = _acc_dtype(o)
    b, t, hd = o.shape
    prod = (g.to(dt) * o.to(dt)).reshape(b, t, nheads, hd // nheads)
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_backward_packed_plain(q, k, v, o, g, lse, lengths, slopes,
                                causal: bool, nheads: int):
    """K3b's function in plain PyTorch, from the saved ``o`` and ``lse``
    (not autograd of the forward: delta comes from the rounded O).
    Returns dq, dk, dv in packed layout and the inputs' dtypes."""
    s, dt = _logits(q, k, lengths, slopes, causal, nheads)
    d = q.shape[-1] // nheads
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(s - lse.to(dt)[..., None])
    gh = _heads(g, nheads, dt)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, _heads(v, nheads, dt))
    ds = (p * (dp - _delta(g, o, nheads)[..., None])).to(q.dtype).to(dt)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _heads(k, nheads, dt)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).to(dt), gh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _heads(q, nheads, dt)) * scale
    return (_packed(dq).to(q.dtype), _packed(dk).to(k.dtype),
            _packed(dv).to(v.dtype))


# ------------------------------------------------------------- kernels
_FWD = None
_BWD = None


def _launchers():
    global _FWD, _BWD
    if _FWD is None:
        from .build import load

        lib = load("flash_attention")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd = lib.flash_fwd_packed_launch
        fwd.argtypes = [p] * 7 + [ll] * 8 + [i] * 5 + [ctypes.c_float, p]
        fwd.restype = i
        bwd = lib.flash_bwd_packed_launch
        bwd.argtypes = ([p] * 11 + [ll] * 14 + [i] * 5
                        + [ctypes.c_float, p])
        bwd.restype = i
        _FWD, _BWD = fwd, bwd
    return _FWD, _BWD


def kernel_supports(q: torch.Tensor, k: torch.Tensor, nheads: int) -> bool:
    """JAX's ``_packed_eligible`` (a 128-lane head grouping, T <= 1024,
    self-attention) and the CUDA kernels' head_dim 64 and dtypes."""
    b, t, hd = q.shape
    if hd % nheads:
        return False
    d = hd // nheads
    hpb = 1 if d % 128 == 0 else (128 // d if 128 % d == 0
                                  and hd % 128 == 0 else 0)
    return (hpb > 0 and nheads % hpb == 0 and k.shape[1] == t
            and t <= MAX_T and d == HEAD_DIM
            and q.dtype in (torch.float32, torch.bfloat16))


def _seq(name: str, x: torch.Tensor, shape, dtype, device):
    """(batch stride, row stride) of a packed operand; raises unless the
    kernel can read it."""
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, expected {tuple(shape)} {dtype} on "
                         f"{device}")
    if x.stride(2) != 1:
        raise ValueError(f"{name}: the feature axis must be contiguous "
                         f"(strides {x.stride()})")
    if dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8
                                    or x.stride(1) % 8):
        raise ValueError(f"{name}: the bf16 kernels read rows 16 bytes at "
                         f"a time; data_ptr {x.data_ptr()} and strides "
                         f"{x.stride()} are not 16-byte aligned")
    return x.stride(0), x.stride(1)


def _check_cuda(q, k, v, lengths, slopes, nheads: int):
    if not kernel_supports(q, k, nheads):
        raise NotImplementedError(
            f"flash_attention_packed on CUDA takes T <= {MAX_T}, head_dim "
            f"{HEAD_DIM}, float32/bfloat16 packed self-attention; got q "
            f"{tuple(q.shape)} {q.dtype} with {nheads} heads, k "
            f"{tuple(k.shape)}.  Other shapes run through the BHTD (K4) or "
            "q-tiled (K5) kernels, which are not ported yet (ROADMAP.md)")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor on "
                         "q's device")
    if slopes is not None and (slopes.dtype != torch.float32
                               or slopes.shape != (nheads,)
                               or slopes.device != q.device
                               or not slopes.is_contiguous()):
        raise ValueError("slopes must be a contiguous (H,) float32 tensor "
                         "on q's device")


def flash_forward_packed(q, k, v, lengths, slopes, causal: bool,
                         nheads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o, lse).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_forward_packed_plain(q, k, v, lengths, slopes, causal,
                                          nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    _check_cuda(q, k, v, lengths, slopes, nheads)
    b, t, hd = q.shape
    dev = q.device
    seqs = [_seq(n, x, q.shape, q.dtype, dev)
            for n, x in (("q", q), ("k", k), ("v", v))]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, nheads, t), dtype=torch.float32, device=dev)
    fwd, _ = _launchers()
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), lengths.data_ptr(),
              slopes.data_ptr() if slopes is not None else None,
              *seqs[0], *seqs[1], *seqs[2], *o.stride()[:2],
              b, t, nheads, int(q.dtype == torch.bfloat16), int(causal),
              1.0 / math.sqrt(hd // nheads),
              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    flash_forward_packed.launches += 1
    return o, lse


flash_forward_packed.launches = 0


def flash_backward_packed(q, k, v, o, g, lse, lengths, slopes,
                          causal: bool, nheads: int):
    """K3b: (dq, dk, dv).  CPU tensors take the plain version; CUDA
    tensors launch the kernels (two launches, one count) or raise.
    ``delta`` is a plain torch op, as JAX computes it outside its
    kernel."""
    if q.device.type == "cpu":
        return flash_backward_packed_plain(q, k, v, o, g, lse, lengths,
                                           slopes, causal, nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    _check_cuda(q, k, v, lengths, slopes, nheads)
    b, t, hd = q.shape
    dev = q.device
    seqs = [_seq(n, x, q.shape, q.dtype, dev)
            for n, x in (("q", q), ("k", k), ("v", v), ("dO", g))]
    _seq("o", o, q.shape, q.dtype, dev)
    if lse.shape != (b, nheads, t) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, H, T) float32 tensor")
    delta = _delta(g, o, nheads)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=dev)
             for _ in range(3)]
    _, bwd = _launchers()
    err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
              slopes.data_ptr() if slopes is not None else None,
              *(x.data_ptr() for x in grads),
              *seqs[0], *seqs[1], *seqs[2], *seqs[3],
              *(s for x in grads for s in x.stride()[:2]),
              b, t, nheads, int(q.dtype == torch.bfloat16), int(causal),
              1.0 / math.sqrt(hd // nheads),
              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    flash_backward_packed.launches += 1
    return tuple(grads)


flash_backward_packed.launches = 0


class FlashAttentionPacked(torch.autograd.Function):
    """Saves q, k, v, o, lse, lengths and slopes; the backward is K3b."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, slopes, causal, nheads):
        o, lse = flash_forward_packed(q, k, v, lengths, slopes, causal,
                                      nheads)
        ctx.save_for_backward(q, k, v, o, lse, lengths, slopes)
        ctx.causal, ctx.nheads = causal, nheads
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, lengths, slopes = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv = flash_backward_packed(q, k, v, o, g.to(q.dtype), lse,
                                           lengths, slopes, ctx.causal,
                                           ctx.nheads)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           slopes: Optional[torch.Tensor], causal: bool,
                           nheads: int) -> torch.Tensor:
    """Fused attention over the packed (B, T, H*D) layout; returns the
    packed output that ``out_proj`` consumes."""
    return FlashAttentionPacked.apply(q, k, v, lengths.to(torch.int32),
                                      slopes, causal, nheads)
