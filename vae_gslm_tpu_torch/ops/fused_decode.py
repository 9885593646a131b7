"""Single-query decode attention over the hybrid cold/tail int8 KV
cache (port of ``vae_gslm_tpu/ops/fused_decode.py``).

``fused_decode_attention`` is the wrapper of the hand-written Hopper
kernel ``csrc/fused_decode.cu``, which replaces the Pallas kernel
``fused_decode_attention_prepared``.  The cache keeps the JAX layout at
this function so that the tests compare like with like:

  * cold: ``(L, NB, B, H, D, 256)`` int8, block-major and time-minor,
    holding the ``flushed`` (a multiple of 256) oldest positions, with
    float32 per-position scales ``(L, NB, B, H, 256)``;
  * tail: ``(L, B, H, 256, D)`` int8 holding positions
    ``[flushed, flushed + 256)`` with scales ``(L, B, H, 256)``.

Numerics (the reference ``fused_decode_attention_reference``): q is
quantized to int8 per head; QK is int8 x int8 with int32 sums; ALiBi
adds ``slope * |t - pos|``; tail rows are valid only at ``t < pos``;
the current token (its cache write is deferred by the caller) enters as
one extra float32 logit ``q . k_new / sqrt(D)`` with no ALiBi term,
its dot product summed in float64 and rounded once;
P.V requantizes ``e * v_scale`` per 256-position block (cold blocks
from 0, then the tail as one block) against its block max, rounding
half to even, and sums int8 x int8 in int32.

On a CPU tensor the wrapper computes ``fused_decode_attention_plain``;
on a CUDA tensor it launches the kernel or raises.  The kernel runs one
thread-block cluster per (batch row, head), its position blocks spread
over the cluster's CTAs (``k1_plan``, ``k1_owner``), and gives the bits
of a one-block kernel that takes the blocks in order: CTA 0 sums ``l``
and merges the blocks' terms in the reference's order
(``k1_merge_order``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

BLK = 256
TAIL = 256
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
MAX_CLUSTER = 8                      # the portable cluster size
MAX_SLOTS = 13                       # slot mbarriers in a CTA's header
SMEM_LIMIT = 232448                  # an H100 block's most shared memory
_HDR = 352                           # mbarriers, reduction scratch, maxima


class K1Plan(NamedTuple):
    """One K1 launch (``make_plan`` in ``csrc/fused_decode.cu``)."""
    cluster: int      # CTAs per (batch row, head)
    owned: int        # position blocks of the CTA that owns the most
    slots: int        # K/V plane slots of a CTA's shared memory
    smem: int         # dynamic shared memory of a CTA, bytes


@functools.lru_cache(maxsize=None)
def k1_plan(d: int, nblk: int) -> K1Plan:
    """The cluster, ownership and shared memory of a call over ``nblk``
    cold blocks and the tail (``nblk + 1`` position blocks): a cluster of
    ``min(nblk + 1, 8)`` CTAs, CTA r owning blocks r, r + C, ..; each CTA
    keeps a 352-byte header, q8, u8, the int32 sums, each owned block's
    e and term, when every CTA owns one block the receive buffers into
    which the others push blocks 1 .. nblk's e and terms, and ``slots``
    planes (a 256-position K or V plane and its scales): all of its K and
    V planes when they fit (every plane requested before the first
    product), else a ring of as many as fit.  Raises if not one plane
    fits."""
    cluster = min(nblk + 1, MAX_CLUSTER)
    owned = -(-(nblk + 1) // cluster)
    fixed = _HDR + 5 * d + BLK + owned * (BLK * 4 + d * 4)
    if owned == 1:
        fixed += nblk * (BLK * 4 + d * 4)
    slot = d * BLK + BLK * 4
    slots = min(2 * owned, MAX_SLOTS, max((SMEM_LIMIT - fixed) // slot, 0))
    if slots < 1:
        raise ValueError(f"K1: {nblk} cold blocks at head_dim {d} leave no "
                         "room for a plane in a CTA's shared memory")
    return K1Plan(cluster, owned, slots, fixed + slots * slot)


def k1_owner(j: int, cluster: int) -> Tuple[int, int]:
    """(CTA rank, its local index) of position block ``j`` (cold blocks
    from 0, the tail last)."""
    return j % cluster, j // cluster


def k1_merge_order(nblk: int) -> List[int]:
    """The position blocks in the order CTA 0 adds their terms (and sums
    their e into l), after ``e_self * v_new``: the reference's order,
    cold blocks 0 .. nblk - 1 and then the tail (block nblk)."""
    return list(range(nblk + 1))


def fused_decode_attention_plain(q, k_cold, v_cold, kc_scale, vc_scale,
                                 k_tail, v_tail, kt_scale, vt_scale,
                                 pos: int, li: int, slopes, k_new, v_new,
                                 flushed: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's quantized math.

    Integer products are taken in float32 on int8-valued operands:
    every partial sum is an integer below 2**24, so they are exact on
    any device and in any order."""
    qf = q.float()
    # a true division: PyTorch's CUDA kernels multiply by the reciprocal
    # of a Python scalar divisor, which can differ in the last bit
    i8_max = torch.tensor(127.0, device=q.device)
    q_scale = qf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / i8_max
    q8 = torch.round(qf / q_scale).to(torch.int8).float()
    b, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    slopes_f = slopes.float()[None, :, None]
    dev = q.device

    def logits(k8_bhtd, ks, base, strict_mask):
        s = torch.einsum("bhd,bhtd->bht", q8, k8_bhtd.float())
        s = s * (q_scale * ks * scale)
        t_idx = base + torch.arange(k8_bhtd.shape[2], device=dev)
        s = s + slopes_f * (t_idx - pos).abs().float()[None, None]
        if strict_mask:
            s = torch.where(t_idx[None, None] < pos, s,
                            torch.tensor(NEG_INF, device=dev))
        return s

    def unblock(x):      # (NB, B, H, D, BLK) -> (B, H, NB*BLK, D)
        return x.permute(1, 2, 0, 4, 3).reshape(b, h, -1, d)[:, :, :flushed]

    def unblock_s(x):    # (NB, B, H, BLK) -> (B, H, NB*BLK)
        return x.permute(1, 2, 0, 3).reshape(b, h, -1)[..., :flushed]

    parts = []
    if flushed:
        parts.append((logits(unblock(k_cold[li]), unblock_s(kc_scale[li]),
                             0, False),
                      unblock(v_cold[li]), unblock_s(vc_scale[li])))
    parts.append((logits(k_tail[li], kt_scale[li], flushed, True),
                  v_tail[li], vt_scale[li]))
    # summed in float64 and rounded once, like the kernel: the result
    # does not depend on the order of the sum
    s_self = ((qf.double() * k_new.double()).sum(-1).float()[..., None]
              * scale)
    full = torch.cat([p[0] for p in parts] + [s_self], dim=-1)
    m = full.amax(dim=-1, keepdim=True)
    e_all = torch.exp(full - m)
    l = e_all.sum(dim=-1, keepdim=True)
    acc = e_all[..., -1:] * v_new.float()
    off = 0
    for s_p, v8, vs in parts:
        n = s_p.shape[-1]
        e = e_all[..., off:off + n]
        off += n
        for i in range(0, n, BLK):
            j = min(i + BLK, n)
            u = e[..., i:j] * vs[..., i:j]
            u_scale = u.amax(dim=-1, keepdim=True).clamp(min=1e-20) / i8_max
            u8 = torch.round(u / u_scale).to(torch.int8).float()
            av = torch.einsum("bht,bhtd->bhd", u8, v8[:, :, i:j].float())
            acc = acc + av * u_scale
    return acc / l


def _check(name, t, dtype, shape, device, row_strides=None):
    """Raise unless ``t`` has this dtype, shape and device and is
    contiguous, or with ``row_strides`` has those strides after the batch
    axis."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape or t.device != device:
        raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
    if (t.stride()[1:] != row_strides if row_strides
            else not t.is_contiguous()):
        raise ValueError(f"{name}: strides {t.stride()} are not the "
                         "layout the kernel reads")


_LAUNCH = None


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from .build import load

        fn = load("fused_decode").fused_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def fused_decode_attention(q, k_cold, v_cold, kc_scale, vc_scale,
                           k_tail, v_tail, kt_scale, vt_scale,
                           pos: int, li: int, slopes, k_new, v_new,
                           flushed: int) -> torch.Tensor:
    """q/k_new/v_new: (B, H, D) float32 or bfloat16, each batch row a
    contiguous (H, D) block at one common batch stride (views into the
    fused qkv projection need no copy); caches as in the module
    docstring; ``pos``, ``li``, ``flushed`` host ints; slopes (H,)
    negative ALiBi slopes.  Returns (B, H, D) float32."""
    if q.device.type == "cpu":
        return fused_decode_attention_plain(
            q, k_cold, v_cold, kc_scale, vc_scale, k_tail, v_tail,
            kt_scale, vt_scale, pos, li, slopes, k_new, v_new, flushed)
    if q.device.type != "cuda":
        raise ValueError(f"no fused_decode_attention for {q.device}")
    b, h, d = q.shape
    nl, nb = k_cold.shape[0], k_cold.shape[1]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32/bfloat16")
    row_stride = q.stride(0)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _check(name, t, q.dtype, (b, h, d), dev, row_strides=(d, 1))
        if t.stride(0) != row_stride:
            raise ValueError(f"{name}: batch stride {t.stride(0)}, q has "
                             f"{row_stride}")
    for name, t in (("k_cold", k_cold), ("v_cold", v_cold)):
        _check(name, t, torch.int8, (nl, nb, b, h, d, BLK), dev)
    for name, t in (("kc_scale", kc_scale), ("vc_scale", vc_scale)):
        _check(name, t, torch.float32, (nl, nb, b, h, BLK), dev)
    for name, t in (("k_tail", k_tail), ("v_tail", v_tail)):
        _check(name, t, torch.int8, (nl, b, h, TAIL, d), dev)
    for name, t in (("kt_scale", kt_scale), ("vt_scale", vt_scale)):
        _check(name, t, torch.float32, (nl, b, h, TAIL), dev)
    _check("slopes", slopes, torch.float32, (h,), dev)
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel needs a multiple of "
                         "16 that divides 256")
    for name, t in (("k_cold", k_cold), ("v_cold", v_cold),
                    ("kc_scale", kc_scale), ("vc_scale", vc_scale),
                    ("k_tail", k_tail), ("v_tail", v_tail),
                    ("kt_scale", kt_scale), ("vt_scale", vt_scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies cache planes 16 "
                             f"bytes at a time; data_ptr {t.data_ptr()} "
                             "is not 16-byte aligned")
    if flushed % BLK or not 0 <= flushed <= nb * BLK:
        raise ValueError(f"flushed={flushed} must be a multiple of {BLK} "
                         f"within the {nb}-block cold cache")
    if not flushed <= pos < flushed + TAIL:
        raise ValueError(f"pos={pos} outside the tail [{flushed}, "
                         f"{flushed + TAIL})")
    if not 0 <= li < nl:
        raise ValueError(f"layer index {li} outside [0, {nl})")
    plan = k1_plan(d, flushed // BLK)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    err = _launcher()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        int(q.dtype == torch.bfloat16),
        k_cold.data_ptr(), v_cold.data_ptr(), kc_scale.data_ptr(),
        vc_scale.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        kt_scale.data_ptr(), vt_scale.data_ptr(),
        slopes.data_ptr(), out.data_ptr(), row_stride,
        b, h, d, nb, li, pos, flushed,
        1.0 / math.sqrt(d), *plan, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_attention launch failed: CUDA "
                           f"error {err}")
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
