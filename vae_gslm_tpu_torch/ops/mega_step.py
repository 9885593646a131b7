"""One whole trunk AR step over the three-tier mega cache (port of
``vae_gslm_tpu/ops/mega_step.py``).

``fused_trunk_step`` is the wrapper of the hand-written Hopper kernel
``csrc/mega_step.cu``, which replaces the Pallas kernel
``fused_trunk_step`` (body ``_kernel``).  One call runs all L layers:
RMSNorm, the int8-weight QKV projection, attention over the cache,
the out-projection, RMSNorm and the GELU FFN.  Weights and cache keep
the JAX layouts at this function, so that the tests compare like with
like:

  * weights (``TransformerLayerStack.build_mega_decode``): ``wq`` (L, D,
    3D), ``wo`` (L, D, D), ``w1`` (L, D, 4D), ``w2`` (L, 4D, D) int8,
    ``x @ w``; per-output-column float32 scales ``sq/so/s1/s2`` (L,
    dout); RMSNorm scales ``n1/n3`` (L, D); biases ``bq/bo/b1/b2``;
  * cache: cold ``k_cold/v_cold`` (L, NB, H, B, Dh, 128) int8,
    block-major and time-minor, with ``kc_scale/vc_scale`` (L, NB, H, B,
    128); tail ``k_tail/v_tail`` (L, H, B, 128, Dh) int8 with
    ``kt_scale/vt_scale`` (L, H, B, 128); stage ``k_stage/v_stage`` (L,
    8, H, B, Dh) bfloat16.

Positions [0, flushed) live in the cold blocks, [flushed, stage_base)
in the int8 tail and [stage_base, pos) in the bf16 stage, with
``stage_base = pos - (pos - flushed) % 8``; the current token enters
as one extra logit.  The caller appends the returned K/V rows to the
stage (``stage_append``), merges the stage into the tail every 8 steps
(``merge_stage``) and moves a full tail into the next cold block every
128 (``flush_mega``); these three update the cache dict in place.

Nibble-packed int4 weights (``build_mega_decode_w4``, detected as JAX
detects them, by ``"gq" in weights``): ``wq/wo/w1/w2`` are (L, din/2,
dout) int8 with rows ``r`` and ``r + din/2`` in the hi and lo nibble of
one byte, and ``gq/go/g1/g2`` (L, din/group, dout) float32 fold the
per-(row group, column) int4 scale with the int8 column scale.  Each
dense product quantizes the activation per group of ``group`` inputs
(scale max|x|/127), takes an exact int32 dot per group and adds ``dot *
(x_scale * g)`` to a float32 sum in group order; the out-projection
quantizes each head's row and scales it by the head's group row of
``go``; no ``s*`` column scale is applied (``a8`` has no effect).

Numerics (``fused_trunk_step_reference``): with ``a8`` the dense
products quantize each activation row to int8 (scale max|x|/127) and
sum int8 x int8 in int32; otherwise they multiply bfloat16 activations
by the int8 weights (float32 sums on the TPU; float64 sums here and in
the kernel, so that both round the same sum).  Attention quantizes q
per head; the cold and tail tiers take int8 x int8 QK, then requantize
``e * v_scale`` per 128-row block against the running (not the global)
softmax maximum; the stage tier and the current token run in float32.
GELU uses the Abramowitz-Stegun rational erf, as the TPU kernel does.
Every sum whose order the kernel cannot match cheaply (RMS, the stage
and current-token dots, the softmax denominators, the stage P.V) is
taken in float64 and rounded once, in the kernel and here.

On a CPU tensor the wrapper computes ``fused_trunk_step_plain``; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .fused_decode import _check

BLK = 128
TAIL = 128
STAGE = 8
NEG_INF = -1e30
HEAD_DIM = 64          # the CUDA kernel's head width (the flagship's)
WEIGHT_KEYS = ("wq", "wo", "w1", "w2", "sq", "so", "s1", "s2", "n1", "n3",
               "bq", "bo", "b1", "b2")
W4_KEYS = ("gq", "go", "g1", "g2")        # K2-w4's folded group scales
W4_GROUPS = (64, 128)                     # the groups K2-w4 is built for
CACHE_KEYS = ("k_cold", "v_cold", "kc_scale", "vc_scale", "k_tail",
              "v_tail", "kt_scale", "vt_scale", "k_stage", "v_stage")

_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
          1.061405429)
_ERF_P = 0.3275911


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf, written as the TPU kernel
    writes it (each operation rounded once, ``1 / t`` a true division)."""
    a1, a2, a3, a4, a5 = _ERF_A
    one = torch.tensor(1.0, device=x.device)
    ax = x.abs()
    t = one / (1.0 + _ERF_P * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t
               + a1) * t * torch.exp(-ax * ax)
    return torch.sign(x) * y


def gelu_rational(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU with the rational erf (K2's activation; the hybrid
    path's GELU uses the true erf)."""
    return 0.5 * x * (1.0 + _erf(x * (1.0 / math.sqrt(2.0))))


def _quant_rows(x: torch.Tensor, floor: float):
    """Per-row symmetric int8 over the last axis: (integer-valued
    float32, scale (..., 1)).  The scale is divided by a tensor: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal."""
    i8_max = torch.tensor(127.0, device=x.device)
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=floor) / i8_max
    return torch.round(x / scale), scale


def _rms(x: torch.Tensor, nscale: torch.Tensor) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + 1e-6) * nscale``.  The squares are summed in
    float64 and rounded once (so the kernel's order of summation does not
    matter), and rsqrt is the correctly rounded ``1 / sqrt`` in both."""
    dev = x.device
    ms = (x.square().double().sum(dim=-1, keepdim=True).float()
          / torch.tensor(float(x.shape[-1]), device=dev))
    r = torch.tensor(1.0, device=dev) / torch.sqrt(ms + 1e-6)
    return x * r * nscale


def _mm(x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
        a8: bool) -> torch.Tensor:
    """A dense product with int8 weights (din, dout) and column scales.
    K is 1024 or 4096 terms of up to 127^2, whose partial sums exceed
    2^24, so the products are taken in float64 (exact for a8) and rounded
    once."""
    if a8:
        x8, xs = _quant_rows(x, 1e-8)
        y = (x8.double() @ w8.double()).float()
        return y * (xs * scales)
    xb = x.to(torch.bfloat16).double()
    return (xb @ w8.double()).float() * scales


def unpack_w4(wp: torch.Tensor) -> torch.Tensor:
    """(din/2, dout) nibble-packed int8 -> (din, dout) int32 in row order:
    the hi nibbles (``b >> 4``) are rows [0, din/2), the sign-extended lo
    nibbles (``(b << 28) >> 28``) rows [din/2, din), unpacked through
    int32 as the TPU kernel does."""
    w32 = wp.to(torch.int32)
    return torch.cat([w32 >> 4, (w32 << 28) >> 28])


def _mm_w4(x: torch.Tensor, wp: torch.Tensor,
           gscale: torch.Tensor) -> torch.Tensor:
    """A dense product with nibble-packed weights and folded group scales
    (G, dout): per group of din/G inputs, the activation quantized to int8,
    an exact int32 dot (at most 128 terms of 127 x 8), and ``y += dot *
    (x_scale * g)`` in float32 in group order."""
    w8 = unpack_w4(wp).double()
    b = x.shape[0]
    ng = gscale.shape[0]
    gsz = w8.shape[0] // ng
    x8, xs = _quant_rows(x.reshape(b, ng, gsz), 1e-8)   # (B, G, g), (B, G, 1)
    dots = torch.einsum("bgk,gkn->gbn", x8.double(),
                        w8.reshape(ng, gsz, -1)).float()
    y = torch.zeros((b, w8.shape[1]), device=x.device)
    for gi in range(ng):
        y = y + dots[gi] * (xs[:, gi] * gscale[gi])
    return y


def _merge(m, l, acc, s, v_fn):
    """One online-softmax block against the running maximum ``m``."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    e = torch.exp(s - m_new)
    l_new = l * corr + e.double().sum(dim=-1, keepdim=True).float()
    return m_new, l_new, acc * corr + v_fn(e)


def _av_i8(e, vs, v8, equation: str):
    """P.V of one 128-row block: ``e * v_scale`` requantized to int8
    against the block's own maximum, int8 x int8 sums (at most 128 terms
    of 127^2: exact in float32)."""
    u8, u_scale = _quant_rows(e * vs, 1e-20)
    return torch.einsum(equation, u8, v8.float()) * u_scale


def fused_trunk_step_plain(x, weights: dict, cache: dict, pos: int,
                           slopes, flushed: int, a8: bool = False):
    """Plain PyTorch version of the kernel's math.  Per-head tensors are
    (H, B, ...).  Returns (x (B, D) float32, k_new, v_new (L, H, B, Dh)
    bfloat16)."""
    w4 = "gq" in weights
    b, d = x.shape
    nl = weights["wq"].shape[0]
    h = cache["k_tail"].shape[1]
    dh = d // h
    dev = x.device
    scale = 1.0 / math.sqrt(dh)
    slopes_f = slopes.float().reshape(h, 1, 1)
    stage_base = pos - (pos - flushed) % STAGE
    nblk = flushed // BLK
    ar_blk = torch.arange(BLK, device=dev)
    ar_st = torch.arange(STAGE, device=dev)
    neg_inf = torch.tensor(NEG_INF, device=dev)

    def alibi(t_idx):
        return slopes_f * (t_idx - pos).abs().float()

    def mm(xin, li, w, s, g):
        if w4:
            return _mm_w4(xin, weights[w][li], weights[g][li])
        return _mm(xin, weights[w][li], weights[s][li], a8)

    x = x.float()
    k_news, v_news = [], []
    for li in range(nl):
        qkv = (mm(_rms(x, weights["n1"][li]), li, "wq", "sq", "gq")
               + weights["bq"][li])
        q, k_cur, v_cur = (qkv[:, i * d:(i + 1) * d].reshape(b, h, dh)
                           .transpose(0, 1) for i in range(3))
        q8, q_scale = _quant_rows(q, 1e-8)
        qs = q_scale * scale
        k_news.append(k_cur.to(torch.bfloat16))
        v_news.append(v_cur.to(torch.bfloat16))

        m = torch.full((h, b, 1), NEG_INF, device=dev)
        l = torch.zeros((h, b, 1), device=dev)
        acc = torch.zeros((h, b, dh), device=dev)
        for i in range(nblk):
            s = torch.einsum("hbd,hbdt->hbt", q8,
                             cache["k_cold"][li, i].float())
            s = (s * qs) * cache["kc_scale"][li, i]
            s = s + alibi(i * BLK + ar_blk)
            vs, v8 = cache["vc_scale"][li, i], cache["v_cold"][li, i]
            m, l, acc = _merge(m, l, acc, s, lambda e: _av_i8(
                e, vs, v8, "hbt,hbdt->hbd"))

        t_idx = flushed + ar_blk
        s = torch.einsum("hbd,hbtd->hbt", q8, cache["k_tail"][li].float())
        s = (s * qs) * cache["kt_scale"][li]
        s = torch.where(t_idx < stage_base, s + alibi(t_idx), neg_inf)
        m, l, acc = _merge(m, l, acc, s, lambda e: _av_i8(
            e, cache["vt_scale"][li], cache["v_tail"][li],
            "hbt,hbtd->hbd"))

        kst = cache["k_stage"][li].float()                  # (S, H, B, Dh)
        vst = cache["v_stage"][li].float()
        s = ((q[None] * kst).double().sum(dim=-1).float() * scale
             ).permute(1, 2, 0)                             # (H, B, S)
        j_idx = stage_base + ar_st
        s = torch.where(j_idx < pos, s + alibi(j_idx), neg_inf)
        m, l, acc = _merge(m, l, acc, s, lambda e: (
            e.permute(2, 0, 1)[..., None] * vst).double().sum(dim=0).float())

        s_self = (q * k_cur).double().sum(dim=-1, keepdim=True).float() * scale
        m_f = torch.maximum(m, s_self)
        corr = torch.exp(m - m_f)
        e_self = torch.exp(s_self - m_f)
        attn = (acc * corr + e_self * v_cur) / (l * corr + e_self)

        y = torch.zeros((b, d), device=dev)
        if w4:
            wo = unpack_w4(weights["wo"][li]).double()
            go = weights["go"][li]
            gsz = d // go.shape[0]
            a8_, asx = _quant_rows(attn, 1e-8)
            for h0 in range(h):
                y = y + (a8_[h0].double() @ wo[h0 * dh:(h0 + 1) * dh]
                         ).float() * (asx[h0] * go[(h0 * dh) // gsz])
            x = x + y + weights["bo"][li]
        elif a8:
            wo = weights["wo"][li].double()
            a8_, asx = _quant_rows(attn, 1e-8)
            for h0 in range(h):
                y = y + (a8_[h0].double() @ wo[h0 * dh:(h0 + 1) * dh]
                         ).float() * asx[h0]
            x = x + y * weights["so"][li] + weights["bo"][li]
        else:
            wo = weights["wo"][li].double()
            ab = attn.to(torch.bfloat16).double()
            for h0 in range(h):
                y = y + (ab[h0] @ wo[h0 * dh:(h0 + 1) * dh]).float()
            x = x + y * weights["so"][li] + weights["bo"][li]

        g = gelu_rational(mm(_rms(x, weights["n3"][li]), li, "w1", "s1", "g1")
                          + weights["b1"][li])
        x = x + mm(g, li, "w2", "s2", "g2") + weights["b2"][li]
    return x, torch.stack(k_news), torch.stack(v_news)


# ------------------------------------------------------ cache upkeep
def stage_append(cache: dict, k_new, v_new, slot: int) -> dict:
    """Write the step's bf16 K/V rows (L, H, B, Dh) into stage slot
    ``slot``, in place."""
    cache["k_stage"][:, slot] = k_new
    cache["v_stage"][:, slot] = v_new
    return cache


def merge_stage(cache: dict, tail_slot: int) -> dict:
    """Quantize the 8 staged rows per row to int8 (rounding half to
    even, the scale divided by a tensor) and write them into the tail at
    ``tail_slot`` (a multiple of 8), in place.  Runs every 8 steps."""
    for name in ("k", "v"):
        q, sc = _quant_rows(cache[f"{name}_stage"].float(), 1e-8)
        # (L, S, H, B, Dh) -> (L, H, B, S, Dh)
        cache[f"{name}_tail"][:, :, :, tail_slot:tail_slot + STAGE] = (
            q.to(torch.int8).permute(0, 2, 3, 1, 4))
        cache[f"{name}t_scale"][..., tail_slot:tail_slot + STAGE] = (
            sc[..., 0].permute(0, 2, 3, 1))
    return cache


def flush_mega(cache: dict, flushed_prev: int) -> dict:
    """Move the full int8 tail (128 positions) into cold block
    ``flushed_prev // 128``, time-minor, in place."""
    nb = flushed_prev // BLK
    cache["k_cold"][:, nb] = cache["k_tail"].transpose(3, 4)
    cache["v_cold"][:, nb] = cache["v_tail"].transpose(3, 4)
    cache["kc_scale"][:, nb] = cache["kt_scale"]
    cache["vc_scale"][:, nb] = cache["vt_scale"]
    return cache


# ------------------------------------------------------------ kernel
def workspace_bytes(b: int, d: int, h: int) -> int:
    """Scratch of one call, laid out as ``csrc/mega_step.cu`` carves it:
    the split-K partial sums, qkv, the FFN activation, the float32 and
    the int8 dense inputs, and the int8 inputs' scales (one per row and
    head, or per row and group of at least 64 inputs)."""
    return (8 * b * d * max(d // 16, h)
            + 4 * (11 * b * d + b * max(h, d // 16)) + 4 * b * d)


def w4_group(weights: dict, d: int) -> int:
    """The scale group of a ``build_mega_decode_w4`` dict, derived as JAX
    derives it from ``gq``'s shape (L, D / group, 3D).  Raises unless the
    kernel takes it: one of ``W4_GROUPS`` (the kernel's instantiations),
    dividing D / 2."""
    ng = weights["gq"].shape[1]
    group = d // ng if ng else 0
    if group not in W4_GROUPS or ng * group != d or d % (2 * group):
        raise ValueError(f"w4 weights with {ng} scale groups over dim {d}: "
                         f"the kernel takes a group of {W4_GROUPS} that "
                         f"divides dim / 2")
    return group


_LAUNCH = None


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from .build import load

        fn = load("mega_step").fused_trunk_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 34 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def fused_trunk_step(x, weights: dict, cache: dict, pos: int, slopes,
                     flushed: int, a8: bool = False):
    """x (B, D) float32; ``weights`` and ``cache`` as in the module
    docstring; ``pos`` and ``flushed`` host ints (flushed a multiple of
    128, ``flushed <= pos < flushed + 128``); slopes (H,) negative ALiBi
    slopes.  Returns (x (B, D) float32, k_new, v_new (L, H, B, Dh)
    bfloat16).  With nibble-packed weights (``"gq" in weights``) the call
    runs the w4 branch and counts under ``launches_w4``, else under
    ``launches``: one call, one count, whatever the layer count."""
    if x.device.type == "cpu":
        return fused_trunk_step_plain(x, weights, cache, pos, slopes,
                                      flushed, a8=a8)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_trunk_step for {x.device}")
    b, d = x.shape
    dev = x.device
    nl = weights["wq"].shape[0]
    h = cache["k_tail"].shape[1]
    dh = d // h
    nb = cache["k_cold"].shape[1]
    if dh != HEAD_DIM or d % 256:
        raise ValueError(f"dim {d} / {h} heads: the kernel needs head_dim "
                         f"{HEAD_DIM} and dim a multiple of 256")
    if flushed % BLK or not 0 <= flushed <= nb * BLK:
        raise ValueError(f"flushed={flushed} must be a multiple of {BLK} "
                         f"within the {nb}-block cold cache")
    if not flushed <= pos < flushed + TAIL:
        raise ValueError(f"pos={pos} outside the tail [{flushed}, "
                         f"{flushed + TAIL})")
    f32, i8 = torch.float32, torch.int8
    _check("x", x, f32, (b, d), dev)
    w4 = "gq" in weights
    group = w4_group(weights, d) if w4 else 0
    for name, g, din, dout in (("wq", "gq", d, 3 * d), ("wo", "go", d, d),
                               ("w1", "g1", d, 4 * d), ("w2", "g2", 4 * d, d)):
        _check(name, weights[name], i8,
               (nl, din // 2 if w4 else din, dout), dev)
        if w4:
            _check(g, weights[g], f32, (nl, din // group, dout), dev)
    for name, n in (("sq", 3 * d), ("so", d), ("s1", 4 * d), ("s2", d),
                    ("n1", d), ("n3", d), ("bq", 3 * d), ("bo", d),
                    ("b1", 4 * d), ("b2", d)):
        _check(name, weights[name], f32, (nl, n), dev)
    for name in ("k_cold", "v_cold"):
        _check(name, cache[name], i8, (nl, nb, h, b, dh, BLK), dev)
    for name in ("kc_scale", "vc_scale"):
        _check(name, cache[name], f32, (nl, nb, h, b, BLK), dev)
    for name in ("k_tail", "v_tail"):
        _check(name, cache[name], i8, (nl, h, b, TAIL, dh), dev)
    for name in ("kt_scale", "vt_scale"):
        _check(name, cache[name], f32, (nl, h, b, TAIL), dev)
    for name in ("k_stage", "v_stage"):
        _check(name, cache[name], torch.bfloat16, (nl, STAGE, h, b, dh),
               dev)
    _check("slopes", slopes, f32, (h,), dev)
    x_out = torch.empty((b, d), dtype=f32, device=dev)
    k_new = torch.empty((nl, h, b, dh), dtype=torch.bfloat16, device=dev)
    v_new = torch.empty_like(k_new)
    work = torch.empty(workspace_bytes(b, d, h), dtype=torch.uint8,
                       device=dev)
    err = _launcher()(
        x.data_ptr(), x_out.data_ptr(),
        *(weights[k].data_ptr() for k in WEIGHT_KEYS),
        slopes.data_ptr(), *(cache[k].data_ptr() for k in CACHE_KEYS),
        k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(),
        *(weights[g].data_ptr() if w4 else None for g in W4_KEYS),
        nl, b, d, h, nb, pos, flushed, int(a8), group, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_trunk_step launch failed: CUDA error "
                           f"{err}")
    if w4:
        fused_trunk_step.launches_w4 += 1
    else:
        fused_trunk_step.launches += 1
    return x_out, k_new, v_new


fused_trunk_step.launches = 0
fused_trunk_step.launches_w4 = 0
