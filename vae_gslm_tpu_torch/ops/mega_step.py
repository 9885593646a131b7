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

On a CPU tensor the wrapper computes ``fused_trunk_step_plain`` (any
head width); on a CUDA tensor it launches the kernel's instantiation at
the head width D / H, one of ``HEAD_DIMS`` (32, 64 or 128), or raises.
Every branch is one cooperative launch a step (grid barriers between
the phases): the bf16 branch (``a8=False`` on int8 weights)
``k2_bf16_step_kernel``, products
on the FP64 tensor cores, weights streamed by TMA, shared memory laid out
by ``bf16_step_plan``; the a8 and w4 branches ``k2_i8_step_kernel``, 8
phases a layer (each input row quantized once by a rows phase, each
product in tiles of 64 columns x a K range), products on the int8 tensor
cores (``mma.m16n8k32.s8``, exact int32 sums), weights streamed by
cp.async, shared memory laid out by ``i8_step_plan`` and scratch by
``i8_workspace_bytes``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from .fused_decode import _check

BLK = 128
TAIL = 128
STAGE = 8
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the CUDA kernel's head widths (instantiations)
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
    """Plain PyTorch version of the kernel's math, at any head width.
    Per-head tensors are (H, B, ...).  The softmax scale 1/sqrt(Dh), a
    power of two only at Dh = 64, multiplies after each dot in the
    kernel's (and JAX's) order: ``(float(dot) * (q_scale * scale)) *
    k_scale`` and ``float(dot) * scale``.  Returns (x (B, D) float32,
    k_new, v_new (L, H, B, Dh) bfloat16)."""
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
def i8_workspace_bytes(b: int, d: int, h: int, group: int) -> int:
    """Scratch of one a8 (``group`` 0) or w4 call, laid out as
    ``fused_trunk_step_i8_launch`` carves it: the grid barrier's word (16
    bytes) and, for a8, the int32 sums of the one-dot products (B, 4D),
    which the launcher zeroes and each reader zeroes again as it reads;
    the fold terms of the grouped products (fold groups x B x N float32:
    the largest product's); the int8 rows (B,
    4D); two arrays of activation scales (B, nxs) float32.  Nothing is
    kept per layer."""
    nxs = _cdiv(max(h, 4 * d // group if group else 1), 4) * 4
    terms = max(n * (k // gsz) for n, k, gsz in
                (i8_geom(p, d, group, head_dim(d, h)) for p in range(4))
                if gsz)
    acc = 0 if group else 4 * d
    return 16 + 4 * b * acc + 4 * b * terms + 4 * b * d + 2 * 4 * b * nxs


def bf16_workspace_bytes(b: int, d: int) -> int:
    """Scratch of one bf16 call: qkv (B, 3D) float32, the attention and
    GELU rows (B, D) and (B, 4D) as 32-bit high words of their bf16
    values as doubles, and the grid barrier's word (the launcher zeroes
    it, so no state outlives a call)."""
    return 4 * b * (3 * d + d + 4 * d) + 16


# The persistent bf16 step (``k2_bf16_step_kernel``): its block, units
# and shared-memory layout, as ``csrc/mega_step.cu`` defines them.
STEP_THREADS = 512        # 16 warps; 4 attention groups of 128
ATTN_THREADS = 128        # an attention group: one thread per cache row
STEP_WARPS = STEP_THREADS // 32
STEP_GROUPS = STEP_THREADS // ATTN_THREADS
UNIT_COLS = 8             # output columns per unit (an M tile)
STRIP_COLS = 16           # columns per weight strip (a TMA box's 16 bytes)
UNITS_PER_PASS = 4
TILE_ROWS = 16            # batch rows per tile (the products' M)
TILES_PER_PASS = 2
SMEM_LIMIT = 232448       # a block's most on an H100


def head_dim(d: int, h: int) -> int:
    """The head width of dim ``d`` over ``h`` heads; raises unless the
    kernel is instantiated at it (``HEAD_DIMS``)."""
    dh = d // h
    if dh * h != d or dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"dim {d} / {h} heads: K2 takes head_dim 32, 64 or 128")
    return dh


def kv_buffers(dh: int) -> int:
    """The cache-block buffers of an attention group: K and V apart at
    widths up to 64; one buffer at 128 that holds a block's K, then its V
    (two would outgrow the bf16 step's block at d1024 / 8 x 128)."""
    return 1 if dh > 64 else 2


def group_smem(dh: int) -> int:
    """``sizeof(GroupSmem<dh>)`` of ``csrc/mega_step.cu``, an attention
    group's scratch: q, k and v rows (float32), the P.V parts' int32 sums
    (``ATTN_THREADS / dh - 1`` parts past the first, or 4 ints), the
    float64 and float32 reductions, the stage logits, the int8 q and
    probabilities, and ``kv_buffers(dh)`` int8 blocks of 128 x dh; a
    multiple of 16 bytes."""
    parts = ATTN_THREADS // dh
    avred = (parts - 1) * dh if parts > 1 else 4
    n = (4 * 3 * dh + 4 * avred + 8 * 4 + 4 * 4 + 4 * STAGE + dh
         + ATTN_THREADS + kv_buffers(dh) * BLK * dh)
    return _cdiv(n, 16) * 16


class StepPlan(NamedTuple):
    """The grid and dynamic shared memory of one bf16 step launch."""
    grid: int        # blocks: occupancy x the SM count
    slot: int        # bytes of each of the two weight slots
    part: int        # bytes of the products' partial sums
    region: int      # bytes of the region: part + the norm scale, or the
    #                  attention groups' scratch
    rows: int        # bytes of the rows' 1/rms
    bytes: int       # the whole dynamic shared memory


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def step_products(d: int) -> Tuple[Tuple[int, int], ...]:
    """(dout, din) of a layer's four products, in step order: QKV, the
    out-projection, FFN up, FFN down."""
    return ((3 * d, d), (d, d), (4 * d, d), (d, 4 * d))


def step_units(n: int, grid: int, block: int) -> range:
    """The units (8 output columns each, over all K) of an n-column
    product that block ``block`` of ``grid`` takes: block, block + grid,
    .. (``load_units`` and ``dense_phase``; each comes in the 16-column
    strip that holds it)."""
    return range(block, n // UNIT_COLS, grid)


def bf16_step_plan(b: int, d: int, h: int, n_sm: int,
                   occupancy: int = 1) -> StepPlan:
    """``step_plan`` of ``csrc/mega_step.cu`` at B = b rows, laid out for
    one block per SM (``n_sm`` blocks; the launch runs occupancy x n_sm
    blocks, which take no more units each): two slots of the most units
    that a block takes of one product x a 16-column strip x K int8 rows;
    a region for the partial sums of a pass of up to 4 units and 2 batch
    tiles of 16 rows (float64 per warp K-split, or float32 per head for
    the out-projection) and the RMSNorm scale (D float32), or for the
    four attention groups' scratch (each with a cache block's K and V);
    the rows' 1/rms; 1024 bytes of alignment slack and two mbarriers."""
    slot = max(_cdiv(n // UNIT_COLS, n_sm) * STRIP_COLS * k
               for n, k in step_products(d))
    slot = _cdiv(slot, 1024) * 1024
    btp = min(_cdiv(b, TILE_ROWS), TILES_PER_PASS)
    ks = STEP_WARPS // btp
    sums = ks * btp * TILE_ROWS * UNITS_PER_PASS * UNIT_COLS * 8
    heads = (h * btp * TILE_ROWS
             * min(_cdiv(d // UNIT_COLS, n_sm), UNITS_PER_PASS)
             * UNIT_COLS * 4)
    part = _cdiv(max(sums, heads), 16) * 16
    region = max(part + 4 * d, STEP_GROUPS * group_smem(head_dim(d, h)))
    rows = _cdiv(b, 4) * 16
    nbytes = 1024 + 2 * slot + region + rows + 16
    return StepPlan(occupancy * n_sm, slot, part, region, rows, nbytes)


def bf16_step_fits(b: int, d: int, h: int, n_sm: int) -> bool:
    """Whether the bf16 step's plan at B = b, dim d, h heads fits a block
    on a card of ``n_sm`` SMs.  Its two weight slots each hold the most
    units a block takes of one product over all K, so the plan outgrows
    the card at wider dims or fewer SMs (dim 1280 on 132 SMs, dim 1024 on
    114); the sampler then routes such batches elsewhere."""
    return bf16_step_plan(b, d, h, n_sm).bytes <= SMEM_LIMIT


# The persistent a8/w4 step (``k2_i8_step_kernel``): its tiles and
# shared-memory layout, as ``csrc/mega_step.cu`` defines them.
I8_TILE = 64              # output columns per tile (a strip: 64-byte rows)
I8_CHUNK = 32             # logical k per chunk (the mma's K)
I8_PAD = 32               # bytes past each activation row
I8_TILE_COST = 256        # a tile's overhead (staging, barriers), in rows
I8_NO_FIT = 1 << 30       # bytes of a plan that does not fit


class I8Plan(NamedTuple):
    """The grid and dynamic shared memory of one a8/w4 step launch."""
    grid: int        # blocks: the SM count, or the launcher's grid
    bp: int          # batch rows rounded up to 8
    splits: tuple    # per product: K ranges per 64-column strip
    tp: tuple        # per product: a block's tiles per weight piece
    nxs: int         # activation scales per row (the scales' stride)
    slot: int        # bytes of each of the two weight slots
    region: int      # bytes of the region: the attention groups' scratch,
    #                  a rows phase's row, or a tile's int8 rows and scratch
    bytes: int       # the whole dynamic shared memory (I8_NO_FIT: none)


def i8_geom(p: int, d: int, group: int, dh: int) -> Tuple[int, int, int]:
    """Product ``p`` (0 QKV, 1 out-projection, 2 FFN up, 3 FFN down) of the
    a8/w4 step at head width ``dh``: its output columns N, inputs K and
    fold group in logical inputs (a head of ``dh`` for the out-projection,
    w4's scale group, or 0: a8's one dot)."""
    n = 3 * d if p == 0 else 4 * d if p == 2 else d
    k = 4 * d if p == 3 else d
    return n, k, dh if p == 1 else group


def i8_tiles(p: int, d: int, group: int, dh: int, splits: int):
    """Product ``p``'s tiles in order: (first column, first stored row,
    stored rows).  Tile t is strip t mod NS (64 columns) of K range t // NS
    (K, or K / 2 packed rows for w4, in ``splits`` equal ranges); block j
    of a grid of G takes tiles j, j + G, .. (``i8_issue``)."""
    n, k, _ = i8_geom(p, d, group, dh)
    kst = k // 2 if group else k
    ns, tr = n // I8_TILE, kst // splits
    return [((t % ns) * I8_TILE, (t // ns) * tr, tr)
            for t in range(ns * splits)]


def i8_tile_bytes(p: int, d: int, group: int, dh: int, bp: int,
                  tr: int) -> int:
    """Product ``p``'s tile of ``tr`` stored rows in shared memory: its int8
    rows (w4: both nibble halves, ``I8_PAD`` bytes past each) and its
    scratch: a8's int32 sums (bp x 64) or the scales of its fold groups
    ((bp + 64) float32 a group)."""
    _, _, gsz = i8_geom(p, d, group, dh)
    ngt = (2 if group else 1) * tr // gsz if gsz else 0
    return (bp * ((2 if group else 1) * tr + I8_PAD)
            + (ngt * (bp + I8_TILE) * 4 if gsz else bp * I8_TILE * 4))


@functools.lru_cache(maxsize=None)
def i8_step_plan(b: int, d: int, h: int, n_sm: int, group: int = 0) -> I8Plan:
    """``i8_plan`` of ``csrc/mega_step.cu`` at B = b rows, dim d, h heads,
    ``group`` 0 (a8) or w4's scale group, laid out for one block per SM
    (the head width ``d / h`` one of ``HEAD_DIMS``).
    The region holds the attention groups' scratch or a rows phase's row
    (4D float32), its maxima, 1/rms and norm scale (D float32), and a tile's int8 rows and
    scratch (``i8_tile_bytes``) must fit it; each of the two weight slots is what the block has left, rounded
    down to 1 KiB.  Each product's split S is the one whose tiles fit
    those (its K ranges a multiple of 32 stored rows and of its fold
    group) and that costs the busiest block least, at its stored rows +
    ``I8_TILE_COST`` a tile; a piece is as many of a block's tiles as a
    slot holds."""
    dh = head_dim(d, h)
    bp = _cdiv(b, 8) * 8
    nxs = _cdiv(max(h, 4 * d // group if group else 1), 4) * 4
    region = _cdiv(max(STEP_GROUPS * group_smem(dh), 20 * d + 4 * nxs + 64),
                   16) * 16
    budget = (SMEM_LIMIT - 1024 - region - 16) // 2 // 1024 * 1024
    ok = True
    slot, splits, tps = 0, [], []
    for p in range(4):
        n, k, gsz = i8_geom(p, d, group, dh)
        kst = k // 2 if group else k
        ns, gst = n // I8_TILE, max(I8_CHUNK, gsz)
        best, bs = -1, 0
        for sp in range(1, kst // gst + 1):
            tr = kst // sp
            if (kst % sp or tr % gst or tr * I8_TILE > budget
                    or i8_tile_bytes(p, d, group, dh, bp, tr) > region):
                continue
            cost = _cdiv(ns * sp, n_sm) * (tr + I8_TILE_COST)
            if best < 0 or cost < best:
                best, bs = cost, sp
        if best < 0:
            ok = False
            splits.append(0), tps.append(0)
            continue
        tr = kst // bs
        tp = min(_cdiv(ns * bs, n_sm), budget // (tr * I8_TILE))
        splits.append(bs)
        tps.append(tp)
        slot = max(slot, tp * tr * I8_TILE)
    slot = _cdiv(slot, 1024) * 1024
    nbytes = 1024 + 2 * slot + region + 16 if ok else I8_NO_FIT
    return I8Plan(n_sm, bp, tuple(splits), tuple(tps), nxs,
                  slot, region, nbytes)


def i8_row_blocks(b: int, grid: int, block: int) -> range:
    """The batch rows that block ``block`` of ``grid`` takes in an a8/w4
    rows phase (``i8_rows``): block, block + grid, .. below B = b."""
    return range(block, b, grid)


def sm_count(dev: torch.device) -> int:
    """The SM count of ``dev``'s card."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


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


_LIB = None


def _lib():
    """``csrc/mega_step.cu``'s launch functions, built and bound at first
    use."""
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("mega_step")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_trunk_step_i8_launch.argtypes = (
            [p] * 35 + [i] * 8 + [ctypes.c_float, i, p])
        lib.fused_trunk_step_i8_grid.argtypes = (
            [i] * 5 + [ctypes.POINTER(i)] * 2)
        lib.fused_trunk_step_bf16_launch.argtypes = (
            [p] * 31 + [i] * 7 + [ctypes.c_float, i, p])
        lib.fused_trunk_step_bf16_grid.argtypes = [i, i, ctypes.POINTER(i)]
        lib.k2_barrier_probe_launch.argtypes = [p, i, i, p]
        for fn in (lib.fused_trunk_step_i8_launch,
                   lib.fused_trunk_step_i8_grid,
                   lib.fused_trunk_step_bf16_launch,
                   lib.fused_trunk_step_bf16_grid,
                   lib.k2_barrier_probe_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


def _error(what: str, err: int) -> RuntimeError:
    """A failed launch, with the TMA codes of ``csrc/mega_step.cu``."""
    if err == 900:
        why = "the driver has no cuTensorMapEncodeTiled"
    elif err >= 1000:
        why = (f"the driver refused a TMA tensor map of the weights "
               f"(CUresult {err - 1000})")
    else:
        why = f"CUDA error {err}"
    return RuntimeError(f"{what} launch failed: {why}")


@functools.lru_cache(maxsize=None)
def step_plan_for(b: int, d: int, h: int, dev: torch.device,
                  a8: bool = False, group: int = 0):
    """The plan of the step branch that a call at B = b, dim d, h heads
    (head width d / h) takes on ``dev``'s card (bf16, or with ``a8`` or a
    w4 ``group`` the a8/w4 step), and the
    grid the launcher will size (occupancy x SMs) for its shared memory.
    The a8/w4 plan is held against the library's ``i8_plan`` and raises
    unless it fits a block; kept per shape and card, so the wrapper takes
    it on every a8/w4 call."""
    grid = ctypes.c_int(0)
    if a8 or group:
        plan = i8_step_plan(b, d, h, sm_count(dev), group)
        if plan.bytes > SMEM_LIMIT:
            raise ValueError(f"the {'w4' if group else 'a8'} step at B={b}, "
                             f"dim {d} has no shared-memory plan within the "
                             f"{SMEM_LIMIT} bytes a block may use")
        nbytes = ctypes.c_int(0)
        err = _lib().fused_trunk_step_i8_grid(
            b, d, h, group, plan.bytes, ctypes.byref(grid),
            ctypes.byref(nbytes))
        if err == 0 and nbytes.value != plan.bytes:
            raise RuntimeError(f"the a8/w4 step's plan is {nbytes.value} "
                               f"bytes on the card, {plan.bytes} here")
    else:
        plan = bf16_step_plan(b, d, h, sm_count(dev))
        err = _lib().fused_trunk_step_bf16_grid(head_dim(d, h), plan.bytes,
                                                ctypes.byref(grid))
    if err != 0:
        raise _error("fused_trunk_step occupancy", err)
    return plan._replace(grid=grid.value)


def barrier_probe(n: int, b: int, d: int, h: int, dev: torch.device
                  ) -> None:
    """``n`` grid barriers alone on the bf16 step's grid (one
    cooperative launch), to time what a barrier costs."""
    plan = bf16_step_plan(b, d, h, sm_count(dev))
    bar = torch.empty(4, dtype=torch.int32, device=dev)
    err = _lib().k2_barrier_probe_launch(
        bar.data_ptr(), n, plan.bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _error("k2 barrier probe", err)


def fused_trunk_step(x, weights: dict, cache: dict, pos: int, slopes,
                     flushed: int, a8: bool = False, trace=None):
    """x (B, D) float32; ``weights`` and ``cache`` as in the module
    docstring (Dh = D / H one of ``HEAD_DIMS``: any other width raises
    NotImplementedError on a CUDA tensor); ``pos`` and ``flushed`` host
    ints (flushed a multiple of 128, ``flushed <= pos <= flushed + 128``:
    a full tail with an empty stage is taken, as JAX's kernel takes it);
    slopes (H,) negative ALiBi slopes.  Returns (x (B, D) float32, k_new, v_new (L, H, B, Dh)
    bfloat16).  ``trace`` (see ``step_phases``) is None or an int64 CUDA
    tensor for the kernel's phase-end times (1 + 5 L words for the bf16
    branch, 2 + 8 L for the a8 and w4 branches).  Each call is one
    cooperative launch: with nibble-packed weights (``"gq" in weights``)
    of the w4 branch, counted under ``launches_w4``; with int8 weights
    and ``a8`` of the s8 x s8 branch, counted under ``launches``; else of
    the bf16 branch, counted under ``launches_bf16``."""
    if x.device.type == "cpu":
        return fused_trunk_step_plain(x, weights, cache, pos, slopes,
                                      flushed, a8=a8)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_trunk_step for {x.device}")
    b, d = x.shape
    dev = x.device
    nl = weights["wq"].shape[0]
    h = cache["k_tail"].shape[1]
    dh = head_dim(d, h)
    nb = cache["k_cold"].shape[1]
    if d % 256:
        raise ValueError(f"dim {d}: the kernel needs a multiple of 256")
    if flushed % BLK or not 0 <= flushed <= nb * BLK:
        raise ValueError(f"flushed={flushed} must be a multiple of {BLK} "
                         f"within the {nb}-block cold cache")
    if not flushed <= pos <= flushed + TAIL:
        raise ValueError(f"pos={pos} outside the tail [{flushed}, "
                         f"{flushed + TAIL}]")
    f32, i8 = torch.float32, torch.int8
    _check("x", x, f32, (b, d), dev)
    w4 = "gq" in weights
    group = w4_group(weights, d) if w4 else 0
    if group % dh:
        raise ValueError(f"w4 group {group} is not a multiple of head_dim "
                         f"{dh}")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (x.data_ptr(), x_out.data_ptr(),
              *(weights[k].data_ptr() for k in WEIGHT_KEYS),
              slopes.data_ptr(), *(cache[k].data_ptr() for k in CACHE_KEYS),
              k_new.data_ptr(), v_new.data_ptr())
    trace_ptr = trace.data_ptr() if trace is not None else None
    if not (w4 or a8):
        plan = bf16_step_plan(b, d, h, sm_count(dev))
        if plan.bytes > SMEM_LIMIT:
            raise ValueError(f"the bf16 step at B={b}, dim {d} needs "
                             f"{plan.bytes} bytes of shared memory per "
                             f"block, more than the {SMEM_LIMIT} a block "
                             "may use")
        work = torch.empty(bf16_workspace_bytes(b, d), dtype=torch.uint8,
                           device=dev)
        err = _lib().fused_trunk_step_bf16_launch(
            *common, work.data_ptr(), trace_ptr, nl, b, d, h, nb, pos,
            flushed, 1.0 / math.sqrt(dh), plan.bytes, stream)
        if err != 0:
            raise _error("fused_trunk_step (bf16)", err)
        fused_trunk_step.launches_bf16 += 1
        return x_out, k_new, v_new
    plan = step_plan_for(b, d, h, dev, a8, group)
    work = torch.empty(i8_workspace_bytes(b, d, h, group),
                       dtype=torch.uint8, device=dev)
    err = _lib().fused_trunk_step_i8_launch(
        *common, work.data_ptr(),
        *(weights[g].data_ptr() if w4 else None for g in W4_KEYS),
        trace_ptr, nl, b, d, h, nb, pos, flushed, group,
        1.0 / math.sqrt(dh), plan.bytes, stream)
    if err != 0:
        raise _error(f"fused_trunk_step ({'w4' if w4 else 'a8'})", err)
    if w4:
        fused_trunk_step.launches_w4 += 1
    else:
        fused_trunk_step.launches += 1
    return x_out, k_new, v_new


fused_trunk_step.launches = 0
fused_trunk_step.launches_w4 = 0
fused_trunk_step.launches_bf16 = 0


STEP_PHASES = ("qkv", "attention", "out", "ffn_up", "ffn_down")
I8_STEP_PHASES = ("rows", "qkv", "attention", "out", "rows_up", "ffn_up",
                  "gelu_rows", "ffn_down")


def step_phases(x, weights: dict, cache: dict, pos: int, slopes,
                flushed: int, a8: bool = False) -> dict:
    """One step on the card (the branch that ``fused_trunk_step`` takes
    with these weights and ``a8``) with its phase trace: block 0 stamps
    the global timer at the start and at the end of each layer's five
    phases (after each grid barrier, when every block is done).  Returns
    each phase's mean microseconds over the layers (its grid barrier
    included) and the total: the bf16 branch's five phases a layer
    (``STEP_PHASES``), or the a8/w4 branch's eight (``I8_STEP_PHASES``)
    and its last rows phase (``tail``: the last FFN down finalized)."""
    nl = weights["wq"].shape[0]
    names = I8_STEP_PHASES if a8 or "gq" in weights else STEP_PHASES
    n_ph = len(names)
    extra = 1 if names is I8_STEP_PHASES else 0
    trace = torch.zeros(1 + n_ph * nl + extra, dtype=torch.int64,
                        device=x.device)
    fused_trunk_step(x, weights, cache, pos, slopes, flushed, a8=a8,
                     trace=trace)
    t = trace.cpu().double()
    steps = (t[1:1 + n_ph * nl] - t[:n_ph * nl]).reshape(nl, n_ph) / 1e3
    out = {name: float(steps[:, i].mean()) for i, name in enumerate(names)}
    if extra:
        out["tail"] = float((t[-1] - t[-2]) / 1e3)
    out["total"] = float((t[-1] - t[0]) / 1e3)
    return out
