"""Flash attention (port of ``vae_gslm_tpu/ops/flash_attention.py``).

Three forwards and three backwards, each a CUDA kernel on the card
(``csrc/flash_attention.cu``) with its plain PyTorch version beside it:

- K3 ``flash_forward_packed`` (JAX ``_flash_forward_full_packed`` :230)
  and K3b ``flash_backward_packed`` (``_flash_backward_packed`` :359):
  causal self-attention over the packed ``(B, T, H*D)`` projection
  layout (views into the fused qkv projection are fine: the last axis
  must be contiguous), forward with ``lse``;
- K4 ``flash_forward_full`` (``_flash_forward_full`` :406): the
  ``(B, H, T, D)`` forward for Tq = Tk <= 1024, ``lse`` optional, and
  K4b ``flash_backward_full`` (``_flash_backward`` :735): its backward,
  from K4's ``lse`` (JAX reaches ``_flash_backward`` without one only
  after a failed K4, a fallback the port does not take);
- K5 ``flash_forward_tiled`` (``_flash_forward`` :443): the q-tiled
  ``(B, H, T, D)`` forward for any Tq and Tk, no ``lse``, and K5b ``flash_backward_blockwise``
  (``_flash_backward_blockwise`` :682): the backward for any Tq and Tk
  up to 8192, each query row's softmax exact over the whole key axis.

lengths ``(B,)`` are valid key counts; slopes ``(H,)`` negative ALiBi
slopes or None.

Numerics (JAX's ``_attention_reference`` :43 and the TPU kernels):
``s = (q . k) / sqrt(D) + slope * |k - q|`` in float32 (query and key
positions both from 0), ``-1e30`` where the key is at or past
``lengths[b]`` or (causal) after the query; the softmax is normalized
before P.V and rounded to V's dtype; ``lse = m + log(sum exp(s - m))``
as ``(B, H, Tq)`` float32 (the port's own layout).  A row of length 0 is
uniform over all Tk keys.  The backwards form ``p = exp(s - lse)``
(K3b, K4b; a row of length 0 then has p = 1 on every key, as in JAX's
kernels) or ``p = exp(s - m) / l`` (K5b: 1/Tk there); with ``delta =
rowsum(dO * O)`` computed outside the kernels (``_delta``): ``ds = p (dO.v
- delta)`` rounded to q's dtype, ``dq = (ds . k) / sqrt(D)``, ``dv =
round(p)^T . dO``, ``dk = (ds^T . q) / sqrt(D)``, each summed in float32
and written in its input's dtype.  The plain versions compute in float32
(float64 for float64 inputs, for ``gradcheck``).

``flash_attention_packed`` is a ``torch.autograd.Function`` that
dispatches as JAX does.  Inside the packed envelope (JAX's
``_packed_eligible``: a 128-lane head grouping, self-attention, T <=
1024) it runs K3 and K3b.  Outside it the forward is K4 (Tq = Tk <=
1024) or K5, read straight from the packed projection through strides
(JAX relayouts to ``(B, H, T, D)``; the values are the same), and the
backward recomputes the dense reference from q, k, v and differentiates
it, as JAX's ``_bwd_packed`` takes ``jax.vjp`` of ``_attention_reference``
(:936-943): no ``(B, H, T, T)`` tensor is kept from the forward.
``flash_attention_bhtd`` is JAX's ``flash_attention`` custom VJP (:776),
the route of every self-attention layer under a data-parallel process
group (``parallel/tp.py``): ``backward_route`` picks K4 with ``lse`` and
K4b, K4/K5 and K5b, or K5 and the dense recompute.  On CPU tensors every
wrapper runs its plain version; on CUDA tensors it launches its kernel or
raises (head_dim 32, 64 or 128, ``HEAD_DIMS``: every body is a template
on the head width, instantiated at those three; float32/bfloat16 only).
Every plan below is a function of the head width ``d``.  K3 and K4 in
bfloat16 run a Hopper kernel (TMA tensor maps built from the operands'
strides, ``wgmma``) whose dynamic shared memory the wrapper plans
(``fwd_smem_plan``: K resident, or at D = 128 past 704 keys streamed
through K5's body, which then writes lse) and the launcher checks; so do
K3b, K4b and K5b in
bfloat16 (``bwd_smem_plan``: two launches, dq then dk/dv, K5b's row
statistics folded into the dq kernel).  K5 in bfloat16 runs a Hopper
kernel of its own (two passes over K streamed through a TMA ring, two
consumer warpgroups sharing each K/V tile) whose plan (``k5_fwd_plan``,
the same for every Tq and Tk) the launcher checks.  K3, K4 and K5 in
float32 run one body, a single pass over the key tiles with the softmax
online, whose plan (``f32_fwd_plan``: 128-query tiles, a two-stage K/V
ring) the launcher checks; K3b, K4b and K5b in float32 run one backward
body (``f32_bwd_plan``: the dq kernel, K5b's row statistics folded in,
then the dk/dv kernel, 128 resident rows and a two-stage ring of 64-row
tiles each).  The float32 kernels read their operands 16 bytes at a
time, so every operand's base and strides must be 16-byte aligned, as
the bf16 kernels' must.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
MAX_T = 1024          # K3/K4 envelope (JAX's _FWD_FULL_MAX_T)
MAX_TK = 8192         # K5b's key walk (JAX's _BWD_BLOCKWISE_MAX_TK); K5
#                       walks any Tk
HEAD_DIMS = (32, 64, 128)   # the kernels' instantiations (csrc templates)
TILE = 64             # the kernels' query and key rows per tile
V_STAGES = 2          # the bf16 K3/K4 forward's ring of V tiles
BWD_STAGES = 2        # the bf16 K3b/K4b/K5b backward's rings
K5B_BF16_KERNELS = 2  # kernels per bf16 K5b call: dq (statistics folded
#                       in), then dk/dv
K5B_F32_KERNELS = 2   # the same in float32
K5_Q_ROWS = 128       # the bf16 K5 forward's query rows per block
K5_STAGES = 4         # its K/V ring
F32_STAGES = 2        # the float32 bodies' K/V ring (and the backward's)
F32_P_PITCH = TILE + 4   # floats per shared row of their P/dS tiles
SMEM_LIMIT = 232448   # the most dynamic shared memory an H100 block takes


def f32_q_tile(d: int) -> int:
    """The float32 forward's query rows per block (and the float32
    backward's resident rows) at head width ``d``: 64 at 128 (so that the
    plans fit a block), else 128 (``F32<D>::FQ``)."""
    return 64 if d == 128 else 128


def f32_pitch(d: int) -> int:
    """Floats per shared row of the float32 bodies' Q, K and dO tiles
    (``F32<D>::FP``): the row and 16 bytes, so that sixteen rows read
    along D fall in different banks."""
    return d + 4


def tile_bytes(d: int) -> int:
    """Bytes of one 64-row bf16 tile of head width ``d``
    (``Tile<D>::BYTES``)."""
    return TILE * d * 2


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _heads(x: torch.Tensor, nheads: int, dt: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D) (a view unless ``dt`` converts)."""
    b, t, hd = x.shape
    x = x.reshape(b, t, nheads, hd // nheads).transpose(1, 2)
    return x if dt is None else x.to(dt)


def _packed(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _logits(qh, kh, lengths, slopes, causal: bool):
    """Masked logits (B, H, Tq, Tk) of (B, H, T, D) operands and the
    accumulation dtype."""
    dt = _acc_dtype(qh)
    tq, tk, d = qh.shape[2], kh.shape[2], qh.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", qh.to(dt), kh.to(dt)) * (
        1.0 / math.sqrt(d))
    q_pos = torch.arange(tq, device=qh.device)
    k_pos = torch.arange(tk, device=qh.device)
    if slopes is not None:
        dist = (k_pos[None, :] - q_pos[:, None]).abs().to(dt)
        s = s + slopes.to(dt)[:, None, None] * dist[None]
    mask = k_pos[None, None, None, :] < lengths.to(qh.device)[:, None, None,
                                                              None]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return torch.where(mask, s, torch.tensor(NEG_INF, dtype=dt,
                                             device=qh.device)), dt


def attention_reference(q, k, v, lengths, slopes, causal: bool
                        ) -> torch.Tensor:
    """JAX's ``_attention_reference`` (:43) on (B, H, T, D) operands:
    float32 logits and softmax, the probabilities rounded to V's dtype,
    the output in q's dtype.  Differentiable: the dense backward off the
    packed envelope takes autograd of it."""
    s, dt = _logits(q, k, lengths, slopes, causal)
    w = torch.softmax(s, dim=-1).to(v.dtype).to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.to(dt)).to(q.dtype)


def flash_forward_packed_plain(q, k, v, lengths, slopes, causal: bool,
                               nheads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: (o (B, T, H*D) in q's dtype,
    lse (B, H, T) in the accumulation dtype)."""
    s, dt = _logits(_heads(q, nheads), _heads(k, nheads), lengths, slopes,
                    causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    w = (e / denom).to(v.dtype).to(dt)
    out = torch.einsum("bhqk,bhkd->bhqd", w, _heads(v, nheads, dt))
    return _packed(out).to(q.dtype), (m + torch.log(denom))[..., 0]


def _delta(g: torch.Tensor, o: torch.Tensor,
           nheads: Optional[int] = None) -> torch.Tensor:
    """rowsum(dO * O) per head as a contiguous (B, H, T), float32
    (float64 inputs: float64), of packed (B, T, H*D) operands (``nheads``
    given) or (B, H, T, D) ones."""
    dt = _acc_dtype(o)
    prod = g.to(dt) * o.to(dt)
    if nheads is None:
        return prod.sum(-1).contiguous()
    b, t, hd = o.shape
    return prod.reshape(b, t, nheads, hd // nheads).sum(-1).transpose(
        1, 2).contiguous()


def _grads(p, qh, kh, vh, gh, delta, dt):
    """dq, dk, dv (B, H, T, D) in ``dt`` from the probabilities ``p``
    (B, H, Tq, Tk) and ``delta`` (B, H, Tq): the five products of the
    backward kernels, ds rounded to q's dtype and p to dO's."""
    scale = 1.0 / math.sqrt(qh.shape[-1])
    g32 = gh.to(dt)
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, vh.to(dt))
    ds = (p * (dp - delta.to(dt)[..., None])).to(qh.dtype).to(dt)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh.to(dt)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(gh.dtype).to(dt), g32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh.to(dt)) * scale
    return dq, dk, dv


def flash_backward_packed_plain(q, k, v, o, g, lse, lengths, slopes,
                                causal: bool, nheads: int):
    """K3b's function in plain PyTorch, from the saved ``o`` and ``lse``
    (not autograd of the forward: delta comes from the rounded O).
    Returns dq, dk, dv in packed layout and the inputs' dtypes."""
    qh, kh = _heads(q, nheads), _heads(k, nheads)
    s, dt = _logits(qh, kh, lengths, slopes, causal)
    p = torch.exp(s - lse.to(dt)[..., None])
    dq, dk, dv = _grads(p, qh, kh, _heads(v, nheads), _heads(g, nheads),
                        _delta(g, o, nheads), dt)
    return (_packed(dq).to(q.dtype), _packed(dk).to(k.dtype),
            _packed(dv).to(v.dtype))


def flash_forward_full_plain(q, k, v, lengths, slopes, causal: bool,
                             with_stats: bool = False):
    """K4's function in plain PyTorch: o (B, H, T, D) in q's dtype and,
    with ``with_stats``, lse (B, H, T) in the accumulation dtype."""
    o = attention_reference(q, k, v, lengths, slopes, causal)
    if not with_stats:
        return o
    s, _ = _logits(q, k, lengths, slopes, causal)
    return o, torch.logsumexp(s, dim=-1)


def flash_forward_tiled_plain(q, k, v, lengths, slopes, causal: bool
                              ) -> torch.Tensor:
    """K5's function in plain PyTorch: o (B, H, Tq, D) in q's dtype."""
    return attention_reference(q, k, v, lengths, slopes, causal)


def flash_backward_full_plain(q, k, v, o, g, lse, lengths, slopes,
                              causal: bool):
    """K4b's function in plain PyTorch on (B, H, T, D) operands: p =
    exp(s - lse) with K4's ``lse``.  dq, dk, dv in the inputs' dtypes."""
    s, dt = _logits(q, k, lengths, slopes, causal)
    p = torch.exp(s - lse.to(dt)[..., None])
    dq, dk, dv = _grads(p, q, k, v, g, _delta(g, o), dt)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_blockwise_plain(q, k, v, o, g, lengths, slopes,
                                   causal: bool):
    """K5b's function in plain PyTorch on (B, H, Tq, D) queries and
    (B, H, Tk, D) keys: each row's softmax exact over the key axis, p =
    exp(s - m) / sum exp(s - m).  dq in q's dtype, dk and dv summed in
    float32 and cast to k's and v's."""
    s, dt = _logits(q, k, lengths, slopes, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dq, dk, dv = _grads(p, q, k, v, g, _delta(g, o), dt)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- kernels
_LIB = None


def _launchers():
    """The five launch functions of ``csrc/flash_attention.cu``, built
    and bound at first use."""
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("flash_attention")
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        lib.flash_fwd_packed_launch.argtypes = [p] * 7 + [ll] * 8 + [i] * 6 \
            + [f] + [i] * 3 + [p]
        lib.flash_bwd_packed_launch.argtypes = [p] * 11 + [ll] * 14 \
            + [i] * 6 + [f] + [i] * 2 + [p]
        lib.flash_fwd_full_launch.argtypes = [p] * 7 + [ll] * 12 + [i] * 6 \
            + [f] + [i] * 3 + [p]
        lib.flash_fwd_tiled_launch.argtypes = [p] * 6 + [ll] * 12 \
            + [i] * 7 + [f] + [i] * 3 + [p]
        lib.flash_bwd_bhtd_launch.argtypes = [i] + [p] * 12 + [ll] * 21 \
            + [i] * 7 + [f] + [i] * 2 + [p]
        for fn in (lib.flash_fwd_packed_launch, lib.flash_bwd_packed_launch,
                   lib.flash_fwd_full_launch, lib.flash_fwd_tiled_launch,
                   lib.flash_bwd_bhtd_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


class FwdPlan(NamedTuple):
    """The dynamic shared memory of one bf16 K3/K4 forward launch."""
    tiles: int        # resident key tiles (the most any query tile
    #                   walks), or 0: K streamed (``k5_fwd_plan``'s body)
    stages: int       # V ring stages (streamed: K/V ring stages)
    bytes: int        # alignment slack, Q, K, V stages and mbarriers


def resident_plan_bytes(tiles: int, d: int) -> int:
    """The resident plan's bytes (``plan_bytes<D>``): Q, ``tiles`` key
    tiles kept for both softmax passes and ``V_STAGES`` V tiles of 64
    rows at head width ``d``, 1024 bytes of alignment slack, one 8-byte
    mbarrier for Q, each key tile and each stage's full and empty."""
    return (1024 + (1 + tiles + V_STAGES) * tile_bytes(d)
            + 8 * (1 + tiles + 2 * V_STAGES))


def resident_tiles(d: int) -> int:
    """The most key tiles K3/K4's bf16 forward keeps resident at head
    width ``d`` (``resident_tiles<D>``): 16 (T <= 1024) at 32 and 64, 11
    (T <= 704) at 128."""
    n = -(-MAX_T // TILE)
    while n > 0 and resident_plan_bytes(n, d) > SMEM_LIMIT:
        n -= 1
    return n


def fwd_smem_plan(t: int, d: int) -> FwdPlan:
    """The shared-memory plan of the bf16 K3/K4 forward over T = Tq = Tk
    at head width ``d`` (``fwd_wgmma`` in ``csrc/flash_attention.cu``):
    every key tile a query tile can walk resident (``resident_plan_bytes``;
    a row of length 0 walks all ceil(T / 64) key tiles, the kernels'
    ``key_tiles``, causal or not, so the plan holds them all), or, where
    they do not fit (``resident_tiles``: D = 128 past 704 keys), 0 tiles
    and ``k5_fwd_plan``'s stages and bytes: the launcher then runs K5's
    streaming body, which writes lse, under K3's or K4's name."""
    tiles = -(-t // TILE)
    if tiles > resident_tiles(d):
        plan = k5_fwd_plan(d)
        return FwdPlan(0, plan.stages, plan.bytes)
    return FwdPlan(tiles, V_STAGES, resident_plan_bytes(tiles, d))


class BwdPlan(NamedTuple):
    """The dynamic shared memory of the bf16 K3b/K4b/K5b backward
    launches."""
    stages: int       # ring stages of each kernel
    bytes: int        # alignment slack, tiles, query rows and mbarriers


def bwd_smem_plan(d: int) -> BwdPlan:
    """The shared-memory plan of the bf16 K3b/K4b/K5b backward at head
    width ``d`` (``bwd_wgmma`` in ``csrc/flash_attention.cu``, whose
    ``bwd_plan_bytes<D>`` is the same sum), one plan for both kernels:
    1024 bytes of alignment slack; two resident 64-row bf16 tiles (K and
    V in the dk/dv kernel, Q and dO in the dq kernel) and two per ring
    stage (Q and dO, or K and V); each stage's float32 query rows (lse or
    m, l, 1/l, delta: 4 x 64); one 8-byte mbarrier for the resident
    tiles and each stage's full and empty.  Nothing grows with T (every
    walk streams), so every Tq and Tk the wrappers admit take it."""
    nbytes = (1024 + (2 + 2 * BWD_STAGES) * tile_bytes(d)
              + BWD_STAGES * 4 * TILE * 4 + 8 * (1 + 2 * BWD_STAGES))
    return BwdPlan(BWD_STAGES, nbytes)


def bwd_plan_args(q: torch.Tensor, d: int) -> Tuple[int, int]:
    """(smem bytes, ring stages) of a backward launch at head width
    ``d``: ``bwd_smem_plan`` for bf16 and ``f32_bwd_plan`` for float32
    (K3b, K4b and K5b alike)."""
    plan = (bwd_smem_plan(d) if q.dtype == torch.bfloat16
            else f32_bwd_plan(d))
    return (plan.bytes, plan.stages)


class K5Plan(NamedTuple):
    """The launch plan of the bf16 K5 forward (``fwd_stream_wgmma`` in
    ``csrc/flash_attention.cu``, whose ``k5_plan_bytes`` is the same
    sum)."""
    q_rows: int       # query rows per block: 64 per consumer warpgroup
    stages: int       # ring stages, each a K and a V tile
    bytes: int        # alignment slack, Q, the stages and mbarriers


def k5_fwd_plan(d: int) -> K5Plan:
    """The bf16 K5 forward's plan at head width ``d``
    (``k5_plan_bytes<D>``): 1024 bytes of alignment slack, the block's
    128 query rows as two 64-row bf16 tiles, ``K5_STAGES`` ring stages of
    a K and a V tile (both passes stream K, the second V too, so nothing
    grows with Tq or Tk: one plan takes every call, at any Tk), one
    8-byte mbarrier for Q and each stage's full and empty."""
    nbytes = (1024 + (K5_Q_ROWS // TILE + 2 * K5_STAGES) * tile_bytes(d)
              + 8 * (1 + 2 * K5_STAGES))
    return K5Plan(K5_Q_ROWS, K5_STAGES, nbytes)


def k5_grid(b: int, h: int, tq: int) -> Tuple[int, int, int]:
    """The bf16 K5 forward's grid (x, y, z): heads, batch rows and
    128-row query blocks, block z holding query tile ``nz - 1 - z`` (the
    longest causal walks first)."""
    return (h, b, -(-tq // K5_Q_ROWS))


def k5_walks(qb: int, tq: int, length: int, tk: int,
             causal: bool) -> Tuple[int, int, int]:
    """(warpgroup 0's walk, warpgroup 1's walk, the ring's walk) of
    query block ``qb`` of the bf16 K5 forward: warpgroup w owns 64-row
    tile 2 qb + w and walks key tiles [0, n) (``key_tiles`` of the bf16
    bodies; none for rows wholly at or past ``tq``), and the producer
    streams the longer walk."""
    walks = []
    for w in range(2):
        t64 = 2 * qb + w
        if t64 * TILE >= tq:
            walks.append(0)
            continue
        end = -(-tk // TILE)
        if length >= 1:
            end = min(end, -(-length // TILE))
            if causal:
                end = min(end, t64 + 1)
        walks.append(end)
    return walks[0], walks[1], max(walks)


class F32BwdPlan(NamedTuple):
    """The launch plan of the float32 backward (K3b, K4b and K5b in
    float32: ``dq_f32`` and ``dkv_f32`` in ``csrc/flash_attention.cu``,
    whose ``BWD_F32_SMEM`` and ``F_STAGES`` the launcher holds it to)."""
    rows: int         # resident rows per block (queries, or keys)
    tile: int         # rows per streamed tile
    stages: int       # ring stages
    bytes: int        # the resident rows, the P/dS tile and the stages


def f32_bwd_plan(d: int) -> F32BwdPlan:
    """The float32 backward's plan at head width ``d``
    (``F32<D>::BWD_SMEM``), one for both kernels: two resident tiles of
    ``f32_q_tile(d)`` rows at ``f32_pitch(d)`` floats (Q and dO, or K and
    V), the warps' P or dS rows (that many rows of 64 at
    ``F32_P_PITCH``) and ``F32_STAGES`` stages of two streamed 64-row
    tiles (K and V, or Q and dO) with the dk/dv walk's three float32 rows
    of query statistics (lse or m, l, and delta).  Nothing grows with Tq
    or Tk."""
    rows, fp = f32_q_tile(d), f32_pitch(d)
    floats = (2 * rows * fp + rows * F32_P_PITCH
              + F32_STAGES * (2 * TILE * fp + 3 * TILE))
    return F32BwdPlan(rows, TILE, F32_STAGES, 4 * floats)


def f32_bwd_walk(kind: str, i: int, tq: int, length: int, tk: int,
                 causal: bool, d: int) -> range:
    """The tiles block ``i`` of the float32 backward walks at head width
    ``d``: ``kind`` "dq" (query tile ``i`` of ``f32_q_tile(d)`` rows,
    aligned to end at ``tq`` as the float32 forward's: its 64-key tiles,
    the forward's ``f32_key_tiles``) or "dkv" (key tile ``i`` of as many
    rows: the 64-query tiles from the first that can see it)."""
    if kind == "dq":
        return range(f32_key_tiles(i, tq, length, tk, causal, d))
    nq = -(-tq // TILE)
    k0 = i * f32_q_tile(d)
    begin = 0
    if length >= 1:
        if k0 >= length:
            begin = nq
        elif causal:
            begin = min(nq, k0 // TILE)
    return range(begin, nq)


class F32Plan(NamedTuple):
    """The launch plan of the float32 forward (K3, K4 and K5 in float32:
    ``fwd_f32`` in ``csrc/flash_attention.cu``, whose ``FWD_F32_SMEM``,
    ``FQ`` and ``F_STAGES`` the launcher holds it to)."""
    q_tile: int       # query rows per block
    k_tile: int       # keys per tile of the walk
    stages: int       # K/V ring stages
    bytes: int        # Q, the K and V stages and P


def f32_fwd_plan(d: int) -> F32Plan:
    """The float32 forward's plan at head width ``d``
    (``F32<D>::FWD_SMEM``): a query tile of ``f32_q_tile(d)`` rows of Q
    (padded rows of ``f32_pitch(d)`` floats) and its P tile (64 keys a
    row at ``F32_P_PITCH``), ``F32_STAGES`` 64-key K tiles (padded) and V
    tiles (``d`` floats a row), float32.  Nothing grows with Tq or Tk
    (every walk streams), so one plan takes every call."""
    rows, fp = f32_q_tile(d), f32_pitch(d)
    floats = (rows * fp + rows * F32_P_PITCH + F32_STAGES * TILE * fp
              + F32_STAGES * TILE * d)
    return F32Plan(rows, TILE, F32_STAGES, 4 * floats)


def f32_fwd_grid(b: int, h: int, tq: int, d: int
                 ) -> Tuple[int, int, int]:
    """The float32 forward's grid (x, y, z): heads, batch rows and query
    tiles, the tiles in the slowest axis."""
    return (h, b, -(-tq // f32_q_tile(d)))


def f32_block_tile(x: int, y: int, z: int, nz: int) -> Tuple[int, int, int]:
    """(query tile, head, batch row) of block (x, y, z) of a grid with
    ``nz`` query tiles: the kernel walks the query tiles from the last,
    whose causal walks are the longest, to the first."""
    return (nz - 1 - z, x, y)


def f32_tile_rows(qt: int, tq: int, d: int) -> range:
    """The query rows of tile ``qt`` (``f32_q_tile(d)`` rows): the tiles
    are aligned to end at ``tq``, so a ragged tile is the first (its rows
    before 0 are not computed into the output) and no row past ``tq`` is
    walked."""
    fq = f32_q_tile(d)
    q0 = qt * fq - (-(-tq // fq) * fq - tq)
    return range(max(q0, 0), q0 + fq)


def f32_key_tiles(qt: int, tq: int, length: int, tk: int,
                  causal: bool, d: int) -> int:
    """The key tiles [0, n) that query tile ``qt`` of the float32 forward
    walks (the kernel's ``key_tiles_f32``): every tile for a row of
    length 0, else up to the length and, causal, to the tile's last
    query row."""
    end = -(-tk // TILE)
    if length >= 1:
        end = min(end, -(-length // TILE))
        if causal:
            end = min(end, (f32_tile_rows(qt, tq, d)[-1]) // TILE + 1)
    return end


def _plan_args(q: torch.Tensor, t: int, d: int) -> Tuple[int, ...]:
    """(smem bytes, key tiles, V stages) for the launcher: the plan for
    bf16, zeros for float32 (whose kernels take none)."""
    if q.dtype != torch.bfloat16:
        return (0, 0, 0)
    plan = fwd_smem_plan(t, d)
    return (plan.bytes, plan.tiles, plan.stages)


def _fwd_args(q: torch.Tensor, t: int, d: int) -> Tuple[int, ...]:
    """The plan a K3/K4 forward launch takes at head width ``d``:
    ``_plan_args`` for bfloat16, and for float32 ``f32_fwd_plan`` as
    (smem bytes, query rows per tile, stages), which K5's float32 launch
    takes too."""
    if q.dtype == torch.bfloat16:
        return _plan_args(q, t, d)
    plan = f32_fwd_plan(d)
    return (plan.bytes, plan.q_tile, plan.stages)


def _launch_error(what: str, err: int) -> RuntimeError:
    """The error of a failed launch; the bf16 forwards and backwards add
    codes of their own for the TMA tensor maps (csrc TMA_NO_ENCODER,
    TMA_ENCODE)."""
    if err == 900:
        why = "the driver has no cuTensorMapEncodeTiled"
    elif err >= 1000:
        why = (f"the driver refused a TMA tensor map of the operands "
               f"(CUresult {err - 1000})")
    else:
        why = f"CUDA error {err}"
    return RuntimeError(f"{what} launch failed: {why}")


def packed_eligible(q: torch.Tensor, k: torch.Tensor, nheads: int) -> bool:
    """JAX's ``_packed_eligible``: a 128-lane head grouping (``hpb``),
    self-attention, T <= 1024.  Outside it JAX (and the port) take the
    (B, H, T, D) forwards K4/K5 and the dense backward."""
    b, t, hd = q.shape
    if hd % nheads:
        return False
    d = hd // nheads
    hpb = 1 if d % 128 == 0 else (128 // d if 128 % d == 0
                                  and hd % 128 == 0 else 0)
    return hpb > 0 and nheads % hpb == 0 and k.shape[1] == t and t <= MAX_T


def _check_kernel(what: str, q, lengths, slopes, nheads: int) -> int:
    """The kernels' head widths and dtypes, and the lengths/slopes they
    read; raises naming what is missing.  Returns the head width."""
    d = q.shape[-1] if q.dim() == 4 else q.shape[-1] // nheads
    if d not in HEAD_DIMS or q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{what} on CUDA takes head_dim 32, 64 or 128 and "
            f"float32/bfloat16; got head_dim {d} in {q.dtype} (q "
            f"{tuple(q.shape)}, {nheads} heads).  Other head widths are not "
            "ported (ROADMAP.md)")
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
    return d


def _strides(name: str, x: torch.Tensor, shape, dtype, device,
             aligned: Optional[bool] = None):
    """The element strides of an operand but its last (contiguous) axis;
    raises unless the kernels can read it: a bf16 operand (the TMA tensor
    maps of the wgmma kernels) and, with ``aligned``, any operand (the
    float32 forward's 16-byte cp.async rows) needs a 16-byte aligned base
    and strides that are multiples of 16 bytes, which a view into a fused
    projection at an odd offset or of an odd width breaks."""
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, expected {tuple(shape)} {dtype} on "
                         f"{device}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the feature axis must be contiguous "
                         f"(strides {x.stride()})")
    st = x.stride()[:-1]
    if aligned is None:
        aligned = dtype == torch.bfloat16
    per16 = 16 // x.element_size()
    if aligned and (x.data_ptr() % 16 or any(s % per16 for s in st)):
        raise ValueError(f"{name}: the kernels read rows 16 bytes at "
                         f"a time; data_ptr {x.data_ptr()} and strides "
                         f"{x.stride()} are not 16-byte aligned")
    return st


def _check_packed(q, k, v, lengths, slopes, nheads: int):
    if not packed_eligible(q, k, nheads):
        raise ValueError(
            f"K3/K3b take packed causal self-attention with a 128-lane head "
            f"grouping and T <= {MAX_T}; got q {tuple(q.shape)} with "
            f"{nheads} heads, k {tuple(k.shape)} (flash_attention_packed "
            "takes K4/K5 there)")
    return _check_kernel("K3/K3b (packed flash attention)", q, lengths,
                         slopes, nheads)


def flash_forward_packed(q, k, v, lengths, slopes, causal: bool,
                         nheads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o, lse).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_forward_packed_plain(q, k, v, lengths, slopes, causal,
                                          nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    out = _packed_forward(q, k, v, lengths, slopes, causal, nheads,
                          _stream(q.device))
    flash_forward_packed.launches += 1
    return out


flash_forward_packed.launches = 0


def _packed_forward(q, k, v, lengths, slopes, causal: bool, nheads: int,
                    stream: int):
    """K3's checks and its launch on ``stream``: the head width, the
    operands' strides (the tensor maps' 16-byte rule), then
    ``flash_fwd_packed_launch`` with ``_fwd_args``."""
    d = _check_packed(q, k, v, lengths, slopes, nheads)
    b, t, _ = q.shape
    dev = q.device
    seqs = [_strides(n, x, q.shape, q.dtype, dev, aligned=True)
            for n, x in (("q", q), ("k", k), ("v", v))]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, nheads, t), dtype=torch.float32, device=dev)
    err = _launchers().flash_fwd_packed_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), lengths.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        *seqs[0], *seqs[1], *seqs[2], *o.stride()[:2],
        b, t, nheads, d, int(q.dtype == torch.bfloat16), int(causal),
        1.0 / math.sqrt(d), *_fwd_args(q, t, d), stream)
    if err != 0:
        raise _launch_error("flash attention forward", err)
    return o, lse


def flash_backward_packed(q, k, v, o, g, lse, lengths, slopes,
                          causal: bool, nheads: int):
    """K3b: (dq, dk, dv).  CPU tensors take the plain version; CUDA
    tensors launch the kernels (two launches, one count: in bf16 the dq
    and dk/dv kernels of ``bwd_wgmma`` with ``bwd_smem_plan``) or raise.
    ``delta`` is a plain torch op, as JAX computes it outside its
    kernel."""
    if q.device.type == "cpu":
        return flash_backward_packed_plain(q, k, v, o, g, lse, lengths,
                                           slopes, causal, nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    grads = _packed_backward(q, k, v, o, g, lse, lengths, slopes, causal,
                             nheads, _stream(q.device))
    flash_backward_packed.launches += 1
    return grads


flash_backward_packed.launches = 0


def _stream(dev: torch.device) -> int:
    """The handle of the caller's current CUDA stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


def _packed_backward(q, k, v, o, g, lse, lengths, slopes, causal: bool,
                     nheads: int, stream: int):
    """K3b's checks and its launch on ``stream``: the operands' strides
    (the tensor maps' 16-byte rule), lse's layout, delta, then
    ``flash_bwd_packed_launch`` with ``bwd_plan_args``."""
    d = _check_packed(q, k, v, lengths, slopes, nheads)
    b, t, _ = q.shape
    dev = q.device
    seqs = [_strides(n, x, q.shape, q.dtype, dev, aligned=True)
            for n, x in (("q", q), ("k", k), ("v", v), ("dO", g))]
    _strides("o", o, q.shape, q.dtype, dev)
    if lse.shape != (b, nheads, t) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, H, T) float32 tensor")
    delta = _delta(g, o, nheads)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=dev)
             for _ in range(3)]
    err = _launchers().flash_bwd_packed_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        *(x.data_ptr() for x in grads),
        *seqs[0], *seqs[1], *seqs[2], *seqs[3],
        *(s for x in grads for s in x.stride()[:2]),
        b, t, nheads, d, int(q.dtype == torch.bfloat16), int(causal),
        1.0 / math.sqrt(d), *bwd_plan_args(q, d), stream)
    if err != 0:
        raise _launch_error("flash attention backward", err)
    return tuple(grads)


def _bhtd_launch(kind: str, q, k, v, lengths, slopes, causal: bool,
                 with_stats: bool = False):
    """Launch K4 (``kind`` "full") or K5 ("tiled") on (B, H, T, D)
    operands of any (batch, head, row) strides.  The output is allocated
    in the packed (B, Tq, H, D) memory order and returned as its
    (B, H, Tq, D) view, so the packed caller reshapes it for free."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev = q.device
    what = ("K4 (the (B, H, T, D) full forward)" if kind == "full" else
            "K5 (the q-tiled (B, H, T, D) forward)")
    _check_kernel(what, q, lengths, slopes, h)
    kshape = (b, h, tk, d)
    st = [_strides("q", q, q.shape, q.dtype, dev, aligned=True),
          _strides("k", k, kshape, q.dtype, dev, aligned=True),
          _strides("v", v, kshape, q.dtype, dev, aligned=True)]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    st.append(o.stride()[:3])
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=dev)
           if with_stats else None)
    lib = _launchers()
    common = (*st[0], *st[1], *st[2], *st[3])
    tail = (int(q.dtype == torch.bfloat16), int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(dev).cuda_stream)
    slope_ptr = slopes.data_ptr() if slopes is not None else None
    if kind == "full":
        err = lib.flash_fwd_full_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None, lengths.data_ptr(),
            slope_ptr, *common, b, tq, h, d, *tail[:3],
            *_fwd_args(q, tq, d), tail[3])
    else:
        if q.dtype == torch.float32:
            plan = _fwd_args(q, tq, d)
        else:
            p5 = k5_fwd_plan(d)
            plan = (p5.bytes, p5.q_rows, p5.stages)
        err = lib.flash_fwd_tiled_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lengths.data_ptr(), slope_ptr, *common, b, tq, tk, h, d,
            *tail[:3], *plan, tail[3])
    if err != 0:
        raise _launch_error(what, err)
    return (o, lse) if with_stats else o


def flash_forward_full(q, k, v, lengths, slopes, causal: bool,
                       with_stats: bool = False):
    """K4: o (B, H, T, D) and, with ``with_stats``, lse (B, H, T), for
    Tq = Tk <= 1024.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_forward_full_plain(q, k, v, lengths, slopes, causal,
                                        with_stats)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    if q.shape[2] != k.shape[2] or k.shape[2] > MAX_T:
        raise ValueError(f"K4 takes Tq = Tk <= {MAX_T}; got Tq {q.shape[2]},"
                         f" Tk {k.shape[2]} (flash_forward_tiled takes the "
                         "rest)")
    out = _bhtd_launch("full", q, k, v, lengths, slopes, causal, with_stats)
    flash_forward_full.launches += 1
    return out


flash_forward_full.launches = 0


def flash_forward_tiled(q, k, v, lengths, slopes, causal: bool
                        ) -> torch.Tensor:
    """K5: o (B, H, Tq, D) for any Tq and Tk, as JAX's forward takes
    (its 8192-key limit is the blockwise backward's alone).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_forward_tiled_plain(q, k, v, lengths, slopes, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    out = _bhtd_launch("tiled", q, k, v, lengths, slopes, causal)
    flash_forward_tiled.launches += 1
    return out


flash_forward_tiled.launches = 0


def _bhtd_backward(kind: str, q, k, v, o, g, lengths, slopes, causal: bool,
                   lse: Optional[torch.Tensor] = None):
    """Launch K4b (``kind`` "full", from ``lse``) or K5b ("blockwise":
    each row's statistics folded into the dq kernel) on (B, H, T, D)
    operands of any 16-byte aligned (batch, head, row) strides: the dq
    and dk/dv kernels.  The gradients
    are allocated in the packed (B, T, H, D) memory order and returned as
    their (B, H, T, D) views."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev = q.device
    what = ("K4b (the (B, H, T, D) full backward)" if kind == "full" else
            "K5b (the blockwise (B, H, T, D) backward)")
    _check_kernel(what, q, lengths, slopes, h)
    kshape = (b, h, tk, d)
    st = [_strides("q", q, q.shape, q.dtype, dev, aligned=True),
          _strides("k", k, kshape, q.dtype, dev, aligned=True),
          _strides("v", v, kshape, q.dtype, dev, aligned=True),
          _strides("dO", g, q.shape, q.dtype, dev, aligned=True)]
    _strides("o", o, q.shape, q.dtype, dev)
    delta = _delta(g, o)
    grads = [torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
             .transpose(1, 2) for t in (tq, tk, tk)]
    st += [x.stride()[:3] for x in grads]
    lib = _launchers()
    kid = 1 if kind == "full" else 2
    slope_ptr = slopes.data_ptr() if slopes is not None else None
    bf16 = q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rowl = None
    if kind == "full":
        if not isinstance(lse, torch.Tensor) or lse.shape != (b, h, tq) \
                or lse.dtype != torch.float32 or not lse.is_contiguous() \
                or lse.device != dev:
            raise ValueError("K4b needs K4's lse: a contiguous (B, H, T) "
                             "float32 tensor on q's device")
        rowa = lse
    else:   # each row's m and l, written by the dq kernel
        rowa = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
        rowl = torch.empty_like(rowa)
    err = lib.flash_bwd_bhtd_launch(
        kid, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        rowa.data_ptr(), rowl.data_ptr() if rowl is not None else None,
        delta.data_ptr(), lengths.data_ptr(), slope_ptr,
        *(x.data_ptr() for x in grads), *(s_ for x in st for s_ in x),
        b, tq, tk, h, d, int(bf16), int(causal), scale,
        *bwd_plan_args(q, d), stream)
    if err != 0:
        raise _launch_error(what, err)
    return tuple(grads)


def flash_backward_full(q, k, v, o, g, lse, lengths, slopes, causal: bool):
    """K4b: (dq, dk, dv) of (B, H, T, D) operands for Tq = Tk <= 1024,
    from K4's ``lse``.  CPU tensors take the plain version; CUDA tensors
    launch the kernels (one count) or raise."""
    if q.device.type == "cpu":
        return flash_backward_full_plain(q, k, v, o, g, lse, lengths, slopes,
                                         causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    if q.shape[2] != k.shape[2] or k.shape[2] > MAX_T:
        raise ValueError(f"K4b takes Tq = Tk <= {MAX_T}; got Tq "
                         f"{q.shape[2]}, Tk {k.shape[2]} "
                         "(flash_backward_blockwise takes the rest)")
    out = _bhtd_backward("full", q, k, v, o, g, lengths, slopes, causal,
                         lse)
    flash_backward_full.launches += 1
    return out


flash_backward_full.launches = 0


def flash_backward_blockwise(q, k, v, o, g, lengths, slopes, causal: bool):
    """K5b: (dq, dk, dv) of (B, H, Tq, D) queries against (B, H, Tk, D)
    keys, Tk <= 8192 on the card.  CPU tensors take the plain version;
    CUDA tensors launch the kernels (one count) or raise."""
    if q.device.type == "cpu":
        return flash_backward_blockwise_plain(q, k, v, o, g, lengths,
                                              slopes, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    if k.shape[2] > MAX_TK:
        raise NotImplementedError(
            f"K5b on CUDA walks at most {MAX_TK} keys (JAX's "
            f"_BWD_BLOCKWISE_MAX_TK); got Tk {k.shape[2]}")
    out = _bhtd_backward("blockwise", q, k, v, o, g, lengths, slopes,
                         causal)
    flash_backward_blockwise.launches += 1
    return out


flash_backward_blockwise.launches = 0


def flash_attention(q, k, v, lengths, slopes, causal: bool) -> torch.Tensor:
    """JAX's ``_dispatch`` (:787) on (B, H, T, D) operands: K4 for
    self-attention at T <= 1024, K5 otherwise."""
    if q.shape[2] == k.shape[2] and k.shape[2] <= MAX_T:
        return flash_forward_full(q, k, v, lengths, slopes, causal)
    return flash_forward_tiled(q, k, v, lengths, slopes, causal)


def _dense_grads(fn, ins, g):
    """Gradients of ``fn(*ins)`` under ``g``, recomputed from the inputs
    alone: JAX's ``jax.vjp`` of the dense reference off the kernels'
    envelope."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_() for x in ins]
        out = fn(*ins)
        return torch.autograd.grad(out, ins, g.to(out.dtype))


class FlashAttentionPacked(torch.autograd.Function):
    """Inside the packed envelope K3 forward (saving o and lse) and K3b
    backward; outside it K4/K5 forward and the dense recomputed
    backward (saving only the inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, slopes, causal, nheads):
        ctx.causal, ctx.nheads = causal, nheads
        ctx.dense = not packed_eligible(q, k, nheads)
        if ctx.dense:
            o = _packed(flash_attention(_heads(q, nheads), _heads(k, nheads),
                                        _heads(v, nheads), lengths, slopes,
                                        causal))
            ctx.save_for_backward(q, k, v, lengths, slopes)
            return o
        o, lse = flash_forward_packed(q, k, v, lengths, slopes, causal,
                                      nheads)
        ctx.save_for_backward(q, k, v, o, lse, lengths, slopes)
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.dense:
            q, k, v, lengths, slopes = ctx.saved_tensors
            h = ctx.nheads
            dq, dk, dv = _dense_grads(
                lambda *x: _packed(attention_reference(
                    *(_heads(y, h) for y in x), lengths, slopes,
                    ctx.causal)), (q, k, v), g)
            return dq, dk, dv, None, None, None, None
        q, k, v, o, lse, lengths, slopes = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv = flash_backward_packed(q, k, v, o, g.to(q.dtype), lse,
                                           lengths, slopes, ctx.causal,
                                           ctx.nheads)
        return dq, dk, dv, None, None, None, None


def backward_route(tq: int, tk: int) -> str:
    """JAX's ``_fwd``/``_bwd`` routing (:826-864) of the (B, H, T, D)
    custom VJP: "full" (K4 with lse, then K4b) for Tq = Tk <= 1024,
    "blockwise" (K4 or K5, then K5b) for Tk <= 8192, else "dense" (K5,
    then the dense reference differentiated)."""
    if tq == tk <= MAX_T:
        return "full"
    return "blockwise" if tk <= MAX_TK else "dense"


class FlashAttention(torch.autograd.Function):
    """JAX's ``flash_attention`` custom VJP on (B, H, T, D) operands: the
    forward saves o (and K4's lse on the "full" route); the backward
    takes K4b, K5b or the dense recompute by ``backward_route``."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, slopes, causal):
        ctx.causal = causal
        ctx.route = backward_route(q.shape[2], k.shape[2])
        if ctx.route == "full":
            o, lse = flash_forward_full(q, k, v, lengths, slopes, causal,
                                        with_stats=True)
        else:
            o, lse = flash_attention(q, k, v, lengths, slopes, causal), None
        ctx.save_for_backward(q, k, v, o, lse, lengths, slopes)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, lengths, slopes = ctx.saved_tensors
        g = g.to(q.dtype)
        if g.stride(-1) != 1:
            g = g.contiguous()
        if ctx.route == "full":
            grads = flash_backward_full(q, k, v, o, g, lse, lengths, slopes,
                                        ctx.causal)
        elif ctx.route == "blockwise":
            grads = flash_backward_blockwise(q, k, v, o, g, lengths, slopes,
                                             ctx.causal)
        else:
            grads = _dense_grads(
                lambda *x: attention_reference(*x, lengths, slopes,
                                               ctx.causal), (q, k, v), g)
        return (*grads, None, None, None)


def flash_attention_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         slopes: Optional[torch.Tensor],
                         causal: bool = True) -> torch.Tensor:
    """Fused attention over (B, H, T, D) operands (views of any batch,
    head and row strides with a contiguous feature axis) with the
    backward of JAX's custom VJP; returns o (B, H, Tq, D)."""
    return FlashAttention.apply(q, k, v, lengths.to(torch.int32), slopes,
                                causal)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           slopes: Optional[torch.Tensor], causal: bool,
                           nheads: int) -> torch.Tensor:
    """Fused attention over the packed (B, T, H*D) layout; returns the
    packed output that ``out_proj`` consumes."""
    return FlashAttentionPacked.apply(q, k, v, lengths.to(torch.int32),
                                      slopes, causal, nheads)
