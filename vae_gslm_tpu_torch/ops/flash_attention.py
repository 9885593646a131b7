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
  ``(B, H, T, D)`` forward for any Tq and Tk (up to 8192 keys on the
  card), no ``lse``, and K5b ``flash_backward_blockwise``
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
raises (head_dim 64, float32/bfloat16 only).  K3 and K4 in bfloat16 run
a Hopper kernel (TMA tensor maps built from the operands' strides,
``wgmma``) whose dynamic shared memory the wrapper plans
(``fwd_smem_plan``) and the launcher checks; so do K4b and K5b in
bfloat16 (``bwd_smem_plan``: two launches, dq then dk/dv, K5b's row
statistics folded into the dq kernel).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
MAX_T = 1024          # K3/K4 envelope (JAX's _FWD_FULL_MAX_T)
MAX_TK = 8192         # K5's key walk (JAX's _BWD_BLOCKWISE_MAX_TK)
HEAD_DIM = 64
TILE = 64             # the kernels' query and key rows per tile
V_STAGES = 2          # the bf16 K3/K4 forward's ring of V tiles
BWD_STAGES = 2        # the bf16 K4b/K5b backward's rings
K5B_BF16_KERNELS = 2  # kernels per bf16 K5b call: dq (statistics folded
#                       in), then dk/dv


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
    """The six launch functions of ``csrc/flash_attention.cu``, built
    and bound at first use."""
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("flash_attention")
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        lib.flash_fwd_packed_launch.argtypes = [p] * 7 + [ll] * 8 + [i] * 5 \
            + [f] + [i] * 3 + [p]
        lib.flash_bwd_packed_launch.argtypes = [p] * 11 + [ll] * 14 \
            + [i] * 5 + [f, p]
        lib.flash_fwd_full_launch.argtypes = [p] * 7 + [ll] * 12 + [i] * 5 \
            + [f] + [i] * 3 + [p]
        lib.flash_fwd_tiled_launch.argtypes = [p] * 6 + [ll] * 12 \
            + [i] * 6 + [f, p]
        lib.flash_stats_launch.argtypes = [p] * 6 + [ll] * 6 + [i] * 5 \
            + [f, p]
        lib.flash_bwd_bhtd_launch.argtypes = [i] + [p] * 12 + [ll] * 21 \
            + [i] * 6 + [f] + [i] * 2 + [p]
        for fn in (lib.flash_fwd_packed_launch, lib.flash_bwd_packed_launch,
                   lib.flash_fwd_full_launch, lib.flash_fwd_tiled_launch,
                   lib.flash_stats_launch, lib.flash_bwd_bhtd_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


class FwdPlan(NamedTuple):
    """The dynamic shared memory of one bf16 K3/K4 forward launch."""
    tiles: int        # resident key tiles: the most any query tile walks
    stages: int       # V ring stages
    bytes: int        # alignment slack, Q, K, V stages and mbarriers


def fwd_smem_plan(t: int) -> FwdPlan:
    """The shared-memory plan of the bf16 K3/K4 forward over T = Tq = Tk
    (``fwd_wgmma`` in ``csrc/flash_attention.cu``, whose ``plan_bytes``
    is the same sum): Q, every key tile a query tile can walk (kept for
    both softmax passes) and ``V_STAGES`` V tiles of 64 x 64 bf16, 1024
    bytes of alignment slack, one 8-byte mbarrier for Q, each key tile
    and each stage's full and empty.  A row of length 0 walks all
    ceil(T / 64) key tiles (the kernels' ``key_tiles``), causal or not,
    so the plan holds them all."""
    tiles = -(-t // TILE)
    tile_bytes = TILE * HEAD_DIM * 2
    nbytes = (1024 + (1 + tiles + V_STAGES) * tile_bytes
              + 8 * (1 + tiles + 2 * V_STAGES))
    return FwdPlan(tiles, V_STAGES, nbytes)


class BwdPlan(NamedTuple):
    """The dynamic shared memory of the bf16 K4b/K5b backward launches."""
    stages: int       # ring stages of each kernel
    bytes: int        # alignment slack, tiles, query rows and mbarriers


def bwd_smem_plan() -> BwdPlan:
    """The shared-memory plan of the bf16 K4b/K5b backward
    (``bwd_wgmma`` in ``csrc/flash_attention.cu``, whose
    ``bwd_plan_bytes`` is the same sum), one plan for both kernels: 1024
    bytes of alignment slack; two resident 64 x 64 bf16 tiles (K and V
    in the dk/dv kernel, Q and dO in the dq kernel) and two per ring
    stage (Q and dO, or K and V); each stage's float32 query rows (lse or
    m, l, 1/l, delta: 4 x 64); one 8-byte mbarrier for the resident
    tiles and each stage's full and empty.  Nothing grows with T (every
    walk streams), so every Tq and Tk the wrappers admit take it."""
    tile_bytes = TILE * HEAD_DIM * 2
    nbytes = (1024 + (2 + 2 * BWD_STAGES) * tile_bytes
              + BWD_STAGES * 4 * TILE * 4 + 8 * (1 + 2 * BWD_STAGES))
    return BwdPlan(BWD_STAGES, nbytes)


def _plan_args(q: torch.Tensor, t: int) -> Tuple[int, ...]:
    """(smem bytes, key tiles, V stages) for the launcher: the plan for
    bf16, zeros for float32 (whose kernels take none)."""
    if q.dtype != torch.bfloat16:
        return (0, 0, 0)
    plan = fwd_smem_plan(t)
    return (plan.bytes, plan.tiles, plan.stages)


def _launch_error(what: str, err: int) -> RuntimeError:
    """The error of a failed launch; the bf16 K3/K4 forward and K4b/K5b
    backward add codes of their own for the TMA tensor maps (csrc
    TMA_NO_ENCODER, TMA_ENCODE)."""
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


def _check_kernel(what: str, q, lengths, slopes, nheads: int) -> None:
    """The kernels' head_dim and dtypes, and the lengths/slopes they
    read; raises naming what is missing."""
    d = q.shape[-1] if q.dim() == 4 else q.shape[-1] // nheads
    if d != HEAD_DIM or q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{what} on CUDA takes head_dim {HEAD_DIM} and float32/bfloat16; "
            f"got head_dim {d} in {q.dtype} (q {tuple(q.shape)}, {nheads} "
            "heads).  Other head widths are not ported (ROADMAP.md)")
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


def _strides(name: str, x: torch.Tensor, shape, dtype, device):
    """The element strides of an operand but its last (contiguous) axis;
    raises unless the kernels can read it."""
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, expected {tuple(shape)} {dtype} on "
                         f"{device}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the feature axis must be contiguous "
                         f"(strides {x.stride()})")
    st = x.stride()[:-1]
    if dtype == torch.bfloat16 and (x.data_ptr() % 16
                                    or any(s % 8 for s in st)):
        raise ValueError(f"{name}: the bf16 kernels read rows 16 bytes at "
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
    _check_kernel("K3/K3b (packed flash attention)", q, lengths, slopes,
                  nheads)


def flash_forward_packed(q, k, v, lengths, slopes, causal: bool,
                         nheads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o, lse).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_forward_packed_plain(q, k, v, lengths, slopes, causal,
                                          nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    _check_packed(q, k, v, lengths, slopes, nheads)
    b, t, hd = q.shape
    dev = q.device
    seqs = [_strides(n, x, q.shape, q.dtype, dev)
            for n, x in (("q", q), ("k", k), ("v", v))]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, nheads, t), dtype=torch.float32, device=dev)
    err = _launchers().flash_fwd_packed_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), lengths.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        *seqs[0], *seqs[1], *seqs[2], *o.stride()[:2],
        b, t, nheads, int(q.dtype == torch.bfloat16), int(causal),
        1.0 / math.sqrt(hd // nheads), *_plan_args(q, t),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _launch_error("flash attention forward", err)
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
    _check_packed(q, k, v, lengths, slopes, nheads)
    b, t, hd = q.shape
    dev = q.device
    seqs = [_strides(n, x, q.shape, q.dtype, dev)
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
        b, t, nheads, int(q.dtype == torch.bfloat16), int(causal),
        1.0 / math.sqrt(hd // nheads),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    flash_backward_packed.launches += 1
    return tuple(grads)


flash_backward_packed.launches = 0


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
    st = [_strides("q", q, q.shape, q.dtype, dev),
          _strides("k", k, kshape, q.dtype, dev),
          _strides("v", v, kshape, q.dtype, dev)]
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
            slope_ptr, *common, b, tq, h, *tail[:3],
            *_plan_args(q, tq), tail[3])
    else:
        err = lib.flash_fwd_tiled_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lengths.data_ptr(), slope_ptr, *common, b, tq, tk, h, *tail)
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
    """K5: o (B, H, Tq, D) for any Tq and Tk (Tk <= 8192 on the card).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if q.device.type == "cpu":
        return flash_forward_tiled_plain(q, k, v, lengths, slopes, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for {q.device}")
    if k.shape[2] > MAX_TK:
        raise NotImplementedError(
            f"K5 on CUDA walks at most {MAX_TK} keys (JAX's "
            f"_BWD_BLOCKWISE_MAX_TK); got Tk {k.shape[2]}")
    out = _bhtd_launch("tiled", q, k, v, lengths, slopes, causal)
    flash_forward_tiled.launches += 1
    return out


flash_forward_tiled.launches = 0


def _bhtd_backward(kind: str, q, k, v, o, g, lengths, slopes, causal: bool,
                   lse: Optional[torch.Tensor] = None):
    """Launch K4b (``kind`` "full", from ``lse``) or K5b ("blockwise":
    each row's statistics folded into the dq kernel in bf16, a
    statistics launch first in float32) on (B, H, T, D) operands of any
    (batch, head, row) strides: the dq and dk/dv kernels.  The gradients
    are allocated in the packed (B, T, H, D) memory order and returned as
    their (B, H, T, D) views."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev = q.device
    what = ("K4b (the (B, H, T, D) full backward)" if kind == "full" else
            "K5b (the blockwise (B, H, T, D) backward)")
    _check_kernel(what, q, lengths, slopes, h)
    kshape = (b, h, tk, d)
    st = [_strides("q", q, q.shape, q.dtype, dev),
          _strides("k", k, kshape, q.dtype, dev),
          _strides("v", v, kshape, q.dtype, dev),
          _strides("dO", g, q.shape, q.dtype, dev)]
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
    plan = bwd_smem_plan() if bf16 else BwdPlan(0, 0)
    rowl = None
    if kind == "full":
        if not isinstance(lse, torch.Tensor) or lse.shape != (b, h, tq) \
                or lse.dtype != torch.float32 or not lse.is_contiguous() \
                or lse.device != dev:
            raise ValueError("K4b needs K4's lse: a contiguous (B, H, T) "
                             "float32 tensor on q's device")
        rowa = lse
    else:   # each row's m and l (bf16: from the dq kernel)
        rowa = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
        rowl = torch.empty_like(rowa)
        if not bf16:
            err = lib.flash_stats_launch(
                q.data_ptr(), k.data_ptr(), lengths.data_ptr(), slope_ptr,
                rowa.data_ptr(), rowl.data_ptr(), *st[0], *st[1], b, tq, tk,
                h, int(causal), scale, stream)
            if err != 0:
                raise RuntimeError(f"{what} statistics launch failed: CUDA "
                                   f"error {err}")
    err = lib.flash_bwd_bhtd_launch(
        kid, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        rowa.data_ptr(), rowl.data_ptr() if rowl is not None else None,
        delta.data_ptr(), lengths.data_ptr(), slope_ptr,
        *(x.data_ptr() for x in grads), *(s_ for x in st for s_ in x),
        b, tq, tk, h, int(bf16), int(causal), scale, plan.bytes, plan.stages,
        stream)
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
