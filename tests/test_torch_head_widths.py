"""The flash family (K3-K5b) and K6 at head widths 32 and 128, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_head_widths.py -q

Every CUDA body of ``csrc/flash_attention.cu`` and ``csrc/flash_decode.cu``
is a template on the head width D, instantiated at 32, 64 and 128.  Here,
without a card:

- the plain versions at D = 32 and 128 against the JAX package's Pallas
  kernels run in interpret mode (``pallas_call`` patched inside the
  test; the JAX package is not changed): K3/K3b (``_flash_forward_full_
  packed`` with its log-sum-exp, ``_flash_backward_packed`` from it), K4/
  K4b (``_flash_forward_full`` with lse, ``_flash_backward``), K5/K5b
  (``_flash_forward``, ``_flash_backward_blockwise``), and K6 against
  ``flash_decode_int8`` in TPU interpret mode.  Tolerances, float32: o
  to 1e-6 x max|ref|, lse to 1e-5 absolute, gradients to 1e-5 x
  max|ref| (2e-5 for K5b: a row sums more terms), K6 to 1e-6 x
  max|ref|: the same products in another order;
- every shared-memory plan at every instantiated D equals its CUDA sum
  (written out here from the kernels' layouts) and fits the 232,448
  bytes an H100 block may use; the D = 64 plans are the untemplated
  kernels' sums;
- the K3/K4 walk at D = 128 past the resident key tiles (the streaming
  body, 128-query blocks of two warpgroups) and the float32 walks at
  D = 128 (64-row blocks) cover every (query, key) pair of nonzero
  probability;
- with the launchers stubbed, D = 32 and 128 calls reach them with their
  head width and its plan, and D = 16 and 256 raise NotImplementedError
  naming 32, 64 and 128 before any launch.
- ``chip_smoke.py``'s bound on a bf16 backward's distance from the
  float64 gradient (``grad_bounds``) holds the plain version and a
  backward that sums in another order at every element, and the gate
  built on it (``hold_flips``) passes an element past the element-wise
  limit inside the bound and fails one outside it.

The card cases are ``tests/test_torch_head_widths_cuda.py``."""
import functools
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.nn.attention import _quantize_i8
from vae_gslm_tpu.ops import flash_attention as jfa
from vae_gslm_tpu.ops.flash_decode import flash_decode_int8 as jax_k6
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa
from vae_gslm_tpu_torch.ops import flash_decode as fd

WIDTHS = (32, 128)
TILE = fa.TILE


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels of the JAX package in interpret mode."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def tpu_interpret(monkeypatch):
    """The JAX package's Pallas kernels in TPU interpret mode (K6's DMA
    copies need it)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def T(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err)


def _bhtd(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    return q, k, v, g, -np.asarray(alibi_slopes(h), np.float32)


# ---------------------------------- plain versions against Pallas (JAX)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("alibi", [True, False])
def test_k3_k3b_plain_match_pallas_kernels(interpret, d, alibi):
    """K3 (o, lse) and K3b from that lse on the packed layout: at D = 32
    four heads share one 128-lane block (JAX's ``hpb`` 4), at D = 128
    each head is a block; lengths T, 1 and 0."""
    b, t, h = 3, 100, 128 // d if d < 128 else 2
    rng = np.random.RandomState(d)
    q, k, v, g = (rng.randn(b, t, h * d).astype(np.float32)
                  for _ in range(4))
    lens = np.asarray([t, 1, 0], np.int32)
    sl = -np.asarray(alibi_slopes(h), np.float32) if alibi else None
    jsl = jnp.asarray(sl) if alibi else None
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward_full_packed(jq, jk, jv, jnp.asarray(lens),
                                            jsl, True, h, with_stats=True)
    # JAX's (B, groups, T, heads a group) -> the port's (B, H, T)
    lse_p = np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, h, t)
    got_o, got_lse = fa.flash_forward_packed_plain(
        T(q), T(k), T(v), T(lens), T(sl) if alibi else None, True, h)
    _close(got_o, o, 1e-6, "o")
    np.testing.assert_allclose(got_lse.numpy(), lse_p, rtol=0, atol=1e-5)
    want = jfa._flash_backward_packed(jq, jk, jv, jg, o, jnp.asarray(lens),
                                      jsl, True, h, lse)
    got = fa.flash_backward_packed_plain(
        T(q), T(k), T(v), T(np.asarray(o)), T(g), T(lse_p), T(lens),
        T(sl) if alibi else None, True, h)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, 1e-5, name)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_k4_k4b_plain_match_pallas_kernels(interpret, d, causal):
    """K4 with lse and K4b from it on (B, H, T, D) operands, T 128,
    lengths (128, 50, 0): a row of length 0 has p = 1 on every key in
    both."""
    lens = np.asarray([128, 50, 0], np.int32)
    q, k, v, g, sl = _bhtd(3, 2, 128, 128, d, seed=d + 1)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward_full(jq, jk, jv, jnp.asarray(lens),
                                     jnp.asarray(sl), causal,
                                     with_stats=True)
    got_o, got_lse = fa.flash_forward_full_plain(
        T(q), T(k), T(v), T(lens), T(sl), causal, True)
    _close(got_o, o, 1e-6, "o")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=0, atol=1e-5)
    want = jfa._flash_backward(jq, jk, jv, jg, o, jnp.asarray(lens),
                               jnp.asarray(sl), causal, lse=lse)
    got = fa.flash_backward_full_plain(
        T(q), T(k), T(v), T(np.asarray(o)), T(g),
        T(np.asarray(lse)[..., 0]), T(lens), T(sl), causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, 1e-5, name)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", ["self", "cross"])
def test_k5_k5b_plain_match_pallas_kernels(interpret, d, case):
    """K5 and K5b: T 300 causal with lengths (300, 1, 0), and Tq 96 x Tk
    256 non-causal with lengths (256, 0, 131); ALiBi."""
    if case == "self":
        tq, tk, causal, lens = 300, 300, True, [300, 1, 0]
    else:
        tq, tk, causal, lens = 96, 256, False, [256, 0, 131]
    lens = np.asarray(lens, np.int32)
    q, k, v, g, sl = _bhtd(3, 2, tq, tk, d, seed=d + 2)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o = jfa._flash_forward(jq, jk, jv, jnp.asarray(lens), jnp.asarray(sl),
                           causal, block_q=128)
    _close(fa.flash_forward_tiled_plain(T(q), T(k), T(v), T(lens), T(sl),
                                        causal), o, 1e-6, "o")
    want = jfa._flash_backward_blockwise(jq, jk, jv, jg, o,
                                         jnp.asarray(lens), jnp.asarray(sl),
                                         causal)
    got = fa.flash_backward_blockwise_plain(
        T(q), T(k), T(v), T(np.asarray(o)), T(g), T(lens), T(sl), causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, 2e-5, name)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("pos", [0, 255, 256, 511])
def test_k6_plain_matches_pallas_kernel(tpu_interpret, d, pos):
    """K6's plain version on the head-major int8 cache (JAX's quantizer)
    against JAX's ``flash_decode_int8``, positions across the 256-key
    block edge; the scale is 1 / sqrt(D) in both."""
    b, h, t = 2, 2, 512
    rng = np.random.RandomState(d + pos)
    q = rng.randn(b, h, d).astype(np.float32)
    k8, ks = _quantize_i8(jnp.asarray(rng.randn(b, h, t, d), jnp.float32))
    v8, vs = _quantize_i8(jnp.asarray(rng.randn(b, h, t, d), jnp.float32))
    sl = -np.asarray(alibi_slopes(h), np.float32)
    want = jax_k6(jnp.asarray(q), k8, v8, ks, vs,
                  jnp.asarray(pos, jnp.int32), jnp.asarray(sl))
    got = fd.flash_decode_int8(*(T(x) for x in (q, k8, v8, ks, vs)), pos,
                               T(sl))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, d)
    _close(got, want, 1e-6, "K6")


# -------------------------------------------------------------- plans
def _resident_sum(tiles, d):
    """``plan_bytes<D>(tiles, 2)``: slack, Q, the key tiles and two V
    stages of 64 rows x D bf16, and the mbarriers."""
    return 1024 + (1 + tiles + 2) * 64 * d * 2 + 8 * (1 + tiles + 4)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plans_equal_the_cuda_sums_and_fit(d):
    """Each plan is its kernel's sum at width D: the bf16 K5 plan
    (``k5_plan_bytes<D>``: two Q tiles, four stages of K and V), the
    bf16 backward (``bwd_plan_bytes<D>``: four resident and ring tiles a
    stage pair, the query rows, the mbarriers), the float32 forward and
    backward (``F32<D>``: 64 rows a block at D = 128, 128 below; rows of
    D + 4 floats, P rows of 68) and the resident K3/K4 plan; each fits
    an H100 block, and the D = 64 ones are the sums the kernels took
    before they were templated."""
    tile = 64 * d * 2
    fq = 64 if d == 128 else 128
    want = {
        "k5": 1024 + (2 + 2 * 4) * tile + 8 * (1 + 2 * 4),
        "bwd": 1024 + (2 + 2 * 2) * tile + 2 * 4 * 64 * 4 + 8 * (1 + 2 * 2),
        "f32_fwd": 4 * (fq * (d + 4) + fq * 68 + 2 * 64 * (d + 4)
                        + 2 * 64 * d),
        "f32_bwd": 4 * (2 * fq * (d + 4) + fq * 68
                        + 2 * (2 * 64 * (d + 4) + 3 * 64)),
    }
    got = {"k5": fa.k5_fwd_plan(d).bytes, "bwd": fa.bwd_smem_plan(d).bytes,
           "f32_fwd": fa.f32_fwd_plan(d).bytes,
           "f32_bwd": fa.f32_bwd_plan(d).bytes}
    assert got == want
    assert all(v <= fa.SMEM_LIMIT for v in got.values())
    assert fa.f32_fwd_plan(d).q_tile == fa.f32_bwd_plan(d).rows == fq
    assert fa.resident_tiles(d) == {32: 16, 64: 16, 128: 11}[d]
    n = fa.resident_tiles(d)
    assert _resident_sum(n, d) <= fa.SMEM_LIMIT
    assert n == 16 or _resident_sum(n + 1, d) > fa.SMEM_LIMIT
    if d == 64:
        assert got == {"k5": 83016, "bwd": 52264, "f32_fwd": 137216,
                       "f32_bwd": 175616}


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fwd_smem_plan_at_every_t(d):
    """For every T up to 1024 the bf16 K3/K4 plan fits: every key tile
    resident where ``resident_tiles`` allows (the sum above), else 0
    tiles and the streaming body's plan (at D = 128 past 704 keys)."""
    for t in range(1, fa.MAX_T + 1):
        plan = fa.fwd_smem_plan(t, d)
        tiles = -(-t // TILE)
        assert plan.bytes <= fa.SMEM_LIMIT
        if tiles <= fa.resident_tiles(d):
            assert plan == (tiles, fa.V_STAGES, _resident_sum(tiles, d))
        else:
            k5 = fa.k5_fwd_plan(d)
            assert d == 128 and t > 704
            assert plan == (0, k5.stages, k5.bytes)


def _needed(r, c, length, causal):
    return length < 1 or (c < length and (not causal or c <= r))


@pytest.mark.parametrize("t", [705, 768, 1000, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_k3_k4_walk_covers_every_nonzero_pair(t, causal):
    """K3/K4 at D = 128 past the resident plan run the streaming body:
    query block qb holds rows [128 qb, 128 qb + 128), warpgroup w of it
    the rows of 64-row tile 2 qb + w over key tiles [0, walk); every
    (query, key) pair of nonzero probability lies on its warpgroup's
    walk, and the ring streams the longer of the two."""
    assert fa.fwd_smem_plan(t, 128).tiles == 0
    nb = fa.k5_grid(1, 1, t)[2]
    for length in (0, 1, 63, 64, 65, t // 2, t):
        for qb in range(nb):
            w0, w1, ring = fa.k5_walks(qb, t, length, t, causal)
            assert ring == max(w0, w1)
            for wg, walk in enumerate((w0, w1)):
                rows = range((2 * qb + wg) * TILE,
                             min((2 * qb + wg + 1) * TILE, t))
                for r in rows[::7]:
                    for c in range(0, t, 5):
                        if _needed(r, c, length, causal):
                            assert c // TILE < walk, (length, qb, r, c)


@pytest.mark.parametrize("tq,tk,causal", [(640, 640, True), (200, 200, False),
                                          (96, 256, False), (129, 129, True),
                                          (37, 300, False)])
def test_f32_walks_at_d128_cover_every_nonzero_pair(tq, tk, causal):
    """The float32 bodies at D = 128 take 64-row blocks (``f32_q_tile``):
    the forward's and the dq kernel's query tiles (aligned to end at Tq)
    over their key tiles, and the dk/dv kernel's 64-key tiles over the
    64-query tiles from the first that sees them, cover every pair of
    nonzero probability; the forward's tiles cover every query row
    once."""
    d = 128
    nqb = fa.f32_fwd_grid(1, 1, tq, d)[2]
    rows = [r for qt in range(nqb) for r in fa.f32_tile_rows(qt, tq, d)
            if r >= 0]
    assert sorted(rows) == list(range(tq))
    for length in (0, 1, 63, 64, 65, tk // 2, tk):
        dq = set()
        for i in range(nqb):
            rr = fa.f32_tile_rows(i, tq, d)
            for kt in fa.f32_bwd_walk("dq", i, tq, length, tk, causal, d):
                dq.add((max(rr[0], 0), rr[-1], kt * 64, kt * 64 + 63))
        dkv = set()
        for i in range(-(-tk // fa.f32_q_tile(d))):
            for qt in fa.f32_bwd_walk("dkv", i, tq, length, tk, causal, d):
                dkv.add((qt * 64, qt * 64 + 63, i * 64, i * 64 + 63))
        for r in range(0, tq, 7):
            for c in range(0, tk, 5):
                if _needed(r, c, length, causal):
                    for blocks in (dq, dkv):
                        assert any(r0 <= r <= r1 and c0 <= c <= c1
                                   for r0, r1, c0, c1 in blocks), (length, r,
                                                                   c)


# ------------------------------------------------- launches, stubbed
class _FakeLib:
    """Records the arguments of every launch function."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(fa, "_launchers", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _packed(d, h, t, dtype):
    qkv = torch.zeros((2, t, 3 * h * d), dtype=dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    g = torch.zeros((2, t, h * d), dtype=dtype)
    lengths = torch.tensor([t, 1], dtype=torch.int32)
    return q, k, v, g, lengths


def _bhtd_views(d, h, tq, tk, dtype):
    xq = torch.zeros((2, tq, 2 * h * d), dtype=dtype)
    xkv = torch.zeros((2, tk, 2 * h * d), dtype=dtype)
    q, g = (x.view(2, tq, h, d).transpose(1, 2) for x in xq.chunk(2, -1))
    k, v = (x.view(2, tk, h, d).transpose(1, 2) for x in xkv.chunk(2, -1))
    return q, k, v, g, torch.tensor([tk, 1], dtype=torch.int32)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_widths_reach_the_launchers(fake, d, dtype):
    """K3, K3b, K4, K4b, K5 and K5b at D = 32 and 128 hand the launcher
    their head width (after H) with the plan of that width and scale
    1 / sqrt(D); K3 at D = 128 and T 1000 in bf16 takes the streamed plan
    (0 tiles)."""
    h = 128 // d if d < 128 else 2
    bf16 = dtype == torch.bfloat16
    t = 1000
    q, k, v, g, lengths = _packed(d, h, t, dtype)
    o, lse = fa._packed_forward(q, k, v, lengths, None, True, h, 0)
    fa._packed_backward(q, k, v, o, g, lse, lengths, None, True, h, 0)
    qb, kb, vb, gb, lb = _bhtd_views(d, 3, 300, 300, dtype)
    ob, lseb = fa._bhtd_launch("full", qb, kb, vb, lb, None, True, True)
    fa._bhtd_backward("full", qb, kb, vb, ob, gb, lb, None, True, lseb)
    qc, kc, vc, gc, lc = _bhtd_views(d, 3, 96, 9000, dtype)
    oc = fa._bhtd_launch("tiled", qc, kc, vc, lc, None, False)
    fa._bhtd_backward("blockwise", qc, kc[:, :, :256], vc[:, :, :256], oc,
                      gc, torch.tensor([256, 1], dtype=torch.int32), None,
                      False)
    calls = dict((n, a) for n, a in fake.calls)
    assert len(fake.calls) == 6 and len(calls) == 5
    scale = 1.0 / math.sqrt(d)
    fwd_plan = fa._fwd_args(q, t, d)
    assert calls["flash_fwd_packed_launch"][15:23] == (
        2, t, h, d, int(bf16), 1, scale, fwd_plan[0])
    assert calls["flash_fwd_packed_launch"][22:25] == fwd_plan
    if bf16 and d == 128:
        assert fwd_plan == (fa.k5_fwd_plan(128).bytes, 0, fa.K5_STAGES)
    assert calls["flash_bwd_packed_launch"][25:32] == (
        2, t, h, d, int(bf16), 1, scale)
    assert calls["flash_bwd_packed_launch"][32:34] == fa.bwd_plan_args(q, d)
    assert calls["flash_fwd_full_launch"][19:23] == (2, 300, 3, d)
    assert calls["flash_fwd_tiled_launch"][18:23] == (2, 96, 9000, 3, d)
    p5 = fa.k5_fwd_plan(d) if bf16 else fa.f32_fwd_plan(d)
    assert calls["flash_fwd_tiled_launch"][26:29] == (p5.bytes, p5[0],
                                                      p5.stages)
    bwd = [a for n, a in fake.calls if n == "flash_bwd_bhtd_launch"]
    assert [a[0] for a in bwd] == [1, 2]
    assert [a[34:39] for a in bwd] == [(2, 300, 300, 3, d),
                                       (2, 96, 256, 3, d)]


@pytest.mark.parametrize("d", [16, 256])
def test_other_widths_raise_before_any_launch(fake, d):
    """No kernel is instantiated at D = 16 or 256: every launch raises
    NotImplementedError naming the widths, before the launcher."""
    h = 128 // d if d < 128 else 1
    q, k, v, g, lengths = _packed(d, h, 64, torch.bfloat16)
    qb, kb, vb, gb, lb = _bhtd_views(d, 2, 64, 64, torch.bfloat16)
    calls = [lambda: fa._packed_forward(q, k, v, lengths, None, True, h, 0),
             lambda: fa._packed_backward(q, k, v, q, g, None, lengths, None,
                                         True, h, 0),
             lambda: fa._bhtd_launch("full", qb, kb, vb, lb, None, True),
             lambda: fa._bhtd_launch("tiled", qb, kb, vb, lb, None, True),
             lambda: fa._bhtd_backward("blockwise", qb, kb, vb, qb, gb, lb,
                                       None, True)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="32, 64 or 128"):
            call()
    assert fake.calls == []


class _OnCard:
    """A CPU tensor that says it lies on the card: K6's wrapper reads its
    shape, dtype, strides and address before it launches."""
    device = types.SimpleNamespace(type="cuda")

    def __init__(self, x):
        self.x = x
        self.shape, self.dtype = x.shape, x.dtype

    def stride(self, *dim):
        return self.x.stride(*dim)

    def is_contiguous(self):
        return self.x.is_contiguous()

    def data_ptr(self):
        return self.x.data_ptr()


@pytest.mark.parametrize("d", [16, 32, 128, 256])
def test_k6_launches_at_its_widths(monkeypatch, d):
    """K6's CUDA branch hands D = 32 and 128 to its launcher with scale
    1 / sqrt(D), one count a call; D = 16 and 256 raise naming the
    widths."""
    calls = []
    monkeypatch.setattr(fd, "_launcher",
                        lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None:
                        empty(shape, dtype=dtype))
    b, h, t = 2, 2, 512
    q = _OnCard(torch.zeros((b, h, d), dtype=torch.bfloat16))
    k8 = _OnCard(torch.zeros((b, h, t, d), dtype=torch.int8))
    sc = _OnCard(torch.zeros((b, h, t)))
    sl = _OnCard(torch.zeros(h))
    before = fd.flash_decode_int8.launches
    if d not in fd.HEAD_DIMS:
        with pytest.raises(NotImplementedError, match="32, 64 or 128"):
            fd.flash_decode_int8(q, k8, k8, sc, sc, 300, sl)
        assert calls == []
        return
    out = fd.flash_decode_int8(q, k8, k8, sc, sc, 300, sl)
    assert out.shape == (b, h, d) and fd.flash_decode_int8.launches == \
        before + 1
    (args,) = calls
    assert args[9:14] == (b, h, t, d, 300)
    assert args[14] == pytest.approx(1.0 / math.sqrt(d))



def _other_order_backward(q, k, v, o, g, lse, lengths, slopes, causal):
    """The bf16 backward on (B, H, T, D) operands as the plain version
    computes it (p and ds rounded to bf16), with every float32
    intermediate taken from a float64 sum: another summation order's
    roundings, as a kernel's."""
    s, _ = fa._logits(q.double(), k.double(), lengths, slopes, causal)
    s = s.float()
    p = (torch.softmax(s, -1) if lse is None
         else torch.exp(s - lse[..., None]))
    dp = torch.einsum("bhqd,bhkd->bhqk", g.double(), v.double()).float()
    ds = (p * (dp - fa._delta(g, o)[..., None])).to(torch.bfloat16).double()
    scale = 1.0 / math.sqrt(q.shape[-1])
    grads = (scale * ds @ k.double(), scale * ds.transpose(-1, -2) @ q.double(),
             p.to(torch.bfloat16).double().transpose(-1, -2) @ g.double())
    return tuple(x.float().to(torch.bfloat16) for x in grads)


@pytest.mark.parametrize("kind", ["k3b", "k4b", "k5b"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_grad_bounds_hold_the_plain_version(kind, d):
    """``chip_smoke.py``'s ``grad_bounds``: its float64 gradients equal
    the plain version's in float64 (1e-12 x max|ref|, where that is
    finite: a keyless row with a given lse has p = 1 in float32 and NaN in
    float64), and the bf16 plain version and a backward that sums in
    another order (``_other_order_backward``) stay within its bound at
    every element and pass ``hold_flips``, K3b on the packed layout with
    K3's lse, K4b with K4's, K5b with its own row statistics; ALiBi,
    causal, lengths full, 1, 0 and 77, logits scaled by 3."""
    import chip_smoke as cs

    b, h, t = 4, 2, 130
    lengths = torch.tensor([t, 1, 0, 77])
    sl = -torch.tensor(alibi_slopes(h))
    gen = torch.Generator().manual_seed(d)
    q = (3 * torch.randn((b, h, t, d), generator=gen)).to(torch.bfloat16)
    k, v, g = (torch.randn((b, h, t, d), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    if kind == "k3b":
        pk = [fa._packed(x) for x in (q, k, v, g)]
        o, lse = fa.flash_forward_packed_plain(*pk[:3], lengths, sl, True, h)
        args = (pk[0], pk[1], pk[2], o, pk[3], lse, lengths, sl, True)
        want = fa.flash_backward_packed_plain(*args, h)
        ref = fa.flash_backward_packed_plain(
            *(x.double() for x in args[:5]), *args[5:], h)
        exact, bounds = cs.grad_bounds(*args, h)
        other = tuple(fa._packed(x) for x in _other_order_backward(
            q, k, v, fa._heads(o, h), g, lse, lengths, sl, True))
    else:
        if kind == "k4b":
            o, lse = fa.flash_forward_full_plain(q, k, v, lengths, sl, True,
                                                 True)
            plain, extra = fa.flash_backward_full_plain, (lse,)
        else:
            o, lse = fa.flash_forward_tiled_plain(q, k, v, lengths, sl,
                                                  True), None
            plain, extra = fa.flash_backward_blockwise_plain, ()
        want = plain(q, k, v, o, g, *extra, lengths, sl, True)
        ref = plain(*(x.double() for x in (q, k, v, o, g)), *extra, lengths,
                    sl, True)
        exact, bounds = cs.grad_bounds(q, k, v, o, g, lse, lengths, sl, True)
        other = _other_order_backward(q, k, v, o, g, lse, lengths, sl, True)
    for name, w, r, x, bd, a in zip(("dq", "dk", "dv"), want, ref, exact,
                                    bounds, other):
        fin = torch.isfinite(r)
        assert (x - r)[fin].abs().max() <= 1e-12 * max(
            1.0, r[fin].abs().max().item())
        assert torch.isfinite(bd).all()
        assert ((w.double() - x).abs() <= bd).all()
        assert ((a.double() - x).abs() <= bd).all()
        cs.hold_flips(kind, name, a, w, x, bd, 2e-2)


@pytest.mark.parametrize("case", ["flip", "fault"])
def test_hold_flips_passes_a_flip_and_fails_a_fault(case):
    """20,000 float64 gradient elements, the plain version their bf16
    rounding, a rounding bound of 2^-8 |x| + 1e-3 each; at one element
    the kernel sits 0.03 past the element-wise limit (2 ulps + 0.02 x
    rms): within the bound there ("flip") or 0.06 past it ("fault").
    Only the fault fails."""
    import chip_smoke as cs

    exact = torch.from_numpy(np.random.RandomState(0).randn(20000))
    want = exact.to(torch.bfloat16).double()
    bound = 2.0 ** -8 * exact.abs() + 1e-3
    got = want.clone()
    limit = (2 * cs.ulp_bf16(want) + 2e-2 * want.pow(2).mean().sqrt())[7]
    if case == "flip":
        bound[7] = limit + 0.05
    got[7] = exact[7] + limit + 0.03
    if case == "fault":
        with pytest.raises(AssertionError):
            cs.hold_flips("a CPU case", "dq", got, want, exact, bound, 2e-2)
    else:
        cs.hold_flips("a CPU case", "dq", got, want, exact, bound, 2e-2)
