"""The port's (B, H, T, D) flash attention backwards K4b and K5b and its
``FlashAttention`` autograd Function against the JAX package.

The plain K4b and K5b are held against JAX's Pallas kernels themselves,
``_flash_backward`` and ``_flash_backward_blockwise``, run in interpret
mode on the CPU: inside the test only, ``pallas_call`` is replaced by
itself with ``interpret=True`` (the JAX package is not changed).  K4b
takes the log-sum-exp of JAX's own ``_flash_forward_full`` (interpret
mode), as on JAX's path; ``FlashAttention``
is held against ``jax.vjp`` of JAX's ``flash_attention`` custom VJP, which
off the TPU differentiates ``_attention_reference``.  Tolerances, float32:
gradients to 1e-5 x max|ref| (2e-5 at T = 1100, where a row sums more
terms): the same five products in another order.  The forward to 1e-6.
``gradcheck`` runs in float64.  A Python mirror of the bf16 backward's
walks (``bwd_wgmma`` in ``csrc/flash_attention.cu``: ``qt_begin`` of the
dk/dv kernel, ``key_tiles`` of the dq kernel) and of its longest-first
grid order is held against the masks, and its shared-memory plan
against the H100's per-block limit.  The ``cuda`` cases hold the kernels
against their plain versions on a card and skip without one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.ops import flash_attention as jfa
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels of the JAX package in interpret mode."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(b, h, tq, tk, d=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    g = rng.randn(b, h, tq, d).astype(np.float32)
    slopes = -np.asarray(alibi_slopes(h), np.float32)
    return q, k, v, g, slopes


def _close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("alibi", [True, False])
def test_k4b_plain_matches_pallas_kernel(interpret, causal, alibi):
    """B 3, H 2, T 256, D 64, lengths (256, 100, 0), with K4's lse: a
    row of length 0 has p = 1 on every key in both."""
    lens = np.asarray([256, 100, 0], np.int32)
    q, k, v, g, slopes = _inputs(3, 2, 256, 256, seed=1)
    sl = slopes if alibi else None
    jsl = jnp.asarray(sl) if alibi else None
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward_full(jq, jk, jv, jnp.asarray(lens), jsl,
                                     causal, with_stats=True)
    want = jfa._flash_backward(jq, jk, jv, jg, o, jnp.asarray(lens), jsl,
                               causal, lse=lse)
    got = fa.flash_backward_full_plain(
        T(q), T(k), T(v), T(np.asarray(o)), T(g), T(np.asarray(lse)[..., 0]),
        T(lens), T(sl) if alibi else None, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("case", ["t1100", "cross"])
def test_k5b_plain_matches_pallas_kernel(interpret, case):
    """T 1100 causal with lengths (1100, 1, 0), and Tq 96 x Tk 256
    non-causal with lengths (256, 0, 131); ALiBi."""
    if case == "t1100":
        b, h, tq, tk, causal, lens = 3, 1, 1100, 1100, True, [1100, 1, 0]
    else:
        b, h, tq, tk, causal, lens = 3, 2, 96, 256, False, [256, 0, 131]
    lens = np.asarray(lens, np.int32)
    q, k, v, g, slopes = _inputs(b, h, tq, tk, seed=2)
    o = np.asarray(jfa._attention_reference(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(lens), jnp.asarray(slopes),
        causal))
    want = jfa._flash_backward_blockwise(
        *map(jnp.asarray, (q, k, v, g, o)), jnp.asarray(lens),
        jnp.asarray(slopes), causal)
    got = fa.flash_backward_blockwise_plain(
        T(q), T(k), T(v), T(o), T(g), T(lens), T(slopes), causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        _close(a, b, 2e-5, name)


@pytest.mark.parametrize("tq, tk, route", [(200, 200, "full"),
                                           (1100, 1100, "blockwise"),
                                           (96, 256, "blockwise")])
def test_flash_attention_matches_jax_vjp(tq, tk, route):
    """The port's custom VJP (forward and its routed backward) against
    ``jax.vjp`` of JAX's ``flash_attention``; causal, ALiBi, lengths
    down to 1."""
    b, h = 2, 2
    causal = tq == tk
    lens = np.asarray([tk, 1], np.int32)
    q, k, v, g, slopes = _inputs(b, h, tq, tk, seed=3)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(lens),
                                               jnp.asarray(slopes), causal),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    assert fa.backward_route(tq, tk) == route
    ins = [T(x).requires_grad_() for x in (q, k, v)]
    got = fa.flash_attention_bhtd(*ins, T(lens), T(slopes), causal)
    _close(got, out, 1e-6, "o")
    got.backward(T(g))
    for name, x, w in zip(("dq", "dk", "dv"), ins, want):
        _close(x.grad, w, 2e-5 if tq > 1024 else 1e-5, name)


@pytest.mark.parametrize("tq, tk", [(5, 5), (3, 5)])
def test_flash_attention_gradcheck(tq, tk):
    """float64: the "full" route (Tq = Tk) and the "blockwise" one."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, t, 4)).requires_grad_()
               for t in (tq, tk, tk))
    slopes = torch.tensor([-0.5, -0.25], dtype=torch.float64)
    lengths = torch.tensor([tk - 1], dtype=torch.int32)
    causal = tq == tk
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: fa.FlashAttention.apply(q_, k_, v_, lengths,
                                                   slopes, causal),
        (q, k, v))


def _counting(monkeypatch):
    """Each wrapper FlashAttention reaches, counted by name (CPU tensors
    run their plain versions)."""
    calls = []

    def wrap(name):
        fn = getattr(fa, name)

        def counted(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)

        monkeypatch.setattr(fa, name, counted)

    for name in ("flash_forward_full", "flash_forward_tiled",
                 "flash_backward_full", "flash_backward_blockwise"):
        wrap(name)
    return calls


@pytest.mark.parametrize("tq, tk, want", [
    (40, 40, ["flash_forward_full", "flash_backward_full"]),
    (70, 70, ["flash_forward_tiled", "flash_backward_blockwise"]),
    (20, 150, ["flash_forward_tiled"]),
    (9000, 9000, None)])
def test_backward_routing(monkeypatch, tq, tk, want):
    """JAX's ``_fwd``/``_bwd`` routing, with the envelope shrunk to
    T <= 64 (full) and Tk <= 128 (blockwise) so that every route runs at
    a small size: K4 + K4b, K5 + K5b, K5 + the dense recompute.  At the
    real limits 9000 frames take the dense route.  Every route's
    gradients equal autograd of the dense reference to 1e-5."""
    if want is None:
        assert fa.backward_route(tq, tk) == "dense"
        assert fa.backward_route(1024, 1024) == "full"
        assert fa.backward_route(1025, 1025) == "blockwise"
        assert fa.backward_route(1000, 8192) == "blockwise"
        return
    monkeypatch.setattr(fa, "MAX_T", 64)
    monkeypatch.setattr(fa, "MAX_TK", 128)
    calls = _counting(monkeypatch)
    q, k, v, g, slopes = _inputs(1, 2, tq, tk, d=8, seed=5)
    ins = [T(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_bhtd(*ins, torch.tensor([tk]), T(slopes),
                                  tq == tk)
    out.backward(T(g))
    assert calls == want
    ref_ins = [T(x).requires_grad_() for x in (q, k, v)]
    fa.attention_reference(*ref_ins, torch.tensor([tk]), T(slopes),
                           tq == tk).backward(T(g))
    for x, r in zip(ins, ref_ins):
        _close(x.grad, r.grad.numpy(), 1e-5)


# ------------------------------------------------- the bf16 walks (mirror)
TILE = fa.TILE
SMEM_LIMIT = 232448        # a block's most on an H100


def _qt_begin(kt, length, tq, causal):
    """The dk/dv kernel's walk: key tile ``kt`` visits query tiles
    [qt_begin, ceil(Tq / 64))."""
    nq = -(-tq // TILE)
    if length >= 1:
        if kt * TILE >= length:
            return nq
        if causal:
            return kt
    return 0


def _key_tiles(qt, length, tk, causal):
    """The dq kernel's walk: query tile ``qt`` visits key tiles [0, n)
    (twice in K5b: its row statistics, then dq)."""
    end = -(-tk // TILE)
    if length >= 1:
        end = min(end, -(-length // TILE))
        if causal:
            end = min(end, qt + 1)
    return end


def _needed(tq, tk, length, causal):
    """The (query tile, key tile) pairs holding a (query, key) pair of
    nonzero probability, from the masks: a key below ``length`` (any key
    for a row of length 0, uniform over all Tk), at or before the query
    when causal."""
    out = set()
    for qt in range(-(-tq // TILE)):
        last_q = min(qt * TILE + TILE, tq) - 1
        for kt in range(-(-tk // TILE)):
            k0 = kt * TILE
            if length < 1 or (k0 < min(length, tk)
                              and (not causal or k0 <= last_q)):
                out.add((qt, kt))
    return out


def _walked(tq, tk, length, causal):
    """The tile pairs each kernel's walks visit: (dk/dv, dq)."""
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    dkv = {(qt, kt) for kt in range(nk)
           for qt in range(_qt_begin(kt, length, tq, causal), nq)}
    dq = {(qt, kt) for qt in range(nq)
          for kt in range(_key_tiles(qt, length, tk, causal))}
    return dkv, dq


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_walks_cover_every_nonzero_pair(causal):
    """For T 1 to 1100 (Tq = Tk) and lengths 0, 1 and T, every tile
    pair holding a nonzero probability lies on both kernels' walks, and
    the two kernels walk the same pairs (dq and dk/dv sum the same
    terms)."""
    for t in range(1, 1101):
        for length in (0, 1, t):
            need = _needed(t, t, length, causal)
            dkv, dq = _walked(t, t, length, causal)
            assert need <= dkv and dkv == dq, (t, length)


def test_bwd_walks_cover_the_cross_shape():
    """Tq 96 x Tk 256, non-causal, lengths 256, 0 and 1 (K5b's cross
    call), and Tk 8192, the envelope's edge."""
    for tq, tk in ((96, 256), (100, 8192), (8192, 8192)):
        for length in (tk, 0, 1, 131):
            for causal in ((False,) if tq != tk else (False, True)):
                need = _needed(tq, tk, length, causal)
                dkv, dq = _walked(tq, tk, length, causal)
                assert need <= dkv and dkv == dq, (tq, tk, length, causal)


def _grid(kind, n_tiles, nheads, batch):
    """(tile, head, batch) of each block in launch order: the grid is
    (H, B, tiles), x fastest; the dk/dv kernel takes key tile z, the dq
    kernel query tile tiles - 1 - z."""
    for z in range(n_tiles):
        for b in range(batch):
            for h in range(nheads):
                yield (z if kind == "dkv" else n_tiles - 1 - z, h, b)


@pytest.mark.parametrize("t", [64, 640, 1100, 1536])
def test_bwd_grid_runs_the_longest_walks_first(t):
    """Each kernel's grid order is a permutation of every (tile, head,
    batch); on causal rows of full length the walks never grow along it
    (the longest start first, out of the tail)."""
    nt, nheads, batch = -(-t // TILE), 3, 2
    for kind in ("dkv", "dq"):
        order = list(_grid(kind, nt, nheads, batch))
        assert sorted(order) == sorted(
            (i, h, b) for i in range(nt) for h in range(nheads)
            for b in range(batch))
        if kind == "dkv":
            walks = [nt - _qt_begin(i, t, t, True) for i, _, _ in order]
        else:
            walks = [_key_tiles(i, t, t, True) for i, _, _ in order]
        assert walks == sorted(walks, reverse=True), kind
        assert walks[0] == nt


def test_bwd_smem_plan_fits_every_shape():
    """The bf16 K4b/K5b plan fits the 232,448 bytes a block may use on an
    H100, holds its tiles, rows and mbarriers and rings at least two
    stages; nothing in it grows with T, so it holds every shape the
    envelope admits (K4b: Tq = Tk <= 1024; K5b: Tk <= 8192)."""
    tile_bytes = TILE * 64 * 2
    plan = fa.bwd_smem_plan()
    assert plan.stages >= 2 and plan.bytes <= SMEM_LIMIT
    assert plan.bytes >= (1023 + (2 + 2 * plan.stages) * tile_bytes
                          + plan.stages * 4 * TILE * 4
                          + 8 * (1 + 2 * plan.stages))


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the flash attention CUDA kernels need an NVIDIA GPU "
                    "(sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_CASES = {"k4b_causal": (300, 300, True),
              "k4b_noncausal": (300, 300, False),
              "k4b_200": (200, 200, True), "k4b_640": (640, 640, True),
              "k4b_1000": (1000, 1000, True),
              "k4b_1024": (1024, 1024, True),
              "k5b_self": (1100, 1100, True),
              "k5b_1536": (1536, 1536, True),
              "k5b_cross": (96, 256, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k4b_k5b_match_plain(cuda_device, case, alibi, dtype):
    """K4b at T 200, 300 (causal and not), 640, 1000 and 1024 (K4's lse)
    and K5b at T 1100, 1536 and 96 x 256 (non-causal), ALiBi on and off,
    from strided views of packed projections, against their plain
    versions; lengths down to 0 and 1.  bf16 takes the ``bwd_wgmma``
    kernels.  float32 to 1e-4 max|ref|; bf16 to 2e-2 max|ref|, element
    by element 2 bf16 ulps + 2e-2 rms(ref), relative L2 1e-3."""
    b, h, d = 3, 3, 64
    tq, tk, causal = CUDA_CASES[case]
    gen = torch.Generator(cuda_device).manual_seed(11)
    xq = torch.randn((b, tq, 2 * h * d), generator=gen, device=cuda_device)
    xkv = torch.randn((b, tk, 2 * h * d), generator=gen, device=cuda_device)
    q, go = (x.view(b, tq, h, d).transpose(1, 2)
             for x in xq.to(dtype).chunk(2, dim=-1))
    k, v = (x.view(b, tk, h, d).transpose(1, 2)
            for x in xkv.to(dtype).chunk(2, dim=-1))
    lengths = torch.tensor([tk, 1, 0], dtype=torch.int32, device=cuda_device)
    slopes = (-torch.tensor(alibi_slopes(h), device=cuda_device) if alibi
              else None)
    if case.startswith("k4b"):
        o, lse = fa.flash_forward_full(q, k, v, lengths, slopes, causal,
                                       with_stats=True)
        fn, plain = fa.flash_backward_full, fa.flash_backward_full_plain
        extra = (lse,)
    else:
        o = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
        fn, plain = (fa.flash_backward_blockwise,
                     fa.flash_backward_blockwise_plain)
        extra = ()
    before = fn.launches
    got = fn(q, k, v, o, go, *extra, lengths, slopes, causal)
    want = plain(q, k, v, o, go, *extra, lengths, slopes, causal)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    bf16 = dtype == torch.bfloat16
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == dtype
        a, w = a.float(), w.float()
        diff = (a - w).abs()
        tol = 2e-2 if bf16 else 1e-4
        assert diff.max().item() <= tol * w.abs().max().item()
        if bf16:
            _, e = torch.frexp(w)
            ulp = torch.where(w == 0, torch.zeros_like(w),
                              torch.ldexp(torch.ones_like(w), e - 8))
            assert (diff <= 2 * ulp + tol * w.pow(2).mean().sqrt()).all()
            assert diff.norm() <= 1e-3 * w.norm()
