"""The port's flash attention (K3/K3b, K4, K5) against the JAX package.

On the CPU the port runs its plain versions; the JAX
``flash_attention_packed`` and ``flash_attention`` run their off-TPU
route (``_attention_reference`` forward, ``jax.vjp`` of it backward),
which is also the oracle of the Pallas kernels K4 ``_flash_forward_full``
and K5 ``_flash_forward``.  q/k/v are non-contiguous views of one qkv
projection, as the model hands them over.  Tolerances: float32 forward
1e-6 absolute (2e-6 at T = 1100, where a row sums more terms); bfloat16
inputs within one bfloat16 ulp of the output; the log-sum-exp to 1e-5;
the backward rtol 1e-4 / atol 1e-5 (the port's K3b formula from the
saved O and LSE, or autograd of the port's dense reference, against
``jax.vjp`` of JAX's: the same math in another order).  The bf16 K3/K4
forward's shared-memory plan is held on the CPU against the key tiles a
launch can walk and the H100's per-block limit.  The ``cuda`` cases hold
the kernels against the plain versions on a card and skip without
one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from vae_gslm_tpu.ops.flash_attention import (
    _attention_reference as jax_reference)
from vae_gslm_tpu.ops.flash_attention import (
    flash_attention_packed as jax_flash_packed)
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops.flash_attention import (
    MAX_T, TILE, FlashAttentionPacked, _plan_args,
    flash_attention_packed, flash_backward_packed,
    flash_backward_packed_plain, flash_forward_full, flash_forward_full_plain,
    flash_forward_packed, flash_forward_packed_plain, flash_forward_tiled,
    flash_forward_tiled_plain, fwd_smem_plan, packed_eligible)

LENGTHS = [37, 20, 1]
# head widths: 16 (plain only), and the kernels' instantiations 32, 64
# and 128 (at 32 four heads share one 128-lane block, at 128 each is one)
SHAPES = {"d16": (3, 37, 4, 16), "d32": (3, 37, 4, 32), "d64": (3, 37, 2, 64),
          "d128": (3, 37, 2, 128)}


def _inputs(shape, seed=0, dtype=np.float32):
    b, t, h, d = shape
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, t, 3 * h * d).astype(np.float32)
    g = rng.randn(b, t, h * d).astype(np.float32)
    slopes = -np.asarray(alibi_slopes(h), np.float32)
    return qkv, g, slopes


def _torch_views(qkv, dtype=torch.float32):
    x = torch.from_numpy(qkv).to(dtype)
    q, k, v = x.chunk(3, dim=-1)
    assert not q.is_contiguous()
    return q, k, v


def _jax_split(qkv, dtype=jnp.float32):
    x = jnp.asarray(qkv).astype(dtype)
    return jnp.split(x, 3, axis=-1)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax(shape, alibi, dtype):
    b, t, h, d = SHAPES[shape]
    qkv, _, slopes = _inputs(SHAPES[shape], seed=1)
    lengths = np.asarray(LENGTHS, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = _jax_split(qkv, jdt)
    want = _f32(jax_flash_packed(jq, jk, jv, jnp.asarray(lengths),
                                 jnp.asarray(slopes) if alibi else None,
                                 True, h))
    q, k, v = _torch_views(qkv, tdt)
    got, lse = flash_forward_packed_plain(
        q, k, v, torch.from_numpy(lengths),
        torch.from_numpy(slopes) if alibi else None, True, h)
    assert got.dtype == tdt and got.shape == (b, t, h * d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    got = got.float().numpy()
    if dtype == "float32":   # at D = 128 each logit sums 128 products
        #                       in another order: a few float32 ulps more
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 if d == 128 else 1e-6)
    else:   # one bf16 ulp: 2**(exponent - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("alibi", [True, False])
def test_plain_lse_matches_jax_logsumexp(alibi):
    b, t, h, d = SHAPES["d16"]
    qkv, _, slopes = _inputs(SHAPES["d16"], seed=2)
    lengths = np.asarray(LENGTHS, np.int32)
    jq, jk, _ = _jax_split(qkv)
    heads = lambda x: jnp.transpose(x.reshape(b, t, h, d), (0, 2, 1, 3))
    logits = jnp.einsum("bhqd,bhkd->bhqk", heads(jq), heads(jk)) / np.sqrt(d)
    pos = jnp.arange(t)
    if alibi:
        logits = logits + (jnp.asarray(slopes)[:, None, None]
                           * jnp.abs(pos[None, :] - pos[:, None])[None])
    mask = ((pos[None, None, None, :] < jnp.asarray(lengths)[:, None, None,
                                                             None])
            & (pos[None, :] <= pos[:, None])[None, None])
    want = np.asarray(logsumexp(jnp.where(mask, logits, -1e30), axis=-1))
    q, k, v = _torch_views(qkv)
    _, lse = flash_forward_packed_plain(
        q, k, v, torch.from_numpy(lengths),
        torch.from_numpy(slopes) if alibi else None, True, h)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("alibi", [True, False])
def test_plain_backward_matches_jax_vjp(shape, alibi):
    b, t, h, d = SHAPES[shape]
    qkv, g, slopes = _inputs(SHAPES[shape], seed=3)
    lengths = np.asarray(LENGTHS, np.int32)
    jslopes = jnp.asarray(slopes) if alibi else None
    jq, jk, jv = _jax_split(qkv)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_packed(
        q, k, v, jnp.asarray(lengths), jslopes, True, h), jq, jk, jv)
    want = vjp(jnp.asarray(g))
    q, k, v = _torch_views(qkv)
    tl = torch.from_numpy(lengths)
    ts = torch.from_numpy(slopes) if alibi else None
    o, lse = flash_forward_packed_plain(q, k, v, tl, ts, True, h)
    got = flash_backward_packed_plain(q, k, v, o, torch.from_numpy(g), lse,
                                      tl, ts, True, h)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _gradcheck(b, t, h, d, lengths, alibi, seed):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, t, 3 * h * d)).requires_grad_()
    lengths = torch.tensor(lengths, dtype=torch.int32)
    slopes = (-torch.tensor(alibi_slopes(h), dtype=torch.float32)
              if alibi else None)

    def fn(x):
        q, k, v = x.chunk(3, dim=-1)
        return FlashAttentionPacked.apply(q, k, v, lengths, slopes, True, h)

    # ~16k tiny float64 calls: on a host whose cores the other test
    # workers keep busy, torch's intra-op thread pool turns them from
    # ~10 s into many minutes, and one thread runs them at full speed
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.autograd.gradcheck(fn, (qkv,), eps=1e-6, atol=1e-7)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("alibi", [True, False])
def test_autograd_function_gradcheck(alibi):
    """float64, T = 9, two heads of 64 (inside the packed envelope): the
    K3b formula is the exact gradient of K3."""
    assert packed_eligible(torch.zeros(2, 9, 128), torch.zeros(2, 9, 128), 2)
    assert _gradcheck(2, 9, 2, 64, [9, 1], alibi, seed=4)


@pytest.mark.parametrize("alibi", [True, False])
def test_dense_backward_gradcheck(alibi):
    """float64, T = 9, two heads of 4 (no 128-lane grouping: off the
    packed envelope): the recomputed dense backward is the exact gradient
    of the K4 forward."""
    assert not packed_eligible(torch.zeros(3, 9, 8), torch.zeros(3, 9, 8), 2)
    assert _gradcheck(3, 9, 2, 4, [9, 5, 1], alibi, seed=8)


def test_wrapper_takes_plain_version_on_cpu():
    qkv, g, slopes = _inputs(SHAPES["d64"], seed=5)
    q, k, v = _torch_views(qkv)
    q.requires_grad_()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    ts = torch.from_numpy(slopes)
    before = (flash_forward_packed.launches, flash_backward_packed.launches)
    out = flash_attention_packed(q, k, v, lengths, ts, True, 2)
    out.backward(torch.from_numpy(g))
    o, lse = flash_forward_packed_plain(q.detach(), k, v, lengths, ts, True,
                                        2)
    np.testing.assert_array_equal(out.detach().numpy(), o.numpy())
    dq = flash_backward_packed_plain(q.detach(), k, v, o,
                                     torch.from_numpy(g), lse, lengths, ts,
                                     True, 2)[0]
    np.testing.assert_array_equal(q.grad.numpy(), dq.numpy())
    assert (flash_forward_packed.launches,
            flash_backward_packed.launches) == before


def _bhtd(rng, b, h, t, d):
    return rng.randn(b, h, t, d).astype(np.float32)


def _jax_ref(q, k, v, lengths, slopes, causal):
    return np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(slopes) if slopes is not None else None, causal))


def _t(x):
    return torch.from_numpy(x) if x is not None else None


K5_CASES = {   # name: (B, H, Tq, Tk, D, lengths, causal)
    "self_1100": (4, 2, 1100, 1100, 16, [1100, 0, 1, 777], True),
    "cross_96x256": (3, 2, 96, 256, 16, [256, 0, 131], False),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
@pytest.mark.parametrize("alibi", [True, False])
def test_k5_plain_matches_jax_reference(case, alibi):
    """K5's plain version against JAX's ``_attention_reference`` (the
    oracle of ``_flash_forward``): causal self-attention past the 1024
    envelope with rows of length 0 (uniform over all keys) and 1, and a
    Tq != Tk non-causal case, as JAX's own test runs it."""
    b, h, tq, tk, d, lengths, causal = K5_CASES[case]
    rng = np.random.RandomState(10)
    q, k, v = _bhtd(rng, b, h, tq, d), _bhtd(rng, b, h, tk, d), \
        _bhtd(rng, b, h, tk, d)
    slopes = -np.asarray(alibi_slopes(h), np.float32) if alibi else None
    lengths = np.asarray(lengths, np.int32)
    want = _jax_ref(q, k, v, lengths, slopes, causal)
    got = flash_forward_tiled_plain(_t(q), _t(k), _t(v), _t(lengths),
                                    _t(slopes), causal)
    assert got.shape == (b, h, tq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    # the length-0 row is uniform over all Tk keys
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(1, keepdims=True),
                                               (h, tq, d)), atol=1e-5)
    wrapped = flash_forward_tiled(_t(q), _t(k), _t(v), _t(lengths),
                                  _t(slopes), causal)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("alibi", [True, False])
def test_k4_plain_matches_jax_reference(alibi):
    """K4's plain version at T = 300 (three heads: no packed grouping)
    against ``_attention_reference``; its lse against JAX's logsumexp of
    the masked logits."""
    b, h, t, d = 3, 3, 300, 16
    rng = np.random.RandomState(11)
    q, k, v = (_bhtd(rng, b, h, t, d) for _ in range(3))
    slopes = -np.asarray(alibi_slopes(h), np.float32) if alibi else None
    lengths = np.asarray([300, 1, 0], np.int32)
    want = _jax_ref(q, k, v, lengths, slopes, True)
    got, lse = flash_forward_full_plain(_t(q), _t(k), _t(v), _t(lengths),
                                        _t(slopes), True, with_stats=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    pos = jnp.arange(t)
    if alibi:
        logits = logits + (jnp.asarray(slopes)[:, None, None]
                           * jnp.abs(pos[None, :] - pos[:, None])[None])
    mask = ((pos[None, None, None, :] < jnp.asarray(lengths)[:, None, None,
                                                             None])
            & (pos[None, :] <= pos[:, None])[None, None])
    want_lse = np.asarray(logsumexp(jnp.where(mask, logits, -1e30), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        flash_forward_full(_t(q), _t(k), _t(v), _t(lengths), _t(slopes),
                           True).numpy(), got.numpy())


OFF_ENVELOPE = {   # name: (B, T, H, D, lengths): K5 past 1024, K4 odd heads
    "k5_T1100": (2, 1100, 2, 16, [1100, 1]),
    "k4_3heads": (3, 300, 3, 64, [300, 0, 149]),
}


@pytest.mark.parametrize("case", sorted(OFF_ENVELOPE))
@pytest.mark.parametrize("alibi", [True, False])
def test_off_envelope_packed_matches_jax_vjp(case, alibi):
    """``flash_attention_packed`` off the packed envelope (T = 1100, or
    three heads of 64 at T = 300): the K5/K4 forward and the recomputed
    dense backward against JAX's ``flash_attention_packed`` and its
    ``jax.vjp``."""
    b, t, h, d, lengths = OFF_ENVELOPE[case]
    qkv, g, slopes = _inputs((b, t, h, d), seed=12)
    lengths = np.asarray(lengths, np.int32)
    jslopes = jnp.asarray(slopes) if alibi else None
    jq, jk, jv = _jax_split(qkv)
    want, vjp = jax.vjp(lambda q, k, v: jax_flash_packed(
        q, k, v, jnp.asarray(lengths), jslopes, True, h), jq, jk, jv)
    want_grads = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    q, k, v = x.chunk(3, dim=-1)
    assert not packed_eligible(q, k, h)
    before = (flash_forward_packed.launches, flash_forward_full.launches,
              flash_forward_tiled.launches)
    out = flash_attention_packed(q, k, v, torch.from_numpy(lengths),
                                 torch.from_numpy(slopes) if alibi else None,
                                 True, h)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-6)
    out.backward(torch.from_numpy(g))
    got = x.grad.chunk(3, dim=-1)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert (flash_forward_packed.launches, flash_forward_full.launches,
            flash_forward_tiled.launches) == before


def _key_tiles(qt, length, tk, causal):
    """The kernels' ``key_tiles`` (``csrc/flash_attention.cu``): the key
    tiles [0, n) that query tile ``qt`` walks."""
    end = -(-tk // TILE)
    if length >= 1:
        end = min(end, -(-length // TILE))
        if causal:
            end = min(end, qt + 1)
    return end


def _tiles_walked(qt, length, t, causal):
    """The key tiles query tile ``qt`` needs, from the masks themselves:
    up to the last key that one of its rows sees (every key for a row of
    length 0, which is uniform over all T)."""
    last_row = min(qt * TILE + TILE, t) - 1
    if length < 1:
        last_key = t - 1
    else:
        last_key = min(length, t) - 1
        if causal:
            last_key = min(last_key, last_row)
    return last_key // TILE + 1


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_smem_plan_holds_every_launch(causal):
    """For every T from 1 to 1024 the bf16 K3/K4 plan fits the 232,448
    bytes a block may use on an H100, and its resident key tiles are the
    most that ``key_tiles`` gives any query tile of a causal or
    non-causal launch, which is what the masks need."""
    tile_bytes = TILE * 64 * 2
    for t in range(1, MAX_T + 1):
        plan = fwd_smem_plan(t, 64)
        assert plan.bytes <= 232448 and plan.stages >= 2
        assert plan.bytes >= (1 + plan.tiles + plan.stages) * tile_bytes
        most = 0
        for qt in range(-(-t // TILE)):
            for length in {0, 1, TILE - 1, TILE, TILE + 1, t // 2, t - 1, t}:
                n = _key_tiles(qt, length, t, causal)
                assert n == _tiles_walked(qt, length, t, causal), (t, qt,
                                                                   length)
                most = max(most, n)
        assert plan.tiles == most, t


def test_plan_args_only_for_bf16():
    """The launcher gets the plan for bfloat16 and zeros for float32."""
    q = torch.zeros(1, 640, 128)
    assert _plan_args(q, 640, 64) == (0, 0, 0)
    plan = fwd_smem_plan(640, 64)
    assert _plan_args(q.to(torch.bfloat16), 640, 64) == (
        plan.bytes, plan.tiles, plan.stages)


def test_packed_eligible_matches_jax():
    from vae_gslm_tpu.ops.flash_attention import _packed_eligible

    for t, hd, h in ((640, 1024, 16), (1024, 1024, 16), (1025, 1024, 16),
                     (300, 192, 3), (37, 64, 4), (37, 128, 2), (9, 256, 1)):
        x = np.zeros((1, t, hd), np.float32)
        assert packed_eligible(torch.from_numpy(x), torch.from_numpy(x),
                               h) == _packed_eligible(jnp.asarray(x),
                                                      jnp.asarray(x), h)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the flash attention CUDA kernels need an NVIDIA GPU "
                    "(sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_LENGTHS = [200, 77, 1, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, alibi, dtype):
    """f32: o and lse to 1e-5 max(1, max|ref|), gradients to 1e-4
    max|ref|; bf16: o to 1e-2 max|ref|, lse 1e-5 max(1, max|ref|),
    gradients 2e-2 max|ref| (a probability one ulp apart may round to
    another bf16 value), and o and the gradients also element by element
    to 2 bf16 ulps of |ref| + tol rms(ref) and to 1e-3 in relative L2."""
    b, t, h, d = 4, 200, 2, 64
    qkv, g, slopes = _inputs((b, t, h, d), seed=6)
    q, k, v = (x.to(cuda_device) for x in _torch_views(qkv, dtype))
    gt = torch.from_numpy(g).to(cuda_device, dtype)
    lengths = torch.tensor(CUDA_LENGTHS, dtype=torch.int32,
                           device=cuda_device)
    ts = torch.from_numpy(slopes).to(cuda_device) if alibi else None
    o, lse = flash_forward_packed(q, k, v, lengths, ts, True, h)
    o_ref, lse_ref = flash_forward_packed_plain(q, k, v, lengths, ts, True,
                                                h)
    grads = flash_backward_packed(q, k, v, o, gt, lse, lengths, ts, True, h)
    refs = flash_backward_packed_plain(q, k, v, o, gt, lse, lengths, ts,
                                       True, h)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16

    def close(got, want, tol, floor=0.0, elementwise=bf16):
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        scale = max(floor, want.abs().max().item())
        assert diff.max().item() <= tol * scale
        if elementwise:
            _, e = torch.frexp(want)
            ulp = torch.where(want == 0, torch.zeros_like(want),
                              torch.ldexp(torch.ones_like(want), e - 8))
            rms = want.pow(2).mean().sqrt()
            assert (diff <= 2 * ulp + tol * rms).all()
            assert diff.norm() <= 1e-3 * want.norm()

    close(o, o_ref, 1e-2 if bf16 else 1e-5, 0.0 if bf16 else 1.0)
    close(lse, lse_ref, 1e-5, 1.0, elementwise=False)
    for got, want in zip(grads, refs):
        close(got, want, 2e-2 if bf16 else 1e-4)


@pytest.mark.cuda
def test_cuda_raises_outside_the_envelope(cuda_device):
    qkv, _, _ = _inputs(SHAPES["d16"], seed=7)
    q, k, v = (x.to(cuda_device) for x in _torch_views(qkv))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K4"):
        flash_attention_packed(q, k, v, lengths, None, True, 4)


def _close_bhtd(got, want, bf16):
    """f32: 1e-5 max(1, max|ref|); bf16: 1e-2 max|ref|, element by element
    2 bf16 ulps + 1e-2 rms(ref), relative L2 1e-3."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = 1e-2 if bf16 else 1e-5
    assert diff.max().item() <= tol * max(0.0 if bf16 else 1.0,
                                          want.abs().max().item())
    if bf16:
        _, e = torch.frexp(want)
        ulp = torch.where(want == 0, torch.zeros_like(want),
                          torch.ldexp(torch.ones_like(want), e - 8))
        assert (diff <= 2 * ulp + tol * want.pow(2).mean().sqrt()).all()
        assert diff.norm() <= 1e-3 * want.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k4", "k5_self", "k5_cross"])
@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k4_k5_match_plain(cuda_device, case, alibi, dtype):
    """K4 at T = 300 and K5 at T = 1100 and 96 x 256 (non-causal), from
    strided views of a packed projection, against their plain versions;
    lengths down to 0 and 1."""
    b, h, d = 3, 3, 64
    tq, tk, causal, fn = {"k4": (300, 300, True, flash_forward_full),
                          "k5_self": (1100, 1100, True, flash_forward_tiled),
                          "k5_cross": (96, 256, False, flash_forward_tiled)
                          }[case]
    g = torch.Generator(cuda_device).manual_seed(9)
    xq = torch.randn((b, tq, h * d), generator=g, device=cuda_device)
    xkv = torch.randn((b, tk, 2 * h * d), generator=g, device=cuda_device)
    q = xq.to(dtype).view(b, tq, h, d).transpose(1, 2)
    k, v = (x.view(b, tk, h, d).transpose(1, 2)
            for x in xkv.to(dtype).chunk(2, dim=-1))
    lengths = torch.tensor([tk, 1, 0], dtype=torch.int32, device=cuda_device)
    slopes = (-torch.tensor(alibi_slopes(h), device=cuda_device)
              if alibi else None)
    plain = (flash_forward_full_plain if fn is flash_forward_full
             else flash_forward_tiled_plain)
    before = fn.launches
    got = fn(q, k, v, lengths, slopes, causal)
    want = plain(q, k, v, lengths, slopes, causal)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.shape == want.shape
    _close_bhtd(got, want, dtype == torch.bfloat16)


@pytest.mark.cuda
def test_cuda_packed_past_1024_launches_k5(cuda_device):
    """On CUDA ``flash_attention_packed`` no longer raises for T > 1024 at
    head_dim 64: K5 forward, dense backward, both against the CPU."""
    b, t, h, d = 2, 1100, 2, 64
    qkv, g, slopes = _inputs((b, t, h, d), seed=13)
    lengths = torch.tensor([1100, 1], dtype=torch.int32)
    runs = []
    for dev in ("cpu", cuda_device):
        x = torch.from_numpy(qkv).to(dev).requires_grad_()
        out = flash_attention_packed(*x.chunk(3, dim=-1), lengths.to(dev),
                                     torch.from_numpy(slopes).to(dev), True,
                                     h)
        out.backward(torch.from_numpy(g).to(dev))
        runs.append((out.detach().cpu(), x.grad.cpu()))
    before = flash_forward_tiled.launches
    x = torch.from_numpy(qkv).to(cuda_device)
    flash_attention_packed(*x.chunk(3, dim=-1), lengths.to(cuda_device),
                           None, True, h)
    assert flash_forward_tiled.launches == before + 1
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-5)


WGMMA_T = [200, 640, 1000, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("t", WGMMA_T)
@pytest.mark.parametrize("alibi", [True, False])
def test_cuda_k3_bf16_forward_matches_plain(cuda_device, t, alibi):
    """The bf16 K3 forward (wgmma, TMA, resident K) at T 200 (a partial
    last tile), 640 (the training call's), 1000 and 1024 (the largest
    resident K), lengths 0 and 1 among them, against its plain version at
    chip_smoke.py's bf16 tolerances: o 1e-2 max|ref| and element by
    element 2 ulps + 1e-2 rms(ref), relative L2 1e-3; lse 1e-5 max(1,
    max|ref|)."""
    b, h, d = 4, 2, 64
    qkv, _, slopes = _inputs((b, t, h, d), seed=t)
    q, k, v = (x.to(cuda_device)
               for x in _torch_views(qkv, torch.bfloat16))
    lengths = torch.tensor([t, 0, 1, t // 2 + 3], dtype=torch.int32,
                           device=cuda_device)
    ts = torch.from_numpy(slopes).to(cuda_device) if alibi else None
    before = flash_forward_packed.launches
    o, lse = flash_forward_packed(q, k, v, lengths, ts, True, h)
    o_ref, lse_ref = flash_forward_packed_plain(q, k, v, lengths, ts, True,
                                                h)
    torch.cuda.synchronize()
    assert flash_forward_packed.launches == before + 1
    _close_bhtd(o, o_ref, True)
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * max(
        1.0, lse_ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("t", WGMMA_T)
@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("with_stats", [True, False])
def test_cuda_k4_bf16_forward_matches_plain(cuda_device, t, alibi,
                                            with_stats):
    """The bf16 K4 forward with 15 heads (no packed head grouping), with
    and without lse, from strided views of packed projections, at K3's
    T and tolerances; lengths 0 and 1 among them."""
    b, h, d = 3, 15, 64
    g = torch.Generator(cuda_device).manual_seed(t)
    xq = torch.randn((b, t, h * d), generator=g, device=cuda_device)
    xkv = torch.randn((b, t, 2 * h * d), generator=g, device=cuda_device)
    q = xq.to(torch.bfloat16).view(b, t, h, d).transpose(1, 2)
    k, v = (x.view(b, t, h, d).transpose(1, 2)
            for x in xkv.to(torch.bfloat16).chunk(2, dim=-1))
    lengths = torch.tensor([t, 1, 0], dtype=torch.int32, device=cuda_device)
    slopes = (-torch.tensor(alibi_slopes(h), device=cuda_device)
              if alibi else None)
    before = flash_forward_full.launches
    got = flash_forward_full(q, k, v, lengths, slopes, True, with_stats)
    want = flash_forward_full_plain(q, k, v, lengths, slopes, True,
                                    with_stats)
    torch.cuda.synchronize()
    assert flash_forward_full.launches == before + 1
    if with_stats:
        (got, lse), (want, lse_ref) = got, want
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * max(
            1.0, lse_ref.abs().max().item())
    _close_bhtd(got, want, True)
