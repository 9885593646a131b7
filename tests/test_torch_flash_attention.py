"""The port's packed flash attention (K3/K3b) against the JAX package.

On the CPU the port runs its plain versions; the JAX
``flash_attention_packed`` runs its off-TPU route
(``_attention_reference`` forward, ``jax.vjp`` of it backward).  q/k/v
are non-contiguous views of one qkv projection, as the model hands them
over.  Tolerances: float32 forward 1e-6 absolute; bfloat16 inputs within
one bfloat16 ulp of the output; the log-sum-exp to 1e-5; the backward
rtol 1e-4 / atol 1e-5 (the port's K3b formula from the saved O and LSE
against autograd of the dense reference: the same math in another
order).  The ``cuda`` cases hold the kernels against the plain versions
on a card and skip without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from vae_gslm_tpu.ops.flash_attention import (
    flash_attention_packed as jax_flash_packed)
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops.flash_attention import (
    FlashAttentionPacked, flash_attention_packed, flash_backward_packed,
    flash_backward_packed_plain, flash_forward_packed,
    flash_forward_packed_plain)

LENGTHS = [37, 20, 1]
SHAPES = {"d16": (3, 37, 4, 16), "d64": (3, 37, 2, 64)}


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
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
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


@pytest.mark.parametrize("alibi", [True, False])
def test_autograd_function_gradcheck(alibi):
    """float64, T = 9: the K3b formula is the exact gradient of K3."""
    b, t, h, d = 3, 9, 2, 4
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(b, t, 3 * h * d)).requires_grad_()
    lengths = torch.tensor([9, 5, 1], dtype=torch.int32)
    slopes = (-torch.tensor(alibi_slopes(h), dtype=torch.float32)
              if alibi else None)

    def fn(x):
        q, k, v = x.chunk(3, dim=-1)
        return FlashAttentionPacked.apply(q, k, v, lengths, slopes, True, h)

    assert torch.autograd.gradcheck(fn, (qkv,), eps=1e-6, atol=1e-7)


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


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the K3/K3b CUDA kernels need an NVIDIA GPU (sm_90a)")
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
