"""K1, the hybrid cold/tail decode attention: the port's plain version
against the JAX kernel (interpret mode) and the JAX reference, on the
inputs and ``(flushed, pos)`` cases of ``tests/test_fused_decode.py``;
and, on a card, the CUDA kernel against the plain version.

Tolerance rtol 1e-4 / atol 1e-5 against JAX: torch's and XLA's ``exp``
may differ by an ulp, which can flip one requantized probability by one
int8 step (the JAX test holds its kernel to its own reference at
1e-5 / 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.ops.fused_decode import (
    fused_decode_attention as jax_kernel,
    fused_decode_attention_reference as jax_reference)
from vae_gslm_tpu_torch.ops.fused_decode import (
    BLK, TAIL, fused_decode_attention, fused_decode_attention_plain)

L, B, H, D, TC = 3, 8, 4, 64, 512
CASES = [(0, 0), (0, 5), (256, 300), (512, 513), (512, 512 + TAIL - 1)]


def _setup(seed=0):
    """The generator of tests/test_fused_decode.py, as numpy arrays."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    nb = TC // BLK
    kc = rng.randint(-127, 128, (L, nb, B, H, D, BLK)).astype(np.int8)
    vc = rng.randint(-127, 128, (L, nb, B, H, D, BLK)).astype(np.int8)
    kcs = (rng.rand(L, nb, B, H, BLK) * 0.02).astype(np.float32)
    vcs = (rng.rand(L, nb, B, H, BLK) * 0.02).astype(np.float32)
    kt = rng.randint(-127, 128, (L, B, H, TAIL, D)).astype(np.int8)
    vt = rng.randint(-127, 128, (L, B, H, TAIL, D)).astype(np.int8)
    kts = (rng.rand(L, B, H, TAIL) * 0.02).astype(np.float32)
    vts = (rng.rand(L, B, H, TAIL) * 0.02).astype(np.float32)
    slopes = -np.asarray([0.25, 0.0625, 0.015625, 0.00390625], np.float32)
    kn = (rng.randn(B, H, D) * 0.1).astype(np.float32)
    vn = (rng.randn(B, H, D) * 0.1).astype(np.float32)
    return (q, kc, vc, kcs, vcs, kt, vt, kts, vts, slopes, kn, vn)


def _split(args):
    q, kc, vc, kcs, vcs, kt, vt, kts, vts, slopes, kn, vn = args
    return (q, kc, vc, kcs, vcs, kt, vt, kts, vts), slopes, kn, vn


@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("oracle", ["interpret_kernel", "reference"])
def test_plain_matches_jax(flushed, pos, oracle):
    cache, slopes, kn, vn = _split(_setup())
    li = pos % L
    fn = jax_reference if oracle == "reference" else jax_kernel
    kw = {} if oracle == "reference" else {"interpret": True}
    want = np.asarray(fn(*map(jnp.asarray, cache), jnp.asarray(pos),
                         jnp.asarray(li), jnp.asarray(slopes),
                         jnp.asarray(kn), jnp.asarray(vn), flushed, **kw))
    got = fused_decode_attention_plain(
        *map(torch.from_numpy, cache), pos, li, torch.from_numpy(slopes),
        torch.from_numpy(kn), torch.from_numpy(vn), flushed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    cache, slopes, kn, vn = _split(_setup(1))
    args = (*map(torch.from_numpy, cache), 300, 1,
            torch.from_numpy(slopes), torch.from_numpy(kn),
            torch.from_numpy(vn), 256)
    before = fused_decode_attention.launches
    np.testing.assert_array_equal(fused_decode_attention(*args).numpy(),
                                  fused_decode_attention_plain(*args).numpy())
    assert fused_decode_attention.launches == before   # no kernel launch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos", CASES)
def test_cuda_kernel_matches_plain(cuda_device, flushed, pos):
    """rtol 1e-3 / atol 1e-4: the kernel's exp and sums run in another
    order than torch's, which can flip one requantized probability."""
    cache, slopes, kn, vn = _split(_setup(2))
    args = [torch.from_numpy(a).to(cuda_device) for a in cache]
    rest = [torch.from_numpy(a).to(cuda_device) for a in (slopes, kn, vn)]
    li = pos % L
    got = fused_decode_attention(*args, pos, li, rest[0], rest[1], rest[2],
                                 flushed)
    want = fused_decode_attention_plain(*args, pos, li, rest[0], rest[1],
                                        rest[2], flushed)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
