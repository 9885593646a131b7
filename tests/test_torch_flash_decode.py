"""K6: the plain version of the port's ``flash_decode_int8`` against the
JAX package's Pallas kernel (``vae_gslm_tpu/ops/flash_decode.py``) run in
TPU interpret mode (``pallas_call`` patched inside the test; the JAX
package is not changed), on the CPU.  JAX's two entry points are both
held against it: the head-major one on the same cache, the time-minor
one on the cache's transpose (the port reads only the head-major layout).

Both sides compute the same float32 online softmax over 256-key blocks,
in another summation order, so they agree to 1e-6 relative to max|ref|.
Against JAX's ``decode_attention`` (the XLA route, which quantizes q to
int8 and rounds the weights to bfloat16) the kernel is held to JAX's own
tolerance for it, 2e-2 relative.  The ``cuda`` case holds the kernel
against the plain version on a card."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.nn.attention import _quantize_i8
from vae_gslm_tpu.nn.positions import alibi_slopes
from vae_gslm_tpu.ops.decode_attention import decode_attention as jax_xla
from vae_gslm_tpu.ops.flash_decode import flash_decode_int8 as jax_k6
from vae_gslm_tpu.ops.flash_decode import flash_decode_int8_tm as jax_k6_tm
from vae_gslm_tpu_torch.ops.flash_decode import (flash_decode_int8,
                                                 flash_decode_int8_plain)

B, H, T, D = 2, 4, 512, 16


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in TPU interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _inputs(b=B, h=H, t=T, d=D, seed=0):
    """q, int8 K/V quantized by JAX's ``_quantize_i8`` with their scales,
    and ALiBi slopes, as numpy arrays."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k8, ks = _quantize_i8(jnp.asarray(rng.randn(b, h, t, d), jnp.float32))
    v8, vs = _quantize_i8(jnp.asarray(rng.randn(b, h, t, d), jnp.float32))
    slopes = -np.asarray(alibi_slopes(h), np.float32)
    return [np.array(x) for x in (q, k8, v8, ks, vs)] + [slopes]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.mark.parametrize("layout", ["head_major", "time_minor"])
@pytest.mark.parametrize("pos", [0, 255, 256, T - 1])
def test_k6_plain_matches_pallas_kernel(interpret, layout, pos):
    q, k8, v8, ks, vs, slopes = _inputs()
    if layout == "head_major":
        want = jax_k6(*(jnp.asarray(x) for x in (q, k8, v8, ks, vs)),
                      jnp.asarray(pos, jnp.int32), jnp.asarray(slopes))
    else:
        k_tm, v_tm = k8.transpose(0, 1, 3, 2), v8.transpose(0, 1, 3, 2)
        want = jax_k6_tm(*(jnp.asarray(x) for x in (q, k_tm, v_tm, ks, vs)),
                         jnp.asarray(pos, jnp.int32), jnp.asarray(slopes))
    tq, tk, tv, tks, tvs, ts = _t((q, k8, v8, ks, vs, slopes))
    got = flash_decode_int8(tq, tk, tv, tks, tvs, pos, ts)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("pos", [5, 400])
def test_k6_plain_matches_xla_decode_within_jax_tolerance(pos):
    """JAX's own check of its kernel against the XLA decode path
    (``tests/test_flash_decode.py``), at its 2e-2 relative tolerance."""
    q, k8, v8, ks, vs, slopes = _inputs(t=768, d=64, seed=1)
    ref = np.asarray(jax_xla(*(jnp.asarray(x) for x in (q, k8, v8)),
                             jnp.asarray(pos), jnp.asarray(slopes), None,
                             jnp.asarray(ks), jnp.asarray(vs)))
    out = flash_decode_int8_plain(*_t((q, k8, v8, ks, vs)), pos,
                                  torch.from_numpy(slopes)).numpy()
    err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 2e-2, err


def test_k6_refuses_a_cache_length_off_the_block():
    q, k8, v8, ks, vs, slopes = _t(_inputs(t=300))
    with pytest.raises(ValueError, match="multiple of 256"):
        flash_decode_int8(q, k8, v8, ks, vs, 10, slopes)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_k6_matches_plain(cuda_device):
    """The kernel against its plain version at the per-layer path's width
    (16 heads of 64, T 768, B 4), to 1e-5 x max|ref|."""
    arrays = _t(_inputs(b=4, h=16, t=768, d=64, seed=2))
    q, k8, v8, ks, vs, slopes = (x.to(cuda_device) for x in arrays)
    for pos in (0, 255, 256, 400, 767):
        want = flash_decode_int8_plain(q, k8, v8, ks, vs, pos, slopes)
        got = flash_decode_int8(q, k8, v8, ks, vs, pos, slopes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (pos, err)
