"""The int8-weight samplers at head widths 128 and 32 against the JAX
package on the CPU (moved out of ``tests/test_torch_mega_head_widths.py``
so that no test file keeps one worker for minutes): ``ARTRSampler`` with
int8 weights at 2 x 128 and 8 x 32 against JAX's sampler forced onto its
mega route (``VAE_GSLM_MEGA_DECODE=1``) under the deterministic protocol
of ``tests/test_torch_mega_sampler.py``: a8 at B 2, bf16 products at B 9,
and w4 (group 128 at width 128, groups 64 and 128 at width 32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lvtr_sampler import DETERMINISTIC
from tests.test_torch_mega_step import mega_lvtr_pair
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_torch_trunk import N_MELS
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.inference.speech.sampler import ARTRSampler as JSampler
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.ops import mega_step as jmega
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler


def _prompt(b, tp):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 11, (b, tp, 1)).astype(np.float32)
    mel = rng.randn(b, tp, N_MELS).astype(np.float32)
    return np.concatenate([toks, mel], -1)


def _run_both(monkeypatch, jm, tm, b, length, tp=6, **port_kw):
    """Both samplers under the deterministic protocol, the initial AR state
    pinned on both sides with one numpy array."""
    init = (np.random.RandomState(5).rand(b, 1, 16) * 2 - 1).astype(
        np.float32)
    jinit, tinit = jnp.asarray(init), torch.from_numpy(init)
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None: jinit)
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None: tinit)
    prompt = _prompt(b, tp)
    lengths = np.full((b,), tp)
    want = JSampler(jm, kv_dtype=jnp.int8, quantize_weights=True)(
        length, JMasked.from_lengths(jnp.asarray(prompt),
                                     jnp.asarray(lengths)),
        jax.random.PRNGKey(0), **DETERMINISTIC)
    sampler = ARTRSampler(tm, kv_dtype=torch.int8, quantize_weights=True,
                          device="cpu", **port_kw)
    got = sampler(length, Masked.from_lengths(torch.from_numpy(prompt),
                                              lengths),
                  torch.Generator().manual_seed(0), **DETERMINISTIC)
    return sampler, np.array(want["frames"].value), got["frames"].value.numpy()


# (heads, B, JAX's VAE_GSLM_MEGA_A8, w4 group): a8 at B 2, bf16 products
# at B 9, w4 at B 2
SAMPLER_CASES = [(2, 2, "auto", 0), (8, 2, "auto", 0), (2, 9, "0", 0),
                 (8, 9, "0", 0), (2, 2, "auto", 128), (8, 2, "auto", 64),
                 (8, 2, "auto", 128)]


@pytest.mark.parametrize("h,b,a8_env,w4", SAMPLER_CASES)
def test_sampler_serves_wide_heads_on_k2_as_jax(monkeypatch, h, b, a8_env,
                                                w4):
    """The int8-weight trunk at 2 x 128 or 8 x 32 takes the mega route in
    both packages (the port's took the hybrid route before: K2 was built
    for width 64 alone): 12 steps over a 6-frame prompt cross an
    eight-step merge into the tail and attend over it.  The a8 and w4
    branches requantize every activation row (group) to int8, so a last-bit difference of the
    float32 sums (XLA's order against the port's float64) can flip an
    int8 step and move latents by a few 1e-3 (the a8 band of
    ``tests/test_torch_mega_sampler.py``, atol 1e-2); the token streams
    are equal on every branch.  The models draw from seed 12: from seed 11
    (``tests/test_torch_mega_sampler.py``'s), the 8 x 32 trunk's a8 and
    w4 routes flip a near-tied token argmax at the third generated frame
    after an int8 rounding flip, with the latents before it equal."""
    jm, tm = mega_lvtr_pair(seed=12, nheads=h)
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_MEGA_A8", a8_env)
    monkeypatch.setenv("VAE_GSLM_MEGA_W4", str(w4))
    routes = []
    route = ARTRSampler.route
    monkeypatch.setattr(ARTRSampler, "route", lambda self, *a, **k:
                        routes.append(route(self, *a, **k)) or routes[-1])
    jfused, calls = jmega.fused_trunk_step, []
    monkeypatch.setattr(jmega, "fused_trunk_step", lambda *a, **k:
                        calls.append(1) or jfused(*a, **k))
    length = 12
    sampler, jf, tf = _run_both(
        monkeypatch, jm, tm, b, length,
        mega_a8=None if a8_env == "auto" else False)
    assert sampler.use_mega and sampler.mega_w4 == w4
    assert routes and set(routes) == {"mega"}
    assert tf.shape == jf.shape == (b, 6 + length, 1 + 4)
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg="token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=1e-2,
                               rtol=1e-2, err_msg="latents")
