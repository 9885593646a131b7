"""The slice as a whole: the port's ``ARTRSampler`` on the hybrid int8
decode path against the JAX ``ARTRSampler`` forced onto its hybrid path
(Pallas kernel in interpret mode), on the same exported weights, float32
on the CPU; then the diffusion decode and the vocoder on the same frames.

Deterministic protocol of ``tests/test_reference_parity.py``: temperature
0 pins the latents, token temperature 1e-4 turns the token draw into an
argmax on both sides, encoder temperature 0, and the uniform initial AR
state pinned on both sides with one numpy array.  Length 280 crosses the
256-position tail -> cold flush.  Tokens must be equal; latents agree to
atol 2e-3 / rtol 1e-2, the long-horizon budget of that file (float32
drift compounds through the recursive steps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_models import HFG_HP
from tests.test_torch_layers import _reference_generator_sd
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_torch_trunk import N_MELS, lvtr_pair
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.inference.speech.sampler import ARTRSampler as JSampler
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.models.vocoder.hfgan import Generator as JGenerator
from vae_gslm_tpu.models.vocoder.vocoder import load_torch_generator
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models.convert import load_reference_generator
from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator

B, TP = 2, 6
DETERMINISTIC = dict(temperature=0.0, token_temperature=1e-4,
                     encoder_temperature=0.0)


def _prompt():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 11, (B, TP, 1)).astype(np.float32)
    mel = rng.randn(B, TP, N_MELS).astype(np.float32)
    return np.concatenate([toks, mel], -1)


def _jax_decode(jm, frames: np.ndarray, start: np.ndarray) -> np.ndarray:
    """``JLVTR.decode`` with its start noise replaced by ``start``."""
    x = JMasked.from_lengths(jnp.asarray(frames),
                             jnp.full((B,), frames.shape[1]))
    tokens_id, lat = jm.split_inputs(x)
    cond = jm.fuse_inputs(lat, jm._embed_tokens(tokens_id))
    s = JMasked.from_lengths(jnp.asarray(start), x.lengths)
    out = jm.decoder.sample(s, cond.apply_mask(), jax.random.PRNGKey(0))
    return np.asarray(out.value * jm.diff_scaling)


@pytest.mark.parametrize("length", [8, 280])
def test_sampler_matches_jax_hybrid(monkeypatch, length):
    jm, tm = lvtr_pair(seed=11)
    init = (np.random.RandomState(5).rand(B, 1, 16) * 2 - 1).astype(
        np.float32)
    jinit, tinit = jnp.asarray(init), torch.from_numpy(init)
    # class-level pin: the JAX sampler rebuilds the model via nnx.merge
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None: jinit)
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None: tinit)
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "0")
    prompt = _prompt()
    lengths = np.asarray([TP, TP])

    want = JSampler(jm, kv_dtype=jnp.int8)(
        length, JMasked.from_lengths(jnp.asarray(prompt),
                                     jnp.asarray(lengths)),
        jax.random.PRNGKey(0), **DETERMINISTIC)
    got = ARTRSampler(tm, kv_dtype=torch.int8, device="cpu")(
        length, Masked.from_lengths(torch.from_numpy(prompt), lengths),
        torch.Generator().manual_seed(0), **DETERMINISTIC)

    jf = np.array(want["frames"].value)      # writable, for torch
    tf = got["frames"].value.numpy()
    assert tf.shape == jf.shape == (B, TP + length, 1 + 4)
    np.testing.assert_array_equal(got["frames"].lengths.numpy(),
                                  np.asarray(want["frames"].lengths))
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg=f"{length}-step token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")
    assert got["output"].value.shape == want["output"].value.shape

    # Diffusion decode of the same (JAX) frames from one start at eta 0,
    # then the vocoder on the same mel.  Mel atol 2e-3 / rtol 1e-4: the
    # first DDIM step multiplies the UNet's float32 rounding by
    # sqrt(1 / alpha_bar) = 406 on this 20-step cosine schedule, and the
    # output is scaled by input_scale 5.  Wave 1e-5 absolute, as in
    # tests/test_torch_layers.py.
    for d in (jm.decoder, tm.decoder):
        d.override_sampling(sampling_timesteps=5, ddim_sampling_eta=0.0)
    start = np.random.RandomState(6).randn(B, TP + length, N_MELS).astype(
        np.float32)
    jmel = _jax_decode(jm, jf, start)
    full = torch.from_numpy(jf)
    tmel = tm.decode(Masked.from_lengths(full, [TP + length] * B),
                     torch.Generator().manual_seed(0),
                     start=Masked.from_lengths(torch.from_numpy(start),
                                               [TP + length] * B))
    np.testing.assert_allclose(tmel.value.numpy(), jmel, atol=2e-3,
                               rtol=1e-4, err_msg="mel")

    jg = JGenerator(HFG_HP, rngs=nnx.Rngs(7))
    sd = _reference_generator_sd(jg)
    load_torch_generator(jg, sd)
    jg.remove_weight_norm()
    tg = Generator(Hparams.from_dict(HFG_HP.to_dict()), device="cpu")
    load_reference_generator(tg, {k: torch.from_numpy(v)
                                  for k, v in sd.items()})
    jwave = jg(JMasked.from_lengths(jnp.asarray(jmel),
                                    jnp.full((B,), TP + length)))
    with torch.no_grad():
        twave = tg(dataclasses.replace(tmel, value=torch.from_numpy(jmel)))
    assert twave.value.shape == (B, (TP + length) * 20)
    np.testing.assert_allclose(twave.value.numpy(), np.asarray(jwave.value),
                               atol=1e-5, rtol=0, err_msg="wave")
