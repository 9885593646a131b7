"""Small LVTRs whose trunk heads are 128 and 32 wide against the JAX
package's, on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_head_widths_lvtr.py -q

Two trunks of two layers: d256 with 2 heads of 128, and d128 with 4 heads
of 32 (at T <= 1024 both take the packed flash route: one head a
128-lane block, and four heads sharing one).  The JAX models draw their
weights; the port's are loaded from ``export_torch_lvtr`` through
``models/convert.py``.  On the CPU the port runs its kernels' plain
versions, so this holds the path the card runs through the kernels at
these widths:

- the training loss and its gradients (``LVTRTrainer._loss_fn`` against
  ``jax.grad`` of JAX's, the draws of ``tests/test_torch_train_step.py``):
  metrics rtol 1e-5 / atol 1e-6, gradients 1e-4 x max|g| per leaf;
- ``LVTR.likelihood`` at 40 frames (K3's route) and 1030 frames (past
  1024: K5's), the uniform initial state pinned: rtol 1e-4 / atol 1e-4;
- the deterministic sampling protocol of ``tests/test_reference_parity.py``
  (temperature 0, token temperature 1e-4, encoder temperature 0, the
  initial AR state pinned) through ``ARTRSampler`` on the hybrid int8
  route, 12 steps: tokens equal, latents to atol 2e-3 / rtol 1e-2.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from tests.test_torch_train_step import N_MELS as TRAIN_MELS
from tests.test_torch_train_step import (SMALL_VOCODER, UTTERANCE, _batch,
                                         _close, _draws, _jax_batch,
                                         _torch_batch)
from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech.sampler import ARTRSampler as JSampler
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.models.vocoder.vocoder import HiFiGAN
from vae_gslm_tpu.trainers.speech.lvtr import LVTRTrainer as JTrainer
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

# (model dim, heads): head widths 128 and 32
WIDTHS = {"d128": (256, 2), "d32": (128, 4)}


def _trunk(d: dict, width: str) -> dict:
    dim, nheads = WIDTHS[width]
    tr = d["transformer"]
    tr["num_layers"] = 2
    tr["layer"]["dim"] = dim
    tr["layer"]["ffd_size"] = 2 * dim
    tr["layer"]["self_attn"]["nheads"] = nheads
    return d


@pytest.fixture(scope="module")
def vocoder_dir(tmp_path_factory):
    voc = tmp_path_factory.mktemp("vocoder")
    voc_hp = yaml.safe_load(VOCODER_HP)
    voc_hp["model"]["generator"].update(SMALL_VOCODER)
    HiFiGAN(JHparams.from_dict(voc_hp),
            rngs=nnx.Rngs(0)).save_pretrained(str(voc))
    return voc


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_loss_gradients_match_jax(tmp_path, vocoder_dir, width):
    cfg = yaml.safe_load(TRAIN_HP.format(
        log_dir=tmp_path / "log", vocoder_dir=vocoder_dir,
        corpus=tmp_path / "corpus"))
    cfg["model"]["utterance_encoder"] = UTTERANCE
    cfg["trainer"]["n_devices"] = 1
    _trunk(cfg["model"], width)
    jt = JTrainer(JHparams.from_dict(copy.deepcopy(cfg)))
    tt = LVTRTrainer(Hparams.from_dict(copy.deepcopy(cfg)), device="cpu")
    load_reference_lvtr(tt.model, export_torch_lvtr(jt.model))
    assert tt.model.transformer.layers[0].self_attn.head_dim == {
        "d128": 128, "d32": 32}[width]
    raw = _batch()
    key = jax.random.PRNGKey(8)
    kld_weight = 0.3
    jgrads, jmetrics = jax.jit(jax.grad(jt._loss_fn, has_aux=True))(
        jt.params, jt.rest, _jax_batch(raw, 1), jnp.float32(kld_weight),
        key)
    ref = LVTR(Hparams.from_dict(copy.deepcopy(cfg["model"])),
               input_dim=TRAIN_MELS, device="cpu")
    load_reference_lvtr(ref, export_torch_lvtr(jt._merge(jgrads, jt.rest)))
    want = dict(ref.named_parameters())
    for p in tt.params:
        p.grad = None
    loss, metrics = tt._loss_fn(_torch_batch(raw, 1), kld_weight, None,
                                _draws(key, cfg))
    loss.backward()
    for k in ("kld", "rec_loss", "token_kld", "log_p", "log_q"):
        _close(metrics[k].numpy(), np.asarray(jmetrics[k]), 1e-5, 1e-6, k)
    assert set(want) == set(tt.names)
    for name, p in zip(tt.names, tt.params):
        w = want[name].detach().numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


def _pair(width: str, seed: int):
    d = _trunk(Hparams.from_yaml(TINY_YAML).to_dict(), width)
    d["transformer"]["rpe"]["maxpos"] = 2048
    jm = JLVTR(JHparams.from_json(json.dumps(d)), input_dim=N_MELS,
               rngs=nnx.Rngs(seed))
    tm = LVTR(Hparams.from_dict(d), input_dim=N_MELS, device="cpu")
    load_reference_lvtr(tm, export_torch_lvtr(jm))
    return jm, tm


def _init(b: int, seed: int):
    return (np.random.RandomState(seed).rand(b, 1, 16) * 2 - 1).astype(
        np.float32)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("t,lengths", [(40, [40, 23, 1]),
                                       (1030, [1030, 611])])
def test_likelihood_matches_jax(width, t, lengths):
    jm, tm = _pair(width, seed=len(width) + t)
    rng = np.random.RandomState(t)
    b = len(lengths)
    x = np.concatenate([rng.randint(0, 11, (b, t, 1)),
                        rng.randn(b, t, N_MELS)], -1).astype(np.float32)
    init = _init(b, t)
    jm.initial_state = lambda key, bsize, nfeat=None: jnp.asarray(init)
    tm.initial_state = (lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init))
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jm.likelihood(
        JMasked.from_lengths(jnp.asarray(x), jnp.asarray(ln)),
        jax.random.PRNGKey(0), temperature=0.0))
    with torch.no_grad():
        got = tm.likelihood(Masked.from_lengths(torch.from_numpy(x), ln),
                            torch.Generator().manual_seed(0))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_sampler_matches_jax_hybrid(monkeypatch, width):
    b, tp, length = 2, 6, 12
    jm, tm = _pair(width, seed=11)
    init = _init(b, 5)
    jinit, tinit = jnp.asarray(init), torch.from_numpy(init)
    # class-level pin: the JAX sampler rebuilds the model via nnx.merge
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None: jinit)
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None: tinit)
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "0")
    rng = np.random.RandomState(0)
    prompt = np.concatenate([rng.randint(0, 11, (b, tp, 1)),
                             rng.randn(b, tp, N_MELS)], -1).astype(np.float32)
    lengths = np.asarray([tp, tp])
    det = dict(temperature=0.0, token_temperature=1e-4,
               encoder_temperature=0.0)
    want = JSampler(jm, kv_dtype=jnp.int8)(
        length, JMasked.from_lengths(jnp.asarray(prompt),
                                     jnp.asarray(lengths)),
        jax.random.PRNGKey(0), **det)
    sampler = ARTRSampler(tm, kv_dtype=torch.int8, device="cpu")
    assert sampler.route(b) == "hybrid"
    got = sampler(length, Masked.from_lengths(torch.from_numpy(prompt),
                                              lengths),
                  torch.Generator().manual_seed(0), **det)
    jf = np.array(want["frames"].value)
    tf = got["frames"].value.numpy()
    assert tf.shape == jf.shape == (b, tp + length, 1 + 4)
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg="token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")
