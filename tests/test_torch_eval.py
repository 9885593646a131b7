"""Resynthesis evaluation in the port against the JAX package on the CPU
(no kernel on this path):

  * ``inference/eval_utils.py``: the port's numpy copy gives JAX's
    results bit for bit on the same input (f0 tracking and its MSE,
    mel-cepstra and MCD, text normalisation, edit distance, WER, CER and
    the reference's ASR error rate);
  * ``core/augment.py``: the DCT basis equal, MFCC with CMVN and deltas
    at 1e-5, SpecAugment equal with JAX's draws injected;
  * ``ReconstructionEvaluator.run`` (tasks ``f0mse`` and ``mcd``) of the
    port and of JAX on the same compact checkpoint of a tiny LVTR with
    tokens (``tests/test_e2e_lvtr.py``'s) and a unit-gain vocoder, the
    diffusion start pinned and DDIM at eta 0: the same tasks scored, the
    re-vocoded ground truth to 1e-4 and the scores to 1e-3; ``wer``
    without a local ASR model is skipped with a warning;
  * the device rule."""
import copy
import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from tests.test_torch_data import write_corpus
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_torch_tts import abstract_jax_build
from vae_gslm_tpu.core import augment as jaugment
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference import eval_utils as jeval
from vae_gslm_tpu.inference import inferer as jinferer
from vae_gslm_tpu.inference.speech import reconstruction as jrecon
from vae_gslm_tpu.models.vocoder import vocoder as jvocoder_mod
from vae_gslm_tpu.nn.diffusion import GaussianDiffusion1D as JDiffusion
from vae_gslm_tpu_torch.core import augment as taugment
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference import eval_utils as teval
from vae_gslm_tpu_torch.inference.speech.reconstruction import \
    ReconstructionEvaluator
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.models.vocoder.hfgan import WNConv1d, WNConvT1d
from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
from vae_gslm_tpu_torch.nn.diffusion import GaussianDiffusion1D
from vae_gslm_tpu_torch.scripts.registry import resolve
from vae_gslm_tpu_torch.training.checkpoint import save_compact

N_MELS, SR = 20, 16000

RECON_YAML = """
identifier: "inference.speech.reconstruction.ReconstructionEvaluator"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.lvtr.LVTR"}}
tasks: [f0mse, mcd, wer]
diffusion: {{sampling_timesteps: 3, ddim_sampling_eta: 0.0}}
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 2
    num_workers: 1
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
"""


def _waves(seed: int = 0):
    """Two voiced waves (a 190 Hz and a 230 Hz tone with harmonics and
    noise) and a resynthesis-like copy of the first."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(0.5 * SR)) / SR
    out = []
    for f in (190.0, 230.0):
        w = sum(0.2 / k * np.sin(2 * np.pi * k * f * t) for k in (1, 2, 3))
        out.append((w + 0.01 * rng.randn(len(t))).astype(np.float32))
    out.append((out[0][: int(0.45 * SR)]
                + 0.02 * rng.randn(int(0.45 * SR))).astype(np.float32))
    return out


def test_f0_and_mcd_equal_jax_bit_for_bit():
    a, b, c = _waves()
    for got, want in (
            (teval.f0_autocorr(a, SR), jeval.f0_autocorr(a, SR)),
            (teval.crepe_f0(b, SR), jeval.crepe_f0(b, SR))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert teval.f0_mse(a, c, SR) == jeval.f0_mse(a, c, SR)
    assert np.isfinite(teval.f0_mse(a, c, SR))
    assert teval.mcd_wav(a, c) == jeval.mcd_wav(a, c)
    frames = np.random.RandomState(1).randn(3, 256)
    np.testing.assert_array_equal(teval.mcep(frames, 12),
                                  jeval.mcep(frames, 12))
    np.testing.assert_array_equal(teval.wav2mcep(b), jeval.wav2mcep(b))
    logmel = np.random.RandomState(2).randn(2, 30, N_MELS)
    np.testing.assert_array_equal(teval.mel_cepstrum(logmel[0]),
                                  jeval.mel_cepstrum(logmel[0]))
    assert teval.mcd(logmel[0], logmel[1]) == jeval.mcd(logmel[0],
                                                         logmel[1])


def test_text_metrics_equal_jax():
    refs = ["It's a test, isn't it?", "We'll see  the   CAT",
            "won't you come"]
    hyps = ["its a test is not it", "we will sea the cat", "will not you"]
    for r in refs:
        assert teval.normalize_text(r) == jeval.normalize_text(r)
    assert teval.edit_distance("kitten", "sitting") == \
        jeval.edit_distance("kitten", "sitting") == 3
    for fn in ("wer", "cer", "asr_error_rate"):
        assert getattr(teval, fn)(refs, hyps) == \
            getattr(jeval, fn)(refs, hyps), fn


@pytest.mark.parametrize("delta,cmvn", [(False, False), (True, True)])
def test_mfcc_matches_jax(delta, cmvn):
    rng = np.random.RandomState(3)
    mel = rng.randn(2, 17, N_MELS).astype(np.float32)
    lengths = [17, 9]
    dct = taugment.dct_matrix(N_MELS, 13)
    np.testing.assert_array_equal(dct, jaugment.dct_matrix(N_MELS, 13))
    np.testing.assert_array_equal(taugment.dct_matrix(N_MELS, 13, "none"),
                                  jaugment.dct_matrix(N_MELS, 13, "none"))
    want = jaugment.compute_mfcc(
        JMasked.from_lengths(jnp.asarray(mel), jnp.asarray(lengths)),
        jnp.asarray(dct), delta=delta, cmvn=cmvn)
    got = taugment.compute_mfcc(
        Masked.from_lengths(torch.from_numpy(mel), lengths), dct,
        delta=delta, cmvn=cmvn)
    assert got.value.shape[-1] == (39 if delta else 13)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rates", [(0.3, 0.2), (0.0, 0.5)])
def test_specaug_matches_jax_with_its_draws(rates):
    x = np.random.RandomState(4).randn(2, 11, 6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jaugment.specaug(JMasked.from_lengths(jnp.asarray(x),
                                                 jnp.asarray([11, 7])),
                            key, *rates)
    k1, k2 = jax.random.split(key)
    draws = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (2, 11))))
                  for k in (k1, k2))
    got = taugment.specaug(Masked.from_lengths(torch.from_numpy(x), [11, 7]),
                           None, *rates, draws=draws)
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    drawn = taugment.specaug(Masked.from_lengths(torch.from_numpy(x),
                                                 [11, 7]),
                             torch.Generator().manual_seed(0), *rates)
    zeroed = (drawn.value == 0).all(-1)
    assert zeroed.any() == (rates[0] > 0)


@pytest.fixture(scope="module")
def recon_dirs(tmp_path_factory):
    """Two utterances (one batch), a vocoder directory and a checkpoint of
    ``tests/test_e2e_lvtr.py``'s tiny LVTR with tokens, both written by
    the port in JAX's compact contract; the vocoder redrawn at unit gain
    (at its 0.01 init the wave is its last bias and the scores compare
    near-silence)."""
    root = tmp_path_factory.mktemp("recon")
    corpus, voc, ckpt = (str(root / n) for n in ("corpus", "voc", "ckpt"))
    for d in (corpus, ckpt):
        os.makedirs(d)
    write_corpus(corpus, [0.62, 1.04], seed=5)
    vocoder = HiFiGAN(Hparams.from_yaml(VOCODER_HP), device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for m in vocoder.model.modules():
            if isinstance(m, (WNConv1d, WNConvT1d)):
                v = rng.randn(*m.weight_v.shape) / np.sqrt(m.fan_in)
                m.weight_v.copy_(torch.from_numpy(v))
                m.weight_g.copy_(m.weight_v.square().sum(
                    dim=(1, 2), keepdim=True).sqrt())
    vocoder.save_pretrained(voc)
    hp = Hparams.from_dict(yaml.safe_load(TRAIN_HP.format(
        log_dir=corpus, vocoder_dir=voc, corpus=corpus)))
    hp.save(os.path.join(ckpt, "hp.yaml"))
    save_compact(LVTR(hp.model, input_dim=N_MELS, device="cpu",
                      generator=torch.Generator().manual_seed(1)),
                 os.path.join(ckpt, "last-cpt.npz"))
    return yaml.safe_load(RECON_YAML.format(ckpt=ckpt, corpus=corpus))


def _pin_start(monkeypatch, seed: int = 6):
    """The diffusion start noise as one numpy array in both packages."""
    start = np.random.RandomState(seed).randn(2, 64, N_MELS).astype(
        np.float32)
    jsample, tsample = JDiffusion.sample, GaussianDiffusion1D.sample

    def jpinned(self, s, cond, key, **kw):
        s = dataclasses.replace(s, value=jnp.asarray(
            start[: s.value.shape[0], : s.value.shape[1]])).apply_mask()
        return jsample(self, s, cond, key, **kw)

    def tpinned(self, s, cond, generator):
        s = dataclasses.replace(s, value=torch.from_numpy(
            start[: s.value.shape[0], : s.value.shape[1]].copy())
        ).apply_mask()
        return tsample(self, s, cond, generator)

    monkeypatch.setattr(JDiffusion, "sample", jpinned)
    monkeypatch.setattr(GaussianDiffusion1D, "sample", tpinned)


def test_reconstruction_evaluator_matches_jax(recon_dirs, monkeypatch,
                                              caplog):
    assert resolve("inference.speech.reconstruction."
                   "ReconstructionEvaluator") is ReconstructionEvaluator
    _pin_start(monkeypatch)
    # JAX's models built abstractly, their arrays all from the checkpoints
    resolve_jax = jinferer.resolve

    def abstract_model(identifier):
        holder = type("H", (), {"cls": resolve_jax(identifier)})
        abstract_jax_build(monkeypatch, holder, "cls")
        return holder.cls

    monkeypatch.setattr(jinferer, "resolve", abstract_model)
    abstract_jax_build(monkeypatch, jvocoder_mod, "Generator")
    jev = jrecon.ReconstructionEvaluator(JHparams.from_dict(
        copy.deepcopy(recon_dirs)))
    with caplog.at_level(logging.WARNING):
        tev = ReconstructionEvaluator(Hparams.from_dict(
            copy.deepcopy(recon_dirs)), device="cpu")
    assert "wer task is skipped" in caplog.text
    assert tev.asr is None
    jwaves, twaves = [], []
    jstep = jrecon.ReconstructionEvaluator.test_step

    def jrecord(self, batch, key):
        jwaves.append(np.asarray(self.vocoder.decode(batch["mel"]).value))
        return jstep(self, batch, key)

    monkeypatch.setattr(jrecon.ReconstructionEvaluator, "test_step",
                        jrecord)
    want = jev.run(seed=0)
    timings = {}
    got = tev.run(seed=0, timings=timings)
    assert timings["utterances"] == 2 and timings["model"] > 0
    # the random vocoder's waves have no voiced frame: f0mse has no score
    assert sorted(got) == sorted(want) == ["mcd"], (got, want)
    assert got["mcd"] > 1.0, got
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    # the re-vocoded ground truth that both scored against
    batch = next(iter(tev.test_dataloader()))
    gold, rec = tev.resynthesise(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(gold.value.numpy(), jwaves[0], atol=1e-4,
                               rtol=0)
    assert rec.value.shape == gold.value.shape


def test_entry_point_needs_cuda_unless_asked_for_cpu(recon_dirs,
                                                     monkeypatch):
    hp = Hparams.from_dict(copy.deepcopy(recon_dirs))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReconstructionEvaluator(hp, **kw)
    ReconstructionEvaluator(hp, device="cpu")
