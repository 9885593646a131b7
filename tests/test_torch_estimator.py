"""The port's checkpoint contract and ``LikelihoodEstimator`` against the
JAX package's.

  * compact checkpoints both ways: a JAX ``save_compact`` npz loads into
    the port (``load_compact``) and the port's npz into JAX, for the
    LVTR (likelihoods agree to rtol/atol 1e-5: the same weights, float32
    in another order) and the HiFi-GAN generator through
    ``from_pretrained``/``save_pretrained`` (waves to 1e-5); the map is
    strict (a missing or extra key, or a changed ALiBi slope, raises);
  * ``LikelihoodEstimator(hp, device="cpu").run()`` against the JAX
    estimator on one synthetic corpus and checkpoint directory, built as
    ``tests/test_e2e_lvtr.py`` builds them, with the initial AR state
    pinned on both sides: scores to rtol/atol 1e-3 (the log-mels agree
    to 1e-3, not bit for bit, and feed the whole model);
  * the registry resolves inside the port only; the DiscreteAR type
    raises over a checkpoint that names no ``hubert.path`` codec.
All on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from tests.test_torch_data import write_corpus
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.models.vocoder.vocoder import HiFiGAN as JHiFiGAN
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.likelihood import \
    LikelihoodEstimator
from vae_gslm_tpu_torch.models.convert import load_flat, to_flat
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
from vae_gslm_tpu_torch.scripts.registry import resolve
from vae_gslm_tpu_torch.training import checkpoint

N_MELS = 20


def _model_hp(tmp):
    return TRAIN_HP.format(log_dir=tmp, vocoder_dir=tmp, corpus=tmp)


def _pin(jm, tm, init):
    jm.initial_state = lambda key, bsize, nfeat=None: jnp.asarray(
        init[:bsize])
    tm.initial_state = (lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init[:bsize]))


def _likelihoods(jm, tm, seed=0):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randint(0, 32, (2, 30, 1)),
                        rng.randn(2, 30, N_MELS)], -1).astype(np.float32)
    ln = np.asarray([30, 17], np.int32)
    _pin(jm, tm, (rng.rand(2, 1, 8) * 2 - 1).astype(np.float32))
    want = np.asarray(jm.likelihood(JMasked.from_lengths(
        jnp.asarray(x), jnp.asarray(ln)), jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = tm.likelihood(Masked.from_lengths(torch.from_numpy(x), ln),
                            None).numpy()
    return got, want


def test_compact_checkpoint_jax_to_port_and_back(tmp_path):
    hp = _model_hp(tmp_path)
    jm = JLVTR(JHparams.from_yaml(hp).model, input_dim=N_MELS,
               rngs=nnx.Rngs(3))
    path = str(tmp_path / "jax-cpt.npz")
    jckpt.save_compact(jm, path)
    tm = LVTR(Hparams.from_yaml(hp).model, input_dim=N_MELS, device="cpu")
    checkpoint.load_compact(tm, path)
    got, want = _likelihoods(jm, tm)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the port's npz into a fresh JAX model: every key, the parameters
    # bit for bit, the recomputed variables (sin/cos tables, schedules)
    # to 1e-6, same outputs
    back = str(tmp_path / "port-cpt.npz")
    checkpoint.save_compact(tm, back)
    variables = ("transformer/rpe/slopes", "decoder/schedule",
                 "decoder/model/time_embedding/embedding/p")
    with np.load(path) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=1e-6 if k in variables else 0,
                                       err_msg=k)
    jm2 = JLVTR(JHparams.from_yaml(hp).model, input_dim=N_MELS,
                rngs=nnx.Rngs(4))
    jckpt.load_compact(jm2, back)
    _, want2 = _likelihoods(jm2, tm)
    np.testing.assert_allclose(want2, want, rtol=0, atol=0)


def test_compact_checkpoint_is_strict(tmp_path):
    tm = LVTR(Hparams.from_yaml(_model_hp(tmp_path)).model,
              input_dim=N_MELS, device="cpu")
    flat = to_flat(tm)
    assert "transformer/rpe/slopes" in flat and "decoder/schedule" in flat
    for change in ("missing", "extra", "slopes"):
        bad = dict(flat)
        if change == "missing":
            del bad["q_spliter/dense/kernel"]
        elif change == "extra":
            bad["q_spliter/dense/scale"] = np.ones(3, np.float32)
        else:
            bad["transformer/rpe/slopes"] = bad["transformer/rpe/slopes"] * 2
        with pytest.raises((KeyError, ValueError)):
            load_flat(tm, bad)


def test_vocoder_checkpoint_both_ways(tmp_path):
    jvoc = JHiFiGAN(JHparams.from_yaml(VOCODER_HP), rngs=nnx.Rngs(0))
    jdir = str(tmp_path / "jax_voc")
    jvoc.save_pretrained(jdir)
    voc = HiFiGAN.from_pretrained(jdir, device="cpu")
    assert voc.hp.n_mels == N_MELS
    jback = JHiFiGAN.from_pretrained(jdir)
    rng = np.random.RandomState(5)
    mel = rng.randn(2, 9, N_MELS).astype(np.float32)
    ln = np.asarray([9, 6], np.int32)
    want = jback.decode(JMasked.from_lengths(jnp.asarray(mel),
                                             jnp.asarray(ln)))
    got = voc.decode(Masked.from_lengths(torch.from_numpy(mel), ln))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-5)
    pdir = str(tmp_path / "port_voc")
    voc.save_pretrained(pdir)
    again = JHiFiGAN.from_pretrained(pdir).decode(JMasked.from_lengths(
        jnp.asarray(mel), jnp.asarray(ln)))
    np.testing.assert_allclose(np.asarray(again.value),
                               np.asarray(want.value), rtol=1e-5, atol=1e-5)


INFER_YAML = """
identifier: "inference.speech.likelihood.LikelihoodEstimator"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.lvtr.LVTR"}}
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 2
    num_workers: 2
    min_audio_length: 0.5
    bits_per_second: 32000
    pad: {{multiple_of: 320, mode: "constant"}}
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
"""


@pytest.fixture(scope="module")
def scoring_dirs(tmp_path_factory):
    """A corpus of five utterances (one under ``min_audio_length``), a
    vocoder directory and a checkpoint directory with a JAX compact
    checkpoint of the e2e LVTR config."""
    root = tmp_path_factory.mktemp("scoring")
    corpus, voc, ckpt = (str(root / n) for n in ("corpus", "voc", "ckpt"))
    for d in (corpus, ckpt):
        os.makedirs(d)
    write_corpus(corpus, [0.62, 1.04, 0.3, 0.86, 0.5013], seed=3)
    JHiFiGAN(JHparams.from_yaml(VOCODER_HP),
             rngs=nnx.Rngs(0)).save_pretrained(voc)
    hp = JHparams.from_yaml(TRAIN_HP.format(log_dir=root, vocoder_dir=voc,
                                            corpus=corpus))
    hp.save(os.path.join(ckpt, "hp.yaml"))
    jckpt.save_compact(JLVTR(hp.model, input_dim=N_MELS, rngs=nnx.Rngs(1)),
                       os.path.join(ckpt, "last-cpt.npz"))
    return corpus, ckpt


def test_estimator_matches_jax(scoring_dirs):
    from vae_gslm_tpu.inference.speech.likelihood import \
        LikelihoodEstimator as JEstimator

    corpus, ckpt = scoring_dirs
    cfg = INFER_YAML.format(ckpt=ckpt, corpus=corpus)
    jest = JEstimator(JHparams.from_yaml(cfg))
    est = LikelihoodEstimator(Hparams.from_yaml(cfg), device="cpu")
    init = (np.random.RandomState(9).rand(2, 1, 8) * 2 - 1).astype(
        np.float32)
    _pin(jest.model, est.model, init)
    want = jest.run(seed=0)
    timings = {}
    got = est.run(seed=0, timings=timings)
    assert got.shape == want.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert np.isfinite(got).all() and (got <= 0).all()
    assert timings["batches"] == 2 and timings["model"] > 0
    assert est.run(seed=0, max_batches=1).shape == (2,)


def test_estimator_reads_a_torch_checkpoint(scoring_dirs, tmp_path):
    """A reference torch ``last-cpt.ckpt`` (the released artifacts'
    form) loads through ``load_reference_lvtr``."""
    from vae_gslm_tpu.models.convert_torch import export_torch_lvtr

    corpus, ckpt = scoring_dirs
    hp = JHparams.from_yamlfile(os.path.join(ckpt, "hp.yaml"))
    jm = JLVTR(hp.model, input_dim=N_MELS, rngs=nnx.Rngs(1))
    tdir = tmp_path / "torch_ckpt"
    tdir.mkdir()
    hp.save(str(tdir / "hp.yaml"))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in export_torch_lvtr(jm).items()}},
               str(tdir / "last-cpt.ckpt"))
    a = LikelihoodEstimator(Hparams.from_yaml(
        INFER_YAML.format(ckpt=ckpt, corpus=corpus)), device="cpu")
    b = LikelihoodEstimator(Hparams.from_yaml(
        INFER_YAML.format(ckpt=tdir, corpus=corpus)), device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_registry_resolves_inside_the_port():
    assert resolve("models.speech.lvtr.LVTR") is LVTR
    assert resolve("inference.speech.likelihood.LikelihoodEstimator") \
        is LikelihoodEstimator
    with pytest.raises(ImportError):
        resolve("vae_gslm_tpu.models.speech.lvtr.LVTR")
    with pytest.raises(ImportError):
        resolve("models.speech.lvtr.NoSuchModel")


def test_discrete_ar_raises(scoring_dirs):
    corpus, ckpt = scoring_dirs
    hp = Hparams.from_yaml(INFER_YAML.format(ckpt=ckpt, corpus=corpus))
    hp.model.identifier = "models.speech.discrete.DiscreteAR"
    with pytest.raises(ValueError, match="path not specified"):
        LikelihoodEstimator(hp, device="cpu")


@pytest.mark.parametrize("builder", ["melspec", "vocoder", "estimator"])
def test_scoring_entry_points_need_cuda_unless_asked_for_cpu(
        monkeypatch, scoring_dirs, builder):
    from vae_gslm_tpu_torch.data.features import MelSpecFeatureProcessor

    corpus, ckpt = scoring_dirs
    hp = Hparams.from_yamlfile(os.path.join(ckpt, "hp.yaml"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "melspec": lambda **kw: MelSpecFeatureProcessor(
            Hparams.from_yaml(VOCODER_HP).feature, **kw),
        "vocoder": lambda **kw: HiFiGAN.from_pretrained(hp.vocoder.path,
                                                        **kw),
        "estimator": lambda **kw: LikelihoodEstimator(Hparams.from_yaml(
            INFER_YAML.format(ckpt=ckpt, corpus=corpus)), **kw),
    }[builder]
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(**kw)
    built = build(device="cpu")
    if builder == "vocoder":
        assert {p.device.type for p in built.model.parameters()} == {"cpu"}
    else:
        assert built.device == torch.device("cpu")
