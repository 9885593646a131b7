"""The speech-continuation CLI path against the JAX package, on the CPU.

  * ``SpeechInferer.run(max_batches=1)`` of the port and of JAX on the
    same JAX-written directories: a checkpoint (``hp.yaml`` +
    ``save_compact``) of a tiny LVTR with tokens and an utterance encoder
    whose trunk K2 can take (dim 256, 4 heads of 64; the infer config's
    ``weight_dtype: int8`` puts it on the mega path, the Pallas kernel in
    interpret mode on the JAX side), a vocoder directory, and WAVs with a
    tokens file.  Deterministic protocol of
    ``tests/test_torch_lvtr_sampler.py`` (temperature 0, token temperature
    1e-4, encoder temperature 0, the initial AR state and the diffusion
    start noise pinned to one numpy array each, DDIM at eta 0): the same
    WAVs with the same lengths after the energy-VAD trim, equal
    continuation tokens, latents to the a8 band of
    ``tests/test_torch_mega_sampler.py`` (atol 1e-2: every dense input is
    requantized to int8, so a last-bit difference of the log-mels, which
    agree to 1e-3, can move one int8 step), the decoded mels to the same
    atol 1e-2 (the latent differences pass through DDIM, scaled by the
    input scale 5) and the 16-bit waves to atol 2e-3;
  * ``energy_vad_segments`` and ``vad_trim`` equal JAX's; the pyannote
    branch against a stub package; without pyannote an ``auth_token``
    falls back to the energy VAD with a warning; the DiscreteAR type
    raises over a checkpoint that names no ``hubert.path`` codec;
  * ``scripts.infer.main`` (with ``-v`` on an ``exp_dir`` layout, and
    without) writes the files ``SpeechInferer.run`` writes;
    ``scripts.preprocess_mels.main`` writes JAX's ``.npy`` tree to the
    log-mel tolerance of ``tests/test_torch_data.py`` (1e-3);
  * entry points raise without CUDA unless asked for the CPU."""
import copy
import dataclasses
import logging
import os
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from tests.test_torch_data import write_corpus
from tests.test_torch_train_step import UTTERANCE
from tests.test_vad import _wave_with_gaps, fake_pyannote  # noqa: F401
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech import inferer as jinferer
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.models.vocoder.vocoder import HiFiGAN as JHiFiGAN
from vae_gslm_tpu.nn.diffusion import GaussianDiffusion1D as JDiffusion
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu_torch.data import audio
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech import inferer as tinferer
from vae_gslm_tpu_torch.inference.speech.inferer import SpeechInferer
from vae_gslm_tpu_torch.nn.diffusion import GaussianDiffusion1D
from vae_gslm_tpu_torch.scripts import infer as infer_cli
from vae_gslm_tpu_torch.scripts import preprocess_mels

N_MELS, SR = 20, 16000
B, TP, LENGTH = 2, 10, 20           # 0.2 s prompt, 0.4 s continuation

INFER_YAML = """
identifier: "inference.speech.inferer.SpeechInferer"
precision: "32"
output_dir: "{out}"
ckpt_path: "{ckpt}"
exp_dir: "{exp}"
model: {{identifier: "models.speech.lvtr.LVTR"}}
vocoder: {{path: "{voc}"}}
sample_prior_length: 0.2
sample_length: 0.4
temperature: 0.0
token_temperature: 1.0e-4
encoder_temperature: 0.0
diffusion: {{sampling_timesteps: 3, ddim_sampling_eta: 0.0}}
kv_cache_dtype: "int8"
weight_dtype: "int8"
data_parallel: false
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 2
    num_workers: 1
    min_audio_length: 0.5
    bits_per_second: 32000
    pad: {{multiple_of: 320, mode: "constant"}}
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
vad: {{auth_token: null}}
"""


def _model_cfg(voc, corpus):
    """``tests/test_e2e_lvtr.py``'s LVTR with an utterance encoder and a
    trunk K2 can take once quantized."""
    d = yaml.safe_load(TRAIN_HP.format(log_dir=corpus, vocoder_dir=voc,
                                       corpus=corpus))
    d["model"]["utterance_encoder"] = copy.deepcopy(UTTERANCE)
    tr = d["model"]["transformer"]
    tr["layer"].update(dim=256, ffd_size=1024)
    tr["layer"]["self_attn"]["nheads"] = 4
    tr["rpe"]["maxpos"] = 512
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A corpus of four utterances, a JAX vocoder directory and a JAX
    checkpoint directory; an ``exp_dir`` whose version 0 holds an older
    and the newest checkpoint."""
    root = tmp_path_factory.mktemp("infer")
    corpus, voc, ckpt, exp = (str(root / n)
                              for n in ("corpus", "voc", "ckpt", "exp"))
    for d in (corpus, ckpt):
        os.makedirs(d)
    write_corpus(corpus, [0.62, 1.04, 0.86, 0.3], seed=3)
    JHiFiGAN(JHparams.from_yaml(VOCODER_HP),
             rngs=nnx.Rngs(0)).save_pretrained(voc)
    hp = JHparams.from_dict(_model_cfg(voc, corpus))
    hp.save(os.path.join(ckpt, "hp.yaml"))
    jckpt.save_compact(JLVTR(hp.model, input_dim=N_MELS, rngs=nnx.Rngs(1)),
                       os.path.join(ckpt, "last-cpt.npz"))
    version = os.path.join(exp, "ckpt", "version_0")
    os.makedirs(version)
    shutil.copy(os.path.join(ckpt, "last-cpt.npz"),
                os.path.join(version, "step=12-cpt.npz"))
    jckpt.save_compact(JLVTR(hp.model, input_dim=N_MELS, rngs=nnx.Rngs(2)),
                       os.path.join(version, "step=4-cpt.npz"))
    hp.save(os.path.join(version, "hp.yaml"))
    return {"root": str(root), "corpus": corpus, "voc": voc, "ckpt": ckpt,
            "exp": exp}


def _config(dirs, out, **changes):
    d = yaml.safe_load(INFER_YAML.format(out=out, **{
        k: dirs[k] for k in ("ckpt", "exp", "voc", "corpus")}))
    d.update(changes)
    path = os.path.join(dirs["root"], f"{os.path.basename(out)}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


class _Recorder:
    """Stands in for an inferer's sampler and keeps each output."""

    def __init__(self, inner):
        self.inner, self.outputs = inner, []

    def __call__(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        self.outputs.append(out)
        return out


def _pin(monkeypatch):
    """The initial AR state and the diffusion start noise as numpy arrays,
    in both packages."""
    rng = np.random.RandomState(5)
    init = (rng.rand(B, 1, 8) * 2 - 1).astype(np.float32)
    start = rng.randn(B, TP + LENGTH, N_MELS).astype(np.float32)
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None:
                        jnp.asarray(init[:bsize]))
    jsample, tsample = JDiffusion.sample, GaussianDiffusion1D.sample

    def jpinned(self, s, cond, key, **kw):
        s = dataclasses.replace(s, value=jnp.asarray(
            start[:, :s.value.shape[1]])).apply_mask()
        return jsample(self, s, cond, key, **kw)

    def tpinned(self, s, cond, generator):
        s = dataclasses.replace(s, value=torch.from_numpy(
            start[:, :s.value.shape[1]].copy())).apply_mask()
        return tsample(self, s, cond, generator)

    monkeypatch.setattr(JDiffusion, "sample", jpinned)
    monkeypatch.setattr(GaussianDiffusion1D, "sample", tpinned)
    return init


def _wavs(out):
    names = sorted(os.listdir(out))
    return names, [audio.load_audio(os.path.join(out, n)) for n in names]


def test_speech_inferer_matches_jax(monkeypatch, dirs):
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    init = _pin(monkeypatch)
    jout, tout = (os.path.join(dirs["root"], n)
                  for n in ("jax_out", "port_out"))
    jinf = jinferer.SpeechInferer(JHparams.from_yamlfile(
        _config(dirs, jout)))
    tinf = SpeechInferer(Hparams.from_yamlfile(_config(dirs, tout)),
                         device="cpu")
    assert tinf.sampler.use_mega and tinf.use_tokens and tinf.use_vad
    assert tinf.model.utterance_net is not None
    tinf.model.initial_state = (lambda generator, bsize, nfeat=None:
                                torch.from_numpy(init[:bsize]))
    jinf.sampler, tinf.sampler = (_Recorder(jinf.sampler),
                                  _Recorder(tinf.sampler))
    timings = {}
    assert jinf.run(max_batches=1) == B
    assert tinf.run(max_batches=1, timings=timings) == B
    assert sorted(timings) == ["ar_loop", "data", "diffusion",
                               "encode_prefill", "vocoder", "write"]

    (jf,), (tf,) = ([np.array(o["frames"].value) for o in r.outputs]
                    for r in (jinf.sampler, tinf.sampler))
    (jm,), (tm,) = ([np.array(o["output"].value) for o in r.outputs]
                    for r in (jinf.sampler, tinf.sampler))
    assert tf.shape == jf.shape == (B, TP + LENGTH, 1 + 4)
    np.testing.assert_array_equal(tf[:, TP:, 0], jf[:, TP:, 0],
                                  err_msg="continuation tokens")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=1e-2,
                               rtol=1e-2, err_msg="latents")
    np.testing.assert_allclose(tm, jm, atol=1e-2, rtol=0, err_msg="mel")
    (jnames, jwaves), (tnames, twaves) = _wavs(jout), _wavs(tout)
    assert tnames == jnames == ["1.wav", "2.wav"]
    for (tw, tsr), (jw, jsr) in zip(twaves, jwaves):
        assert tsr == jsr == SR
        assert len(tw) == len(jw) > 0
        np.testing.assert_allclose(tw, jw, atol=2e-3, err_msg="wave")


def test_energy_vad_and_trim_match_jax():
    rng = np.random.RandomState(0)
    waves = [_wave_with_gaps(), np.zeros(100, np.float32),
             (rng.randn(SR) * 0.1 * (rng.rand(SR) > 0.5)).astype(np.float32),
             np.concatenate([_wave_with_gaps(), np.zeros(SR // 10),
                             _wave_with_gaps()[: SR * 2]])]
    for wave in waves:
        segs = tinferer.energy_vad_segments(wave, SR)
        assert segs == jinferer.energy_vad_segments(wave, SR)
        np.testing.assert_array_equal(tinferer.vad_trim(wave, SR, segs),
                                      jinferer.vad_trim(wave, SR, segs))
    wave = _wave_with_gaps()
    for segs in ([[0.0, 1.0], [1.5, 1.8]], [[0.0, 1.8]], [[1.5, 1.8]], []):
        np.testing.assert_array_equal(tinferer.vad_trim(wave, SR, segs),
                                      jinferer.vad_trim(wave, SR, segs))


def test_pyannote_branch(fake_pyannote):  # noqa: F811
    pipe = tinferer.build_pyannote_vad("hf_token")
    assert pipe is not None
    assert fake_pyannote["model"] == ("pyannote/segmentation-3.0",
                                      "hf_token")
    assert fake_pyannote["params"] == {"min_duration_on": 0.0,
                                       "min_duration_off": 0.0}
    holder = types.SimpleNamespace(vad_pipeline=pipe)
    wave = _wave_with_gaps()
    segs = SpeechInferer._segments(holder, wave, SR)
    assert fake_pyannote["wav_len"] == len(wave)
    assert segs == jinferer.SpeechInferer._segments(holder, wave, SR)
    assert len(tinferer.vad_trim(wave, SR, segs)) < len(wave)


def test_auth_token_without_pyannote_takes_energy_vad(dirs, caplog):
    assert "pyannote" not in sys.modules
    assert tinferer.build_pyannote_vad("tok") is None
    cfg = _config(dirs, os.path.join(dirs["root"], "tok_out"),
                  vad={"auth_token": "tok"})
    with caplog.at_level(logging.WARNING):
        inf = SpeechInferer(Hparams.from_yamlfile(cfg), device="cpu")
    assert inf.use_vad and inf.vad_pipeline is None
    assert "pyannote unavailable; using energy VAD" in caplog.text
    wave = _wave_with_gaps()
    assert inf._segments(wave, SR) == tinferer.energy_vad_segments(wave, SR)


def test_discrete_ar_raises(dirs):
    hp = Hparams.from_yamlfile(_config(dirs, os.path.join(dirs["root"],
                                                          "discrete_out")))
    hp.model.identifier = "models.speech.discrete.DiscreteAR"
    with pytest.raises(ValueError, match="path not specified"):
        SpeechInferer(hp, device="cpu")


def _files(out):
    names = sorted(os.listdir(out))
    return names, [open(os.path.join(out, n), "rb").read() for n in names]


@pytest.mark.parametrize("version", [False, True])
def test_cli_writes_what_the_inferer_writes(dirs, version):
    """``-v 0`` copies version 0's newest checkpoint (step 12, the one in
    ``ckpt_path``; step 4 holds other weights) into a temporary directory
    that is gone afterwards."""
    tag = "v" if version else "c"
    out_run, out_cli = (os.path.join(dirs["root"], f"{tag}_{n}")
                        for n in ("run", "cli"))
    inf = SpeechInferer(Hparams.from_yamlfile(_config(dirs, out_run)),
                        device="cpu")
    assert inf.run(seed=3, max_batches=1) == B
    argv = ["-c", _config(dirs, out_cli, ckpt_path="/nonexistent")
            if version else _config(dirs, out_cli),
            "--max_batches", "1", "--seed", "3", "--device", "cpu"]
    if version:
        argv += ["-v", "0"]
    assert infer_cli.main(argv) == B
    assert _files(out_cli) == _files(out_run)
    assert len(_files(out_cli)[0]) == B


def test_preprocess_mels_matches_jax(dirs, monkeypatch, tmp_path):
    """A two-level WAV tree; the port's ``.npy`` tree mirrors it as JAX's
    does, with the same mels to 1e-3."""
    from vae_gslm_tpu.scripts import preprocess_mels as jpre

    wavdir = tmp_path / "wavs"
    lines = []
    for i, sub in enumerate(("a", "b/c", "b")):
        (wavdir / sub).mkdir(parents=True, exist_ok=True)
        n = int(SR * (0.5 + 0.2 * i))
        wave = (0.2 * np.sin(2 * np.pi * (200 + 50 * i)
                             * np.arange(n) / SR)).astype(np.float32)
        audio.save_wav(str(wavdir / sub / f"u{i}.wav"), wave, SR)
        lines.append(f"{sub}/u{i}.wav|{' '.join(['1'] * (n // 320))}")
    (wavdir / "tokens.txt").write_text("\n".join(lines) + "\n")
    cfg = yaml.safe_load(VOCODER_HP)
    cfg["data"] = {"path": str(wavdir / "tokens.txt"), "wavdir": str(wavdir),
                   "sample_rate": SR, "with_text": False,
                   "with_tokens": True}
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(cfg))
    jdir, tdir = tmp_path / "jax_mels", tmp_path / "port_mels"
    monkeypatch.setattr(sys, "argv", ["preprocess_mels", "-c", str(path),
                                      "-o", str(jdir)])
    jpre.main()
    assert preprocess_mels.main(["-c", str(path), "-o", str(tdir),
                                 "--device", "cpu"]) == 3
    jfiles = sorted(p.relative_to(jdir) for p in jdir.rglob("*.npy"))
    tfiles = sorted(p.relative_to(tdir) for p in tdir.rglob("*.npy"))
    assert [str(p) for p in tfiles] == ["a/u0.npy", "b/c/u1.npy", "b/u2.npy"]
    assert tfiles == jfiles
    for rel in tfiles:
        got, want = np.load(tdir / rel), np.load(jdir / rel)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_cli_path_needs_cuda_unless_asked_for_cpu(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(dirs, os.path.join(dirs["root"], "cuda_out"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeechInferer(Hparams.from_yamlfile(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_cli.main(["-c", cfg, "--max_batches", "1"])
