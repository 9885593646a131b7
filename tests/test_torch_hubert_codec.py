"""The HuBERT token -> mel codec, the two trainers of the token-LM
baseline, the token dataset's dedup and f0, and the token LM's inferer
and estimator against the JAX package, float32 on the CPU:

  * ``length_regulate`` and ``interpolate_linear`` equal JAX's;
  * ``HuBERT`` (plain; dedup with a speaker encoder; f0 with its
    condition interpolated to mels at twice the token rate): the training
    loss on JAX's draws, the condition and the duration prediction
    (rtol/atol 1e-5), ``encode``, and ``decode`` by DDIM at eta 0 from a
    shared start (1e-4);
  * ``HuBERTIO.from_pretrained`` from JAX's compact npz and from JAX's
    ``export_torch_hubert_decoder`` saved as a torch checkpoint (read by
    ``load_reference_hubert_decoder``): the same weights (the recomputed
    position tables to 1e-6), and the same wave from a shared mel;
  * one step of ``DiscreteARTrainer`` and of ``HuBERTDecoderTrainer``
    (dedup) against JAX's loss function: the metrics (rtol 1e-5) and
    every gradient within 1e-5 x the largest |g| of the model, on JAX's
    weights and JAX's diffusion draws; ``fit`` with validation, and both
    resumes;
  * ``DiscreteTokenDataset`` with dedup, f0 and a token crop: each item
    equal to JAX's (mels to 5e-3);
  * the token LM ``SpeechInferer`` (and ``inference/speech/hubert.py``,
    which also writes ``{n}_ov.wav``) end to end on a tiny corpus, and
    ``LikelihoodEstimator``'s scores against JAX's (rtol 1e-4)."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_lvtr_options import fill_jax
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_trainers import (HUBERT_MODEL_HP, _discrete_hp,  # noqa: F401
                                 corpus, hubert_codec_dir, vocoder_dir)
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.data import dataset as jdataset
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech.likelihood import \
    LikelihoodEstimator as JEstimator
from vae_gslm_tpu.models.convert_torch import export_torch_hubert_decoder
from vae_gslm_tpu.models.speech.discrete import DiscreteAR as JDiscreteAR
from vae_gslm_tpu.models.vocoder import hubert as jhubert
from vae_gslm_tpu.models.vocoder.vocoder import HuBERTIO as JHuBERTIO
from vae_gslm_tpu.trainers.speech.discrete import \
    DiscreteARTrainer as JDiscreteARTrainer
from vae_gslm_tpu.trainers.vocoder.hubert import \
    HuBERTDecoderTrainer as JHuBERTTrainer
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.data import audio as audio_lib
from vae_gslm_tpu_torch.data import dataset
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech import hubert as thubert_inferer
from vae_gslm_tpu_torch.inference.speech.inferer import SpeechInferer
from vae_gslm_tpu_torch.inference.speech.likelihood import \
    LikelihoodEstimator
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.vocoder import hubert as thubert
from vae_gslm_tpu_torch.models.vocoder.vocoder import HuBERTIO
from vae_gslm_tpu_torch.trainers.speech.discrete import DiscreteARTrainer
from vae_gslm_tpu_torch.trainers.vocoder.hubert import HuBERTDecoderTrainer

N_MELS, B, T, SR = 20, 2, 12, 16000
RESNET = {"num_layers": 1,
          "layer": {"in_channels": 8, "hidden_channels": 16,
                    "kernel_size": 3, "causal_padding": True,
                    "norm": {"identifier": "InstanceNorm", "eps": 1e-6},
                    "activation": {"identifier": "ReLU"}}}
SPKR = {"embedding_dim": 4, "num_layers": 2, "init_channel": 8,
        "out_channels": [8, 8], "resample_rates": [1, 1],
        "resample_ksize": [3, 3],
        "layer": {"norm": {"identifier": "InstanceNorm", "eps": 1e-6},
                  "activation": {"identifier": "ReLU"}}}
KINDS = ("plain", "dedup_spkr", "f0")


def hubert_hp(kind: str) -> dict:
    d = yaml.safe_load(HUBERT_MODEL_HP)
    d["decoder"]["diffusion"]["ddim_sampling_eta"] = 0.0
    if kind == "dedup_spkr":
        d["hubert"]["deduplicate"] = True
        d["duration_predictor"] = copy.deepcopy(RESNET)
        d["spkr"] = copy.deepcopy(SPKR)
    elif kind == "f0":
        d["f0"] = True
        d["interpolate_ratio"] = 2.0
    return d


def mel_ratio(kind: str) -> int:
    """Mel frames per token: the f0 kind interpolates its condition to
    mels at twice the token rate."""
    return 2 if kind == "f0" else 1


def hubert_pair(kind: str, seed: int = 0):
    d = hubert_hp(kind)
    rate = 50.0 * mel_ratio(kind)
    tm = thubert.HuBERT(Hparams.from_dict(copy.deepcopy(d)), N_MELS, rate,
                        device="cpu")
    jm = fill_jax(lambda: jhubert.HuBERT(JHparams.from_dict(copy.deepcopy(d)),
                                         N_MELS, rate, rngs=nnx.Rngs(0)),
                  tm, seed)
    convert.load_flat(tm, _flatten_state(nnx.state(jm)))
    return jm, tm


def _both(x, lengths):
    return (JMasked.from_lengths(jnp.asarray(x), jnp.asarray(lengths)),
            Masked.from_lengths(torch.from_numpy(x), lengths))


def _jitted(jm, fn):
    """``fn(module, *args)`` on the JAX module, jitted (eager JAX compiles
    every op and takes several times as long)."""
    graphdef, state = nnx.split(jm)
    run = jax.jit(lambda state, *args: fn(nnx.merge(graphdef, state), *args))
    return lambda *args: run(state, *args)


def _close(got, want, tol=1e-5, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=err_msg)


def test_length_regulate_and_interpolate_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4).astype(np.float32)
    dur = rng.randint(0, 4, (3, 5))
    dur[2] = 0
    regulate = jax.jit(jhubert.length_regulate, static_argnums=2)
    for max_len in (6, 20):
        want = regulate(jnp.asarray(x), jnp.asarray(dur), max_len)
        got = thubert.length_regulate(torch.from_numpy(x),
                                      torch.from_numpy(dur), max_len)
        np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
        _close(got.value, want.value, 0.0)
    y = rng.randn(2, 7, 3).astype(np.float32)
    for ratio in (2.0, 0.5, 1.5):
        jy, ty = _both(y, [7, 4])
        want = jax.jit(jhubert.interpolate_linear, static_argnums=1)(
            jy, ratio)
        got = thubert.interpolate_linear(ty, ratio)
        np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
        _close(got.value, want.value, 1e-6)


def _hubert_inputs(kind, seed=1):
    rng = np.random.RandomState(seed)
    lengths = [T, 9]
    toks = rng.randint(0, 32, (B, T))
    if kind == "dedup_spkr":
        toks[:, 1::2] = toks[:, ::2]         # runs to deduplicate
    r = mel_ratio(kind)
    ins = {"x": (toks, lengths),
           "x_mel": (rng.randn(B, T * r, N_MELS).astype(np.float32),
                     [n * r for n in lengths])}
    if kind == "dedup_spkr":
        ins["spkr"] = (rng.randn(B, 8, N_MELS).astype(np.float32), [8, 5])
        ins["dedup_x"] = (toks[:, ::2].copy(), [T // 2, 5])
    if kind == "f0":
        ins["f0"] = (rng.randn(B, T).astype(np.float32), lengths)
    return {k: _both(*v) for k, v in ins.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_hubert_forward_encode_decode_match_jax(kind):
    jm, tm = hubert_pair(kind, KINDS.index(kind))
    ins = _hubert_inputs(kind)
    key = jax.random.PRNGKey(4)
    names = sorted(ins)
    want = _jitted(jm, lambda m, key, *a: m(key=key, **dict(zip(names, a))))(
        key, *(ins[k][0] for k in names))
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (B,), 0, 8))
    noise = np.array(jax.random.normal(kn, (B, T * mel_ratio(kind), N_MELS),
                                       jnp.float32))
    got = tm(generator=None, t=torch.from_numpy(t),
             noise=torch.from_numpy(noise),
             **{k: v[1] for k, v in ins.items()})
    _close(got["diffusion_loss"], want["diffusion_loss"])
    _close(got["condition"].value, want["condition"].value)
    np.testing.assert_array_equal(got["condition"].lengths.numpy(),
                                  want["condition"].lengths)
    if kind == "dedup_spkr":
        _close(got["duration_prediction"].value,
               want["duration_prediction"].value)
    enc_in = {"spkr": "spkr", "f0": "f0"}
    x_key = "dedup_x" if kind == "dedup_spkr" else "x"
    aux = [a for a, k in enc_in.items() if k in ins]
    jc = _jitted(jm, lambda m, x, *a: m.encode(x, **dict(zip(aux, a))))(
        ins[x_key][0], *(ins[a][0] for a in aux))
    tc = tm.encode(ins[x_key][1], **{a: ins[k][1] for a, k in enc_in.items()
                                     if k in ins})
    _close(tc.value, jc.value)
    np.testing.assert_array_equal(tc.lengths.numpy(), jc.lengths)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(5))
    want = _jitted(jm, lambda m, c, k: m.decode(c, k))(jc,
                                                      jax.random.PRNGKey(5))
    intr = float(jm.interpolate_ratio or 1.0)
    out_len = int(jc.value.shape[1] / intr * jm.sample_ratio)
    start = np.array(jax.random.normal(k_noise, (B, out_len, N_MELS),
                                       jnp.float32))
    start_m = Masked.from_lengths(torch.from_numpy(start), torch.ceil(
        tc.lengths.float() * tm.sample_ratio).int()).apply_mask()
    got = tm.decode(tc, None, start=start_m)
    _close(got.value, want.value, 1e-4)
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)


def _codec_dir(root, vocoder_dir, kind="dedup_spkr"):
    hp = JHparams(model=hubert_hp(kind), vocoder={"path": str(vocoder_dir)})
    codec = JHuBERTIO(hp, rngs=nnx.Rngs(3))
    codec.save_pretrained(str(root))
    return codec


def test_hubert_io_from_pretrained_both_formats(tmp_path, vocoder_dir):
    """The compact npz and the reference torch checkpoint give JAX's
    weights, and the codec's vocoder JAX's wave from one mel."""
    jcodec = _codec_dir(tmp_path / "npz", vocoder_dir)
    want = _flatten_state(nnx.state(jcodec.model))
    ref = tmp_path / "ckpt"
    ref.mkdir()
    (ref / "hp.yaml").write_text((tmp_path / "npz" / "hp.yaml").read_text())
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                               export_torch_hubert_decoder(
                                   jcodec.model).items()}},
               str(ref / "last-cpt.ckpt"))
    for d in (tmp_path / "npz", ref):
        codec = HuBERTIO.from_pretrained(str(d), device="cpu")
        flat = convert.to_flat(codec.model)
        assert sorted(flat) == sorted(want)
        for k in want:       # the recomputed tables to float32 rounding
            np.testing.assert_allclose(flat[k], np.asarray(want[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        assert codec.hp_vq.codebook_size == 32 and codec.sample_ratio == 1.0
    mel = np.random.RandomState(0).randn(1, 10, N_MELS).astype(np.float32)
    jw = jcodec.vocoder.decode(JMasked.from_lengths(jnp.asarray(mel),
                                                    jnp.asarray([10])))
    tw = codec.vocoder.decode(Masked.from_lengths(torch.from_numpy(mel),
                                                  [10]))
    _close(tw.value, jw.value, 1e-4)
    toks = Masked.from_lengths(torch.randint(0, 32, (1, 6)), [6])
    spkr = Masked.from_lengths(torch.randn(1, 8, N_MELS), [8])
    wave = codec.decode(toks, torch.Generator().manual_seed(0), spkr=spkr)
    assert wave.value.shape[0] == 1 and torch.isfinite(wave.value).all()


# ------------------------------------------------------------ trainers
def _grads_close(jgrads, model, tol=1e-5):
    """Every port gradient in JAX's layout within ``tol`` x the largest
    |g| of the model."""
    want = _flatten_state(jgrads)
    scale = max(np.abs(np.asarray(v)).max() for v in want.values())
    for name, p in model.named_parameters():
        path, kind = convert._flat_name(model, name)
        got = convert._to_jax(p.grad.detach().numpy(), kind)
        np.testing.assert_allclose(got, np.asarray(want[path]), rtol=0,
                                   atol=tol * scale, err_msg=path)


def _stacked(jx, tx):
    """A batch with an accumulation axis of one, in both packages."""
    return (JMasked(jx.value[None], jx.lengths[None], 1),
            Masked(tx.value[None], tx.lengths[None], 1))


def test_discrete_trainer_step_matches_jax(corpus, hubert_codec_dir):
    jhp = _discrete_hp(corpus, hubert_codec_dir)
    jt = JDiscreteARTrainer(jhp)
    tt = DiscreteARTrainer(Hparams.from_dict(jhp.to_dict()), device="cpu")
    convert.load_flat(tt.model, _flatten_state(nnx.state(jt.model)))
    toks = np.random.RandomState(2).randint(0, 32, (B, 20))
    jx, tx = _both(toks, [20, 13])
    jgrads, _ = jax.jit(jax.grad(jt._loss_fn, has_aux=True))(
        jt.params, {"tokens": jx})
    _, want = jt._loss_fn(jt.params, {"tokens": jx})
    got = tt.run_step({"tokens": _stacked(jx, tx)[1]})
    _grads_close(jgrads, tt.model)
    np.testing.assert_allclose(float(got["kld"]),
                               float(want["kld"] / want["length"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["lr"], float(jt.lr_schedule(0)),
                               rtol=1e-6)


@pytest.mark.parametrize("fuse", [False, True])
def test_discrete_trainer_accumulation_matches_jax(corpus, hubert_codec_dir,
                                                   fuse):
    """Two micro-batches of B rows, summed or (``fuse_accumulation``) run
    as one batch of 2B rows: the gradient is JAX's on the 2B rows (the
    CE is a token sum)."""
    jhp = _discrete_hp(corpus, hubert_codec_dir)
    jt = JDiscreteARTrainer(jhp)
    d = jhp.to_dict()
    d["training"]["fuse_accumulation"] = fuse
    tt = DiscreteARTrainer(Hparams.from_dict(d), device="cpu")
    convert.load_flat(tt.model, _flatten_state(nnx.state(jt.model)))
    toks = np.random.RandomState(4).randint(0, 32, (2 * B, 20))
    jx, tx = _both(toks, [20, 13, 7, 16])
    jgrads, _ = jax.jit(jax.grad(jt._loss_fn, has_aux=True))(
        jt.params, {"tokens": jx})
    tt.run_step({"tokens": Masked(tx.value.reshape(2, B, 20),
                                  tx.lengths.reshape(2, B), 1)})
    _grads_close(jgrads, tt.model)


def _hubert_trainer_hp(corpus, vocoder_dir, kind: str = "dedup_spkr"):
    d = {"trainer": {"identifier":
                     "trainers.vocoder.hubert.HuBERTDecoderTrainer",
                     "total_steps": 4, "limit_val_batches": 1,
                     "distributed": False},
         "logging": {"log_dir": "unused", "num_samples": 1},
         "vocoder": {"path": str(vocoder_dir)},
         "model": hubert_hp(kind),
         "training": {"gradient_accumulation": 1,
                      "optimizer": {"identifier": "AdamW", "lr": 1e-4,
                                    "beta1": 0.9, "beta2": 0.98},
                      "scheduler": {"identifier": "cosine", "min_lr": 1e-5,
                                    "flat_steps": 1}},
         "data": {}}
    d["data"] = _discrete_hp(corpus, vocoder_dir).data.to_dict()
    return d


def test_hubert_trainer_step_matches_jax(corpus, vocoder_dir):
    d = _hubert_trainer_hp(corpus, vocoder_dir)
    jt = JHuBERTTrainer(JHparams.from_dict(copy.deepcopy(d)))
    tt = HuBERTDecoderTrainer(Hparams.from_dict(copy.deepcopy(d)),
                              device="cpu")
    convert.load_flat(tt.model, _flatten_state(nnx.state(jt.model)))
    ins = _hubert_inputs("dedup_spkr", 6)
    counts = np.full((B, T // 2), 2)
    jb = {"tokens": ins["x"][0], "mel": ins["x_mel"][0],
          "cropped_mel": ins["spkr"][0], "dedup_tokens": ins["dedup_x"][0],
          "counts": _both(counts, [T // 2, 5])[0]}
    tb = {"tokens": ins["x"][1], "mel": ins["x_mel"][1],
          "cropped_mel": ins["spkr"][1], "dedup_tokens": ins["dedup_x"][1],
          "counts": _both(counts, [T // 2, 5])[1]}
    _, key = jax.random.split(jt.rng)
    (k,) = jax.random.split(key, 1)
    jgrads, want = jax.jit(jax.grad(jt._loss_fn, has_aux=True))(
        jt.params, jb, k)
    kt, kn = jax.random.split(k)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(
                 kt, (B,), 0, 8))),
             "noise": torch.from_numpy(np.array(jax.random.normal(
                 kn, (B, T, N_MELS), jnp.float32)))}
    got = tt.run_step({k_: Masked(v.value[None], v.lengths[None], 1)
                       for k_, v in tb.items()}, draws=[draws])
    _grads_close(jgrads, tt.model)
    for name in ("rec_loss", "dp_loss"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)


def test_trainers_fit_validate_and_resume(corpus, hubert_codec_dir,
                                          vocoder_dir, tmp_path):
    """``fit`` through validation (audio from the sampler and the codec)
    and a checkpoint, then a resume from the compact npz, for both
    trainers."""
    from vae_gslm_tpu_torch.training.logging import ExperimentLogger

    jhp = _discrete_hp(corpus, hubert_codec_dir)
    for i, (cls, d) in enumerate((
            (DiscreteARTrainer, jhp.to_dict()),
            (HuBERTDecoderTrainer, _hubert_trainer_hp(corpus, vocoder_dir,
                                                      "plain")))):
        hp = Hparams.from_dict(copy.deepcopy(d))
        hp.logging.log_dir = str(tmp_path / f"log{i}")
        tr = cls(hp, device="cpu")
        logger = ExperimentLogger(hp.logging.log_dir)
        tr.fit(logger, max_steps=2, log_every=1)
        assert tr.global_step == 2
        ckpt = os.path.join(logger.ckpt_path, "last-cpt.npz")
        wavs = [f for f in os.listdir(logger.log_path)
                if f.endswith(".wav")] if os.path.isdir(
            logger.log_path) else []
        logger.close()
        again = cls(Hparams.from_dict(copy.deepcopy(d)), seed=5,
                    device="cpu")
        again.resume(ckpt)
        for a, b in zip(again.params, tr.params):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        again.resume(os.path.join(logger.ckpt_path, "full_state.pt"))
        assert again.global_step == 2
        del wavs


# -------------------------------------------------------------- dataset
def _dedup_corpus(root):
    rng = np.random.RandomState(4)
    os.makedirs(os.path.join(root, "f0"))
    lines = []
    for i, dur in enumerate((0.62, 0.8, 0.5)):
        n = int(dur * SR)
        wave = (0.2 * np.sin(2 * np.pi * (190 + 20 * i) * np.arange(n) / SR)
                ).astype(np.float32)
        name = f"u{i}.wav"
        audio_lib.save_wav(os.path.join(root, name), wave, SR)
        toks = np.repeat(rng.randint(0, 32, int(dur * 50)),
                         rng.randint(1, 4, int(dur * 50)))[: int(dur * 50)]
        lines.append(f"{name}|{' '.join(map(str, toks))}")
        f0 = np.abs(rng.randn(int(dur * 50) + 1)).astype(np.float32) * 100
        f0[::5] = 0.0
        np.save(os.path.join(root, "f0", f"u{i}.npy"), f0)
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_token_dataset_dedup_and_f0_match_jax(tmp_path):
    _dedup_corpus(str(tmp_path))
    data = {"path": str(tmp_path / "tokens.txt"), "wavdir": str(tmp_path),
            "sample_rate": SR, "with_text": False, "with_tokens": True,
            "token_segment_size": 20,
            "preprocess_f0": {"path": str(tmp_path / "f0")},
            "sampler": {"type": "standard", "shuffle": False}}
    feat = yaml.safe_load(open(os.path.join(
        os.path.dirname(__file__), "..", "configs", "train", "vocoder",
        "hfgan_16k_50hz_librispeech.yaml")))["feature"]
    hub = {"deduplicate": True, "sample_rate": 50}
    ours = dataset.DiscreteTokenDataset(Hparams.from_dict(data),
                                        Hparams.from_dict(feat),
                                        Hparams.from_dict(hub),
                                        device="cpu", seed=3)
    theirs = jdataset.DiscreteTokenDataset(JHparams.from_dict(data),
                                           JHparams.from_dict(feat),
                                           JHparams.from_dict(hub), seed=3)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        got, want = ours[i], theirs[i]
        for k in ("tokens", "dedup_tokens", "counts", "inverse_indices"):
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=k)
        np.testing.assert_allclose(np.asarray(got["f0"]), want["f0"],
                                   rtol=1e-6, atol=1e-6)
        # float32 STFTs summed in another order, log-compressed: a few
        # quiet bins differ by up to ~3e-3
        np.testing.assert_allclose(got["mel"].cpu().numpy(), want["mel"],
                                   rtol=0, atol=5e-3)
        assert int(np.asarray(got["counts"]).sum()) == len(got["tokens"])


# ------------------------------------------------- inferer and estimator
INFER_YAML = """
identifier: "{identifier}"
precision: "32"
output_dir: "{out}"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.discrete.DiscreteAR"}}
sample_prior_length: 0.2
sample_length: 0.2
temperature: 1.0
diffusion: {{sampling_timesteps: 2, ddim_sampling_eta: 0.0}}
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


@pytest.fixture(scope="module")
def lm_dirs(tmp_path_factory, corpus, hubert_codec_dir):
    """A DiscreteAR checkpoint directory (JAX's compact npz of the
    trainer test's token LM) over the codec fixture."""
    ckpt = tmp_path_factory.mktemp("lm_ckpt")
    jhp = _discrete_hp(corpus, hubert_codec_dir)
    jm = JDiscreteAR(jhp.model, JHparams(num_quantizers=1, codebook_size=32,
                                         dim=8), rngs=nnx.Rngs(2))
    jckpt.save_compact(jm, str(ckpt / "last-cpt.npz"))
    jhp.save(str(ckpt / "hp.yaml"))
    return str(corpus), str(ckpt)


def _infer_hp(lm_dirs, out, identifier):
    corpus, ckpt = lm_dirs
    return INFER_YAML.format(identifier=identifier, out=out, ckpt=ckpt,
                             corpus=corpus)


@pytest.mark.parametrize("which", ["inferer", "hubert"])
def test_token_lm_inferers_run(lm_dirs, tmp_path, which):
    out = str(tmp_path / "out")
    ident = {"inferer": "inference.speech.inferer.SpeechInferer",
             "hubert": "inference.speech.hubert.SpeechInferer"}[which]
    hp = Hparams.from_yaml(_infer_hp(lm_dirs, out, ident))
    cls = {"inferer": SpeechInferer,
           "hubert": thubert_inferer.SpeechInferer}[which]
    inf = cls(hp, device="cpu")
    assert inf.type == "hubert" and inf.sampler.route(2) == "per_layer"
    assert inf.codec.model.decoder.sampling_timesteps == 2
    timings = {}
    n = inf.run(max_batches=1, timings=timings)
    assert n == 2 and timings["ar_loop"] > 0
    names = sorted(os.listdir(out))
    want = ["1.wav", "2.wav"] + (["1_ov.wav", "2_ov.wav"]
                                 if which == "hubert" else [])
    assert names == sorted(want)
    for name in names:
        wave, sr = audio_lib.load_audio(os.path.join(out, name))
        assert sr == SR and np.isfinite(wave).all()
        # 0.2 s prompt + 0.2 s continuation at 50 Hz x 320 samples
        limit = (10 if name.endswith("_ov.wav") else 20) * 320
        assert 0 < len(wave) <= limit


def test_estimator_matches_jax(lm_dirs, tmp_path):
    ident = "inference.speech.likelihood.LikelihoodEstimator"
    hp = _infer_hp(lm_dirs, str(tmp_path), ident)
    want = JEstimator(JHparams.from_yaml(hp)).run()
    est = LikelihoodEstimator(Hparams.from_yaml(hp), device="cpu")
    assert est.type == "hubert"
    got = est.run()
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_scripts_resolve_the_token_lm_classes():
    """``scripts/train.py`` and ``scripts/infer.py`` resolve the token
    LM's identifiers inside the port."""
    from vae_gslm_tpu_torch.models.speech.discrete import DiscreteAR
    from vae_gslm_tpu_torch.scripts.registry import resolve

    assert resolve("trainers.speech.discrete.DiscreteARTrainer") \
        is DiscreteARTrainer
    assert resolve("trainers.vocoder.hubert.HuBERTDecoderTrainer") \
        is HuBERTDecoderTrainer
    assert resolve("models.speech.discrete.DiscreteAR") is DiscreteAR
    assert resolve("inference.speech.hubert.SpeechInferer") \
        is thubert_inferer.SpeechInferer
