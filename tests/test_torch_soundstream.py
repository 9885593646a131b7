"""SoundStream and its vector quantizers: the port against the JAX
package on the CPU (no kernel on this path).

  * ``SimpleVectorQuantizer``: codes, straight-through output and loss,
    and the gradients of a loss of both outputs, on JAX's codebooks
    carried across (``load_flat``);
  * ``SimpleBestRQ``: the codes of JAX's frozen projection and codebooks
    (``nnx.Variable`` buffers), carried across strictly with
    ``to_flat``/``load_flat``;
  * ``SoundStream``: reconstruction and quantizer loss on JAX's weights;
  * ``SoundStreamTrainer``: the loss and one step with accumulation 2
    against ``jax.grad`` of JAX's trainer loss summed over the two
    micro-batches (every gradient within 1e-5 x the largest), the
    metrics the last micro-batch's; ``scripts/train.py`` reaches it by
    its identifier, saves a compact checkpoint that JAX reads and that
    the trainer resumes from;
  * the device rule: no card -> raise unless ``device="cpu"``."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_hubert_codec import _grads_close
from tests.test_trainers import SOUNDSTREAM_CONV, corpus  # noqa: F401
from tests.test_trainers import vocoder_dir  # noqa: F401
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.speech.soundstream import SoundStream as JSoundStream
from vae_gslm_tpu.nn import vq as jvq
from vae_gslm_tpu.trainers.speech.soundstream import \
    SoundStreamTrainer as JTrainer
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.speech.soundstream import SoundStream
from vae_gslm_tpu_torch.nn import vq as tvq
from vae_gslm_tpu_torch.scripts import train as train_cli
from vae_gslm_tpu_torch.scripts.registry import resolve
from vae_gslm_tpu_torch.trainers.speech.soundstream import \
    SoundStreamTrainer

N_MELS, B, T = 20, 2, 16
LENGTHS = [T, 11]


def _model_dict(quantizer="SimpleVectorQuantizer"):
    conv = yaml.safe_load(SOUNDSTREAM_CONV)
    return {"encoder": copy.deepcopy(conv), "decoder": copy.deepcopy(conv),
            "quantizer": {"identifier": quantizer, "dim": 16,
                          "codebook_size": 8}}


def _both(x, lengths):
    return (JMasked.from_lengths(jnp.asarray(x), jnp.asarray(lengths)),
            Masked.from_lengths(torch.from_numpy(x), lengths))


def _carry(jm, tm):
    """JAX's parameters and variables into the port, strictly."""
    convert.load_flat(tm, _flatten_state(nnx.state(jm)))


def _close(got, want, tol=1e-5, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=err_msg)


def test_vector_quantizer_matches_jax():
    jq = jvq.SimpleVectorQuantizer(16, 8, 1.0, 0.25, rngs=nnx.Rngs(1))
    tq = tvq.get_vector_quantizer(Hparams.from_dict(
        {"identifier": "VQ", "dim": 16, "codebook_size": 8}))
    _carry(jq, tq)
    assert sorted(convert.to_flat(tq)) == ["codebooks"]
    x = np.random.RandomState(0).randn(B, T, 16).astype(np.float32)
    jx, tx = _both(x, LENGTHS)
    r = np.random.RandomState(1).randn(B, T, 16).astype(np.float32)

    def jloss(module, xv):
        out = module(JMasked(xv, jx.lengths, 1))
        return jnp.sum(out.quantized.value * r) + out.loss, out

    graphdef, state = nnx.split(jq)
    (jl, jout), grads = jax.value_and_grad(
        lambda st, xv: jloss(nnx.merge(graphdef, st), xv), argnums=(0, 1),
        has_aux=True)(state, jx.value)
    jgm, jgx = grads
    txv = tx.value.clone().requires_grad_(True)
    tout = tq(Masked(txv, tx.lengths, 1))
    tl = (tout.quantized.value * torch.from_numpy(r)).sum() + tout.loss
    tl.backward()
    np.testing.assert_array_equal(tout.indices.value.numpy(),
                                  np.asarray(jout.indices.value))
    _close(tout.quantized.value, jout.quantized.value, err_msg="quantized")
    _close(tout.loss, jout.loss, err_msg="loss")
    _close(tl, jl, err_msg="total")
    _close(txv.grad, jgx, err_msg="d/dx")
    _close(tq.codebooks.grad, _flatten_state(jgm)["codebooks"],
           err_msg="d/dcodebooks")
    _close(tq.get_output(tout.indices.value),
           jq.get_output(jout.indices.value), err_msg="get_output")


def test_best_rq_matches_jax_on_its_frozen_buffers():
    """The frozen projection and codebooks are buffers in the port (JAX's
    ``nnx.Variable``s, not parameters): carried strictly both ways, not
    trained, and the codes equal JAX's."""
    jq = jvq.get_vector_quantizer(JHparams.from_dict(
        {"identifier": "BestRQ", "dim": 16, "codebook_size": 32}),
        rngs=nnx.Rngs(2))
    tq = tvq.get_vector_quantizer(Hparams.from_dict(
        {"identifier": "SimpleBestRQ", "dim": 16, "codebook_size": 32}))
    assert list(tq.parameters()) == []
    _carry(jq, tq)
    flat = convert.to_flat(tq)
    want = _flatten_state(nnx.state(jq))
    assert sorted(flat) == sorted(want) == ["codebooks", "projection"]
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    x = np.random.RandomState(3).randn(B, T, 16).astype(np.float32)
    jx, tx = _both(x, LENGTHS)
    np.testing.assert_array_equal(tq(tx).value.numpy(),
                                  np.asarray(jq(jx).value))


def test_get_vector_quantizer_refuses_unknown():
    with pytest.raises(ValueError, match="not a supported quantizer"):
        tvq.get_vector_quantizer(Hparams.from_dict(
            {"identifier": "RVQ2", "dim": 4, "codebook_size": 2}))


@pytest.mark.parametrize("quantizer", ["VQ", "BestRQ"])
def test_soundstream_matches_jax(quantizer):
    d = _model_dict(quantizer)
    jm = JSoundStream(JHparams.from_dict(copy.deepcopy(d)),
                      input_dim=N_MELS, rngs=nnx.Rngs(4))
    tm = SoundStream(Hparams.from_dict(copy.deepcopy(d)), input_dim=N_MELS,
                     device="cpu")
    _carry(jm, tm)
    assert tm.sample_ratio == jm.sample_ratio
    x = np.random.RandomState(5).randn(B, T, N_MELS).astype(np.float32)
    jx, tx = _both(x, LENGTHS)
    if quantizer == "BestRQ":
        # BestRQ's forward gives codes, not a VQOutput: the encoder's
        # output is quantized to codes alone (as in JAX)
        np.testing.assert_array_equal(
            tm.quantizer(tm.encoder(tx)).value.numpy(),
            np.asarray(jm.quantizer(jm.encoder(jx)).value))
        return
    graphdef, state = nnx.split(jm)
    want = jax.jit(lambda st, v: nnx.merge(graphdef, st)(
        JMasked(v, jx.lengths, 1)))(state, jx.value)
    got = tm(tx)
    _close(got["reconstruction"].value, want["reconstruction"].value,
           err_msg="reconstruction")
    np.testing.assert_array_equal(got["reconstruction"].lengths.numpy(),
                                  np.asarray(want["reconstruction"].lengths))
    _close(got["aux_loss"], want["aux_loss"], err_msg="aux_loss")


def _trainer_dict(corpus_dir, vocoder, log_dir="unused"):
    return {
        "trainer": {"identifier":
                    "trainers.speech.soundstream.SoundStreamTrainer",
                    "total_steps": 4, "limit_val_batches": 1,
                    "precision": "32", "distributed": False},
        "logging": {"log_dir": str(log_dir), "num_samples": 0},
        "vocoder": {"path": str(vocoder)},
        "model": _model_dict(),
        "training": {"gradient_accumulation": 2,
                     "optimizer": {"identifier": "Adam", "lr": 5e-3,
                                   "beta1": 0.9, "beta2": 0.98},
                     "scheduler": {"identifier": "constant",
                                   "flat_steps": 1}},
        "data": {split: {"path": f"{corpus_dir}/tokens.txt",
                         "wavdir": str(corpus_dir), "sample_rate": 16000,
                         "with_text": False, "with_tokens": False,
                         "num_workers": 0, "batch_size": 2,
                         "segment_size": 0.4,
                         "post_pad": {"mel": {"length": 0.4}},
                         "sampler": {"type": "standard",
                                     "shuffle": split == "train"}}
                 for split in ("train", "val")}}


def test_trainer_step_with_accumulation_matches_jax(corpus,  # noqa: F811
                                                    vocoder_dir):  # noqa
    d = _trainer_dict(corpus, vocoder_dir)
    jt = JTrainer(JHparams.from_dict(copy.deepcopy(d)))
    tt = SoundStreamTrainer(Hparams.from_dict(copy.deepcopy(d)),
                            device="cpu")
    _carry(jt.model, tt.model)
    rng = np.random.RandomState(6)
    mels = rng.randn(2, B, T, N_MELS).astype(np.float32)
    lengths = np.array([LENGTHS, [9, T]])
    grad = jax.jit(jax.grad(jt._loss_fn, has_aux=True))
    jgrads, want = None, None
    for i in range(2):
        jx, _ = _both(mels[i], lengths[i])
        g, want = grad(jt.params, {"mel": jx})
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
    jloss, _ = jax.jit(jt._loss_fn)(jt.params, {"mel": _both(
        mels[1], lengths[1])[0]})
    tloss, _ = tt._loss_fn({"mel": Masked.from_lengths(
        torch.from_numpy(mels[1]), lengths[1])})
    _close(tloss, jloss, err_msg="loss")
    got = tt.run_step({"mel": Masked(torch.from_numpy(mels),
                                     torch.from_numpy(lengths), 1)})
    _grads_close(jgrads, tt.model)
    for name in ("rec_loss", "aux_loss"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got["lr"]) == pytest.approx(5e-3)


def test_train_cli_fits_saves_and_resumes(corpus, vocoder_dir,  # noqa
                                          tmp_path):
    """``scripts/train.py`` resolves the trainer by its identifier, takes
    two steps with validation, and writes a compact checkpoint that JAX's
    ``load_compact`` reads into its SoundStream; the port's trainer
    resumes from it (the parameters equal) and from its full state."""
    assert resolve("trainers.speech.soundstream.SoundStreamTrainer") \
        is SoundStreamTrainer
    d = _trainer_dict(corpus, vocoder_dir, tmp_path / "logs")
    d["training"]["gradient_accumulation"] = 1
    cfg = tmp_path / "train.yaml"
    cfg.write_text(yaml.safe_dump(d))
    train_cli.main(["-c", str(cfg), "--max_steps", "2", "--device", "cpu",
                    "-n", "run"])
    ckpt = tmp_path / "logs" / "run" / "ckpt" / "version_0"
    assert "last-cpt.npz" in os.listdir(ckpt)
    jm = JSoundStream(JHparams.from_dict(d["model"]), input_dim=N_MELS,
                      rngs=nnx.Rngs(9))
    jckpt.load_compact(jm, str(ckpt / "last-cpt.npz"))
    again = SoundStreamTrainer(Hparams.from_dict(copy.deepcopy(d)), seed=5,
                               device="cpu")
    _carry(jm, again.model)
    want = [p.detach().clone() for p in again.params]
    again.resume(str(ckpt / "last-cpt.npz"))
    for a, b in zip(again.params, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    again.resume(str(ckpt / "full_state.pt"))
    assert again.global_step == 2


@pytest.mark.parametrize("build", ["model", "trainer"])
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, build,
                                                     corpus,  # noqa: F811
                                                     vocoder_dir):  # noqa
    hp = Hparams.from_dict(_trainer_dict(corpus, vocoder_dir))
    make = {"model": lambda **kw: SoundStream(hp.model, input_dim=N_MELS,
                                              **kw),
            "trainer": lambda **kw: SoundStreamTrainer(hp, **kw)}[build]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(**kw)
    built = make(device="cpu")
    module = built if build == "model" else built.model
    assert all(p.device.type == "cpu" for p in module.parameters())
