"""The port's training loop, checkpoints and CLI on the CPU, against the
JAX package where the two share a contract.

The tiny LVTR of ``tests/test_e2e_lvtr.py`` (with an utterance encoder)
trains on its four-utterance corpus with ``distributed: true`` in one
process (the distributed sampler of a world of one, as the shipped
config runs alone) and accumulation 3 over two batches per epoch, so
every optimizer step takes micro-batches across an epoch boundary.
  * ``fit`` reaches ``total_steps``, logs from rank 0, validates at the
    end (losses and audio through the port's sampler and HiFi-GAN) and
    writes the files JAX writes, by name (``step=N-cpt.npz``,
    ``last-cpt.npz``, ``hp.yaml``), beside the port's full state;
  * the SIGTERM flag checkpoints at the next step and returns; across
    two gloo ranks of the CLI, a signal that only rank 1 receives stops
    both after the same step, and rank 0 writes that step's checkpoints;
  * a trainer resumed from the full state takes the next step exactly
    as the trainer that wrote it (bit for bit);
  * the CLI trains two steps, and JAX's ``load_compact`` reads every key
    of its ``last-cpt.npz`` unchanged;
  * ``encoder.init_from_ckpt`` loads a JAX-written compact checkpoint
    and freezes the encoder."""
import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import (TRAIN_HP, corpus,  # noqa: F401 (fixtures)
                                 vocoder_dir)
from tests.test_torch_train_step import UTTERANCE
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.scripts import train as train_cli
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer
from vae_gslm_tpu_torch.training import trainer as trainer_mod
from vae_gslm_tpu_torch.training.logging import ExperimentLogger
from vae_gslm_tpu_torch.training.trainer import FULL_STATE

N_MELS = 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(log_dir, vocoder, corpus_dir, total_steps=2):
    d = yaml.safe_load(TRAIN_HP.format(log_dir=log_dir, vocoder_dir=vocoder,
                                       corpus=corpus_dir))
    d["model"]["utterance_encoder"] = copy.deepcopy(UTTERANCE)
    d["trainer"].update(distributed=True, total_steps=total_steps)
    d["training"]["gradient_accumulation"] = 3
    return d


@pytest.fixture(scope="module")
def fitted(corpus, vocoder_dir, tmp_path_factory):  # noqa: F811
    log_dir = tmp_path_factory.mktemp("fit")
    cfg = _cfg(log_dir, vocoder_dir, corpus)
    trainer = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
    epochs = []
    make = trainer.train_dataloader

    def loader():
        out = make()
        set_epoch = out.sampler.set_epoch
        out.sampler.set_epoch = lambda e: epochs.append(e) or set_epoch(e)
        return out

    trainer.train_dataloader = loader
    logger = ExperimentLogger(str(log_dir))
    trainer.fit(logger, log_every=1)
    logger.close()
    return {"cfg": cfg, "trainer": trainer, "logger": logger,
            "epochs": epochs}


def test_fit_reaches_total_steps_across_epochs(fitted):
    trainer, logger = fitted["trainer"], fitted["logger"]
    assert trainer.global_step == 2
    # 2 batches per epoch, 3 per step: steps end in epochs 1 and 2
    assert fitted["epochs"] == [0, 1, 2]
    assert sorted(os.listdir(logger.ckpt_path)) == sorted(
        ["step=2-cpt.npz", "last-cpt.npz", "hp.yaml", FULL_STATE])
    with open(os.path.join(logger.log_path, "metrics.jsonl")) as f:
        tags = {(r["tag"], r["step"]) for r in map(json.loads, f)}
    for step in (1, 2):
        assert ("train/rec_loss", step) in tags
        assert ("train/grad_norm", step) in tags
    assert ("val/rec_loss", 2) in tags and ("val/token_kld", 2) in tags
    audio = sorted(os.listdir(os.path.join(logger.log_path, "audio")))
    assert audio == sorted(f"{tag}_0_step2.wav" for tag in
                           ("re_vocoded", "reconstruct", "samples"))


def _step_inputs(seed):
    rng = np.random.RandomState(seed)
    from vae_gslm_tpu_torch.core.masked import Masked

    lengths = torch.tensor([[20, 13]] * 3, dtype=torch.int32)
    utt = torch.tensor([[15, 10]] * 3, dtype=torch.int32)
    batch = {"mel": Masked(torch.from_numpy(rng.randn(3, 2, 20, N_MELS)
                                            .astype(np.float32)), lengths),
             "tokens": Masked(torch.from_numpy(rng.randint(0, 32, (3, 2, 20))
                                               .astype(np.int32)), lengths),
             "cropped_mel_utt": Masked(torch.from_numpy(
                 rng.randn(3, 2, 15, N_MELS).astype(np.float32)), utt)}
    f = (lambda a: torch.from_numpy(a.astype(np.float32)))
    draws = [{"posterior": f(rng.randn(2, 20, 4)),
              "initial": f(rng.uniform(-1, 1, (2, 1, 8))),
              "prior": f(rng.randn(2, 20, 4)),
              "t": torch.from_numpy(rng.randint(0, 8, 2)),
              "noise": f(rng.randn(2, 20, N_MELS))} for _ in range(3)]
    return batch, draws


def test_resume_full_state_reproduces_next_step(fitted):
    trainer = fitted["trainer"]
    path = os.path.join(fitted["logger"].ckpt_path, FULL_STATE)
    fresh = LVTRTrainer(Hparams.from_dict(fitted["cfg"]), seed=5,
                        device="cpu")
    assert not torch.equal(fresh.params[0], trainer.params[0])
    fresh.resume(path)
    assert fresh.global_step == trainer.global_step == 2
    assert fresh.opt.count == trainer.opt.count == 2
    batch, draws = _step_inputs(0)
    got = fresh.run_step(batch, draws=draws)
    want = trainer.run_step(batch, draws=draws)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    for name, a, b in zip(trainer.names, fresh.params, trainer.params):
        assert torch.equal(a, b), name


def test_sigterm_flag_checkpoints_and_returns(corpus, vocoder_dir,  # noqa
                                              tmp_path, monkeypatch):
    """The handler fit installs is called as SIGTERM would call it, during
    the first step: fit writes that step's checkpoints and returns."""
    handlers = []
    monkeypatch.setattr(trainer_mod.signal, "signal",
                        lambda sig, fn: handlers.append((sig, fn)))
    cfg = _cfg(tmp_path, vocoder_dir, corpus, total_steps=50)
    trainer = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
    run_step = trainer.run_step

    def step(stacked):
        sig, on_term = handlers[0]
        assert sig == trainer_mod.signal.SIGTERM
        on_term(sig, None)
        return run_step(stacked)

    trainer.run_step = step
    logger = ExperimentLogger(str(tmp_path))
    trainer.fit(logger, val_check_interval=10 ** 9)
    logger.close()
    assert trainer.global_step == 1
    assert sorted(os.listdir(logger.ckpt_path)) == sorted(
        ["step=1-cpt.npz", "last-cpt.npz", "hp.yaml", FULL_STATE])
    assert len(handlers) == 2        # installed, then restored


def _preempt_worker(rank: int, world: int, port: int, work: str) -> None:
    """One rank of the training CLI over gloo on the CPU; only rank 1
    gets SIGTERM (its handler called during the first step).  Writes the
    step ``fit`` returned at to ``work/rank{rank}.json``."""
    os.environ.update(VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                      VAE_GSLM_NUM_PROCESSES=str(world),
                      VAE_GSLM_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    handlers = []
    trainer_mod.signal.signal = lambda sig, fn: handlers.append(fn)
    run_step, fit = LVTRTrainer.run_step, LVTRTrainer.fit

    def step(self, stacked, draws=None):
        if rank == 1 and self.global_step == 0:
            handlers[0](trainer_mod.signal.SIGTERM, None)
        return run_step(self, stacked, draws)

    def fit_and_record(self, *a, **kw):
        fit(self, *a, **kw)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump({"step": self.global_step}, f)

    LVTRTrainer.run_step, LVTRTrainer.fit = step, fit_and_record
    train_cli.main(["-c", os.path.join(work, "train.yaml"), "--backend",
                    "gloo", "--device", "cpu", "-n", "run"])


def test_sigterm_on_one_rank_stops_every_rank(corpus, vocoder_dir,  # noqa
                                              tmp_path):
    cfg = _cfg(tmp_path / "logs", vocoder_dir, corpus, total_steps=50)
    cfg["trainer"]["val_check_interval"] = 10 ** 9
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_fit import _preempt_worker; "
         f"_preempt_worker({r}, 2, {port}, sys.argv[1])", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            assert json.load(f) == {"step": 1}, r
    ckpt = tmp_path / "logs" / "run" / "ckpt" / "version_0"
    assert sorted(os.listdir(ckpt)) == sorted(
        ["step=1-cpt.npz", "last-cpt.npz", "hp.yaml", FULL_STATE])


def test_cli_two_steps_jax_reads_checkpoint(corpus, vocoder_dir,  # noqa
                                            tmp_path):
    cfg = _cfg(tmp_path / "logs", vocoder_dir, corpus, total_steps=100)
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    train_cli.main(["-c", str(cfg_path), "--max_steps", "2", "--device",
                    "cpu", "-n", "run"])
    ckpt = tmp_path / "logs" / "run" / "ckpt" / "version_0"
    assert sorted(os.listdir(ckpt)) == sorted(
        ["step=2-cpt.npz", "last-cpt.npz", "hp.yaml", FULL_STATE])
    saved = Hparams.from_yamlfile(str(ckpt / "hp.yaml")).to_dict()
    for key in ("trainer", "training", "data", "logging", "vocoder"):
        assert saved[key] == cfg[key], key
    jmodel = JLVTR(JHparams.from_dict(cfg["model"]), input_dim=N_MELS,
                   rngs=nnx.Rngs(3))
    path = str(ckpt / "last-cpt.npz")
    jckpt.load_compact(jmodel, path)
    loaded = jckpt._flatten_state(nnx.state(jmodel))
    with np.load(path) as z:
        assert set(z.files) == set(loaded)
        for k in z.files:
            np.testing.assert_array_equal(np.asarray(loaded[k]), z[k],
                                          err_msg=k)


def test_init_from_ckpt_loads_jax_checkpoint(corpus, vocoder_dir,  # noqa
                                             tmp_path):
    """A JAX LVTR's compact checkpoint warm-starts the port's trainer:
    every parameter equals JAX's, and the encoder is frozen."""
    cfg = _cfg(tmp_path, vocoder_dir, corpus)
    jmodel = JLVTR(JHparams.from_dict(cfg["model"]), input_dim=N_MELS,
                   rngs=nnx.Rngs(7))
    path = str(tmp_path / "enc-cpt.npz")
    jckpt.save_compact(jmodel, path)
    cfg["model"]["encoder"]["init_from_ckpt"] = path
    trainer = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
    assert trainer.freeze_encoder
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR

    ref = LVTR(Hparams.from_dict(cfg["model"]), input_dim=N_MELS,
               device="cpu")
    load_reference_lvtr(ref, export_torch_lvtr(jmodel))
    want = dict(ref.named_parameters())
    for name, p in zip(trainer.names, trainer.params):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[name].detach().numpy(), name)
    batch, draws = _step_inputs(1)
    trainer.run_step(batch, draws=draws)
    frozen = [p for n, p in zip(trainer.names, trainer.params)
              if n.startswith(("encoder_net.", "encoder_head."))]
    assert frozen and not any(p.grad.any() for p in frozen)
