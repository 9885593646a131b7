"""The port's ``HiFiGANTrainer`` against the JAX package's, float32 on the
CPU, at the tiny config of ``tests/test_trainers.py::_hfgan_hp`` (0.2 s
segments, MPD periods 2 and 3, one MRD resolution).

JAX's trainer builds its generator and discriminators abstractly with
weights from a numpy seed (``tests/test_torch_hfgan.py::filled``; no
file of the JAX package changes), and the port's trainer takes them
through ``models/convert.py::load_hfgan_flat``.  The batch's second row
is post-padded (its tail exact zeros), as the shipped config's clips
are.  Tolerances: gradients to 1e-4 of each leaf's max |g|; metrics to
1e-5 relative; parameters after Adam steps to 1 % of the learning rate
where the gradient is at least 1 % of its leaf's max, and everywhere to
the update's bound (Adam's first steps move a parameter by about lr
times the sign of its gradient, so a gradient within float32 noise of 0
may move it the other way).

Also: ``fit`` for two steps then an exact full-state resume, the npz
resume (generator only), the trained directory as a vocoder, the CLI
resolving the trainer inside the port, two gloo ranks against one
process over the whole batch, and the device rule."""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_hfgan import _grads_module, filled
from tests.test_trainers import _hfgan_hp, corpus  # noqa: F401 (fixture)
from vae_gslm_tpu.core.losses import masked_l1_loss as j_masked_l1
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.core.masked import resize_length as j_resize
from vae_gslm_tpu.models.vocoder import hfgan as jh
from vae_gslm_tpu.trainers.vocoder import hfgan as jtr
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.vocoder import hfgan as th
from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
from vae_gslm_tpu_torch.scripts import train as train_cli
from vae_gslm_tpu_torch.scripts.registry import resolve
from vae_gslm_tpu_torch.trainers.vocoder.hfgan import (METRICS,
                                                       HiFiGANTrainer)
from vae_gslm_tpu_torch.training.logging import ExperimentLogger
from vae_gslm_tpu_torch.training.trainer import FULL_STATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, LR = 3200, 1e-4
LENGTHS = [[3200, 2500]]                 # row 1: 700 zero samples
GLOBAL_LENGTHS = [3200, 3200, 1600, 2500]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(lengths, seed: int = 0) -> np.ndarray:
    """(1, B, T) seeded audio with exact zeros past each length."""
    lengths = np.asarray(lengths)
    x = (np.random.RandomState(seed).randn(*lengths.shape, T) * 0.2
         ).astype(np.float32)
    x[np.arange(T)[None, None] >= lengths[..., None]] = 0.0
    return x


def _port_batch(x, lengths):
    return {"audio": Masked(torch.from_numpy(x.copy()),
                            torch.tensor(lengths, dtype=torch.int32), 1)}


def _jax_trainer(hp, seed: int = 0):
    """JAX's trainer with its modules built abstractly and filled from
    numpy seeds ``seed`` (generator) and ``seed + 1``.  The generator's
    convs are drawn at unit gain: at JAX's 0.01 its wave is the last
    bias's constant plus a faint signal, whose near-silent mel bands put
    1/mel ~ 2e4 on the phase of bins below float32's rounding, and the
    mel loss's gradient is then noise in either package (3 % of its max
    between float32 and float64 in both)."""
    make_g, make_d = jtr.Generator, jtr._Discriminators
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "Generator", lambda hp, rngs: filled(
            lambda: make_g(hp, rngs=nnx.Rngs(0)), seed, std=0))
        mp.setattr(jtr, "_Discriminators", lambda hp, rngs: filled(
            lambda: make_d(hp, rngs=nnx.Rngs(0)), seed + 1))
        return jtr.HiFiGANTrainer(hp, seed)


def _port_trainer(hp, jt=None, seed: int = 0) -> HiFiGANTrainer:
    tt = HiFiGANTrainer(Hparams.from_dict(hp.to_dict()), seed=seed,
                        device="cpu")
    if jt is not None:
        convert.load_hfgan_flat(tt.generator, tt.disc,
                                _flatten_state(jt.g_params),
                                _flatten_state(jt.d_params))
    return tt


def _jax_grads(jt, x, lengths):
    """One step's D gradients and G gradients (the latter against the
    D-updated discriminators, with the real feature maps from before the
    update), composed from JAX's public functions."""
    gd, gs = nnx.split(jt.generator)
    dd, ds = nnx.split(jt.disc)
    feats, weight = jt.features, jt.hp.training.mel_loss_weight

    def mel_of(w: JMasked) -> JMasked:
        return JMasked.from_lengths(feats._encode_value(w.value), j_resize(
            w.lengths, feats.sample_ratio))

    @jax.jit
    def grads(gs, ds, audio):
        mel = mel_of(audio)
        y_hat = nnx.merge(gd, gs)(mel)

        def d_loss(ds):
            disc = nnx.merge(dd, ds)
            f_r, fm_f, s_r, fm_s = disc(audio.value)
            f_g, _, s_g, _ = disc(jax.lax.stop_gradient(y_hat.value))
            return (jh.discriminator_loss(f_r, f_g)
                    + jh.discriminator_loss(s_r, s_g)), (fm_f, fm_s)

        (_, maps), d_grads = jax.value_and_grad(d_loss, has_aux=True)(ds)
        maps = jax.lax.stop_gradient(maps)
        upd, _ = jt.tx_d.update(d_grads, jt.tx_d.init(ds), ds)
        ds_new = optax.apply_updates(ds, upd)

        def g_loss(gs):
            y = nnx.merge(gd, gs)(mel)
            f_g, fm_f, s_g, fm_s = nnx.merge(dd, ds_new)(y.value)
            return (jh.generator_loss(f_g) + jh.generator_loss(s_g)
                    + jh.feature_loss(maps[0], fm_f)
                    + jh.feature_loss(maps[1], fm_s)
                    + j_masked_l1(mel_of(y), mel, time_reduction=True,
                                  batch_reduction=True) * weight)

        return d_grads, jax.grad(g_loss)(gs)

    audio = JMasked(jnp.asarray(x[0]), jnp.asarray(lengths[0]), 1)
    d_grads, g_grads = grads(gs, ds, audio)
    return _flatten_state(g_grads), _flatten_state(d_grads)


def _params(tt):
    return {**{f"g.{n}": p.detach().numpy().copy()
               for n, p in zip(tt.g_names, tt.g_params)},
            **{f"d.{n}": p.detach().numpy().copy()
               for n, p in zip(tt.d_names, tt.d_params)}}


@pytest.fixture(scope="module")
def stepped():
    """JAX's and the port's trainers from the same weights, two
    ``run_step`` calls each on the same batch; the port's gradients of
    step 1 and the JAX composition's."""
    hp = _hfgan_hp("unused")
    jt = _jax_trainer(hp)
    tt = _port_trainer(hp, jt)
    x = _batch(LENGTHS)
    want_g, want_d = _jax_grads(jt, x, LENGTHS)
    jbatch = {"audio": JMasked(jnp.asarray(x), jnp.asarray(LENGTHS), 1)}
    jax_metrics, port_metrics, port_grads = [], [], None
    for _ in range(2):
        jax_metrics.append({k: float(v) for k, v in
                            jt.run_step(jbatch).items()})
        port_metrics.append({k: float(v) for k, v in
                             tt.run_step(_port_batch(x, LENGTHS)).items()})
        if port_grads is None:
            port_grads = (convert.to_flat(_grads_module(tt.generator)),
                          convert.to_flat(_grads_module(tt.disc)))
    jt.sync_model()
    jax_params = (_flatten_state(jt.g_params), _flatten_state(jt.d_params))
    return {"want": (want_g, want_d), "port_grads": port_grads,
            "jax_metrics": jax_metrics, "port_metrics": port_metrics,
            "jax_params": jax_params, "tt": tt}


def _near(ours, ref, rel, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("which", ["generator", "discriminators"])
def test_step_gradients_match_jax(stepped, which):
    """Every D gradient, and every G gradient taken against the updated
    discriminators with the pre-update real feature maps, to 1e-4 of each
    leaf's max |g| (the mel loss's gradient passes |rfft| and the
    log-mel of y_hat; the real clip's zero tail reaches the STFT and the
    MRD's |rfft|)."""
    i = 0 if which == "generator" else 1
    want, got = stepped["want"][i], stepped["port_grads"][i]
    assert set(got) == set(want)
    for k in want:
        _near(got[k], want[k], 1e-4, k)
        assert np.abs(want[k]).max() > 0, k


def test_run_step_twice_matches_jax(stepped):
    """Both trainers' metrics of two steps (step 2's depend on step 1's
    updates of both parameter sets) and both parameter sets after them."""
    assert set(stepped["port_metrics"][0]) == set(METRICS)
    for n, (ours, ref) in enumerate(zip(stepped["port_metrics"],
                                        stepped["jax_metrics"])):
        for k in METRICS:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                       err_msg=f"step {n + 1} {k}")
    tt = stepped["tt"]
    for i, module in enumerate((tt.generator, tt.disc)):
        ours = convert.to_flat(module)
        want = stepped["jax_params"][i]
        grads = stepped["port_grads"][i]
        assert set(ours) == set(want)
        for k in want:
            diff = np.abs(ours[k] - want[k])
            big = np.abs(grads[k]) > 1e-2 * np.abs(grads[k]).max()
            assert (diff[big] <= 1e-2 * LR).all(), (k, diff[big].max())
            assert (diff <= 4 * LR).all(), (k, diff.max())


@pytest.fixture(scope="module")
def fitted(corpus, tmp_path_factory):  # noqa: F811
    """The port's trainer ``fit`` for two steps on the tiny corpus (a
    validation pass and the checkpoints at the end)."""
    hp = Hparams.from_dict(_hfgan_hp(corpus).to_dict())
    trainer = HiFiGANTrainer(hp, device="cpu")
    logger = ExperimentLogger(str(tmp_path_factory.mktemp("hfgan_fit")))
    trainer.fit(logger, max_steps=2, val_check_interval=10 ** 9,
                log_every=1)
    logger.close()
    return hp, trainer, logger


def test_fit_writes_checkpoints_and_logs(fitted):
    hp, trainer, logger = fitted
    assert trainer.global_step == 2
    assert trainer.opt_g.count == trainer.opt_d.count == 2
    files = set(os.listdir(logger.ckpt_path))
    assert {"last-cpt.npz", "step=2-cpt.npz", "hp.yaml",
            FULL_STATE} <= files
    audio = os.listdir(os.path.join(logger.log_path, "audio"))
    assert sorted(audio) == ["original_0_step2.wav",
                             "reconstruct_0_step2.wav"]
    with open(os.path.join(logger.log_path, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train/mel", "train/G", "train/feature", "train/D",
            "val/mel"} <= tags


def test_full_state_resume_is_exact(fitted):
    """Both parameter sets, both Adam states and the step come back bit
    for bit, and the next step is the same step."""
    hp, trainer, logger = fitted
    other = HiFiGANTrainer(hp, seed=7, device="cpu")
    other.resume(os.path.join(logger.ckpt_path, FULL_STATE))
    assert other.global_step == 2
    for a, b in ((trainer.opt_g, other.opt_g), (trainer.opt_d, other.opt_d)):
        assert a.count == b.count == 2
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(trainer.g_params + trainer.d_params,
                    other.g_params + other.d_params):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    batch = _port_batch(_batch(LENGTHS, seed=3), LENGTHS)
    m1, m2 = trainer.run_step(batch), other.run_step(batch)
    for k in METRICS:
        assert float(m1[k]) == float(m2[k]), k
    for x, y in zip(trainer.g_params + trainer.d_params,
                    other.g_params + other.d_params):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_npz_resume_loads_generator_only(fitted):
    """A compact npz fills the generator; the discriminators keep their
    own weights and optimizer, the generator's optimizer starts afresh."""
    hp, trainer, logger = fitted
    fresh = HiFiGANTrainer(hp, seed=7, device="cpu")
    other = HiFiGANTrainer(hp, seed=7, device="cpu")
    other.resume(os.path.join(logger.ckpt_path, "step=2-cpt.npz"))
    saved = dict(np.load(os.path.join(logger.ckpt_path, "step=2-cpt.npz")))
    assert saved.keys() == convert.to_flat(other.generator).keys()
    for k, v in convert.to_flat(other.generator).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    for x, y in zip(fresh.d_params, other.d_params):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert other.opt_g.count == 0 and other.global_step == 0
    assert all(float(m.abs().max()) == 0 for m in other.opt_g.mu)
    assert other.opt_g.params[0] is other.g_params[0]


def test_trained_directory_loads_as_vocoder(fitted):
    """``HiFiGAN.from_pretrained`` on the checkpoint directory folds the
    trained generator; its wave equals the trainer's generator's."""
    hp, trainer, logger = fitted
    voc = HiFiGAN.from_pretrained(logger.ckpt_path, device="cpu")
    mel = Masked.from_lengths(torch.from_numpy(np.random.RandomState(4).randn(
        2, 9, 20).astype(np.float32)), [9, 5])
    out = voc.decode(mel)
    with torch.no_grad():
        ref = trainer.generator(mel).apply_mask()
    assert out.value.shape == (2, 9 * 320)
    torch.testing.assert_close(out.value, ref.value, rtol=0, atol=1e-6)


def test_cli_trains_shipped_identifier_on_cpu(corpus, tmp_path):  # noqa
    """``scripts/train.py`` resolves ``trainers.vocoder.hfgan.
    HiFiGANTrainer`` inside the port and trains a step."""
    assert resolve("trainers.vocoder.hfgan.HiFiGANTrainer") is HiFiGANTrainer
    cfg = _hfgan_hp(corpus).to_dict()
    cfg["logging"]["log_dir"] = str(tmp_path / "logs")
    path = tmp_path / "hfgan.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_cli.main(["-c", str(path), "--device", "cpu", "--max_steps", "1",
                    "-n", "cli"])
    ckpt = tmp_path / "logs" / "cli" / "ckpt" / "version_0"
    assert (ckpt / "last-cpt.npz").exists() and (ckpt / "hp.yaml").exists()


# --------------------------------------------------------------- two ranks
def _worker(rank: int, world: int, port: int, work: str) -> None:
    """One gloo rank: the shared weights, this rank's rows of the global
    batch, one step; metrics, gradients and parameters to
    ``work/rank{rank}.npz``."""
    import datetime

    import torch.distributed as dist

    from vae_gslm_tpu_torch.parallel import mesh

    os.environ.update(VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                      VAE_GSLM_NUM_PROCESSES=str(world),
                      VAE_GSLM_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    assert mesh.init_distributed("gloo", datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(work, "cfg.json")) as f:
            hp = Hparams.from_dict(json.load(f))
        tt = HiFiGANTrainer(hp, device="cpu")
        assert tt.world_size == world and tt.rank == rank
        tt.generator.load_state_dict(torch.load(os.path.join(work, "g.pt")))
        tt.disc.load_state_dict(torch.load(os.path.join(work, "d.pt")))
        x = np.load(os.path.join(work, "batch.npy"))
        rows = slice(rank * 2, rank * 2 + 2)
        metrics = tt.run_step(_port_batch(
            x[:, rows], [GLOBAL_LENGTHS[rows]]))
        out = {f"metric.{k}": np.asarray(float(v))
               for k, v in metrics.items()}
        out.update({f"grad.{k}": v.grad.numpy() for k, v in zip(
            tt.g_names + tt.d_names, tt.g_params + tt.d_params)})
        out.update({f"param.{k}": v for k, v in _params(tt).items()})
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path):
    """Two ranks of two rows each (unequal lengths: the mel loss's frame
    count is global) against one process over the four rows: metrics to
    1e-5, parameters as in the JAX comparison; the ranks end bitwise
    equal."""
    hp = _hfgan_hp("unused")
    work = str(tmp_path)
    single = _port_trainer(hp)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(single.hp.to_dict(), f, default=str)
    torch.save(single.generator.state_dict(), os.path.join(work, "g.pt"))
    torch.save(single.disc.state_dict(), os.path.join(work, "d.pt"))
    x = _batch([GLOBAL_LENGTHS], seed=5)
    np.save(os.path.join(work, "batch.npy"), x)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_hfgan_train import _worker; "
         f"_worker({r}, 2, {port}, sys.argv[1])", work],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    want = {k: float(v) for k, v in single.run_step(
        _port_batch(x, [GLOBAL_LENGTHS])).items()}
    grads = {k: p.grad.numpy() for k, p in zip(
        single.g_names + single.d_names, single.g_params + single.d_params)}
    params = _params(single)
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(2)]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    out = ranks[0]
    for k in METRICS:
        np.testing.assert_allclose(out[f"metric.{k}"], want[k], rtol=1e-5,
                                   err_msg=k)
    for k, g in grads.items():
        _near(out[f"grad.{k}"], g, 1e-4, k)
        name = ("g." if k in single.g_names else "d.") + k
        diff = np.abs(out[f"param.{name}"] - params[name])
        big = np.abs(g) > 1e-2 * np.abs(g).max()
        assert (diff[big] <= 1e-2 * LR).all(), (k, diff[big].max())
        assert (diff <= 2 * LR).all(), (k, diff.max())


@pytest.mark.parametrize("build", ["trainer", "mpd", "mrd"])
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, build):
    hp = Hparams.from_dict(_hfgan_hp("unused").to_dict())
    make = {"trainer": lambda **kw: HiFiGANTrainer(hp, **kw),
            "mpd": lambda **kw: th.MultiPeriodDiscriminator(hp.model.mpd,
                                                            **kw),
            "mrd": lambda **kw: th.MultiResolutionDiscriminator(
                hp.model.mrd, **kw)}[build]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(**kw)
    built = make(device="cpu")
    params = (built.g_params + built.d_params if build == "trainer"
              else tuple(built.parameters()))
    assert all(p.device.type == "cpu" for p in params)
