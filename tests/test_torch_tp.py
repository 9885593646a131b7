"""The port's model axis and sequence parallelism against the JAX
package's, on the CPU.

  * ``placed_spec`` (JAX's ``param_spec`` with ``shard_params``'s
    fallback, in the port's layouts) equals JAX's decision for every
    parameter of the tiny LVTR and of the shipped ``vae-gslm.yaml`` (no
    processes; the flagship built abstractly in JAX and on torch's meta
    device), at 2, 3 and 4 model ranks; on the tiny model also the specs
    that ``jax.device_put`` gives on the 8-device CPU mesh;
  * ``active_flash_mesh`` keeps or drops each axis as JAX's does;
  * a head-aligned qkv cut, row and column cuts and ``gather_full``
    invert each other;
  * two gloo ranks run one tiny-LVTR ``run_step`` (float32, 2 layers,
    4 heads, accumulation 2, clipping on) with ``model_parallel: 2``,
    with and without ``sequence_parallel``, and four ranks run data 2 x
    model 2 with FSDP and sequence parallelism; each is held against
    JAX's ``run_step`` with the same trainer settings on the conftest's
    8-device CPU mesh, with the draws pinned: metrics rtol 1e-5
    (``grad_norm`` 1e-4), parameters 1e-6 where the gradient is above
    1e-6 and within 2 lr elsewhere, as ``tests/test_torch_parallel.py``
    holds data parallelism; the sharded sums only reorder float32
    additions of a handful of terms, which these bounds absorb.  Every
    rank of a data row ends with the same parameters.
Each worker process has a timeout of its own."""
import copy
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_parallel import _draws, _free_port, _global_batch
from tests.test_torch_train_step import (ACCUM, N_MELS, _jax_batch,  # noqa
                                         _torch_batch, cfg)
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.parallel import fsdp as jfsdp
from vae_gslm_tpu.parallel import tp as jtp
from vae_gslm_tpu.trainers.speech.lvtr import LVTRTrainer as JTrainer
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech import lvtr as lvtr_mod
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.parallel import mesh, tp
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_GLOBAL = 4
WORKER_TIMEOUT = 200


def mode_cfg(cfg, **trainer):
    """The tiny LVTR config with a 2-layer trunk and ``trainer`` keys."""
    d = copy.deepcopy(cfg)
    d["model"]["transformer"]["num_layers"] = 2
    d["trainer"].update(trainer)
    return d


# ----------------------------------------------------------- decisions
def flat_leaves(state) -> dict:
    """{flax path: leaf} of an nnx state (abstract or placed leaves)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        nnx.to_pure_dict(state))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in leaves}


def jax_params(model_cfg, n_mels=N_MELS):
    """{flax path: ShapeDtypeStruct} of a JAX LVTR built abstractly."""
    m = nnx.eval_shape(lambda: JLVTR(JHparams.from_dict(copy.deepcopy(
        model_cfg)), input_dim=n_mels, rngs=nnx.Rngs(0)))
    return flat_leaves(nnx.state(m, nnx.Param))


def port_model(model_cfg, monkeypatch, n_mels=N_MELS):
    """The port's LVTR on torch's meta device (shapes only)."""
    monkeypatch.setattr(lvtr_mod, "resolve_device", torch.device)
    monkeypatch.setattr(lvtr_mod, "init_parameters", lambda *a: None)
    return LVTR(Hparams.from_dict(copy.deepcopy(model_cfg)),
                input_dim=n_mels, device="meta",
                generator=torch.Generator())


def flagship_model_cfg():
    with open(os.path.join(ROOT, "configs/train/speech/vae-gslm.yaml")) as f:
        return yaml.safe_load(f)["model"]


def _jax_spec(path, leaf, n_model):
    mesh2 = jtp.create_mesh_2d(n_model)
    return tuple(jfsdp._tp_base_spec(tuple(path.split("/")), leaf, mesh2))


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_placed_spec_matches_jax(cfg, monkeypatch, which, n_model):
    mc = (mode_cfg(cfg)["model"] if which == "tiny"
          else flagship_model_cfg())
    jp = jax_params(mc)
    model = port_model(mc, monkeypatch)
    seen, sharded = set(), 0
    for name, p in model.named_parameters():
        path, kind = convert._flat_name(model, name)
        want = tp.port_spec(_jax_spec(path, jp[path], n_model), kind,
                             p.dim())
        got = tp.placed_spec(model, name, p.shape, n_model)
        assert got == want, (name, got, want)
        sharded += "model" in got
        seen.add(path)
    assert seen == set(jp)
    assert sharded > 0


def test_placed_spec_matches_jax_device_put(cfg, monkeypatch):
    """The tiny model's specs as ``jtp.shard_params`` places them on a
    (4, 2) mesh of the CPU devices."""
    mc = mode_cfg(cfg)["model"]
    jm = JLVTR(JHparams.from_dict(copy.deepcopy(mc)), input_dim=N_MELS,
               rngs=nnx.Rngs(0))
    placed = jtp.shard_params(nnx.state(jm, nnx.Param),
                              jtp.create_mesh_2d(2))
    flat = flat_leaves(placed)
    model = port_model(mc, monkeypatch)
    for name, p in model.named_parameters():
        path, kind = convert._flat_name(model, name)
        spec = tuple(flat[path].sharding.spec)
        spec = spec + (None,) * (flat[path].ndim - len(spec))
        assert tp.placed_spec(model, name, p.shape, 2) == tp.port_spec(
            spec, kind, p.dim()), name


@pytest.mark.parametrize("n_data, n_model", [(1, 1), (2, 1), (1, 2),
                                             (2, 2), (1, 4), (4, 2)])
@pytest.mark.parametrize("nheads", [4, 6])
def test_active_flash_mesh_matches_jax(n_data, n_model, nheads):
    devices = np.asarray(jax.devices()[: n_data * n_model]).reshape(
        n_data, n_model)
    jmesh = jax.sharding.Mesh(devices, ("data", "model"))
    with jtp.flash_mesh(jmesh):
        want = jtp.active_flash_mesh(nheads, 8 * n_data) is not None
    with tp.flash_mesh(n_data, n_model):
        assert tp.active_flash_mesh(nheads) == want
    assert not tp.active_flash_mesh(nheads)


@pytest.mark.parametrize("kind", ["qkv", "rows", "cols"])
@pytest.mark.parametrize("n", [2, 4])
def test_cut_and_gather_invert(monkeypatch, kind, n):
    full = torch.randn(12 * n, 8 * n)
    cuts = [tp.cut(full, tp.ParamShard(kind, tp.TPShard(None, n, r)))
            for r in range(n)]
    dim = 1 if kind == "cols" else 0
    monkeypatch.setattr(mesh, "all_gather_dim",
                        lambda x, d, group: torch.cat(cuts, d))
    ps = tp.ParamShard(kind, tp.TPShard(None, n, 0))
    torch.testing.assert_close(tp.gather_full(cuts[0], ps), full,
                               rtol=0, atol=0)
    if kind == "qkv":            # rank r holds heads r of q, k and v
        q, k, v = full.chunk(3, 0)
        torch.testing.assert_close(cuts[1], torch.cat(
            [q.chunk(n)[1], k.chunk(n)[1], v.chunk(n)[1]]))
    assert all(c.shape[dim] == full.shape[dim] // n for c in cuts)


# ------------------------------------------------------------ two ranks
def _mode_worker(rank: int, world: int, port: int, work: str) -> None:
    """One rank: join the gloo group, build the trainer of ``cfg.json``,
    load the shared whole weights, run one step on its data row's rows
    and draws, write metrics, the gradients AdamW took and the whole
    parameters to ``work/rank{rank}.npz``."""
    os.environ.update(VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                      VAE_GSLM_NUM_PROCESSES=str(world),
                      VAE_GSLM_PROCESS_ID=str(rank))
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    assert mesh.init_distributed("gloo", datetime.timedelta(seconds=150))
    try:
        with open(os.path.join(work, "cfg.json")) as f:
            cfg = json.load(f)
        tt = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
        with tt.gathered():
            tt.model.load_state_dict(torch.load(os.path.join(work,
                                                             "model.pt")))
        n_rank = B_GLOBAL // tt.n_data
        rows = slice(tt.data_index * n_rank, (tt.data_index + 1) * n_rank)
        with np.load(os.path.join(work, "batch.npz")) as z:
            data = {k: z[k] for k in z.files}
        batch = {k: Masked(torch.from_numpy(data[k][:, rows].copy()),
                           torch.from_numpy(data[k + ".len"][:, rows]
                                            .copy()), 1)
                 for k in ("mel", "tokens", "cropped_mel_utt")}
        draws = [{k: torch.from_numpy(data[f"draw{i}.{k}"][rows].copy())
                  for k in ("posterior", "initial", "prior", "t", "noise")}
                 for i in range(ACCUM)]
        took = []
        step = tt.opt.step
        tt.opt.step = lambda grads, **kw: (took.extend(
            g.detach().clone() for g in grads), step(grads, **kw))
        with tt.parallel_context():
            metrics = tt.run_step(batch, draws=draws)
        out = {f"metric.{k}": np.asarray(float(v)) for k, v in
               metrics.items()}
        out.update({f"took.{n}": g.numpy() for n, g in zip(tt.names, took)})
        out.update({f"whole.{n}": tt.full_tensor(g, i).numpy()
                    for i, (n, g) in enumerate(zip(tt.names, took))})
        with tt.gathered():
            out.update({f"param.{n}": p.detach().numpy().copy()
                        for n, p in zip(tt.names, tt.params)})
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def mode_run(cfg, tmp_path_factory, world: int, trainer: dict,
             worker: str = "_mode_worker", module: str = "tests.test_torch_tp"
             ):
    """JAX's ``run_step`` with ``trainer`` settings on the CPU mesh, the
    port's on ``world`` gloo ranks and in one process without the mode,
    from the same weights, batch and draws: JAX's metrics, lr and new
    parameters (by port name), the ranks' outputs and the single-process
    gradients."""
    work = str(tmp_path_factory.mktemp("mode"))
    d = mode_cfg(cfg, **trainer)
    jt = JTrainer(JHparams.from_dict(copy.deepcopy(d)))
    base = mode_cfg(cfg)
    base["trainer"]["n_devices"] = 1
    tt = LVTRTrainer(Hparams.from_dict(copy.deepcopy(base)), device="cpu")
    load_reference_lvtr(tt.model, export_torch_lvtr(jt.model))
    torch.save(tt.model.state_dict(), os.path.join(work, "model.pt"))
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(d, f, default=str)
    raw = _global_batch()
    _, key = jax.random.split(jt.rng)          # run_step's split
    draws = [_draws(k, d, B_GLOBAL) for k in jax.random.split(key, ACCUM)]
    arrays = {}
    for k, (v, ln) in raw.items():
        arrays[k], arrays[k + ".len"] = v, ln
    for i, dr in enumerate(draws):
        arrays.update({f"draw{i}.{k}": v for k, v in dr.items()})
    np.savez(os.path.join(work, "batch.npz"), **arrays)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; from {module} import {worker}; "
         f"{worker}({r}, {world}, {port}, sys.argv[1])", work],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        want = jt.run_step(_jax_batch(raw))    # while the ranks start
        tt.run_step(_torch_batch(raw), draws=[
            {k: torch.from_numpy(v) for k, v in dr.items()} for dr in draws])
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    outs = []
    for r in range(world):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    jt.sync_model()
    ref = LVTR(Hparams.from_dict(copy.deepcopy(base["model"])),
               input_dim=N_MELS, device="cpu")
    load_reference_lvtr(ref, export_torch_lvtr(jt.model))
    return {"jax": want, "lr": float(want["lr"]), "ranks": outs,
            "jax_params": {n: p.detach().numpy()
                           for n, p in ref.named_parameters()},
            "grads": {n: p.grad.numpy() for n, p in zip(tt.names,
                                                        tt.params)}}


def check_against_jax(run):
    """Every rank's metrics and new parameters against JAX's step, the
    parameters at 1e-6 where the port's single-process gradient is above
    1e-6 and within 2 lr elsewhere; the whole gradients AdamW took (the
    ranks' slices gathered) against the port's single-process gradients
    at 1e-4 x max|g| per tensor (Adam's first step reads only their
    sign, so the parameters alone would not see a wrong scale); the
    ranks of a data row equal."""
    want, params, lr, outs, grads = (run["jax"], run["jax_params"],
                                     run["lr"], run["ranks"], run["grads"])
    for out in outs:
        assert {k[7:] for k in out if k.startswith("metric.")} == set(want)
        for k in want:
            np.testing.assert_allclose(
                out[f"metric.{k}"], np.asarray(want[k]),
                rtol=1e-4 if k == "grad_norm" else 1e-5, atol=1e-6,
                err_msg=k)
        for name, g in grads.items():
            scale = max(np.abs(g).max(), 1e-30)
            gerr = np.abs(out[f"whole.{name}"] - g).max()
            assert gerr <= 1e-4 * scale, (name, gerr, scale)
            diff = np.abs(out[f"param.{name}"] - params[name])
            big = np.abs(g) > 1e-6
            assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
            assert (diff <= 2 * lr).all(), (name, diff.max())
    for out in outs[1:]:
        for name in grads:
            np.testing.assert_array_equal(out[f"param.{name}"],
                                          outs[0][f"param.{name}"],
                                          err_msg=name)


@pytest.mark.parametrize("seq", [True, False])
def test_model_parallel_step_matches_jax(cfg, tmp_path_factory, seq):
    run = mode_run(cfg, tmp_path_factory, 2,
                   {"model_parallel": 2, "n_devices": 2,
                    "sequence_parallel": seq})
    check_against_jax(run)
    # each rank took its own heads' slice of the sharded gradients
    name = "transformer.layers.0.self_attn.in_proj.weight"
    for r, out in enumerate(run["ranks"]):
        g = run["grads"][name]
        q, k, v = (c[8 * r:8 * (r + 1)] for c in np.split(g, 3))
        np.testing.assert_allclose(out[f"took.{name}"],
                                   np.concatenate([q, k, v]), rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def test_four_ranks_data_model_fsdp_sequence_parallel(cfg,
                                                      tmp_path_factory):
    run = mode_run(cfg, tmp_path_factory, 4,
                   {"model_parallel": 2, "n_devices": 4,
                    "sequence_parallel": True, "fsdp": True,
                    "fsdp_min_size": 64})
    check_against_jax(run)
