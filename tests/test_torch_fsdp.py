"""The port's FSDP (``parallel/fsdp.py``) against the JAX package's, on
the CPU.

  * ``fsdp_spec`` equals JAX's for a grid of shapes, data sizes, base
    specs and ``min_size``;
  * ``placed_fsdp_spec`` equals JAX's decision (``fsdp_spec`` on top of
    ``_tp_base_spec``) for every parameter of the tiny LVTR and of the
    shipped ``vae-gslm.yaml``, on data-only and (data, model) grids, at
    the default ``min_size`` and at 64 (no processes);
  * two gloo ranks run one tiny-LVTR ``run_step`` with ``fsdp: true``
    (``fsdp_min_size: 64``, so that the dense weights are cut), held
    against JAX's FSDP ``run_step`` on two CPU devices with the
    tolerances of ``tests/test_torch_tp.py``; the ranks keep slices of
    the parameters and of AdamW's moments (half the rows or columns);
  * a checkpoint gathers the whole tensors for rank 0
    (``last-cpt.npz``, ``full_state.pt``), and a fresh pair of ranks
    resumes it and cuts the same slices again (parameters and moments
    bit for bit).
Each worker process has a timeout of its own."""
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_tp import (ROOT, WORKER_TIMEOUT,  # noqa
                                 _jax_spec, check_against_jax, cfg,
                                 flagship_model_cfg, jax_params, mode_cfg,
                                 mode_run, port_model)
from tests.test_torch_parallel import _free_port
from vae_gslm_tpu.parallel import fsdp as jfsdp
from vae_gslm_tpu.parallel import mesh as jmesh
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.parallel import fsdp, mesh, tp
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

SHAPES = [(16, 32), (32, 16), (12, 16), (12, 12), (64, 64), (7, 3, 5),
          (4096,), (3, 4096), (128, 8, 2), (1024, 1024), (6, 128), (2,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_data", [1, 2, 4, 8])
@pytest.mark.parametrize("base", [None, "first", "last"])
@pytest.mark.parametrize("min_size", [2, 4096])
def test_fsdp_spec_matches_jax(shape, n_data, base, min_size):
    b = (None if base is None else
         ("model",) if base == "first" else
         (None,) * (len(shape) - 1) + ("model",))
    want = tuple(jfsdp.fsdp_spec(shape, n_data, b, min_size))
    assert fsdp.fsdp_spec(shape, n_data, b, min_size) == want


@pytest.mark.parametrize("min_size", [64, 4096])
@pytest.mark.parametrize("n_data, n_model", [(2, 1), (4, 1), (2, 2),
                                             (4, 2)])
@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_placed_fsdp_spec_matches_jax(cfg, monkeypatch, which, n_data,
                                      n_model, min_size):
    mc = (mode_cfg(cfg)["model"] if which == "tiny"
          else flagship_model_cfg())
    jp = jax_params(mc)
    model = port_model(mc, monkeypatch)
    cut = 0
    for name, p in model.named_parameters():
        path, kind = convert._flat_name(model, name)
        leaf = jp[path]
        if n_model > 1:
            base = _jax_spec(path, leaf, n_model)
        else:
            base = jfsdp._tp_base_spec(tuple(path.split("/")), leaf,
                                       jmesh.create_mesh(n_data))
        want = tp.port_spec(tuple(jfsdp.fsdp_spec(
            leaf.shape, n_data, base, min_size)), kind, p.dim())
        got = fsdp.placed_fsdp_spec(model, name, p.shape, n_data, n_model,
                                    min_size)
        assert got == want, (name, got, want)
        cut += "data" in got
    # the tiny model's tensors are all under 4096 elements
    assert (cut > 0) == (which == "flagship" or min_size == 64)


def test_fsdp_step_matches_jax(cfg, tmp_path_factory):
    run = mode_run(cfg, tmp_path_factory, 2,
                   {"fsdp": True, "fsdp_min_size": 64, "n_devices": 2})
    check_against_jax(run)
    name = "transformer.layers.0.linear1.weight"      # (32, 16), cut rows
    for out in run["ranks"]:
        assert out[f"took.{name}"].shape == (16, 16)


def _ckpt_worker(rank: int, world: int, port: int, work: str) -> None:
    """Build the FSDP trainer, write a checkpoint through ``checkpoint``
    (rank 0), then a fresh trainer resumes ``full_state.pt``; every rank
    writes its slices before and after and whether the compact
    checkpoint holds the whole parameters."""
    os.environ.update(VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                      VAE_GSLM_NUM_PROCESSES=str(world),
                      VAE_GSLM_PROCESS_ID=str(rank))
    import datetime

    import torch.distributed as dist

    from vae_gslm_tpu_torch.training.logging import ExperimentLogger

    torch.set_num_threads(1)
    assert mesh.init_distributed("gloo", datetime.timedelta(seconds=150))
    try:
        with open(os.path.join(work, "cfg.json")) as f:
            cfg = json.load(f)
        tt = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():          # moments that are not zeros
            for i in range(len(tt.params)):
                tt.opt.mu[i].copy_(torch.randn(tt.opt.mu[i].shape,
                                               generator=g))
                tt.opt.nu[i].copy_(torch.rand(tt.opt.nu[i].shape,
                                              generator=g))
        tt.opt.count, tt.global_step = 3, 3
        tt.logger = ExperimentLogger(os.path.join(work, "logs"),
                                     name="run", version=0)
        out = {f"slice.{n}": p.detach().numpy().copy()
               for n, p in zip(tt.names, tt.params)}
        out.update({f"mu.{n}": m.numpy().copy()
                    for n, m in zip(tt.names, tt.opt.mu)})
        with tt.gathered():
            whole = {n: p.detach().numpy().copy()
                     for n, p in zip(tt.names, tt.params)}
        tt.checkpoint()
        dist.barrier()
        ckpt = tt.logger.ckpt_path
        again = LVTRTrainer(Hparams.from_dict(cfg), seed=9, device="cpu")
        again.resume(os.path.join(ckpt, "full_state.pt"))
        out.update({f"again.{n}": p.detach().numpy().copy()
                    for n, p in zip(again.names, again.params)})
        out.update({f"again_mu.{n}": m.numpy().copy()
                    for n, m in zip(again.names, again.opt.mu)})
        out["again_step"] = np.asarray(again.global_step)
        with np.load(os.path.join(ckpt, "last-cpt.npz")) as z:
            flat = {k: z[k] for k in z.files}
        for n in tt.names:
            path, kind = convert._flat_name(tt.model, n)
            arr = convert._from_jax(flat[path], kind, whole[n].shape)
            out[f"ckpt_ok.{n}"] = np.asarray(
                np.array_equal(arr, whole[n]))
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_fsdp_checkpoint_gathers_and_resume_cuts_again(cfg, tmp_path):
    import subprocess
    import sys

    d = mode_cfg(cfg, fsdp=True, fsdp_min_size=64, n_devices=2)
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(d, f, default=str)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_fsdp import _ckpt_worker; "
         f"_ckpt_worker({r}, 2, {port}, sys.argv[1])", str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    name = "transformer.layers.0.linear1.weight"
    assert outs[0][f"slice.{name}"].shape == (16, 16)
    assert not np.array_equal(outs[0][f"slice.{name}"],
                              outs[1][f"slice.{name}"])
    for out in outs:
        assert int(out["again_step"]) == 3
        for k in [k for k in out if k.startswith("slice.")]:
            n = k[6:]
            np.testing.assert_array_equal(out[f"again.{n}"], out[k],
                                          err_msg=n)
            np.testing.assert_array_equal(out[f"again_mu.{n}"],
                                          out[f"mu.{n}"], err_msg=n)
            assert out[f"ckpt_ok.{n}"], n
