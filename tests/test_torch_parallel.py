"""The port's data-parallel training against the JAX package, on the CPU.

  * ``DistributedSampler`` index lists equal JAX's for every (n, world,
    rank, epoch) tried;
  * under ``flash_mesh`` of two ranks ``SelfAttention`` takes the
    (B, H, T, D) custom VJP (K4/K4b's plain versions) and agrees with
    the packed route to 1e-6 (output) and 1e-5 x max|g| (gradients);
  * two gloo processes each run one step of the tiny LVTR (float32,
    accumulation 2, utterance encoder) on their half of a global batch,
    with pinned draws.  The step equals JAX's single-process
    ``LVTRTrainer.run_step`` over the whole batch (metrics rtol 1e-5,
    ``grad_norm`` 1e-4; parameters 1e-6 where the gradient is above
    1e-6, within 2 lr elsewhere, as ``tests/test_torch_train_step.py``)
    and the port's single-process step (the summed gradients to 1e-4 x
    max|g| per leaf, parameters to 1e-6); the ranks' parameters are
    bitwise equal, and the gradients are the SUM over the ranks: halved
    (the mean) they would miss the single-process gradients.
Each worker process has a timeout of its own."""
import copy
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (ACCUM, N_MELS, T, T_UTT, VOCAB,
                                         _jax_batch, _pair, _torch_batch,
                                         cfg)  # noqa: F401 (fixture)
from vae_gslm_tpu.data import sampler as jsampler
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.data import sampler
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.nn.attention import SelfAttention
from vae_gslm_tpu_torch.nn.positions import ALiBi
from vae_gslm_tpu_torch.parallel import tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B_RANK = 2, 2
B_GLOBAL = WORLD * B_RANK


@pytest.mark.parametrize("n", [23, 24])
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (True, False),
                                                (False, True)])
def test_distributed_sampler_matches_jax(n, world, shuffle, drop_last):
    for rank in range(world):
        ours = sampler.standard_sampler(n, 4, shuffle, distributed=True,
                                        world_size=world, rank=rank,
                                        drop_last=drop_last)
        theirs = jsampler.standard_sampler(n, 4, shuffle, distributed=True,
                                           world_size=world, rank=rank,
                                           drop_last=drop_last)
        for epoch in (0, 1, 5):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == [list(map(int, b)) for b in theirs]
            assert len(ours) == len(theirs)


def test_self_attention_mesh_route_matches_packed(monkeypatch):
    """Two heads of 64 (a packed head grouping): outside the mesh the
    packed K3/K3b route, inside it the (B, H, T, D) K4/K4b route."""
    from vae_gslm_tpu_torch.nn import attention

    calls = []
    for name in ("flash_attention_bhtd", "flash_attention_packed"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    torch.manual_seed(0)
    layer = SelfAttention(128, Hparams.from_dict({"nheads": 2,
                                                  "causal": True}))
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.05 * torch.randn(p.shape))
    rpe = ALiBi(2, 64)
    x = torch.randn(3, 40, 128)
    lengths = torch.tensor([40, 17, 1], dtype=torch.int32)
    outs = []
    for world in (1, 2):
        layer.zero_grad()
        with tp.flash_mesh(world):
            assert tp.active_flash_mesh() == (world > 1)
            y = layer(Masked(x, lengths, 1), rpe)
        (y.value * torch.linspace(-1, 1, 128)).sum().backward()
        outs.append((y.value.detach(), [p.grad.clone()
                                         for p in layer.parameters()]))
    assert calls == ["flash_attention_packed", "flash_attention_bhtd"]
    assert not tp.active_flash_mesh()
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=1e-6)
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def _global_batch():
    """Stacked (ACCUM, B_GLOBAL, ...) numpy arrays and lengths."""
    rng = np.random.RandomState(5)
    lengths = np.asarray([[T, 9, 11, 4], [11, 7, T, 1]], np.int32)
    utt = np.asarray([[T_UTT, 6, 8, 3], [8, T_UTT, 5, 9]], np.int32)
    return {
        "mel": (rng.randn(ACCUM, B_GLOBAL, T, N_MELS).astype(np.float32),
                lengths),
        "tokens": (rng.randint(0, VOCAB, (ACCUM, B_GLOBAL, T)).astype(
            np.int32), lengths),
        "cropped_mel_utt": (rng.randn(ACCUM, B_GLOBAL, T_UTT, N_MELS).astype(
            np.float32), utt),
    }


def _draws(key, cfg, b):
    """The draws of one JAX ``LVTR.__call__`` of ``b`` rows under ``key``
    (``tests/test_torch_train_step.py``'s key splits)."""
    m = cfg["model"]
    k_enc, k_init, k_prior, k_diff, _ = jax.random.split(key, 5)
    kt, kn = jax.random.split(k_diff)
    lat = (b, T, m["latent_dim"])
    out = {
        "posterior": jax.random.normal(k_enc, lat),
        "initial": jax.random.uniform(
            k_init, (b, 1, m["tokens"]["embedding_dim"]), minval=-1.0,
            maxval=1.0),
        "prior": jax.random.normal(k_prior, lat),
        "t": jax.random.randint(kt, (b,), 0,
                                m["decoder"]["diffusion"]["timesteps"]),
        "noise": jax.random.normal(kn, (b, T, N_MELS)),
    }
    return {k: np.array(v) for k, v in out.items()}


def _rows(x, r):
    return x[:, r * B_RANK:(r + 1) * B_RANK]


def _worker(rank: int, world: int, port: int, work: str) -> None:
    """One rank: join the gloo group, load the shared weights, run one
    step on this rank's rows and draws, write metrics, summed gradients
    and parameters to ``work/rank{rank}.npz``."""
    os.environ.update(VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                      VAE_GSLM_NUM_PROCESSES=str(world),
                      VAE_GSLM_PROCESS_ID=str(rank))
    import datetime

    import torch.distributed as dist

    from vae_gslm_tpu_torch.parallel import mesh
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    torch.set_num_threads(1)
    assert mesh.init_distributed("gloo", datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(work, "cfg.json")) as f:
            cfg = json.load(f)
        tt = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
        tt.model.load_state_dict(torch.load(os.path.join(work, "model.pt")))
        assert tt.world_size == world and tt.rank == rank
        with np.load(os.path.join(work, "batch.npz")) as z:
            data = {k: z[k] for k in z.files}
        batch = {k: Masked(torch.from_numpy(_rows(data[k], rank).copy()),
                           torch.from_numpy(_rows(data[k + ".len"],
                                                  rank).copy()), 1)
                 for k in ("mel", "tokens", "cropped_mel_utt")}
        draws = [{k: torch.from_numpy(
            data[f"draw{i}.{k}"][rank * B_RANK:(rank + 1) * B_RANK].copy())
            for k in ("posterior", "initial", "prior", "t", "noise")}
            for i in range(ACCUM)]
        with tt.parallel_context():
            metrics = tt.run_step(batch, draws=draws)
        out = {f"metric.{k}": np.asarray(float(v)) for k, v in
               metrics.items()}
        out.update({f"grad.{n}": p.grad.numpy() for n, p in
                    zip(tt.names, tt.params)})
        out.update({f"param.{n}": p.detach().numpy() for n, p in
                    zip(tt.names, tt.params)})
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_rank_step(cfg, tmp_path_factory):
    """JAX's and the port's single-process steps over the global batch,
    and the two ranks' outputs."""
    work = str(tmp_path_factory.mktemp("ranks"))
    jt, tt = _pair(cfg)
    raw = _global_batch()
    _, key = jax.random.split(jt.rng)          # run_step's split
    draws = [_draws(k, cfg, B_GLOBAL) for k in jax.random.split(key, ACCUM)]
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(cfg, f, default=str)
    torch.save(tt.model.state_dict(), os.path.join(work, "model.pt"))
    arrays = {}
    for k, (v, ln) in raw.items():
        arrays[k], arrays[k + ".len"] = v, ln
    for i, d in enumerate(draws):
        arrays.update({f"draw{i}.{k}": v for k, v in d.items()})
    np.savez(os.path.join(work, "batch.npz"), **arrays)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_parallel import _worker; "
         f"_worker({r}, {WORLD}, {port}, sys.argv[1])", work],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    # the single-process steps run while the ranks start
    want = jt.run_step(_jax_batch(raw))
    single = tt.run_step(_torch_batch(raw), draws=[
        {k: torch.from_numpy(v) for k, v in d.items()} for d in draws])
    outs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    for r in range(WORLD):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    jt.sync_model()
    ref = LVTR(Hparams.from_dict(copy.deepcopy(cfg["model"])),
               input_dim=N_MELS, device="cpu")
    load_reference_lvtr(ref, export_torch_lvtr(jt.model))
    return {"jax": want, "jax_params": dict(ref.named_parameters()),
            "single": single, "tt": tt, "ranks": outs}


def test_two_ranks_match_jax_single_process(two_rank_step):
    want, ranks = two_rank_step["jax"], two_rank_step["ranks"]
    tt = two_rank_step["tt"]
    lr = float(want["lr"])
    for out in ranks:
        assert {k[7:] for k in out if k.startswith("metric.")} == set(want)
        for k in want:
            np.testing.assert_allclose(
                out[f"metric.{k}"], np.asarray(want[k]),
                rtol=1e-4 if k == "grad_norm" else 1e-5, atol=1e-6,
                err_msg=k)
        for name in tt.names:
            w = two_rank_step["jax_params"][name].detach().numpy()
            diff = np.abs(out[f"param.{name}"] - w)
            big = np.abs(out[f"grad.{name}"]) > 1e-6
            assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
            assert (diff <= 2 * lr).all(), (name, diff.max())


def test_two_ranks_match_port_single_process(two_rank_step):
    single, tt = two_rank_step["single"], two_rank_step["tt"]
    for out in two_rank_step["ranks"]:
        for k, v in single.items():
            np.testing.assert_allclose(out[f"metric.{k}"], float(v),
                                       rtol=1e-4 if k == "grad_norm"
                                       else 1e-5, atol=1e-6, err_msg=k)
        for name, p in zip(tt.names, tt.params):
            np.testing.assert_allclose(out[f"param.{name}"],
                                       p.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


def test_ranks_end_bitwise_equal(two_rank_step):
    a, b = two_rank_step["ranks"]
    assert set(a) == set(b)
    for k in a:
        if k.startswith(("param.", "metric.")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_gradients_are_summed_over_ranks(two_rank_step):
    """The ranks' gradients equal the single-process gradient of the
    whole batch (token sums), and their mean, half of it, does not."""
    tt = two_rank_step["tt"]
    out = two_rank_step["ranks"][0]
    summed = mean = 0
    for name, p in zip(tt.names, tt.params):
        g = p.grad.numpy()
        scale = max(np.abs(g).max(), 1e-30)
        summed += np.abs(out[f"grad.{name}"] - g).max() <= 1e-4 * scale
        mean += np.abs(out[f"grad.{name}"] / WORLD - g).max() <= 1e-4 * scale
    big = sum(np.abs(p.grad.numpy()).max() > 1e-6 for p in tt.params)
    assert summed == len(tt.params)
    assert mean <= len(tt.params) - big
