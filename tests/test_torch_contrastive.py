"""The rest of the training core against the JAX package, on the CPU:

  * ``nn/contrastive.py``: ``InfoNCE`` (with a static-size subset of the
    frames and without one) and ``CPC`` (three predictors), the loss and
    every parameter's gradient against JAX's at float32, the port fed
    JAX's own draws (InfoNCE's uniform ``r``, CPC's ``neg_idx`` per
    predictor), the weights carried from JAX's parameters;
  * the bucket and concat samplers, single and distributed: the batch
    lists of two epochs equal JAX's, index for index (the distributed
    samplers' last shuffle uses the global ``random`` module in both
    packages, so each side starts from the same global seed);
  * ``get_dataloader`` with ``type: bucket`` and ``type: concat``."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.data import sampler as jsampler
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.nn.contrastive import CPC as JCPC
from vae_gslm_tpu.nn.contrastive import InfoNCE as JInfoNCE
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.data import audio as audio_lib
from vae_gslm_tpu_torch.data import sampler as tsampler
from vae_gslm_tpu_torch.data.dataset import StandardDataset
from vae_gslm_tpu_torch.data.loader import get_dataloader
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.nn.contrastive import CPC, InfoNCE

B, T, D1, D2 = 3, 10, 6, 5
LENGTHS = [10, 7, 4]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, D1).astype(np.float32)
    p = rng.randn(B, T, D2).astype(np.float32)
    return q, p


def _carry(jmod, tmod):
    """JAX's dense parameters into the port's modules (kernel (in, out)
    -> weight (out, in))."""
    flat = nnx.to_pure_dict(nnx.state(jmod, nnx.Param))

    def walk(d, prefix=""):
        for k, v in d.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                yield from walk(v, name + ".")
            else:
                yield name, np.asarray(v)

    sd = {}
    for name, v in walk(flat):
        if name.endswith("kernel"):
            sd[name[:-len("kernel")] + "weight"] = torch.from_numpy(v.T.copy())
        else:
            sd[name] = torch.from_numpy(v.copy())
    tmod.load_state_dict(sd, strict=True)


def _grads_close(jgrads, tmod, rtol=1e-5):
    """Every gradient within ``rtol`` x the largest |g| of any leaf."""
    flat = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(nnx.to_pure_dict(jgrads))
    # a bias whose gradient is zero in exact arithmetic (the softmax's
    # shift invariance) holds only rounding: the gate is global
    scale = max(np.abs(v).max() for v in flat.values())
    for name, p in tmod.named_parameters():
        key = name[:-len("weight")] + "kernel" if name.endswith(
            "weight") else name
        want = flat[key].T if name.endswith("weight") else flat[key]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=rtol * scale, err_msg=name)


def _loss_and_grads(jmod, jfn):
    graph, params, rest = nnx.split(jmod, nnx.Param, ...)

    def f(params):
        return jfn(nnx.merge(graph, params, rest))

    return jax.value_and_grad(f)(params)


@pytest.mark.parametrize("num_negatives", [12, 64])
def test_infonce_matches_jax(num_negatives):
    """A 12-frame subset of the 30 (the smallest draws among the valid
    frames) and the whole batch (64 > B*T: no draw)."""
    hp = {"dim": 8, "num_negatives": num_negatives}
    jm = JInfoNCE(JHparams.from_dict(hp), D1, D2, rngs=nnx.Rngs(0))
    tm = InfoNCE(Hparams.from_dict(hp), D1, D2,
                 generator=torch.Generator().manual_seed(0))
    _carry(jm, tm)
    q, p = _inputs()
    key = jax.random.PRNGKey(3)
    jq = JMasked.from_lengths(jnp.asarray(q), jnp.asarray(LENGTHS))
    jp = JMasked.from_lengths(jnp.asarray(p), jnp.asarray(LENGTHS))
    loss, grads = _loss_and_grads(jm, lambda m: m(jq, jp, key))
    r = torch.from_numpy(np.array(jax.random.uniform(key, (B * T,))))
    got = tm(Masked.from_lengths(torch.from_numpy(q), LENGTHS),
             Masked.from_lengths(torch.from_numpy(p), LENGTHS), r=r)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    _grads_close(grads, tm)


def test_cpc_matches_jax():
    hp = {"dim": 8, "num_negatives": 5, "num_predictors": 3}
    jm = JCPC(JHparams.from_dict(hp), D1, D2, rngs=nnx.Rngs(1))
    tm = CPC(Hparams.from_dict(hp), D1, D2,
             generator=torch.Generator().manual_seed(0))
    _carry(jm, tm)
    q, p = _inputs(1)
    key = jax.random.PRNGKey(5)
    jq = JMasked.from_lengths(jnp.asarray(q), jnp.asarray(LENGTHS))
    jp = JMasked.from_lengths(jnp.asarray(p), jnp.asarray(LENGTHS))
    loss, grads = _loss_and_grads(jm, lambda m: m(jq, jp, key))
    neg = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(key, k), (B * (T - k), 5), 0, B * (T - k))))
        for k in range(3)]
    got = tm(Masked.from_lengths(torch.from_numpy(q), LENGTHS),
             Masked.from_lengths(torch.from_numpy(p), LENGTHS), neg_idx=neg)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    _grads_close(grads, tm)


def test_contrastive_losses_draw_from_a_generator():
    """Without given draws each loss draws from the generator: the same
    seed, the same loss; finite."""
    q, p = _inputs(2)
    qm = Masked.from_lengths(torch.from_numpy(q), LENGTHS)
    pm = Masked.from_lengths(torch.from_numpy(p), LENGTHS)
    for mod in (InfoNCE(Hparams.from_dict({"dim": 8, "num_negatives": 9}),
                        D1, D2, generator=torch.Generator().manual_seed(0)),
                CPC(Hparams.from_dict({"dim": 8, "num_negatives": 4,
                                       "num_predictors": 2}), D1, D2,
                    generator=torch.Generator().manual_seed(0))):
        a = mod(qm, pm, torch.Generator().manual_seed(4))
        b = mod(qm, pm, torch.Generator().manual_seed(4))
        assert torch.isfinite(a) and a.item() == b.item()


@pytest.mark.parametrize("time_axis", [1, 2])
def test_masked_shifts_follow_time_axis(time_axis):
    """``push``/``pop``/``pop_left`` (CPC's shifts) against JAX's on
    ``B T C``; on ``B C T`` the same shifts along axis 2, the layout
    kept."""
    q, _ = _inputs(3)
    h = np.random.RandomState(4).randn(B, 2, D1).astype(np.float32)
    jm = JMasked.from_lengths(jnp.asarray(q), jnp.asarray(LENGTHS))
    want = {"push": jm.push(jnp.asarray(h)),
            "pop": jm.pop(2), "pop_left": jm.pop_left(3)}
    x, head = torch.from_numpy(q), torch.from_numpy(h)
    if time_axis == 2:
        x, head = x.transpose(1, 2), head.transpose(1, 2)
    m = Masked.from_lengths(x, LENGTHS, time_axis)
    got = {"push": m.push(head), "pop": m.pop(2), "pop_left": m.pop_left(3)}
    for name, g in got.items():
        assert g.time_axis == time_axis, name
        v = g.value if time_axis == 1 else g.value.transpose(1, 2)
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[name].value))
        np.testing.assert_array_equal(g.lengths.numpy(),
                                      np.asarray(want[name].lengths))


# -------------------------------------------------------------- samplers
LENS = list(np.random.RandomState(9).uniform(0.5, 9.0, size=37))


def _epochs(make, seed: int, distributed: bool):
    """Two epochs of a sampler's batches, the global ``random`` module
    seeded before each (the distributed samplers' last shuffle)."""
    s = make()
    out = []
    for epoch in range(2):
        s.set_epoch(epoch)
        random.seed(seed + epoch)
        out.append([[int(i) for i in b] for b in iter(s)])
    return out


SINGLE = {
    "bucket_count": lambda m: m.SingleRandomBucketSampler(
        4, LENS, batch_size=3, seed=11),
    "bucket_budget": lambda m: m.SingleRandomBucketSampler(
        5, LENS, batch_length=14.0, drop_last=False, seed=12),
    "concat": lambda m: m.SingleConcatLengthSampler(3, 4.0, LENS, seed=13),
    "bucket_factory": lambda m: m.random_bucket_sampler(
        3, LENS, batch_size=4, drop_last=False),
    "concat_factory": lambda m: m.concat_length_sampler(2, 5.0, LENS),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_samplers_match_jax(name):
    if name.endswith("factory"):
        # the factories seed their generator from the OS, as JAX's do:
        # the same class, built the same way
        got, want = SINGLE[name](tsampler), SINGLE[name](jsampler)
        assert type(got).__name__ == type(want).__name__
        keep = lambda d: {k: v for k, v in vars(d).items()  # noqa: E731
                          if k != "rng"}
        assert keep(got) == keep(want)
        return
    got = _epochs(lambda: SINGLE[name](tsampler), 0, False)
    want = _epochs(lambda: SINGLE[name](jsampler), 0, False)
    assert got == want and got[0] != got[1]


DIST = {
    "bucket": lambda m, w, r: m.DistributedRandomBucketSampler(
        4, LENS, w, r, batch_size=2),
    "bucket_budget": lambda m, w, r: m.DistributedRandomBucketSampler(
        3, LENS, w, r, batch_length=12.0, seed=7),
    "concat": lambda m, w, r: m.DistributedConcatLengthSampler(
        2, 3.0, LENS, w, r),
    "bucket_factory": lambda m, w, r: m.random_bucket_sampler(
        4, LENS, batch_size=3, distributed=True, world_size=w, rank=r),
    "concat_factory": lambda m, w, r: m.concat_length_sampler(
        2, 4.0, LENS, distributed=True, world_size=w, rank=r),
}


@pytest.mark.parametrize("name", sorted(DIST))
def test_distributed_samplers_match_jax(name):
    world = 3
    for rank in range(world):
        got = _epochs(lambda: DIST[name](tsampler, world, rank), rank, True)
        want = _epochs(lambda: DIST[name](jsampler, world, rank), rank,
                       True)
        assert got == want and any(got[0])
    with pytest.raises(ValueError):
        DIST[name](tsampler, 2, 2)


@pytest.mark.parametrize("kind", ["bucket", "concat"])
def test_get_dataloader_takes_bucket_and_concat(tmp_path, kind):
    sr = 16000
    lines = []
    for i, sec in enumerate((0.2, 0.5, 0.3, 0.8, 0.4, 0.6)):
        name = f"u{i}.wav"
        audio_lib.save_wav(str(tmp_path / name),
                           np.zeros(int(sr * sec), np.float32), sr)
        lines.append(name)
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    sampler = ({"type": "bucket", "num_buckets": 2} if kind == "bucket"
               else {"type": "concat"})
    hp = Hparams.from_dict({
        "path": str(tmp_path / "list.txt"), "wavdir": str(tmp_path),
        "sample_rate": sr, "with_text": False, "num_workers": 1,
        "batch_size": 2, "length": 0.5 * sr * 2 / 32000,
        "bits_per_second": sr * 2, "sampler": sampler})
    ds = StandardDataset(hp)
    assert len(ds.lengths) == 6
    loader = get_dataloader(hp, ds)
    batches = list(iter(loader.sampler))
    seen = sorted(i for b in batches for i in b)
    assert seen and len(set(seen)) == len(seen)
    for batch in loader:
        assert batch["audio"].value.shape[0] >= 1
