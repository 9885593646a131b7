"""The port's GPipe pipeline (``parallel/pp.py``) and the trainer's
parallel settings against the JAX package's, on the CPU.

  * each of the four modes in a world of one rank: ``model_parallel: 2``
    and ``pipeline_parallel: 2`` name the grid they cannot build (JAX
    builds an empty (0, 2) mesh there and fails on first use);
    ``fsdp`` and ``sequence_parallel`` build a 1 x 1 grid and shard
    nothing, as JAX's one-device data mesh does;
  * ``pipeline_apply`` raises JAX's errors: layers not divisible into
    stages, a batch not divisible into microbatches, a stack that the
    stacked path cannot take;
  * under an active pipeline an ineligible stack (indivisible layers or
    batch, post-LN, LayerNorm, a memory) runs the plain layers, as JAX's
    does, and ``eligible`` says so;
  * two gloo ranks run one tiny-LVTR ``run_step`` with
    ``pipeline_parallel: 2`` and 2 microbatches, held against JAX's
    pipelined ``run_step`` with the tolerances of
    ``tests/test_torch_tp.py``; the gradients AdamW took equal the
    port's single-process gradients (1e-4 x max|g| per tensor) on every
    rank, the encoder's and the trunk input projection's included: not
    twice them (JAX's note on over-counted cotangents upstream of the
    trunk).
Each worker process has a timeout of its own."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_tp import (check_against_jax, cfg, mode_run)  # noqa
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.nn.transformer import TransformerLayerStack as JStack
from vae_gslm_tpu.parallel import pp as jpp
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.nn.transformer import TransformerLayerStack
from vae_gslm_tpu_torch.parallel import mesh, pp
from vae_gslm_tpu_torch.training.trainer import BaseTrainer


def _stack_hp(num_layers=2, preln=True, norm="RMSNorm", rpe="ALiBi"):
    layer = {"ffd_size": 32, "dim": 16, "preln": preln,
             "norm": {"identifier": norm, "eps": 1e-6},
             "activation": {"identifier": "GELU"},
             "self_attn": {"nheads": 4, "causal": True}}
    hp = {"num_layers": num_layers, "bias": False, "layer": layer}
    if rpe:
        hp["rpe"] = {"identifier": rpe, "maxpos": 64}
    return hp


def _grid(n_pipe=2):
    return mesh.Grid("pipe", 1, n_pipe, 0, 0, {"data": None, "pipe": None})


@pytest.mark.parametrize("mode", ["model_parallel", "pipeline_parallel",
                                  "fsdp", "sequence_parallel"])
def test_parallel_modes_in_a_world_of_one(mode):
    val = 2 if mode in ("model_parallel", "pipeline_parallel") else True
    hp = Hparams.from_dict({"model": {}, "data": {}, "trainer": {mode: val}})
    if val == 2:
        axis = "model" if mode == "model_parallel" else "pipe"
        with pytest.raises(ValueError, match=f"2 {axis} ranks do not "
                           "divide the process group's 1"):
            BaseTrainer(hp)
        return
    t = BaseTrainer(hp)
    assert (t.n_data, t.data_index, t.grid.size("model")) == (1, 0, 1)
    assert t._world() == (None, None)
    with t.parallel_context():
        assert pp.active_pipeline() is None


def _jax_error(hp, b, n_micro):
    stack = JStack(JHparams.from_dict(copy.deepcopy(hp)), input_dim=8,
                   rngs=nnx.Rngs(0))
    jmesh = jpp.create_mesh_pipe(2, 1)
    x = jnp.zeros((b, 12, 16), jnp.float32)
    with pytest.raises(ValueError) as e:
        jpp.pipeline_apply(stack, x, jnp.full((b,), 12, jnp.int32), jmesh,
                           n_micro)
    return str(e.value)


@pytest.mark.parametrize("case", ["layers", "batch", "ineligible"])
def test_pipeline_apply_raises_jax_errors(case):
    hp, b = _stack_hp(), 4
    if case == "layers":
        hp = _stack_hp(num_layers=3)
    elif case == "batch":
        b = 3
    else:
        hp = _stack_hp(preln=False)
    want = _jax_error(hp, b, 2)
    stack = TransformerLayerStack(Hparams.from_dict(copy.deepcopy(hp)),
                                  input_dim=8)
    with pp.pipeline(_grid(), 2):
        with pytest.raises(ValueError) as e:
            pp.pipeline_apply(stack, torch.zeros(b, 12, 16),
                              torch.full((b,), 12, dtype=torch.int32))
    assert str(e.value) == want


@pytest.mark.parametrize("case", ["eligible", "layers", "batch", "postln",
                                  "layernorm", "rotary", "memory"])
def test_ineligible_stacks_run_the_plain_layers(case):
    hp, b, memory = _stack_hp(), 4, None
    if case == "layers":
        hp = _stack_hp(num_layers=3)
    elif case == "batch":
        b = 3
    elif case == "postln":
        hp = _stack_hp(preln=False)
    elif case == "layernorm":
        hp = _stack_hp(norm="LayerNorm")
    elif case == "rotary":
        hp = _stack_hp(rpe="Rotary")
    elif case == "memory":
        memory = Masked.full(torch.zeros(b, 5, 16))
    stack = TransformerLayerStack(Hparams.from_dict(copy.deepcopy(hp)),
                                  input_dim=8)
    jstack = JStack(JHparams.from_dict(copy.deepcopy(hp)), input_dim=8,
                    rngs=nnx.Rngs(0))
    with pp.pipeline(_grid(), 2):
        ok = pp.eligible(stack, b, memory, False)
        assert not pp.eligible(stack, b, memory, True)
    # JAX's test (nn/transformer.py:243-266) on its own stack
    want = (memory is None and jstack.num_layers % 2 == 0 and b % 2 == 0
            and jstack.supports_stacked_decode())
    assert ok == want == (case == "eligible")
    if ok:
        return
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in stack.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    x = Masked.full(torch.randn(b, 12, 8, generator=g))
    with torch.no_grad():
        plain = stack(x, memory).value
        with pp.pipeline(_grid(), 2):
            got = stack(x, memory).value
    assert torch.isfinite(plain).all()
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_pipeline_step_matches_jax(cfg, tmp_path_factory):
    run = mode_run(cfg, tmp_path_factory, 2,
                   {"pipeline_parallel": 2, "pipeline_microbatches": 2,
                    "n_devices": 2})
    check_against_jax(run)
    grads = run["grads"]
    for out in run["ranks"]:
        for name, g in grads.items():
            took = out[f"took.{name}"]
            scale = max(np.abs(g).max(), 1e-30)
            assert np.abs(took - g).max() <= 1e-4 * scale, name
        upstream = [n for n in grads if n.startswith(
            ("encoder_net.", "transformer.linear."))
            and np.abs(grads[n]).max() > 1e-6]
        assert upstream
        for n in upstream:                       # once, not twice
            assert np.abs(out[f"took.{n}"] - 2 * grads[n]).max() > \
                1e-2 * np.abs(grads[n]).max(), n
