"""The port's LVTR under the options of the rest of the ``nn`` layers
against the JAX LVTR, float32 on the CPU, the weights drawn once with
numpy in JAX's layout and carried into the port through ``load_flat``.

Options (each a small LVTR: 2 trunk layers, d 64):
  * ``rotary``: a ``ResNet`` encoder with GroupNorm, Rotary trunk
    positions with xpos, the rational-quadratic spline flow, a
    ``ConditionalUNet`` denoiser with GroupNorm (the full-width
    configuration of ``chip_smoke.py``'s ``lvtr_options``, cut down);
  * ``t5``: a ``CNNStack`` encoder, the T5 relative bias, ``ConvCoupling``;
  * ``sincos_cross``: SinCos trunk positions and cross-attention layers
    over a 12-wide memory (``memory_dim``).

Per option: the training forward's loss terms (rtol 1e-5 / atol 1e-6)
and every parameter's gradient (1e-4 x its leaf's max |g|), with JAX's
draws handed to the port; ``ARTRSampler`` on its per-layer route under
the deterministic protocol of ``tests/test_torch_per_layer_sampler.py``
(tokens equal, latents 2e-3 / 1e-2); ``likelihood`` (rtol/atol 1e-5);
and a flat checkpoint JAX -> port -> JAX, every array bit for bit.  Also: the
exporter's dict of a ``ConditionalUNet`` model is refused naming
``load_flat``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_per_layer import (  # noqa: F401 (autouse fixture)
    DETERMINISTIC, one_torch_thread)
from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech import sampler as jsampler
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.nn.transformer import TransformerLayerStack as JStack
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR

B, T, TP, MEM_T, MEM_DIM, VOCAB = 2, 12, 6, 5, 12, 11
GN = {"identifier": "GroupNorm", "num_groups": 4, "eps": 1e-5}
RESNET_ENCODER = {
    "identifier": "ResNet", "num_layers": 2, "final_norm": True,
    "layer": {"in_channels": 16, "hidden_channels": 32, "kernel_size": 3,
              "causal_padding": True, "norm": GN,
              "activation": {"identifier": "ReLU"}}}
CNN_ENCODER = {
    "identifier": "CNNStack", "num_layers": 2, "init_channel": 16,
    "out_channels": [16, 16], "resample_rates": [1, 1],
    "resample_ksize": [3, 3],
    "layer": {"norm": {"identifier": "InstanceNorm", "eps": 1e-6},
              "activation": {"identifier": "ReLU"}}}
COND_UNET = {
    "cond_net": {"num_layers": 2,
                 "layer": {"in_channels": 16, "hidden_channels": 32,
                           "kernel_size": 3, "causal_padding": True,
                           "norm": {"identifier": "InstanceNorm",
                                    "eps": 1e-6},
                           "activation": {"identifier": "SiLU"}}},
    "unet": {"num_layers": 2, "final_norm": True,
             "layer": {"in_channels": 16, "hidden_channels": 32,
                       "in_dim": 32, "kernel_size": 3,
                       "causal_padding": True, "condition_type": "concat",
                       "norm": GN, "activation": {"identifier": "SiLU"}}},
    "time_embedding": {"dim": 16, "maxpos": 20,
                       "activation": {"identifier": "SiLU"}}}
SPLINE_FLOW = {
    "identifier": "RationalQuadraticSplineCoupling", "num_layers": 2,
    "conditional": True,
    "layer": {"hidden_dim": 8, "num_bins": 6, "tail_bound": 2.5,
              "activation": {"identifier": "GELU"},
              "norm": {"identifier": "LayerNorm", "eps": 1e-6}}}
CONV_FLOW = {
    "identifier": "ConvCoupling", "num_layers": 2, "conditional": True,
    "layer": {"hidden_dim": 8, "kernel_size": 3, "causal_padding": True,
              "mean_only": False, "scale_range": [0.5, 2.0],
              "activation": {"identifier": "GELU"},
              "norm": {"identifier": "LayerNorm", "eps": 1e-6}}}
OPTIONS = ("rotary", "t5", "sincos_cross")


def options_yaml(name: str) -> dict:
    """The tiny LVTR of ``tests/test_torch_trunk.py`` (trunk widened to
    d 64, four heads of 16) under option ``name``."""
    d = yaml.safe_load(TINY_YAML)
    tr = d["transformer"]
    tr["layer"].update(dim=64, ffd_size=128)
    if name == "rotary":
        d["encoder"] = copy.deepcopy(RESNET_ENCODER)
        tr["rpe"] = {"identifier": "Rotary", "use_xpos": True,
                     "xpos_scale_base": 16}
        tr["flow"] = copy.deepcopy(SPLINE_FLOW)
        d["decoder"]["diffusion"]["identifier"] = "ConditionalUNet"
        d["decoder"]["cond_unet"] = copy.deepcopy(COND_UNET)
    elif name == "t5":
        d["encoder"] = copy.deepcopy(CNN_ENCODER)
        tr["rpe"] = {"identifier": "T5RPE", "bidirectional": False,
                     "num_buckets": 8, "max_distance": 16}
        tr["flow"] = copy.deepcopy(CONV_FLOW)
    else:
        tr["rpe"] = {"identifier": "SinCos", "maxpos": 512}
        tr["layer"]["cross_attn"] = {"nheads": 4}
    return d


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def draw(key: str, shape, rng) -> np.ndarray:
    """A parameter in JAX's layout: kernels and tables N(0, 1/fan in),
    biases N(0, 0.01), norm scales and the rest 1 + N(0, 0.01)."""
    if len(shape) >= 2:
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if key.endswith("bias"):
        return 0.1 * rng.randn(*shape)
    return 1.0 + 0.1 * rng.randn(*shape)


def fill_jax(make, port: torch.nn.Module, seed: int):
    """``make()``'s JAX module built abstractly, its parameters drawn by
    ``draw`` from ``np.random.RandomState(seed)`` and its other variables
    (position tables, schedules) taken from the port's ``to_flat``."""
    module = nnx.eval_shape(make)
    state = nnx.state(module)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        nnx.to_pure_dict(state))
    params = set(_flatten_state(nnx.state(module, nnx.Param)))
    variables = convert.to_flat(port)
    rng = np.random.RandomState(seed)
    vals = []
    for path, leaf in leaves:
        k = _key(path)
        v = draw(k, leaf.shape, rng) if k in params else variables[k]
        vals.append(jnp.asarray(v, leaf.dtype))
    nnx.replace_by_pure_dict(state, jax.tree_util.tree_unflatten(treedef,
                                                                 vals))
    nnx.update(module, state)
    return module


def lvtr_options_pair(name: str, seed: int = 0):
    """A JAX LVTR under option ``name`` with numpy-drawn weights and the
    port's LVTR loaded from its flat checkpoint (``load_flat``)."""
    d = options_yaml(name)
    mem = MEM_DIM if name == "sincos_cross" else None
    tm = LVTR(Hparams.from_dict(copy.deepcopy(d)), input_dim=N_MELS,
              device="cpu", memory_dim=mem)
    jm = fill_jax(lambda: JLVTR(JHparams.from_dict(copy.deepcopy(d)),
                                input_dim=N_MELS, memory_dim=mem,
                                rngs=nnx.Rngs(0)), tm, seed)
    convert.load_flat(tm, _flatten_state(nnx.state(jm)))
    return jm, tm


@pytest.fixture(scope="module", params=OPTIONS)
def pair(request):
    return (request.param,) + lvtr_options_pair(request.param,
                                                 OPTIONS.index(request.param))


def _inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randint(0, VOCAB, (B, T, 1)),
                        rng.randn(B, T, N_MELS)], -1).astype(np.float32)
    lengths = np.asarray([T, 9], np.int32)
    mem = rng.randn(B, MEM_T, MEM_DIM).astype(np.float32)
    mem_lengths = np.asarray([MEM_T, 3], np.int32)
    return x, lengths, mem, mem_lengths


def _jmasked(x, ln):
    return JMasked.from_lengths(jnp.asarray(x), jnp.asarray(ln))


def _tmasked(x, ln):
    return Masked.from_lengths(torch.from_numpy(x), ln)


def _jax_draws(key, hp: dict) -> dict:
    """The draws of one JAX ``LVTR.__call__`` under ``key`` (its five
    keys, then the diffusion's step and noise keys)."""
    k_enc, k_init, k_prior, k_diff, _ = jax.random.split(key, 5)
    kt, kn = jax.random.split(k_diff)
    lat = (B, T, hp["latent_dim"])
    out = {"posterior": jax.random.normal(k_enc, lat, jnp.float32),
           "initial": jax.random.uniform(
               k_init, (B, 1, hp["tokens"]["embedding_dim"]), jnp.float32,
               -1.0, 1.0),
           "prior": jax.random.normal(k_prior, lat, jnp.float32),
           "t": jax.random.randint(
               kt, (B,), 0, hp["decoder"]["diffusion"]["timesteps"]),
           "noise": jax.random.normal(kn, (B, T, N_MELS), jnp.float32)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _objective(out) -> list:
    """The forward's differentiable outputs, and one scalar of them."""
    terms = [out["log_p"].value.sum(), out["log_q"].value.sum(),
             out["rec_loss"], out["ce_loss"]]
    return terms, terms[0] + terms[1] - terms[2] - terms[3]


def test_forward_and_gradients_match_jax(pair):
    name, jm, tm = pair
    x, ln, mem, mem_ln = _inputs(1)
    cross = name == "sincos_cross"
    key = jax.random.PRNGKey(3)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    @jax.jit
    def loss(params, x, c):
        m = nnx.merge(graphdef, params, rest)
        terms, total = _objective(m(x, key, c=c))
        return total, terms

    jc = _jmasked(mem, mem_ln) if cross else None
    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(
        params, _jmasked(x, ln), jc)
    tc = _tmasked(mem, mem_ln) if cross else None
    tm.zero_grad()
    terms, total = _objective(tm(_tmasked(x, ln), None, c=tc,
                                 draws=_jax_draws(key, options_yaml(name))))
    total.backward()
    for what, got, ref in zip(("log_p", "log_q", "rec_loss", "ce_loss"),
                              terms, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=what)
    jflat = _flatten_state(jgrads)
    seen = set()
    for pname, p in tm.named_parameters():
        path, kind = convert._flat_name(tm, pname)
        seen.add(path)
        g = convert._to_jax(p.grad.numpy(), kind)
        w = jflat[path]
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= 1e-4 * scale, (path, err, scale)
    assert seen == set(jflat)


def test_per_layer_sampler_matches_jax(pair, monkeypatch):
    name, jm, tm = pair
    init = (np.random.RandomState(5).rand(B, 1, 16) * 2 - 1).astype(
        np.float32)
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None:
                        jnp.asarray(init))
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init))
    rng = np.random.RandomState(2)
    prompt = np.concatenate([rng.randint(0, VOCAB, (B, TP, 1)),
                             rng.randn(B, TP, N_MELS)], -1).astype(
                                 np.float32)
    lengths = np.full((B,), TP)
    tsamp = ARTRSampler(tm, device="cpu")
    assert tsamp.route(B) == "per_layer"
    assert not tm.transformer.supports_stacked_decode()
    steps = 10
    want = jsampler.ARTRSampler(jm)(steps, _jmasked(prompt, lengths),
                                   jax.random.PRNGKey(0), **DETERMINISTIC)
    got = tsamp(steps, _tmasked(prompt, lengths),
                torch.Generator().manual_seed(0), **DETERMINISTIC)
    jf, tf = np.array(want["frames"].value), got["frames"].value.numpy()
    assert tf.shape == jf.shape == (B, TP + steps, 5)
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0], err_msg="tokens")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")
    assert got["output"].value.shape == want["output"].value.shape
    assert np.isfinite(got["output"].value.numpy()).all()


def test_likelihood_matches_jax(pair, monkeypatch):
    """With the memory of the cross-attention trunk, which JAX's
    ``likelihood`` does not pass on, handed to JAX's trunk by a patched
    ``TransformerLayerStack.__call__``."""
    name, jm, tm = pair
    x, ln, mem, mem_ln = _inputs(3)
    tc = None
    if name == "sincos_cross":
        jc, tc = _jmasked(mem, mem_ln), _tmasked(mem, mem_ln)
        monkeypatch.setattr(JStack, "__call__",
                            lambda self, tgt, memory=None:
                            self.run(tgt, memory=jc)["output"])
    init = (np.random.RandomState(4).rand(B, 1, 16) * 2 - 1).astype(
        np.float32)
    jm.initial_state = lambda key, bsize, nfeat=None: jnp.asarray(init)
    tm.initial_state = (lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init))
    graphdef, state = nnx.split(jm)

    @jax.jit
    def likelihood(state, x):
        return nnx.merge(graphdef, state).likelihood(x, jax.random.PRNGKey(0))

    try:
        want = np.asarray(likelihood(state, _jmasked(x, ln)))
        with torch.no_grad():
            got = tm.likelihood(_tmasked(x, ln), None, c=tc).numpy()
    finally:
        del jm.initial_state, tm.initial_state
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flat_checkpoint_round_trip_is_bit_equal(pair):
    """JAX's compact dict -> the port (strict) -> ``to_flat`` -> a fresh
    JAX model: every key, every array bit for bit (the port's recomputed
    variables included)."""
    name, jm, tm = pair
    flat = _flatten_state(nnx.state(jm))
    back = convert.to_flat(tm)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    if name == "rotary":
        assert "transformer/rpe/freqs" in back
        assert "transformer/rpe/scale" in back
    d = options_yaml(name)
    mem = MEM_DIM if name == "sincos_cross" else None
    jm2 = fill_jax(lambda: JLVTR(JHparams.from_dict(d), input_dim=N_MELS,
                                 memory_dim=mem, rngs=nnx.Rngs(0)),
                   tm, seed=99)
    state = nnx.state(jm2)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        nnx.to_pure_dict(state))
    nnx.replace_by_pure_dict(state, jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(back[_key(p)]) for p, _ in leaves]))
    nnx.update(jm2, state)
    again = _flatten_state(nnx.state(jm2))
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(again[k]), np.asarray(v),
                                      err_msg=k)


def test_exporter_dict_of_conditional_unet_model_is_refused():
    """JAX's ``export_torch_lvtr`` drops a ``ConditionalUNet`` denoiser;
    the reference loader raises and names ``load_flat``."""
    jm, tm = lvtr_options_pair("rotary", seed=7)
    sd = export_torch_lvtr(jm)
    assert not any(k.startswith("decoder.") for k in sd)
    with pytest.raises(KeyError, match="load_flat"):
        convert.load_reference_lvtr(tm, sd)
