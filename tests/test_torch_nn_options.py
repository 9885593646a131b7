"""The rest of the port's ``nn`` layers against their JAX counterparts,
float32 on the CPU, on numpy inputs from a seed, the JAX weights drawn
with numpy (``tests/test_torch_lvtr_options.py::fill_jax``) and carried
into the port through ``load_flat``.

Tolerances: forwards 1e-5 max abs (GroupNorm, ResNet, ConditionalUNet,
the couplings both ways and their log-determinants, positions, self- and
cross-attention, decode steps, RVQ, the MLP stack, the Gumbel head);
gradients of a fixed random projection of the output 1e-4 x each leaf's
max |g| (parameters and inputs).  Also: the spline's bins on its knots
against JAX's picks, reverse(forward(x)) == x for both couplings, Rotary
with and without xpos at offset 0 and at decode offsets, the T5 bias
computed once per stack call, T5 adding no bias at decode (JAX's rule),
cross-attention decode against full-memory attention, ``Dropout`` at
rate 0 and p with a fixed generator, the trainer's init rules for
cross-attention and T5 tables, and Rotary's variables in the flat
checkpoint."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_lvtr_options import fill_jax, lvtr_options_pair
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.nn import attention as jattention
from vae_gslm_tpu.nn import conv as jconv
from vae_gslm_tpu.nn import flow as jflow
from vae_gslm_tpu.nn import linear as jlinear
from vae_gslm_tpu.nn import norms as jnorms
from vae_gslm_tpu.nn import positions as jpositions
from vae_gslm_tpu.nn import transformer as jtransformer
from vae_gslm_tpu.nn import unet as junet
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.nn import attention, conv, flow, linear, norms
from vae_gslm_tpu_torch.nn import positions, transformer, unet
from vae_gslm_tpu_torch.training.trainer import init_weights

B, T = 2, 11
LENGTHS = np.asarray([T, 7], np.int32)
GN = {"identifier": "GroupNorm", "num_groups": 4, "eps": 1e-5}
LN = {"identifier": "LayerNorm", "eps": 1e-6}


def hp_pair(d: dict):
    return JHparams.from_dict(copy.deepcopy(d)), Hparams.from_dict(
        copy.deepcopy(d))


def pair(jmake, tmake, seed: int = 0):
    """A JAX module with numpy-drawn weights and the port's loaded from
    its flat state."""
    tm = tmake()
    jm = fill_jax(jmake, tm, seed)
    convert.load_flat(tm, _flatten_state(nnx.state(jm)))
    return jm, tm


def jmask(x, lengths=LENGTHS):
    return JMasked.from_lengths(jnp.asarray(x), jnp.asarray(lengths))


def tmask(x, lengths=LENGTHS):
    return Masked.from_lengths(x, torch.from_numpy(np.asarray(lengths)))


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def near(got, want, what="", atol=1e-5, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def parity(jm, tm, jcall, tcall, xs, seed=0):
    """Forward ``jcall(jm, *xs)`` against ``tcall(tm, *xs)`` (1e-5), then
    the gradients of a random projection of the output with respect to
    every parameter and input (1e-4 x max |g| of each)."""
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    jxs = [jnp.asarray(x) for x in xs]
    jout = jax.jit(lambda params, xs: jcall(
        nnx.merge(graphdef, params, rest), *xs))(params, jxs)
    proj = randn(*jout.shape, seed=seed + 100)

    def f(params, xs):
        out = jcall(nnx.merge(graphdef, params, rest), *xs)
        return (out * proj).sum()

    jg, jxg = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jxs)
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    tm.zero_grad()
    tout = tcall(tm, *txs)
    near(tout, jout, "forward")
    (tout * torch.from_numpy(proj)).sum().backward()
    want = _flatten_state(jg)
    for name, p in tm.named_parameters():
        path, kind = convert._flat_name(tm, name)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        _grad_close(convert._to_jax(g.numpy(), kind), want.pop(path), path)
    assert not want, sorted(want)
    for i, (tx, jx) in enumerate(zip(txs, jxg)):
        _grad_close(tx.grad.numpy(), jx, f"input {i}")


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * scale, (what, err, scale)


# ------------------------------------------------------------- norms, conv
@pytest.mark.parametrize("layout", ["btc", "ncw"])
def test_group_norm_matches_jax(layout):
    jm, tm = pair(lambda: jnorms.GroupNorm(4, 16, 1e-5, rngs=nnx.Rngs(0)),
                  lambda: norms.get_norm(16, Hparams.from_dict(GN)))
    x = randn(B, T, 16, seed=1) * 3 + 1
    if layout == "btc":
        parity(jm, tm, lambda m, x: m(x), lambda m, x: m(x), [x])
    else:
        parity(jm, tm, lambda m, x: m(x),
               lambda m, x: m(x.transpose(1, 2), dim=1).transpose(1, 2), [x])


def test_dropout_rates_and_draws(monkeypatch):
    """Rate 0 is the identity; rate p keeps about 1 - p of the elements
    under a fixed generator and scales them by 1 / (1 - p); with a given
    keep mask the port equals JAX's ``Dropout`` fed the same mask."""
    x = torch.from_numpy(randn(64, 100, 16, seed=2))
    assert conv.Dropout(0.0)(x, deterministic=False) is x
    assert conv.Dropout(0.3)(x) is x                # deterministic default
    g = torch.Generator().manual_seed(0)
    y = conv.Dropout(0.3)(x, deterministic=False, generator=g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01, kept
    np.testing.assert_allclose(y[y != 0].numpy(),
                               (x[y != 0] / 0.7).numpy(), rtol=1e-6)
    keep = np.random.RandomState(3).rand(*x.shape) < 0.7
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    want = jconv.Dropout(0.3, rngs=nnx.Rngs(0))(jnp.asarray(x.numpy()),
                                                deterministic=False)
    got = conv.Dropout(0.3)(x, deterministic=False,
                            keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the blocks hold a dropout, the identity in their forward as in JAX
    hp = {"in_channels": 8, "hidden_channels": 16, "kernel_size": 3,
          "dropout": 0.5, "norm": LN, "activation": {"identifier": "ReLU"}}
    block = conv.ResidualBlock(Hparams.from_dict(hp))
    assert block.dropout.rate == 0.5


RESNET = {"num_layers": 3, "final_norm": True, "first_norm": True,
          "resample_rates": [2, 1, -2], "resample_ksize": [4, 3, 4],
          "layer": {"in_channels": 16, "hidden_channels": 32,
                    "kernel_size": 3, "causal_padding": True, "norm": GN,
                    "activation": {"identifier": "SiLU"}}}


@pytest.mark.parametrize("conditional", [False, True])
def test_resnet_matches_jax(conditional):
    d = copy.deepcopy(RESNET)
    if conditional:                   # the condition keeps its length
        d["layer"]["in_dim"] = 6          # FiLM over a 6-wide condition
        del d["resample_rates"], d["resample_ksize"]
    jh, th = hp_pair(d)
    jm, tm = pair(lambda: jconv.ResNet(jh, input_dim=5, output_dim=3,
                                       conditional=conditional,
                                       rngs=nnx.Rngs(0)),
                  lambda: conv.ResNet(th, input_dim=5, output_dim=3,
                                      conditional=conditional), seed=1)
    assert tm.sample_ratio == jm.sample_ratio == 1.0
    x, c = randn(B, T + 1, 5, seed=3), randn(B, T + 1, 6, seed=4)
    ln = np.asarray([T + 1, 6], np.int32)
    if conditional:
        parity(jm, tm, lambda m, x, c: m(jmask(x, ln), jmask(c, ln)).value,
               lambda m, x, c: m(tmask(x, ln), tmask(c, ln)).value, [x, c])
    else:
        parity(jm, tm, lambda m, x: m(jmask(x, ln)).value,
               lambda m, x: m(tmask(x, ln)).value, [x])


def test_conditional_unet_matches_jax():
    layer = {"in_channels": 16, "hidden_channels": 32, "kernel_size": 3,
             "causal_padding": True, "norm": GN,
             "activation": {"identifier": "SiLU"}}
    d = {"cond_net": {"num_layers": 2, "layer": dict(layer)},
         "unet": {"num_layers": 2, "final_norm": True,
                  "layer": dict(layer, in_dim=32, condition_type="concat")},
         "time_embedding": {"dim": 8, "maxpos": 30,
                            "activation": {"identifier": "SiLU"}}}
    jh, th = hp_pair(d)
    jm, tm = pair(lambda: junet.ConditionalUNet(6, 5, jh, rngs=nnx.Rngs(0)),
                  lambda: unet.ConditionalUNet(6, 5, th), seed=2)
    steps = np.asarray([3, 27], np.int32)
    parity(jm, tm,
           lambda m, x, c: m(jmask(x), jnp.asarray(steps), jmask(c)).value,
           lambda m, x, c: m(tmask(x), torch.from_numpy(steps),
                             tmask(c)).value,
           [randn(B, T, 5, seed=5), randn(B, T, 6, seed=6)])


# ------------------------------------------------------------------ flows
CONV_COUPLING = {"hidden_dim": 12, "kernel_size": 3, "causal_padding": True,
                 "mean_only": False, "scale_range": [0.5, 2.0],
                 "activation": {"identifier": "GELU"}, "norm": GN,
                 "bias": True}
SPLINE = {"hidden_dim": 8, "num_bins": 5, "tail_bound": 2.0,
          "activation": {"identifier": "GELU"}, "norm": LN}


def _coupling_pair(kind: str, seed: int):
    hp = CONV_COUPLING if kind == "conv" else SPLINE
    jcls = (jflow.ConvCoupling if kind == "conv"
            else jflow.RationalQuadraticSplineCoupling)
    tcls = (flow.ConvCoupling if kind == "conv"
            else flow.RationalQuadraticSplineCoupling)
    jh, th = hp_pair(hp)
    return pair(lambda: jcls(6, True, jh, condition_dim=4, rngs=nnx.Rngs(0)),
                lambda: tcls(6, True, th, condition_dim=4), seed)


@pytest.mark.parametrize("kind", ["conv", "spline"])
@pytest.mark.parametrize("direction", ["forward", "logdet", "reverse"])
def test_coupling_matches_jax(kind, direction):
    jm, tm = _coupling_pair(kind, seed=3)
    x = randn(B, T, 6, seed=7) * 1.5        # some beyond the tail bound
    c = randn(B, T, 4, seed=8)
    pick = {"forward": lambda r: r.tensor.value,
            "logdet": lambda r: r.logdet}[direction] \
        if direction != "reverse" else None
    if direction == "reverse":
        # JAX's spline inverse has NaN gradients outside its tail bound
        # (nothing differentiates the sampler's reverse): all inputs
        # forward, the inner ones for the gradients
        jrev = nnx.jit(lambda m, x, c: m.reverse(jmask(x), jmask(c)).value)
        near(tm.reverse(tmask(torch.from_numpy(x)), tmask(torch.from_numpy(
            c))).value, jrev(jm, x, c), "reverse")
        parity(jm, tm, lambda m, x, c: m.reverse(jmask(x), jmask(c)).value,
               lambda m, x, c: m.reverse(tmask(x), tmask(c)).value,
               [np.clip(x, -1.9, 1.9), c])
        return
    parity(jm, tm,
           lambda m, x, c: pick(m.forward(jflow.TensorLogdet(jmask(x), 0.0),
                                          jmask(c))),
           lambda m, x, c: pick(m(flow.TensorLogdet(tmask(x), 0.0),
                                  tmask(c))), [x, c])


@pytest.mark.parametrize("kind", ["conv", "spline"])
def test_coupling_reverse_inverts_forward(kind):
    _, tm = _coupling_pair(kind, seed=4)
    x = torch.from_numpy(randn(B, T, 6, seed=9))
    c = tmask(torch.from_numpy(randn(B, T, 4, seed=10)))
    with torch.no_grad():
        y = tm(flow.TensorLogdet(tmask(x), 0.0), c).tensor
        back = tm.reverse(y, c).value
    near(back, x.numpy(), "reverse(forward(x))", atol=1e-5)


def _jax_spline(jm, x, uw, uh, ud, inverse):
    """JAX's spline on x, with the tables it gathers from: its knots
    (cumw, cumh) and the bins it picked."""
    calls = []
    take = jnp.take_along_axis
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "take_along_axis", lambda a, idx, axis: calls.append(
            (a, idx)) or take(a, idx, axis=axis))
        out, logdet = jm._spline(jnp.asarray(x), uw, uh, ud, inverse=inverse)
    # gathers in order: cumw, widths, cumh, ... at the picked bins
    return (out, logdet, np.asarray(calls[0][0]), np.asarray(calls[2][0]),
            np.asarray(calls[0][1])[..., 0])


def test_spline_bins_on_knots_match_jax():
    """Every input on one of the spline's knots as JAX computes them, the
    two outer knots (the tail bounds) included, forward and inverse.  On
    its own knots each package picks the bin that starts there (the last
    knot: the last bin).  Across packages the picks are equal wherever the
    two packages' knots are equal; where float32 rounding (exp, the
    cumulative sum's order) puts the port's knot an ulp or so off JAX's,
    each side's pick follows its own knot (x >= knot) and the two are one
    bin apart.  The outputs and log-determinants agree at every knot: to
    1e-5 absolute plus 1e-5 relative where the bins agree (the knots
    themselves differ by rounding, and the log-determinant is steep in
    them), to 1e-4 where they are one apart (the spline and its slope are
    continuous at a knot, but the two bins' formulas round
    differently)."""
    jm, tm = _coupling_pair("spline", seed=5)
    nb = jm.num_bins
    x0, c = randn(B, T, 3, seed=11), randn(B, T, 4, seed=12)
    uw, uh, ud = jm._stats(jnp.asarray(x0), jnp.asarray(c))
    with torch.no_grad():
        tu = tm._stats(torch.from_numpy(x0), torch.from_numpy(c))
    _, _, jcumw, jcumh, _ = _jax_spline(jm, np.zeros((B, T, 3), np.float32),
                                        uw, uh, ud, False)
    tknots = tm.knots(*tu)
    flips = 0
    for inverse, jtab, ttab in ((False, jcumw, tknots[0].numpy()),
                                (True, jcumh, tknots[2].numpy())):
        for j in range(nb + 1):
            own = min(j, nb - 1)
            x = jtab[..., j]
            jout, jld, _, _, want = _jax_spline(jm, x, uw, uh, ud, inverse)
            assert (want == own).all(), (j, inverse)
            got = tm.bins(torch.from_numpy(ttab), torch.from_numpy(
                ttab[..., j]))[..., 0].numpy()
            assert (got == own).all(), (j, inverse)
            got = tm.bins(torch.from_numpy(ttab),
                          torch.from_numpy(x))[..., 0].numpy()
            same = ttab[..., j] == x
            np.testing.assert_array_equal(got[same], want[same])
            flip = got != want
            flips += int(flip.sum())
            assert (~same | ~flip).all()
            # where the knots differ, the port's pick is its own rule's
            below = x < ttab[..., j]
            assert (got[flip] == np.where(below, want - 1, want)[flip]).all()
            tout, tld = tm._spline(torch.from_numpy(x), *tu,
                                   inverse=inverse)
            for what, t_, j_ in (("outputs", tout, jout),
                                 ("logdet", tld, jld)):
                t_, j_ = t_.numpy(), np.asarray(j_)
                near(t_[~flip], j_[~flip], f"{what} at knot {j}",
                     rtol=1e-5)
                near(t_[flip], j_[flip], f"{what} at knot {j}, flipped",
                     atol=1e-4)
    assert flips < 0.2 * 2 * (nb + 1) * x0.size, flips


def test_coupling_stack_identifiers():
    for ident, cls in (("ConvCoupling", flow.ConvCoupling),
                       ("RationalQuadraticSplineCoupling",
                        flow.RationalQuadraticSplineCoupling),
                       ("LinearCoupling", flow.LinearCoupling)):
        layer = dict(CONV_COUPLING if ident == "ConvCoupling" else SPLINE)
        layer.update(mean_only=False)
        st = flow.CouplingStack(6, Hparams.from_dict(
            {"identifier": ident, "num_layers": 2, "layer": layer}))
        assert all(type(la) is cls for la in st.layers)
    with pytest.raises(ValueError, match="not supported"):
        flow.CouplingStack(6, Hparams.from_dict(
            {"identifier": "Glow", "num_layers": 2, "layer": SPLINE}))


# -------------------------------------------------------------- positions
@pytest.mark.parametrize("xpos", [False, True])
@pytest.mark.parametrize("offset,t", [(0, 9), (5, 1), (300, 1), (17, 4)])
def test_rotary_matches_jax(xpos, offset, t):
    kw = dict(theta=500.0, use_xpos=xpos, xpos_scale_base=32.0,
              interpolate_factor=2.0, theta_rescale_factor=1.5)
    jr, tr = jpositions.Rotary(12, **kw), positions.Rotary(12, **kw)
    near(tr.freqs, jr.freqs[...], "freqs", atol=1e-7)
    if xpos:
        near(tr.scale, jr.scale[...], "scale", atol=1e-7)
    else:
        assert tr.scale is None and jr.scale is None
    x = randn(B, t, 12, seed=13)
    for power in (0, 1, -1):
        near(tr(torch.from_numpy(x), offset, scale_power=power),
             jr(jnp.asarray(x), offset=offset, scale_power=power),
             f"power {power}")


def test_positional_factory_and_sincos():
    hp = Hparams.from_dict({"theta": 100})
    assert isinstance(positions.get_positional_encoding("Rotery", hp, 8),
                      positions.Rotary)
    js = jpositions.SinCos(8, maxpos=20, scaled=True)
    ts = positions.SinCos(8, maxpos=20, scaled=True)
    x = randn(B, 6, 8, seed=14)
    for offset in (0, 3, 17):                 # 17: clamped to 14, as JAX
        near(ts(torch.from_numpy(x), offset), js(jnp.asarray(x), offset),
             f"offset {offset}")
    with pytest.raises(ValueError, match="valid PE"):
        positions.get_positional_encoding("Learned", hp, 8)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_t5_bias_matches_jax(bidirectional):
    jm, tm = pair(lambda: jpositions.T5RPE(4, bidirectional, 8, 20,
                                           rngs=nnx.Rngs(0)),
                  lambda: positions.T5RPE(4, bidirectional, 8, 20), seed=6)
    np.testing.assert_array_equal(tm(13, 13).detach().numpy(),
                                  np.asarray(jm(13, 13)))
    np.testing.assert_array_equal(tm(3, 40).detach().numpy(),
                                  np.asarray(jm(3, 40)))


# ------------------------------------------------------------- attention
def _stack_hp(rpe, cross=None, preln=True):
    layer = {"dim": 32, "ffd_size": 64, "preln": preln,
             "norm": {"identifier": "RMSNorm", "eps": 1e-6},
             "activation": {"identifier": "GELU"},
             "self_attn": {"nheads": 2, "causal": True}}
    if cross is not None:
        layer["cross_attn"] = cross
    d = {"num_layers": 2, "bias": False, "layer": layer}
    if rpe is not None:
        d["rpe"] = rpe
    return d


RPES = {"rotary": {"identifier": "Rotary"},
        "xpos": {"identifier": "Rotary", "use_xpos": True,
                 "xpos_scale_base": 8},
        "sincos": {"identifier": "SinCos", "maxpos": 64},
        "t5": {"identifier": "T5RPE", "bidirectional": False,
               "num_buckets": 8, "max_distance": 16}}


def _stack_pair(rpe, cross=None, memory_dim=None, seed=0, preln=True):
    jh, th = hp_pair(_stack_hp(rpe, cross, preln))
    return pair(lambda: jtransformer.TransformerLayerStack(
        jh, input_dim=6, memory_dim=memory_dim, rngs=nnx.Rngs(0)),
        lambda: transformer.TransformerLayerStack(
            th, input_dim=6, memory_dim=memory_dim), seed)


@pytest.mark.parametrize("rpe", sorted(RPES))
def test_stack_with_positions_matches_jax(rpe):
    """The trunk's training call under each position: the fused route
    (Rotary/SinCos move q and k, no slopes) or the dense one (T5)."""
    jm, tm = _stack_pair(RPES[rpe], seed=7)
    parity(jm, tm, lambda m, x: m(jmask(x)).value,
           lambda m, x: m(tmask(x)).value, [randn(B, T, 6, seed=15)])


def test_t5_bias_is_computed_once_per_call(monkeypatch):
    _, tm = _stack_pair(RPES["t5"], seed=8)
    calls = []
    fwd = positions.T5RPE.forward
    monkeypatch.setattr(positions.T5RPE, "forward",
                        lambda self, tq, tk: calls.append((tq, tk))
                        or fwd(self, tq, tk))
    tm(tmask(torch.from_numpy(randn(B, T, 6, seed=16))))
    assert calls == [(T, T)]


@pytest.mark.parametrize("rpe", sorted(RPES))
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_decode_steps_with_positions_match_jax(rpe, kind):
    """A prefill then single-token steps through every layer over the
    per-layer caches: Rotary/SinCos rotate at the absolute positions
    before the cache write; T5 adds no bias at decode, as in JAX."""
    jm, tm = _stack_pair(RPES[rpe], seed=9)
    assert not tm.supports_stacked_decode()
    jdt = {"int8": jnp.int8, "float32": jnp.float32}[kind]
    tdt = {"int8": torch.int8, "float32": torch.float32}[kind]
    jcs, tcs = jm.init_cache(B, 24, jdt), tm.init_cache(B, 24, tdt)
    jdecode = nnx.jit(lambda m, x, c, pos: m.decode(x, c, pos))
    x = randn(B, 7, 6, seed=17)
    jh, jcs = jdecode(jm, jnp.asarray(x), jcs, jnp.asarray(0))
    th, tcs = tm.decode(torch.from_numpy(x), tcs, 0)
    near(th, jh, "prefill", atol=1e-4)
    for pos in range(7, 11):
        x1 = randn(B, 1, 6, seed=pos)
        jh, jcs = jdecode(jm, jnp.asarray(x1), jcs, jnp.asarray(pos))
        th, tcs = tm.decode(torch.from_numpy(x1), tcs, pos)
        near(th, jh, f"step {pos}", atol=1e-4)
    if kind == "float32":
        for tc, jc in zip(tcs, jcs):
            near(tc.k, jc.k, "rotated keys in the cache")


CROSS = {"plain": {"nheads": 2},
         "source": {"nheads": 2, "rpe": {"identifier": "SinCos",
                                         "maxpos": 64, "target": "source"}},
         "memory": {"nheads": 2, "rpe": {"identifier": "Rotary",
                                         "target": "memory"}},
         "both": {"nheads": 2, "rpe": {"identifier": "Rotary"}}}
MEM = randn(B, 5, 9, seed=18)
MEM_LN = np.asarray([5, 2], np.int32)


@pytest.mark.parametrize("target", sorted(CROSS))
def test_cross_attention_matches_jax(target):
    jh, th = hp_pair(CROSS[target])
    jm, tm = pair(lambda: jattention.CrossAttention(32, jh,
                                                    rngs=nnx.Rngs(0)),
                  lambda: attention.CrossAttention(32, th), seed=10)
    mem = randn(B, 5, 32, seed=19)
    parity(jm, tm, lambda m, q, kv: m(jmask(q), jmask(kv, MEM_LN))[
        "output"].value,
        lambda m, q, kv: m(tmask(q), tmask(kv, MEM_LN)).value,
        [randn(B, T, 32, seed=20), mem])


@pytest.mark.parametrize("preln", [True, False])
def test_cross_attention_trunk_matches_jax(preln):
    """A trunk with cross-attention layers and a memory projection: the
    training call against JAX's, then its per-layer decode (the memory
    projected once) against JAX's and against the training call on the
    whole sequence, step by step."""
    jm, tm = _stack_pair(RPES["rotary"], CROSS["plain"], memory_dim=9,
                         seed=11, preln=preln)
    assert tm.is_cross_attn and not tm.supports_stacked_decode()
    x = randn(B, T, 6, seed=21)
    full = np.asarray(LENGTHS * 0 + T)
    parity(jm, tm,
           lambda m, x, c: m(jmask(x), jmask(c, MEM_LN)).value,
           lambda m, x, c: m(tmask(x), tmask(c, MEM_LN)).value, [x, MEM])
    tmem = tm.project_memory(tmask(torch.from_numpy(MEM), MEM_LN))
    jmem = jm.project_memory(jmask(MEM, MEM_LN))
    with torch.no_grad():
        whole = tm(tmask(torch.from_numpy(x), full),
                   tmask(torch.from_numpy(MEM), MEM_LN)).value
    tcs, jcs = tm.init_cache(B, T, torch.float32), jm.init_cache(B, T,
                                                                jnp.float32)
    jdecode = nnx.jit(lambda m, x, c, pos, mem: m.decode(x, c, pos,
                                                         memory=mem))
    th, tcs = tm.decode(torch.from_numpy(x[:, :4]), tcs, 0, memory=tmem)
    jh, jcs = jdecode(jm, jnp.asarray(x[:, :4]), jcs, jnp.asarray(0), jmem)
    near(th, jh, "prefill")
    near(th, whole[:, :4], "prefill against the whole sequence")
    for pos in range(4, T):
        th, tcs = tm.decode(torch.from_numpy(x[:, pos:pos + 1]), tcs, pos,
                            memory=tmem)
        jh, jcs = jdecode(jm, jnp.asarray(x[:, pos:pos + 1]), jcs,
                          jnp.asarray(pos), jmem)
        near(th, jh, f"step {pos}")
        near(th[:, 0], whole[:, pos], f"step {pos} against the whole")
    with pytest.raises(ValueError, match="memory"):
        tm(tmask(torch.from_numpy(x)))


# ---------------------------------------------------------------- linear
def test_rvq_embedding_matches_jax():
    jm, tm = pair(lambda: jlinear.RVQEmbedding(3, 10, 8, rngs=nnx.Rngs(0)),
                  lambda: linear.RVQEmbedding(3, 10, 8), seed=12)
    ids = np.random.RandomState(22).randint(0, 10, (B, T, 3))
    got = tm(tmask(torch.from_numpy(ids))).value
    near(got, jm(jmask(ids)).value)


def test_linear_layer_stack_matches_jax():
    d = {"num_layers": 2, "layer": {"hidden_dim": 16, "norm": LN,
                                    "activation": {"identifier": "ReLU"}}}
    jh, th = hp_pair(d)
    jm, tm = pair(lambda: jlinear.LinearLayerStack(jh, 5, 3,
                                                   rngs=nnx.Rngs(0)),
                  lambda: linear.LinearLayerStack(th, 5, 3), seed=13)
    parity(jm, tm, lambda m, x: m(jmask(x)).value,
           lambda m, x: m(tmask(x)).value, [randn(B, T, 5, seed=23)])


def test_gumbel_head_matches_jax_with_injected_draws(monkeypatch):
    jm, tm = pair(lambda: jlinear.GumbelSoftMaxParameterize(
        6, 7, 4, temperature=0.7, rngs=nnx.Rngs(0)),
        lambda: linear.GumbelSoftMaxParameterize(6, 7, 4, temperature=0.7),
        seed=14)
    u = np.random.RandomState(24).rand(B, T, 7).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(u))
    for key in ("output", "logits", "gumbel_prob"):
        parity(jm, tm, lambda m, x: m(jmask(x), jax.random.PRNGKey(0))[
            key].value, lambda m, x: m(tmask(x), None, u=torch.from_numpy(
                u))[key].value, [randn(B, T, 6, seed=25)])


# --------------------------------------------------- trainer, checkpoint
def test_init_rules_for_cross_attention_and_t5():
    _, tm = _stack_pair(RPES["t5"], CROSS["plain"], memory_dim=9, seed=15)
    std = 1.0 / np.sqrt(32 / 3)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    init_weights(tm, 1.0, torch.Generator().manual_seed(0))
    ca = tm.layers[0].cross_attn
    for name, m in (("q_proj", ca.q_proj), ("kv_proj", ca.kv_proj),
                    ("out_proj", ca.out_proj)):
        w = m.weight.detach()
        assert w.abs().max() <= std and w.abs().max() > 0.9 * std, name
        assert not torch.equal(w, before[f"layers.0.cross_attn.{name}."
                                         "weight"]), name
    table = tm.rpe.table.detach()
    assert table.abs().max() <= std and table.abs().max() > 0.5 * std
    assert not torch.equal(table, before["rpe.table"])
    assert tm.memory_linear.bias is None or not tm.memory_linear.bias.any()


def test_flat_checkpoint_carries_rotary_variables():
    jm, tm = lvtr_options_pair("rotary", seed=16)
    flat = convert.to_flat(tm)
    want = jpositions.Rotary(64, use_xpos=True, xpos_scale_base=16)
    near(flat["transformer/rpe/freqs"], want.freqs[...], atol=1e-7)
    near(flat["transformer/rpe/scale"], want.scale[...], atol=1e-7)
    bad = dict(flat)
    del bad["transformer/rpe/freqs"]
    with pytest.raises(KeyError, match="freqs"):
        convert.load_flat(tm, bad)
    bad = dict(flat, **{"transformer/rpe/scale": flat[
        "transformer/rpe/scale"] * 2})
    with pytest.raises(ValueError, match="scale"):
        convert.load_flat(tm, bad)
