"""The port's HiFi-GAN modules against the JAX package's, float32 on the
CPU, at the tiny config of ``tests/test_trainers.py::_hfgan_hp``.

JAX modules are built abstractly (``nnx.eval_shape``: nothing drawn or
compiled) and get every weight-norm triple from a numpy seed, with g
off ||v|| so that the norm's scale shows; the port's modules take them
through ``models/convert.py`` (``load_flat``, the JAX compact contract).
Each comparison states its tolerance: forwards to 1e-5 of the output's
max |value| (float32 convolutions summed in another order), gradients to
1e-4 of each leaf's max |value|.  Also: the compact checkpoint both ways
(JAX's and the port's ``HiFiGAN.from_pretrained``) and the float32
policy's TF32 switches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_trainers import VOCODER_HP, _hfgan_hp
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.vocoder import hfgan as jh
from vae_gslm_tpu.models.vocoder import vocoder as jvocoder
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core import precision
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech import likelihood
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.vocoder import hfgan as th
from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN

FWD, GRAD = 1e-5, 1e-4          # of max |ref|
T_WAVE = 3200                   # the tiny config's 0.2 s segment


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small convolutions on many threads stall in torch's pool while the
    other test workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def filled(make, seed: int, std: float = 0.01):
    """``make()``'s JAX module, built abstractly, each weight-normed conv's
    v drawn as JAX draws it (normal ``std`` for 1-D, uniform +-1/sqrt(fan
    in) for 2-D), g = ||v|| times U(0.8, 1.2) and the bias uniform +-1/
    sqrt(fan in), from ``np.random.RandomState(seed)``.  ``std`` 0 draws
    1-D v at 1/sqrt(fan in) (unit gain) instead."""
    module = nnx.eval_shape(make)
    state = nnx.state(module, nnx.Param)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        nnx.to_pure_dict(state))
    keys = [_key(p) for p, _ in leaves]
    shapes = {k: leaf.shape for k, (_, leaf) in zip(keys, leaves)}
    rng = np.random.RandomState(seed)
    vals = {}
    for k in keys:
        if k != "v" and not k.endswith("/v"):
            continue
        pre, shape = k[:-1], shapes[k]
        fan = int(np.prod(shape[:-1]))
        if len(shape) == 4:
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan)
        else:
            v = rng.randn(*shape) * (std or 1 / np.sqrt(fan))
        norm = np.sqrt((v ** 2).sum(axis=tuple(range(v.ndim - 1))))
        vals[k] = v
        vals[pre + "g"] = norm * rng.uniform(0.8, 1.2, shape[-1])
        vals[pre + "bias"] = rng.uniform(-1, 1, shapes[pre + "bias"]) \
            / np.sqrt(fan)
    assert set(vals) == set(keys)
    pure = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(vals[k], jnp.float32) for k in keys])
    nnx.replace_by_pure_dict(state, pure)
    nnx.update(module, state)
    return module


def flat(module) -> dict:
    return _flatten_state(nnx.state(module, nnx.Param))


def ported(jmodule, tmodule):
    convert.load_flat(tmodule, flat(jmodule))
    return tmodule


def near(ours, ref, rel, what=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, (what, err, scale)


def nhwc(x):
    """A JAX NWC/NHWC feature map in the port's NCW/NCHW layout."""
    x = np.asarray(x)
    return x.transpose(0, 2, 1) if x.ndim == 3 else x.transpose(0, 3, 1, 2)


def wave(t: int, seed: int = 0, tail: int = 0) -> np.ndarray:
    """Two rows of a seeded wave, the last ``tail`` samples of row 1 zero
    (a post-padded clip)."""
    w = (np.random.RandomState(seed).randn(2, t) * 0.3).astype(np.float32)
    if tail:
        w[1, -tail:] = 0.0
    return w


# ------------------------------------------------------- weight-normed convs
CONVS = {
    # (JAX module, port module, input shape (B, T[, W], C) in JAX layout)
    "conv1d_grouped_strided": (
        lambda: jh.WNConv1d(6, 10, 5, 2, padding=2, groups=2,
                            rngs=nnx.Rngs(0)),
        lambda: th.WNConv1d(6, 10, 5, 2, padding=2, groups=2),
        (2, 23, 6)),
    "conv1d_dilated": (
        lambda: jh.WNConv1d(8, 8, 3, 1, padding=3, dilation=3,
                            rngs=nnx.Rngs(0)),
        lambda: th.WNConv1d(8, 8, 3, 1, padding=3, dilation=3),
        (2, 17, 8)),
    "convt1d_rate5": (   # the generator's first stage: crop (3, 2)
        lambda: jh.WNConvT1d(8, 6, 10, 5, padding=3, output_padding=1,
                             rngs=nnx.Rngs(0)),
        lambda: th.WNConvT1d(8, 6, 10, 5, padding=3, output_padding=1),
        (2, 7, 8)),
    "conv2d_period": (
        lambda: jh.WNConv2d(3, 5, (5, 1), (3, 1), (2, 0), rngs=nnx.Rngs(0)),
        lambda: th.WNConv2d(3, 5, (5, 1), (3, 1), (2, 0)),
        (2, 11, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_wn_conv_matches_jax(name):
    """Forward, the folded kernel, and the gradients of <y, c> with
    respect to g, v and bias (``jax.grad`` against autograd)."""
    make_j, make_t, shape = CONVS[name]
    jc = filled(make_j, 1)
    tc = ported(jc, make_t())
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    gd, st = nnx.split(jc)

    @jax.jit
    def f(st, x, c):
        def loss(st):
            m = nnx.merge(gd, st)
            y = m(x)
            return jnp.sum(y * c), (y, m.kernel())
        return jax.value_and_grad(loss, has_aux=True)(st)

    y_shape = jax.eval_shape(lambda s: nnx.merge(gd, s)(x), st).shape
    c = rng.randn(*y_shape).astype(np.float32)
    (_, (jy, jk)), jg = f(st, x, c)
    perm = (0, 2, 1) if len(shape) == 3 else (0, 3, 1, 2)
    y = tc(torch.from_numpy(x.transpose(perm).copy()))
    (y * torch.from_numpy(c.transpose(perm).copy())).sum().backward()
    near(y, nhwc(jy), FWD, "forward")
    back = (2, 1, 0) if len(shape) == 3 else (3, 2, 0, 1)
    grads = nnx.to_pure_dict(jg)
    near(tc.weight_v.grad, np.asarray(grads["v"]).transpose(back), GRAD,
         "dv")
    near(tc.weight_g.grad.reshape(-1), grads["g"], GRAD, "dg")
    near(tc.bias.grad, grads["bias"], GRAD, "dbias")
    tc.remove_weight_norm()
    assert set(dict(tc.named_parameters())) == {"weight", "bias"}
    near(tc.weight, np.asarray(jk).transpose(back), FWD, "folded kernel")
    with torch.no_grad():
        near(tc(torch.from_numpy(x.transpose(perm).copy())), nhwc(jy), FWD,
             "folded forward")


# ------------------------------------------------------------ discriminators
def _jax_discriminators():
    hp = _hfgan_hp("unused").model
    mpd = filled(lambda: jh.MultiPeriodDiscriminator(hp.mpd,
                                                     rngs=nnx.Rngs(0)), 3)
    mrd = filled(lambda: jh.MultiResolutionDiscriminator(
        hp.mrd, rngs=nnx.Rngs(0)), 4)
    msd = filled(lambda: jh.MultiScaleDiscriminator(
        JHparams(num_scales=2, weight_norm=True), rngs=nnx.Rngs(0)), 5)
    return {"mpd": mpd, "mrd": mrd, "msd": msd}


DISC = {   # case -> (multi-discriminator, sub-discriminator index or None)
    "DiscriminatorP": ("mpd", 1), "DiscriminatorS": ("msd", 0),
    "DiscriminatorR": ("mrd", 0), "MultiPeriodDiscriminator": ("mpd", None),
    "MultiScaleDiscriminator": ("msd", None),
    "MultiResolutionDiscriminator": ("mrd", None),
}


@pytest.fixture(scope="module")
def discriminators():
    """JAX's and the port's three multi-discriminators with the same
    weights, and JAX's outputs of every case at T 3200 and at T 3203 (a
    multiple of neither period: the reflect pad), in one jit a length."""
    js = _jax_discriminators()
    hp = Hparams.from_dict(_hfgan_hp("unused").to_dict()).model
    ts = {"mpd": th.MultiPeriodDiscriminator(hp.mpd, device="cpu"),
          "mrd": th.MultiResolutionDiscriminator(hp.mrd, device="cpu"),
          "msd": th.MultiScaleDiscriminator(Hparams(num_scales=2),
                                            device="cpu")}
    for k in js:
        ported(js[k], ts[k])

    @nnx.jit
    def run(js, w):
        out = {}
        for case, (k, i) in DISC.items():
            if i is None:
                out[case] = js[k](w)
            else:
                o, f = js[k].discriminators[i](w)
                out[case] = ([o], [f])
        return out

    refs = {t: run(js, jnp.asarray(wave(t, 6, tail=700)))
            for t in (T_WAVE, T_WAVE + 3)}
    return ts, refs


@pytest.mark.parametrize("t", [T_WAVE, T_WAVE + 3])
@pytest.mark.parametrize("case", sorted(DISC))
def test_discriminator_matches_jax(discriminators, case, t):
    """Outputs and every feature map, in JAX's order."""
    ts, refs = discriminators
    k, i = DISC[case]
    w = torch.from_numpy(wave(t, 6, tail=700))
    with torch.no_grad():
        if i is None:
            outs, fmaps = ts[k](w)
        else:
            o, f = ts[k].discriminators[i](w)
            outs, fmaps = [o], [f]
    jouts, jfmaps = refs[t][case]
    assert len(outs) == len(jouts) and len(fmaps) == len(jfmaps)
    for n, (o, jo) in enumerate(zip(outs, jouts)):
        near(o, jo, FWD, f"{case} output {n}")
    for n, (f, jf) in enumerate(zip(fmaps, jfmaps)):
        assert len(f) == len(jf)
        for m, (a, b) in enumerate(zip(f, jf)):
            near(a, nhwc(b), FWD, f"{case} map {n}.{m}")


# ------------------------------------------------------ pooling and losses
def test_avg_pool_and_losses_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 37).astype(np.float32)
    near(th.avg_pool1d(torch.from_numpy(x)), jh.avg_pool1d(jnp.asarray(x)),
         1e-6, "avg_pool1d")
    outs_r = [rng.randn(2, n).astype(np.float32) for n in (5, 9)]
    outs_g = [rng.randn(2, n).astype(np.float32) for n in (5, 9)]
    maps_r = [[rng.randn(2, 3, n).astype(np.float32) for n in (4, 6)]
              for _ in range(2)]
    maps_g = [[rng.randn(*m.shape).astype(np.float32) for m in d]
              for d in maps_r]

    def tt(tree):
        return jax.tree_util.tree_map(torch.from_numpy, tree)

    def jj(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    for name, ours, ref in (
            ("feature_loss", th.feature_loss(tt(maps_r), tt(maps_g)),
             jh.feature_loss(jj(maps_r), jj(maps_g))),
            ("discriminator_loss",
             th.discriminator_loss(tt(outs_r), tt(outs_g)),
             jh.discriminator_loss(jj(outs_r), jj(outs_g))),
            ("generator_loss", th.generator_loss(tt(outs_g)),
             jh.generator_loss(jj(outs_g)))):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6,
                                   err_msg=name)


# ----------------------------------------------------------------- generator
def _generators():
    jg = filled(lambda: jh.Generator(_hfgan_hp("unused").model.generator,
                                     rngs=nnx.Rngs(0)), 8)
    tg = th.Generator(Hparams.from_dict(
        _hfgan_hp("unused").to_dict()).model.generator, device="cpu")
    return jg, ported(jg, tg)


def test_generator_forward_and_gradients_match_jax():
    """The trainable (weight-normed) generator: the wave and the gradient
    of <wave, c> for every g, v and bias."""
    jg, tg = _generators()
    rng = np.random.RandomState(9)
    mel = rng.randn(2, 11, 20).astype(np.float32)
    lengths = np.asarray([11, 8], np.int32)
    c = rng.randn(2, 11 * 320).astype(np.float32)
    gd, st = nnx.split(jg)

    @jax.jit
    def f(st):
        def loss(st):
            out = nnx.merge(gd, st)(JMasked.from_lengths(
                jnp.asarray(mel), jnp.asarray(lengths)))
            return jnp.sum(out.value * c), out
        return jax.value_and_grad(loss, has_aux=True)(st)

    (_, jout), jgrads = f(st)
    out = tg(Masked.from_lengths(torch.from_numpy(mel),
                                 torch.from_numpy(lengths)))
    assert out.value.requires_grad
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(jout.lengths))
    near(out.value, jout.value, FWD, "wave")
    (out.value * torch.from_numpy(c)).sum().backward()
    want = _flatten_state(jgrads)
    got = convert.to_flat(_grads_module(tg))
    assert set(got) == set(want)
    for k in want:
        near(got[k], want[k], GRAD, k)


def _grads_module(module):
    """A copy of ``module`` whose parameters are its gradients (so
    ``to_flat`` lays them out as JAX's gradient state)."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(),
                                  out.named_parameters()):
            q.copy_(p.grad)
    return out


# ------------------------------------------------- compact checkpoint contract
@pytest.fixture
def jax_builds_abstract(monkeypatch):
    """JAX's ``HiFiGAN`` builds its generator abstractly (``filled``): the
    weights are replaced by the checkpoint's at load, and an abstract
    build compiles nothing."""
    make = jh.Generator
    monkeypatch.setattr(jvocoder, "Generator",
                        lambda hp, rngs: filled(lambda: make(
                            hp, rngs=nnx.Rngs(0)), 11))


def test_compact_checkpoint_both_ways(tmp_path, jax_builds_abstract):
    """A directory the port writes from its weight-normed trainer's
    generator loads through JAX's ``HiFiGAN.from_pretrained``, one JAX
    writes loads through the port's, and all four vocoders (each folded
    at load) give the same wave."""
    jg, tg = _generators()
    hp_text = VOCODER_HP
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    for d in (pdir, jdir):
        d.mkdir()
        (d / "hp.yaml").write_text(hp_text)
    from vae_gslm_tpu_torch.training.checkpoint import save_compact
    save_compact(tg, str(pdir / "last-cpt.npz"))
    jvoc = jvocoder.HiFiGAN(JHparams.from_yaml(hp_text))
    jvoc.model = jg
    jvoc.save_pretrained(str(jdir))
    mel = np.random.RandomState(12).randn(2, 9, 20).astype(np.float32)
    lengths = np.asarray([9, 6], np.int32)
    waves = {}
    for src, d in (("port", pdir), ("jax", jdir)):
        tv = HiFiGAN.from_pretrained(str(d), device="cpu")
        assert not tv.model.conv_pre.weight_norm
        waves[f"port<-{src}"] = tv.decode(Masked.from_lengths(
            torch.from_numpy(mel), torch.from_numpy(lengths))).value.numpy()
        jv = jvocoder.HiFiGAN.from_pretrained(str(d))
        waves[f"jax<-{src}"] = np.asarray(jv.decode(JMasked.from_lengths(
            jnp.asarray(mel), jnp.asarray(lengths))).value)
    ref = waves["jax<-jax"]
    for k, w in waves.items():
        near(w, ref, FWD, k)


@pytest.mark.parametrize("form", ["weight_g", "parametrizations",
                                  "removed"])
def test_reference_torch_checkpoint_loads_in_both(tmp_path, form,
                                                  jax_builds_abstract):
    """A reference torch ``last-cpt.ckpt`` in each weight form the
    reference writes loads through the port's and JAX's
    ``HiFiGAN.from_pretrained``, each folded at load, to the same wave."""
    _, tg = _generators()
    sd = {}
    for prefix, mod in convert._wn_convs(tg):
        g, v = mod.weight_g.detach(), mod.weight_v.detach()
        if form == "weight_g":
            sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"] = g, v
        elif form == "parametrizations":
            sd[f"{prefix}.parametrizations.weight.original0"] = g
            sd[f"{prefix}.parametrizations.weight.original1"] = v
        else:
            sd[f"{prefix}.weight"] = th.wn_kernel(g, v)
        sd[f"{prefix}.bias"] = mod.bias.detach()
    (tmp_path / "hp.yaml").write_text(VOCODER_HP)
    torch.save({"state_dict": sd}, str(tmp_path / "last-cpt.ckpt"))
    mel = np.random.RandomState(13).randn(2, 9, 20).astype(np.float32)
    lengths = np.asarray([9, 6], np.int32)
    tv = HiFiGAN.from_pretrained(str(tmp_path), device="cpu")
    assert not tv.model.conv_pre.weight_norm
    got = tv.decode(Masked.from_lengths(
        torch.from_numpy(mel), torch.from_numpy(lengths))).value
    jv = jvocoder.HiFiGAN.from_pretrained(str(tmp_path))
    near(got, jv.decode(JMasked.from_lengths(
        jnp.asarray(mel), jnp.asarray(lengths))).value, FWD, form)


# ------------------------------------------------------------ TF32 switches
@pytest.fixture
def tf32_on():
    saved = precision.tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]


@pytest.mark.parametrize("policy", ["float32", "bf16"])
def test_policy_scope_sets_tf32(tf32_on, policy):
    """The float32 policy turns both TF32 switches off inside its scope;
    the bf16 policy leaves them; both are back on exit."""
    pol = precision.Policy() if policy == "float32" else \
        precision.bf16_mixed()
    with precision.policy_scope(pol):
        inside = precision.tf32_flags()
        with precision.policy_scope(precision.bf16_mixed()):
            nested = precision.tf32_flags()
        assert precision.tf32_flags() == inside
    want = (False, False) if policy == "float32" else (True, True)
    assert inside == want and nested == want
    assert precision.tf32_flags() == (True, True)


def test_likelihood_run_turns_tf32_off(tf32_on, monkeypatch):
    """``LikelihoodEstimator.run`` scores under the float32 policy with
    both switches off, whatever the caller's policy, and puts them back."""
    seen = {}

    def fake_run(self, seed, max_batches, timings):
        seen["flags"] = precision.tf32_flags()
        seen["dtype"] = precision.get_policy().compute_dtype
        return np.zeros((0,), np.float32)

    monkeypatch.setattr(likelihood.LikelihoodEstimator, "_run", fake_run)
    est = object.__new__(likelihood.LikelihoodEstimator)
    with precision.policy_scope(precision.bf16_mixed()):
        est.run()
        assert precision.get_policy().compute_dtype == torch.bfloat16
    assert seen == {"flags": (False, False), "dtype": torch.float32}
    assert precision.tf32_flags() == (True, True)


def test_generator_keeps_reference_names_and_folds_once():
    """The weight-normed generator's state dict is the reference's
    (``weight_g`` (n, 1, 1), ``weight_v``, ``bias``); folding leaves
    ``weight`` and ``bias`` and the same function."""
    _, tg = _generators()
    sd = tg.state_dict()
    assert sd["conv_pre.weight_g"].shape == (64, 1, 1)
    assert sd["ups.0.weight_g"].shape == (64, 1, 1)       # per in-channel
    assert sd["ups.0.weight_v"].shape == (64, 32, 10)
    mel = Masked.from_lengths(torch.randn(1, 6, 20), [6])
    with torch.no_grad():
        before = tg(mel).value
        tg.remove_weight_norm()
        tg.remove_weight_norm()
        after = tg(mel).value
    assert not any(k.endswith(("weight_g", "weight_v"))
                   for k in tg.state_dict())
    torch.testing.assert_close(after, before, rtol=0, atol=1e-6)
