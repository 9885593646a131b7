"""Text-to-speech in the port against the JAX package on the CPU, at the
sizes of the JAX trainer test (``tests/test_trainers.py::_tts_hp``: a
1-layer d16 trunk with cross-attention over a 1-layer non-causal text
encoder, 4 heads of 4), on the same weights, carried from JAX's state
into the port strictly (``load_flat``):

  * ``eos_loss`` (rtol 1e-6);
  * ``LVTTS.encode_condition`` and the training forward's
    ``log_q``/``log_p``/``rec_loss``/``eos`` on JAX's draws (rtol/atol
    1e-5, float32);
  * ``supports_stacked_decode(allow_cross)`` on the TTS trunk and on a
    speech trunk;
  * the stacked single-token step with ``memory_kv`` against JAX's
    ``decode_stacked`` at positions 0-4, float32 and ``16-mixed`` (JAX's
    bf16 x bf16 -> f32 products on float32 copies, as
    ``tests/test_torch_per_layer_sampler.py`` runs them);
  * ``ARTRTTSSampler`` on both routes against JAX's under the
    deterministic protocol (temperature 0, the initial state and the
    diffusion start pinned, DDIM eta 0): lengths equal, frames at rtol
    1e-4, the decoded mel; the ``return_attn`` maps;
  * ``LVTTSTrainer``: the loss and one step with accumulation 2 against
    JAX's gradient (1e-5 x max |g|); ``scripts/train.py`` -> ``fit`` ->
    ``symbols.json`` -> ``resume``; ``TTSInferer.run``'s three files per
    row through ``scripts/infer.py -v``;
  * the device rule.

The JAX trainer (and with it the JAX model) is built once per module,
abstractly, and filled with the port's initial weights."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_torch_per_layer_sampler import _f32_products_of_bf16
from tests.test_trainers import _tts_hp, corpus  # noqa: F401
from tests.test_trainers import vocoder_dir  # noqa: F401
from vae_gslm_tpu.core import losses as jlosses
from vae_gslm_tpu.core import precision as jprecision
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.tts import sampler as jsampler
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.nn.diffusion import GaussianDiffusion1D as JDiffusion
from vae_gslm_tpu.nn.transformer import TransformerLayerStack as JStack
from vae_gslm_tpu.models.vocoder import vocoder as jvocoder_mod
from vae_gslm_tpu.trainers.tts import lvtts as jtrainer_mod
from vae_gslm_tpu.trainers.tts.lvtts import LVTTSTrainer as JTrainer
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core import losses as tlosses
from vae_gslm_tpu_torch.core import precision as tprecision
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.tts.inferer import TTSInferer
from vae_gslm_tpu_torch.inference.tts.sampler import ARTRTTSSampler
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.tts.lvtr import LVTTS
from vae_gslm_tpu_torch.nn.diffusion import GaussianDiffusion1D
from vae_gslm_tpu_torch.nn.transformer import TransformerLayerStack
from vae_gslm_tpu_torch.scripts import infer as infer_cli
from vae_gslm_tpu_torch.scripts import train as train_cli
from vae_gslm_tpu_torch.scripts.registry import resolve
from vae_gslm_tpu_torch.trainers.tts.lvtts import LVTTSTrainer

N_MELS, B, T, TT, TS = 20, 2, 16, 8, 12
LATENT, DIM = 4, 16
MAX_FRAMES, MIN_FRAMES = 24, 3
EOS_BIAS = 0.2


def _tts_dict(corpus_dir, vocoder):
    return _tts_hp(corpus_dir, vocoder).to_dict()


def abstract_jax_build(mp, module, name: str) -> None:
    """``module.name`` (a JAX module class) built under ``nnx.eval_shape``
    (its own ``nnx.Rngs``): eager JAX compiles every drawn shape, which
    costs seconds per model on the CPU; the arrays come from a
    checkpoint or ``fill_jax_state`` after."""
    cls = getattr(module, name)
    mp.setattr(module, name, lambda *a, rngs=None, **kw: nnx.eval_shape(
        lambda: cls(*a, rngs=nnx.Rngs(0), **kw)))


def fill_jax_state(module, flat) -> None:
    """Every variable of a (possibly abstract) JAX module from a flat
    ``flax path -> array`` dict, strictly: each leaf must have its key."""
    state = nnx.state(module)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        nnx.to_pure_dict(state))
    vals = []
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert flat[key].shape == leaf.shape, key
        vals.append(jnp.asarray(flat[key], leaf.dtype))
    nnx.replace_by_pure_dict(state, jax.tree_util.tree_unflatten(treedef,
                                                                 vals))
    nnx.update(module, state)


@pytest.fixture(scope="module")
def trainers(corpus, vocoder_dir):  # noqa: F811
    """JAX's ``LVTTSTrainer`` and the port's on the same config and the
    same weights: the port's initial weights fill JAX's abstractly built
    model (in place of its ``init_weights``), then JAX's state is carried
    back into the port strictly (``load_flat``)."""
    d = _tts_dict(corpus, vocoder_dir)
    tt = LVTTSTrainer(Hparams.from_dict(copy.deepcopy(d)), device="cpu")
    flat = convert.to_flat(tt.model)
    with pytest.MonkeyPatch.context() as mp:
        abstract_jax_build(mp, jtrainer_mod, "LVTTS")
        abstract_jax_build(mp, jvocoder_mod, "Generator")
        mp.setattr(jtrainer_mod, "init_weights",
                   lambda model, *a, **kw: fill_jax_state(model, flat))
        jt = JTrainer(JHparams.from_dict(copy.deepcopy(d)))
    assert tt.symbols.symbol == jt.train_dataset.symbols.symbol
    convert.load_flat(tt.model, _flatten_state(nnx.state(jt.model)))
    return jt, tt


def _both(x, lengths):
    return (JMasked.from_lengths(jnp.asarray(x), jnp.asarray(lengths)),
            Masked.from_lengths(torch.from_numpy(np.asarray(x)), lengths))


def _close(got, want, tol=1e-5, err_msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=err_msg)


def _inputs(seed: int, num_symbols: int):
    rng = np.random.RandomState(seed)
    mel = rng.randn(B, T, N_MELS).astype(np.float32)
    text = rng.randint(2, num_symbols, (B, TT)).astype(np.int32)
    spkr = rng.randn(B, TS, N_MELS).astype(np.float32)
    return ((mel, [T, 11]), (text, [TT, 5]), (spkr, [TS, 9]))


def _jax_draws(key):
    """The draws of one JAX ``LVTR.__call__`` under ``key``."""
    k_enc, k_init, k_prior, k_diff, _ = jax.random.split(key, 5)
    kt, kn = jax.random.split(k_diff)
    lat = (B, T, LATENT)
    out = {"posterior": jax.random.normal(k_enc, lat, jnp.float32),
           "initial": jax.random.uniform(k_init, (B, 1, LATENT),
                                         jnp.float32, -1.0, 1.0),
           "prior": jax.random.normal(k_prior, lat, jnp.float32),
           "t": jax.random.randint(kt, (B,), 0, 8),
           "noise": jax.random.normal(kn, (B, T, N_MELS), jnp.float32)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def test_eos_loss_matches_jax():
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(3, 9)).astype(np.float32)
    jx, tx = _both(x, [9, 4, 1])
    for pw in (25.0, 1.0):
        np.testing.assert_allclose(
            tlosses.eos_loss(tx, pw).numpy(),
            np.asarray(jlosses.eos_loss(jx, pw)), rtol=1e-6)


def test_forward_and_condition_match_jax(trainers):
    """``encode_condition`` (the text memory and speaker embedding), the
    eos head over the cross-attention trunk and the loss terms."""
    jt, tt = trainers
    jm, tm = jt.model, tt.model
    (mel, ml), (text, tl), (spkr, sl) = _inputs(
        1, tt.symbols.num_symbols)
    jmel, tmel = _both(mel, ml)
    jtext, ttext = _both(text, tl)
    jspk, tspk = _both(spkr, sl)
    key = jax.random.PRNGKey(3)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def run(state, mel, text, spkr):
        m = nnx.merge(graphdef, state)
        mem, emb = m.encode_condition(text, spkr)
        out = m(mel, key, text=text, spkr=spkr)
        keep = ("log_q", "log_p", "eos", "rec_loss", "transformer_latent")
        return mem, emb, {k: out[k] for k in keep}

    jmem, jemb, jout = run(state, jmel, jtext, jspk)
    with torch.no_grad():
        tmem, temb = tm.encode_condition(ttext, tspk)
        tout = tm(tmel, None, text=ttext, spkr=tspk, draws=_jax_draws(key))
    _close(tmem.value, jmem.value, err_msg="text memory")
    _close(temb, jemb, err_msg="speaker embedding")
    for k in ("log_q", "log_p", "eos"):
        _close(tout[k].value, jout[k].value, err_msg=k)
        np.testing.assert_array_equal(tout[k].lengths.numpy(),
                                      np.asarray(jout[k].lengths))
    _close(tout["rec_loss"], jout["rec_loss"], err_msg="rec_loss")
    _close(tout["transformer_latent"].value,
           jout["transformer_latent"].value, err_msg="trunk")
    hm = Masked.full(tout["transformer_latent"].value)
    np.testing.assert_array_equal(
        tm.is_eos(hm, 0.4).numpy(),
        np.asarray(jm.is_eos(JMasked.full(jout["transformer_latent"]
                                          .value), 0.4)))


def _speech_trunk(cross: bool, norm2: str = "RMSNorm", rpe=None):
    layer = {"ffd_size": 32, "dim": 16,
             "norm": {"identifier": "RMSNorm", "eps": 1e-6},
             "activation": {"identifier": "GELU"},
             "self_attn": {"nheads": 4, "causal": True}}
    if cross:
        layer["cross_attn"] = {"nheads": 4}
        if rpe:
            layer["cross_attn"]["rpe"] = rpe
    d = {"num_layers": 1, "rpe": {"identifier": "ALiBi", "maxpos": 64},
         "layer": layer}
    return d


@pytest.mark.parametrize("case", ["speech", "cross", "cross_rpe"])
def test_supports_stacked_decode_matches_jax(trainers, case):
    """JAX's rule on the TTS trunk, a speech trunk and a cross trunk
    whose cross-attention has positions of its own."""
    d = {"speech": _speech_trunk(False), "cross": _speech_trunk(True),
         "cross_rpe": _speech_trunk(
             True, rpe={"identifier": "SinCos", "maxpos": 64})}[case]
    js = nnx.eval_shape(lambda: JStack(JHparams.from_dict(
        copy.deepcopy(d)), input_dim=4, rngs=nnx.Rngs(0)))
    ts = TransformerLayerStack(Hparams.from_dict(copy.deepcopy(d)),
                               input_dim=4)
    jt, tt = trainers
    pairs = [(js, ts), (jt.model.transformer, tt.model.transformer)]
    for j, t in pairs:
        for allow in (False, True):
            assert t.supports_stacked_decode(allow) == \
                j.supports_stacked_decode(allow), (case, allow)
    assert tt.model.transformer.supports_stacked_decode(allow_cross=True)


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
def test_stacked_step_with_memory_matches_jax(trainers, monkeypatch,
                                              precision):
    """One single-token stacked step over the float32 cache and the
    per-layer memory K/V at positions 0-4 against JAX's, the hidden and
    the cache rows written."""
    jt, tt = trainers
    js, ts = jt.model.transformer, tt.model.transformer
    jpol, tpol = jprecision.Policy(), tprecision.Policy()
    tol = 1e-5
    if precision == "16-mixed":
        jpol, tpol = jprecision.bf16_mixed(), tprecision.bf16_mixed()
        _f32_products_of_bf16(monkeypatch)
        tol = 2e-2
    rng = np.random.RandomState(4)
    mem = rng.randn(B, TT, DIM).astype(np.float32)
    jmem, tmem = _both(mem, [TT, 5])
    with jprecision.policy_scope(jpol), tprecision.policy_scope(tpol):
        jw = js.build_stacked_decode(allow_cross=True)
        tw = ts.build_stacked_decode(allow_cross=True)
        assert sorted(tw) == sorted(jw)
        jkv = js.build_stacked_memory(jmem)
        tkv = ts.build_stacked_memory(tmem)
        _close(tkv["mk"], jkv["mk"], tol, "memory keys")
        np.testing.assert_array_equal(tkv["mask"].numpy(),
                                      np.asarray(jkv["mask"]))
        jc = js.init_stacked_cache(B, 6)
        tc = ts.init_stacked_cache(B, 6, None)
        assert tc.k.dtype == torch.float32 and tc.k_scale is None
        step = jax.jit(lambda w, c, x, pos, kv: js.decode_stacked(
            x, w, c, pos, memory_kv=kv))
        for pos in range(5):
            x = rng.randn(B, 1, LATENT).astype(np.float32)
            jh, jc = step(jw, jc, jnp.asarray(x), jnp.asarray(pos), jkv)
            th, tc = ts.decode_stacked(torch.from_numpy(x), tw, tc, pos,
                                       memory_kv=tkv)
            _close(th, jh, tol, f"hidden {pos}")
        _close(tc.k, jc.k, tol, "cache k")
        _close(tc.v, jc.v, tol, "cache v")


def _pin(monkeypatch, tm):
    """The initial AR state and the diffusion start noise as numpy arrays
    in both packages, DDIM at eta 0."""
    rng = np.random.RandomState(5)
    init = (rng.rand(B, 1, LATENT) * 2 - 1).astype(np.float32)
    start = rng.randn(B, MAX_FRAMES, N_MELS).astype(np.float32)
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None:
                        jnp.asarray(init[:bsize]))
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init[:bsize]))
    jsample, tsample = JDiffusion.sample, GaussianDiffusion1D.sample

    def jpinned(self, s, cond, key, **kw):
        s = dataclasses.replace(s, value=jnp.asarray(
            start[:, :s.value.shape[1]])).apply_mask()
        return jsample(self, s, cond, key, **kw)

    def tpinned(self, s, cond, generator):
        s = dataclasses.replace(s, value=torch.from_numpy(
            start[:, :s.value.shape[1]].copy())).apply_mask()
        return tsample(self, s, cond, generator)

    monkeypatch.setattr(JDiffusion, "sample", jpinned)
    monkeypatch.setattr(GaussianDiffusion1D, "sample", tpinned)


def _sample_both(monkeypatch, jt, tt, route, return_attn=False):
    jm, tm = jt.model, tt.model
    _pin(monkeypatch, tm)
    for dec in (jm.decoder, tm.decoder):
        dec.override_sampling(3, 0.0)
    (_, _), (text, tl), (spkr, sl) = _inputs(7, tt.symbols.num_symbols)
    jtext, ttext = _both(text, tl)
    jspk, tspk = _both(spkr, sl)
    tsamp = ARTRTTSSampler(tm, device="cpu")
    if route == "per_layer" and not return_attn:
        monkeypatch.setattr(JStack, "supports_stacked_decode",
                            lambda self, allow_cross=False: False)
        monkeypatch.setattr(tsamp, "route", lambda b, ra=False: "per_layer")
    assert tsamp.route(B, return_attn) == route
    kw = dict(max_frames=MAX_FRAMES, min_frames=MIN_FRAMES,
              temperature=0.0, eos_threshold=0.5, return_attn=return_attn)
    # the eos head's output bias raised in both, so that the rows end at
    # different steps inside the rollout
    jbias, tbias = jm.eos_head.out_linear.bias, tm.eos_head.out_linear.bias
    old = np.array(jbias[...])
    jbias[...] = jnp.full(old.shape, EOS_BIAS, old.dtype)
    with torch.no_grad():
        tbias.fill_(EOS_BIAS)
    try:
        want = jsampler.ARTRTTSSampler(jm)(jtext, jspk,
                                           jax.random.PRNGKey(0), **kw)
        got = tsamp(ttext, tspk, torch.Generator().manual_seed(0), **kw)
    finally:
        jbias[...] = jnp.asarray(old)
        with torch.no_grad():
            tbias.copy_(torch.from_numpy(old))
    return want, got


@pytest.mark.parametrize("route", ["stacked", "per_layer"])
def test_tts_sampler_matches_jax(trainers, monkeypatch, route):
    jt, tt = trainers
    want, got = _sample_both(monkeypatch, jt, tt, route)
    jl = np.asarray(want["lengths"])
    np.testing.assert_array_equal(got["lengths"].numpy(), jl)
    # one row ends at its first EOS past min_frames, one inside the rollout
    assert jl.tolist() == [MIN_FRAMES + 1, 9], jl
    frames = got["frames"].value.numpy()
    assert not frames[0, MIN_FRAMES + 1:].any() and frames[0, 0].any()
    jf = np.asarray(want["frames"].value)
    assert got["frames"].value.shape == jf.shape == (B, MAX_FRAMES, LATENT)
    np.testing.assert_allclose(got["frames"].value.numpy(), jf, rtol=1e-4,
                               atol=1e-5, err_msg="frames")
    _close(got["output"].value, want["output"].value, 1e-4, "mel")
    np.testing.assert_array_equal(got["output"].lengths.numpy(),
                                  np.asarray(want["output"].lengths))


def test_tts_sampler_attention_maps_match_jax(trainers, monkeypatch):
    """``return_attn`` (the per-layer route): each step's self- and
    cross-attention rows (bfloat16, as JAX's scan rows) and the text
    encoder's maps, every row summing to 1."""
    jt, tt = trainers
    want, got = _sample_both(monkeypatch, jt, tt, "per_layer",
                             return_attn=True)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    shapes = {"self_attn": (B, 1, 4, MAX_FRAMES + 1, MAX_FRAMES + 1),
              "cross_attn": (B, 1, 4, MAX_FRAMES + 1, TT),
              "text_self_attn": (B, 1, 4, TT, TT)}
    for name, shape in shapes.items():
        assert tuple(got[name].shape) == shape, name
        assert got[name].dtype == torch.float32
        _close(got[name], want[name], 1e-5 if name == "text_self_attn"
               else 4e-3, name)
        np.testing.assert_allclose(got[name].sum(-1).numpy(), 1.0,
                                   atol=2e-2 if name != "text_self_attn"
                                   else 1e-5, err_msg=name)


def _grads_close(jgrads, model, tol=1e-5):
    """Every port gradient in JAX's layout within ``tol`` x the largest
    |g| of the model; a parameter that the loss does not reach (the
    speaker encoder and its FiLM, which the forward never applies) has
    no gradient in the port and zeros in JAX."""
    want = _flatten_state(jgrads)
    scale = max(np.abs(np.asarray(v)).max() for v in want.values())
    for name, p in model.named_parameters():
        path, kind = convert._flat_name(model, name)
        got = (np.zeros_like(want[path]) if p.grad is None
               else convert._to_jax(p.grad.detach().numpy(), kind))
        np.testing.assert_allclose(got, np.asarray(want[path]), rtol=0,
                                   atol=tol * scale, err_msg=path)


def _stacked_batches(tt, seed: int):
    """Two micro-batches of (mel, text, cropped_mel), stacked, as numpy
    and as port ``Masked``."""
    ins = [_inputs(seed + i, tt.symbols.num_symbols) for i in range(2)]
    out = {}
    for j, name in enumerate(("mel", "text", "cropped_mel")):
        v = np.stack([x[j][0] for x in ins])
        ln = np.asarray([x[j][1] for x in ins], np.int32)
        out[name] = (v, ln)
    return out


def test_trainer_step_with_accumulation_matches_jax(trainers):
    """The port's loss on JAX's draws, then one ``run_step`` over two
    micro-batches against JAX's summed ``jax.grad`` of its loss (the
    port's step draws its own noise, so each micro-batch's draws are
    JAX's, handed in)."""
    jt, tt = trainers
    batches = _stacked_batches(tt, 11)
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]
    grad = jax.jit(jax.grad(jt._loss_fn, has_aux=True))
    loss = jax.jit(jt._loss_fn)
    jgrads, want_m = None, None
    draws = []
    for i in range(2):
        jb = {k: JMasked.from_lengths(jnp.asarray(v[i]), jnp.asarray(ln[i]))
              for k, (v, ln) in batches.items()}
        g, want_m = grad(jt.params, jt.rest, jb, keys[i])
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
        k_model, _ = jax.random.split(keys[i])
        draws.append(_jax_draws(k_model))
    jl, _ = loss(jt.params, jt.rest, jb, keys[1])
    tb = {k: Masked.from_lengths(torch.from_numpy(v[1]), ln[1])
          for k, (v, ln) in batches.items()}
    tl, _ = tt._loss_fn(tb, None, draws[1])
    _close(tl, jl, err_msg="loss")
    stacked = {k: Masked(torch.from_numpy(v), torch.from_numpy(ln), 1)
               for k, (v, ln) in batches.items()}
    got = tt.run_step(stacked, draws=draws)
    _grads_close(jgrads, tt.model)
    n = float(want_m["length"])
    for k in ("kld", "rec_loss"):
        np.testing.assert_allclose(float(got[k]), float(want_m[k]) / n,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["eos_loss"]),
                               float(want_m["eos_loss"]), rtol=1e-5)


def test_train_cli_fit_resume_and_inferer(corpus, vocoder_dir,  # noqa
                                          tmp_path):
    """``scripts/train.py`` reaches the trainer by its identifier, fits
    two steps and writes the compact checkpoint with ``hp.yaml`` and
    ``symbols.json``; a fresh trainer resumes it equal; then
    ``scripts/infer.py -v`` reaches ``TTSInferer`` by its identifier and
    writes ``N.wav``, ``N_c.wav`` and ``N.txt`` for every row."""
    assert resolve("trainers.tts.lvtts.LVTTSTrainer") is LVTTSTrainer
    assert resolve("inference.tts.inferer.TTSInferer") is TTSInferer
    d = _tts_dict(corpus, vocoder_dir)
    d["logging"]["log_dir"] = str(tmp_path / "logs")
    cfg = tmp_path / "train.yaml"
    cfg.write_text(yaml.safe_dump(d))
    train_cli.main(["-c", str(cfg), "--max_steps", "2", "--device", "cpu",
                    "-n", "run"])
    ckpt = tmp_path / "logs" / "run" / "ckpt" / "version_0"
    files = set(os.listdir(ckpt))
    assert {"last-cpt.npz", "hp.yaml", "symbols.json"} <= files
    again = LVTTSTrainer(Hparams.from_dict(copy.deepcopy(d)), seed=5,
                         device="cpu")
    again.resume(str(ckpt / "last-cpt.npz"))
    flat = np.load(ckpt / "last-cpt.npz")
    back = convert.to_flat(again.model)
    assert sorted(back) == sorted(flat.files)
    for k in flat.files:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    infer = {"identifier": "inference.tts.inferer.TTSInferer",
             "exp_dir": str(tmp_path / "logs" / "run"),
             "output_dir": str(tmp_path / "out"),
             "model": {"identifier": "models.tts.lvtr.LVTTS"},
             "max_sample_length": 0.3, "min_sample_length": 0.1,
             "temperature": 1.0, "eos_threshold": 0.5,
             "diffusion": {"sampling_timesteps": 2,
                           "ddim_sampling_eta": 0.0},
             "data": copy.deepcopy(d["data"]["val"])}
    icfg = tmp_path / "infer.yaml"
    icfg.write_text(yaml.safe_dump(infer))
    n = infer_cli.main(["-c", str(icfg), "-v", "0", "--device", "cpu"])
    assert n == 4
    out = set(os.listdir(tmp_path / "out"))
    for i in range(1, n + 1):
        assert {f"{i}.wav", f"{i}_c.wav", f"{i}.txt"} <= out
    assert (tmp_path / "out" / "1.txt").read_text()


@pytest.mark.parametrize("build", ["model", "sampler", "trainer"])
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, build,
                                                     trainers, corpus,  # noqa
                                                     vocoder_dir):  # noqa
    jt, tt = trainers
    hp = Hparams.from_dict(_tts_dict(corpus, vocoder_dir))
    make = {"model": lambda **kw: LVTTS(hp.model, tt.symbols,
                                        input_dim=N_MELS, **kw),
            "sampler": lambda **kw: ARTRTTSSampler(tt.model, **kw),
            "trainer": lambda **kw: LVTTSTrainer(hp, **kw)}[build]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(**kw)
    make(device="cpu")
