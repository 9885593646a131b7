"""The per-layer decode modules against the JAX package, on the same
exported weights, float32 on the CPU (the sampler's routes are in
``tests/test_torch_per_layer_sampler.py``):

  * ``SelfAttention.decode_step``, ``TransformerLayerStack.decode`` (pre-LN
    and post-LN) and ``LVTR.step`` on per-layer caches: a prefill, then
    single-token steps with windows, int8 and float caches,
    ``return_attn``;
  * the K6 route of ``LVTR.step`` (``flash_decode``, the kernel's plain
    version here) against JAX's ``LVTR.step`` with its ``decode_attention``
    replaced by its Pallas ``flash_decode_int8`` in TPU interpret mode;
  * the device rule of the new entry points.

``LVTR.step`` samples by the deterministic protocol of
``tests/test_reference_parity.py``: temperature 0, token temperature 1e-4
(an argmax), the initial AR state pinned with one numpy array.  Tokens
must be equal; hidden states and latents agree to atol 2e-3 / rtol 1e-2
(float32 sums in another order; an int8 cache row requantized one step
apart moves a state by ~1e-4), attention weights to 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.ops import decode_attention as jda
from vae_gslm_tpu.ops.flash_decode import flash_decode_int8 as jax_k6
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models.convert import (layer_cache_from_numpy,
                                               load_reference_lvtr)
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.scripts import bench_slope

B, TP = 2, 6
DETERMINISTIC = dict(temperature=0.0, token_temperature=1e-4,
                     encoder_temperature=0.0)
JDT = {"int8": jnp.int8, "float32": jnp.float32}
TDT = {"int8": torch.int8, "float32": torch.float32}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test makes thousands of tiny torch calls; torch's intra-op
    thread pool stalls them for minutes while other test workers keep the
    cores busy, and one thread runs them at full speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, **layer):
    """The tiny LVTR of ``tests/test_torch_trunk.py`` widened to dim 64
    (four heads of 16, ffd 128), in both packages, the port loaded from
    the JAX export."""
    d = yaml.safe_load(TINY_YAML)
    d["transformer"]["layer"].update(dim=64, ffd_size=128, **layer)
    jm = JLVTR(JHparams.from_dict(d), input_dim=N_MELS, rngs=nnx.Rngs(seed))
    tm = LVTR(Hparams.from_dict(d), input_dim=N_MELS, device="cpu")
    load_reference_lvtr(tm, export_torch_lvtr(jm))
    return jm, tm


def _pin_initial_state(monkeypatch, tm, b=B, nfeat=16, seed=5):
    init = (np.random.RandomState(seed).rand(b, 1, nfeat) * 2 - 1).astype(
        np.float32)
    jinit, tinit = jnp.asarray(init), torch.from_numpy(init)
    # class-level pin: the JAX sampler rebuilds the model via nnx.merge
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None: jinit)
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None: tinit)


def _close(got, want, err_msg="", atol=2e-3, rtol=1e-2):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def _assert_cache_close(tc, jc):
    """int8 rows within one step (a row requantized from hidden states
    ~1e-6 apart can round the other way), scales and float rows to
    1e-4."""
    want = layer_cache_from_numpy(jc)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b_ = getattr(tc, name), getattr(want, name)
        assert (a is None) == (b_ is None), name
        if a is None:
            continue
        assert a.shape == b_.shape, name
        atol = 1 if a.dtype == torch.int8 else 1e-4
        np.testing.assert_allclose(a.float().numpy(), b_.float().numpy(),
                                   atol=atol, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_self_attention_decode_step_matches_jax(kind):
    jm, tm = _pair(seed=1)
    ja = jm.transformer.layers[0].self_attn
    ta = tm.transformer.layers[0].self_attn
    trpe = tm.transformer.rpe

    @nnx.jit(static_argnames="window")
    def jstep(stack, x, cache, pos, window=None):
        return stack.layers[0].self_attn.decode_step(
            x, cache, pos, rpe_pair=("ALiBi", stack.rpe), window=window,
            return_attn=True)

    jc = ja.init_cache(B, 24, JDT[kind])
    tc = ta.init_cache(B, 24, TDT[kind])
    assert tc.max_len == 24
    rng = np.random.RandomState(0)
    x = rng.randn(B, 10, 64).astype(np.float32)
    jo, jc, jw = jstep(jm.transformer, jnp.asarray(x), jc, jnp.asarray(0))
    to, tc, tw = ta.decode_step(torch.from_numpy(x), tc, 0, rpe=trpe,
                                return_attn=True)
    _close(to, jo, "prefill", atol=1e-5, rtol=1e-4)
    assert tuple(tw.shape) == (B, 4, 10, 24)
    _close(tw, jw, "prefill weights", atol=1e-5, rtol=0)
    for pos in range(10, 14):
        x1 = rng.randn(B, 1, 64).astype(np.float32)
        jo, jc, jw = jstep(jm.transformer, jnp.asarray(x1), jc,
                           jnp.asarray(pos), window=16)
        to, tc, tw = ta.decode_step(torch.from_numpy(x1), tc, pos, rpe=trpe,
                                    window=16, return_attn=True)
        _close(to, jo, f"step {pos}", atol=2e-4, rtol=1e-3)
        assert tuple(tw.shape) == (B, 4, 1, 24)
        _close(tw, jw, f"weights {pos}", atol=1e-5, rtol=0)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("kind,preln", [("int8", True), ("float32", True),
                                        ("int8", False)])
def test_stack_decode_matches_jax(kind, preln):
    jm, tm = _pair(seed=2, preln=preln)
    js, ts = jm.transformer, tm.transformer
    jdecode = nnx.jit(lambda m, *a, window=None: m.decode(
        *a, window=window, return_attn=True), static_argnames="window")
    jcs = js.init_cache(B, 20, JDT[kind])
    tcs = ts.init_cache(B, 20, TDT[kind])
    assert len(tcs) == 2
    rng = np.random.RandomState(1)
    x = rng.randn(B, 8, 16).astype(np.float32)
    jh, jcs, ja = jdecode(js, jnp.asarray(x), jcs, jnp.asarray(0))
    th, tcs, ta = ts.decode(torch.from_numpy(x), tcs, 0, return_attn=True)
    _close(th, jh, "prefill", atol=1e-4, rtol=1e-3)
    assert sorted(ta) == ["self_attn"]
    assert tuple(ta["self_attn"].shape) == (2, B, 4, 8, 20)
    _close(ta["self_attn"], ja["self_attn"], "prefill maps", atol=1e-5,
           rtol=0)
    for pos in range(8, 13):
        x1 = rng.randn(B, 1, 16).astype(np.float32)
        jh, jcs, ja = jdecode(js, jnp.asarray(x1), jcs, jnp.asarray(pos),
                              window=16)
        th, tcs, ta = ts.decode(torch.from_numpy(x1), tcs, pos, window=16,
                                return_attn=True)
        _close(th, jh, f"step {pos}", atol=5e-4, rtol=1e-3)
        _close(ta["self_attn"], ja["self_attn"], f"maps {pos}", atol=1e-5,
               rtol=0)
    for tc, jc in zip(tcs, jcs):
        _assert_cache_close(tc, jc)


def _prompt(b=B, nfeat=4, seed=0):
    """[token, feature] frames: latents for ``LVTR.step``, mels for the
    samplers."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 11, (b, TP, 1)).astype(np.float32)
    return np.concatenate([toks, rng.randn(b, TP, nfeat).astype(np.float32)],
                          -1)


def _steps_both(monkeypatch, jm, tm, kind, max_len, steps, return_attn=False,
                flash=False):
    """A prefill of [initial state, prompt latents] by ``LVTR.step``, then
    ``steps`` steps, each side fed its own output (JAX's steps jitted, but
    eager on the K6 route, whose kernel calls the test counts).  Returns
    the per-step (JAX, port) outputs and maps."""
    _pin_initial_state(monkeypatch, tm)
    x = _prompt()
    jcs = jm.init_cache(B, max_len, JDT[kind])
    tcs = tm.init_cache(B, max_len, TDT[kind])
    kw = dict(temperature=0.0, token_temperature=1e-4)
    jprefill = nnx.jit(lambda m, x, c, key: m.step(
        x, c, jnp.asarray(0), key, push_init_state=True, init_key=key, **kw))
    jstep = (lambda m, x, c, pos, key: m.step(
        x, c, pos, key, return_attn=return_attn, **kw))
    if not flash:
        jstep = nnx.jit(jstep)
    jo, jcs = jprefill(jm, jnp.asarray(x), jcs, jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    to, tcs = tm.step(torch.from_numpy(x), tcs, 0, g, temperature=0.0,
                      token_temperature=1e-4, push_init_state=True)
    outs = [(jo, to)]
    jf, tf = jo[:, -1:], to[:, -1:]
    for i in range(steps):
        pos = TP + 1 + i
        jres = jstep(jm, jf, jcs, jnp.asarray(pos), jax.random.PRNGKey(i + 1))
        tres = tm.step(tf, tcs, pos, g, return_attn=return_attn,
                       flash_decode=flash, **kw)
        (jf, jcs), (tf, tcs) = jres[:2], tres[:2]
        outs.append((jres[0], tres[0]) + ((jres[2], tres[2])
                                          if return_attn else ()))
    return outs


@pytest.mark.parametrize("kind,return_attn", [("int8", False),
                                              ("float32", False),
                                              ("int8", True)])
def test_lvtr_step_per_layer_matches_jax(monkeypatch, kind, return_attn):
    jm, tm = _pair(seed=3)
    outs = _steps_both(monkeypatch, jm, tm, kind, 24, 10, return_attn)
    for i, o in enumerate(outs):
        jo, to = np.asarray(o[0]), o[1].numpy()
        np.testing.assert_array_equal(to[..., 0], jo[..., 0],
                                      err_msg=f"tokens {i}")
        _close(o[1][..., 1:], jo[..., 1:], f"latents {i}")
        if return_attn and i:
            assert tuple(o[3].shape) == (2, B, 4, 1, 24)
            _close(o[3], o[2], f"maps {i}", atol=1e-5, rtol=0)


def test_lvtr_step_k6_route_matches_jax_kernel(monkeypatch):
    """12 steps over a 256-position int8 cache: the port's K6 route (the
    plain version) against JAX's step with ``decode_attention`` replaced
    by the interpreted Pallas kernel (24 kernel calls)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    calls = []

    def k6(q, k, v, pos, slopes, window=None, k_scale=None, v_scale=None,
           return_weights=False):
        calls.append(pos)
        # waited for: the interpreted kernel reads its operands through
        # host callbacks, which can deadlock against the eager step's
        # next dispatch (the cache write of the next layer)
        return jax.block_until_ready(
            jax_k6(q, k, v, k_scale, v_scale, pos, slopes))

    monkeypatch.setattr(jda, "decode_attention", k6)
    jm, tm = _pair(seed=4)
    outs = _steps_both(monkeypatch, jm, tm, "int8", 256, 12, flash=True)
    assert len(calls) == 2 * 12
    for i, (jo, to) in enumerate(outs):
        jo = np.asarray(jo)
        np.testing.assert_array_equal(to.numpy()[..., 0], jo[..., 0],
                                      err_msg=f"tokens {i}")
        _close(to[..., 1:], jo[..., 1:], f"latents {i}")


@pytest.mark.parametrize("build", ["float_cache", "flash_decode",
                                   "bench_slope"])
def test_new_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if build == "bench_slope":
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_slope.main([])
        return
    _, tm = _pair(seed=8)
    kw = dict(kv_dtype=torch.int8, flash_decode=True) \
        if build == "flash_decode" else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ARTRSampler(tm, **kw)
    assert ARTRSampler(tm, device="cpu", **kw).device.type == "cpu"
    with pytest.raises(ValueError, match="int8"):
        ARTRSampler(tm, device="cpu", flash_decode=True)
