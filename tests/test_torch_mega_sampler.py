"""The int8-weight serving path against the JAX package, float32 on the
CPU: the mega trunk step by step, the whole ``ARTRSampler`` with
``quantize_weights=True`` (JAX forced onto its mega path,
``VAE_GSLM_MEGA_DECODE=1``, Pallas kernel in interpret mode), the
chunked call, and the int8-weight hybrid path of a model K2 cannot take.

Deterministic protocol of ``tests/test_torch_lvtr_sampler.py``:
temperature 0 pins the latents, token temperature 1e-4 turns the token
draw into an argmax, encoder temperature 0, and the initial AR state is
pinned on both sides with one numpy array.  A 6-frame prompt (tail 0,
stage 7 rows) continued by 150 frames crosses 18 eight-step merges and
the tail -> cold flush at position 128."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lvtr_sampler import DETERMINISTIC, _prompt
from tests.test_torch_mega_step import (assert_cache_equal, mega_lvtr_pair,
                                        t)
from tests.test_torch_trunk import lvtr_pair
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.inference.speech.sampler import ARTRSampler as JSampler
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.ops import mega_step as jmega
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.nn.attention import LayerKVCache
from vae_gslm_tpu_torch.ops import mega_step as tmega

B, TP = 2, 6


def _pin_initial_state(monkeypatch, tm, seed=5):
    init = (np.random.RandomState(seed).rand(B, 1, 16) * 2 - 1).astype(
        np.float32)
    jinit, tinit = jnp.asarray(init), torch.from_numpy(init)
    # class-level pin: the JAX sampler rebuilds the model via nnx.merge
    monkeypatch.setattr(JLVTR, "initial_state",
                        lambda self, key, bsize, nfeat=None: jinit)
    monkeypatch.setattr(tm, "initial_state",
                        lambda generator, bsize, nfeat=None: tinit)


def _run_both(jm, tm, length, **port_kw):
    prompt = _prompt()
    lengths = np.asarray([TP, TP])
    want = JSampler(jm, kv_dtype=jnp.int8, quantize_weights=True)(
        length, JMasked.from_lengths(jnp.asarray(prompt),
                                     jnp.asarray(lengths)),
        jax.random.PRNGKey(0), **DETERMINISTIC)
    sampler = ARTRSampler(tm, kv_dtype=torch.int8, quantize_weights=True,
                          device="cpu", **port_kw)
    got = sampler(length, Masked.from_lengths(torch.from_numpy(prompt),
                                              lengths),
                  torch.Generator().manual_seed(0), **DETERMINISTIC)
    return sampler, np.array(want["frames"].value), got["frames"].value.numpy()


def _first_token_disagreement(tf, jf):
    neq = (tf[:, TP:, 0] != jf[:, TP:, 0]).any(0)
    return int(neq.argmax()) if neq.any() else neq.shape[0]


def test_mega_trunk_matches_jax_across_merges_and_flush(monkeypatch):
    """Stacked int8-weight prefill, ``mega_cache_from_prefill`` and 20
    ``decode_mega`` steps (bf16 dense products) with the sampler's merge
    and flush cadence: merges into tail slots 112 and 120, then the flush
    at position 128.  The two prefills agree to 5e-4 (XLA and torch sum
    the float32 products in another order, which can flip an int8 K/V
    byte and move an attention output); the steps then start from JAX's
    prefill cache, converted by each package."""
    monkeypatch.setenv("VAE_GSLM_MEGA_A8", "0")
    jm, tm = mega_lvtr_pair(seed=1)
    jst, tst = jm.transformer, tm.transformer
    jst.quantize_weights_int8()
    tst.quantize_weights_int8()
    rng = np.random.RandomState(0)
    b, prompt, total = 2, 115, 135
    x = rng.randn(b, prompt, 16).astype(np.float32)
    jw, tw = jst.build_stacked_decode(), tst.build_stacked_decode()
    jcache = jst.init_stacked_cache(b, prompt, dtype=jnp.int8)
    tcache = tst.init_stacked_cache(b, prompt)
    jh, jcache = jst.decode_stacked(jnp.asarray(x), jw, jcache,
                                    jnp.asarray(0))
    th, tcache = tst.decode_stacked(t(x), tw, tcache, 0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-3,
                               atol=5e-4)
    assert (np.abs(tcache.k.numpy().astype(np.int32)
                   - np.asarray(jcache.k, np.int32)).max() <= 1)

    jc, flushed = jst.mega_cache_from_prefill(jcache, prompt, total)
    tc, tflushed = tst.mega_cache_from_prefill(
        LayerKVCache(*(t(a) for a in (jcache.k, jcache.v, jcache.k_scale,
                                      jcache.v_scale))), prompt, total)
    assert flushed == tflushed == 0
    assert_cache_equal(tc, jc)
    jmw, tmw = jst.build_mega_decode(), tst.build_mega_decode()
    errs = []
    for pos in range(prompt, total):
        if pos - flushed == tmega.BLK:
            jc = jmega.flush_mega(jc, flushed)
            tc = tmega.flush_mega(tc, flushed)
            flushed += tmega.BLK
        xs = rng.randn(b, 1, 16).astype(np.float32)
        jo, jc = jst.decode_mega(jnp.asarray(xs), jmw, jc, jnp.asarray(pos),
                                 flushed, interpret=True)
        to, tc = tst.decode_mega(t(xs), tmw, tc, pos, flushed, a8=False)
        diff = np.abs(to.numpy() - np.asarray(jo))
        # K2 rounds every dense input to bf16: a last-bit difference (XLA's
        # float32 sums against the port's float64 sums) can flip one such
        # rounding (2^-8 relative), or a requantized probability by one
        # int8 step, and move outputs by up to ~2e-3; a flipped K/V row
        # stays in the stage and the tail.  Most elements still agree to
        # float32 rounding.
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-2,
                                   atol=5e-3, err_msg=f"pos {pos}")
        errs.append(np.median(diff))
        if (pos + 1 - flushed) % tmega.STAGE == 0:
            slot = pos + 1 - flushed - tmega.STAGE
            jc = jmega.merge_stage(jc, slot)
            tc = tmega.merge_stage(tc, slot)
    assert flushed == tmega.BLK
    assert max(errs) < 1e-5, errs


def test_sampler_matches_jax_mega(monkeypatch):
    """bf16 dense products (``VAE_GSLM_MEGA_A8=0`` / ``mega_a8=False``):
    the 150-step token streams are equal, latents within the long-horizon
    budget of ``tests/test_torch_lvtr_sampler.py``."""
    jm, tm = mega_lvtr_pair(seed=11)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_MEGA_A8", "0")
    sampler, jf, tf = _run_both(jm, tm, 150, mega_a8=False)
    assert sampler.use_mega
    assert tf.shape == jf.shape == (B, TP + 150, 1 + 4)
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg="150-step token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")


def test_sampler_matches_jax_mega_a8(monkeypatch):
    """s8 x s8 dense products, the default at B = 2 (JAX's ``auto``
    gate, the port's ``mega_a8=None``): the 150-step token streams are
    equal.  Each activation row is requantized to int8 before every
    product, so a last-bit difference (float32 sums in XLA's order
    against the port's float64 sums) can flip one int8 step of an
    activation; over these 150 steps no flip reaches a token, and the
    flips move latents by up to 5.4e-3, so their band is atol 1e-2."""
    jm, tm = mega_lvtr_pair(seed=11)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_MEGA_A8", "auto")
    _, jf, tf = _run_both(jm, tm, 150)
    assert _first_token_disagreement(tf, jf) >= 150
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=1e-2,
                               rtol=1e-2, err_msg="latents")


@pytest.mark.parametrize("length", [8, 280])
def test_int8_weight_hybrid_matches_jax(monkeypatch, length):
    """A model K2 cannot take (dim 32) with int8 weights serves through
    the hybrid path (K1 per layer, the stacked matmuls upconverting the
    int8 weights) in both packages; 280 steps cross the 256-position
    flush."""
    jm, tm = lvtr_pair(seed=11)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    sampler, jf, tf = _run_both(jm, tm, length)
    assert not sampler.use_mega
    assert tm.transformer.layers[0].linear1.weight.dtype == torch.int8
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg=f"{length}-step token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")


def test_chunked_call_matches_chunks_run_alone():
    """B = 3 with ``mega_max_batch=2``: chunks [0, 2) and [2, 3) run one
    after the other on one generator, and their outputs are
    concatenated; B = 5 > 2 x 2 runs the per-layer int8 route, as JAX's
    sampler does past its chunked batches."""
    _, tm = mega_lvtr_pair(seed=3)
    sampler = ARTRSampler(tm, kv_dtype=torch.int8, quantize_weights=True,
                          mega_max_batch=2, device="cpu")
    rng = np.random.RandomState(0)
    prompt = np.concatenate([rng.randint(0, 11, (3, TP, 1)),
                             rng.randn(3, TP, 10)], -1).astype(np.float32)
    lengths = np.asarray([TP, TP, TP - 1])
    kw = dict(temperature=0.8, token_temperature=0.8)
    timings = {}
    out = sampler(12, Masked.from_lengths(torch.from_numpy(prompt), lengths),
                  torch.Generator().manual_seed(0), timings=timings, **kw)
    assert sorted(timings) == ["ar_loop", "diffusion", "encode_prefill"]
    g = torch.Generator().manual_seed(0)
    parts = [sampler(12, Masked.from_lengths(torch.from_numpy(prompt[sl]),
                                             lengths[sl]), g, **kw)
             for sl in (slice(0, 2), slice(2, 3))]
    for key in ("frames", "output"):
        np.testing.assert_array_equal(
            out[key].value.numpy(),
            torch.cat([p[key].value for p in parts]).numpy(), err_msg=key)
        np.testing.assert_array_equal(
            out[key].lengths.numpy(),
            torch.cat([p[key].lengths for p in parts]).numpy())
    assert out["frames"].lengths.tolist() == [TP + 12, TP + 12, TP - 1 + 12]
    wide = np.concatenate([prompt, prompt[:2]])
    assert [sampler.route(b) for b in (2, 3, 4, 5)] == [
        "mega", "chunked", "chunked", "per_layer"]
    out = sampler(4, Masked.from_lengths(torch.from_numpy(wide), [TP] * 5))
    assert out["frames"].value.shape == (5, TP + 4, 5)
    assert bool(torch.isfinite(out["output"].value).all())


@pytest.mark.parametrize("n_sm, a8, w4, routes", [
    (132, False, 0, ["mega", "chunked", "per_layer"]),
    (1, False, 0, ["hybrid", "hybrid", "per_layer"]),
    (1, None, 0, ["mega", "chunked", "per_layer"]),
    (1, False, 128, ["mega", "chunked", "per_layer"])])
def test_route_asks_the_bf16_step_plan_on_a_card(monkeypatch, n_sm, a8, w4,
                                                 routes):
    """On a card, a mega batch (or chunk) that K2's bf16 branch would run
    takes the hybrid route when the persistent step's plan does not fit
    a block of that card (``bf16_step_fits``; here the small trunk's on a
    one-SM card), so the sampler never picks a route that raises; the a8
    branch (B <= 8 by default) and the w4 branch take any width, and the
    CPU's plain version any batch."""
    _, tm = mega_lvtr_pair(seed=3)
    sampler = ARTRSampler(tm, kv_dtype=torch.int8, quantize_weights=True,
                          mega_max_batch=2, mega_a8=a8, mega_w4=w4,
                          device="cpu")
    assert [sampler.route(b) for b in (2, 3, 5)] == [
        "mega", "chunked", "per_layer"]
    monkeypatch.setattr(tmega, "sm_count", lambda dev: n_sm)
    sampler.device = torch.device("cuda")
    assert [sampler.route(b) for b in (2, 3, 5)] == routes
