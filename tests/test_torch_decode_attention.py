"""The port's per-layer decode attention and cache against the JAX
package's: ``ops/decode_attention.py`` (int8 and float caches, ALiBi or none, windows, ``return_weights``) and
the per-layer ``LayerKVCache`` (``zeros``, ``write``, ``dense_kv``), on
the same numpy inputs, on the CPU.

The int8 logits are compared bit for bit: JAX's are read by running its
function with ``jax.nn.softmax`` replaced by the identity (its "weights"
are then the masked logits).  Outputs and weights agree to rtol 1e-5 /
atol 1e-6 (float32 softmax and sums in another order), except the int8
output, held to atol 2e-4: the weights are rounded to bfloat16 before the
V product, and should an f32 ulp of the softmax flip one rounding, the
output moves by one bfloat16 step of a weight times an int8 value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.nn.attention import LayerKVCache as JCache
from vae_gslm_tpu.nn.attention import _quantize_i8
from vae_gslm_tpu.nn.positions import alibi_slopes
from vae_gslm_tpu.ops import decode_attention as jda
from vae_gslm_tpu_torch.models.convert import layer_cache_from_numpy
from vae_gslm_tpu_torch.nn.attention import LayerKVCache
from vae_gslm_tpu_torch.ops import decode_attention as tda

B, H, T, D = 2, 4, 96, 16


def _inputs(kind: str, seed: int = 0):
    """q (B, H, D) and a cache as (JAX arrays, torch tensors): int8 rows
    with scales quantized by JAX's ``_quantize_i8``, or float32 rows."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, H, T, D).astype(np.float32)
    v = rng.randn(B, H, T, D).astype(np.float32)
    if kind == "int8":
        (k, ks), (v, vs) = _quantize_i8(jnp.asarray(k)), _quantize_i8(
            jnp.asarray(v))
        k, ks, v, vs = (np.asarray(x) for x in (k, ks, v, vs))
    else:
        ks = vs = None
    arrays = (q, k, v, ks, vs)
    return ([None if x is None else jnp.asarray(x) for x in arrays],
            [None if x is None else torch.from_numpy(np.array(x))
             for x in arrays])


CASES = [(0, None, True), (0, 64, True), (63, 64, True), (T - 1, None, True),
         (50, None, False)]


@pytest.mark.parametrize("pos,window,alibi", CASES)
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_decode_attention_matches_jax(monkeypatch, kind, pos, window, alibi):
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = _inputs(kind)
    s = -np.asarray(alibi_slopes(H), np.float32) if alibi else None
    js = None if s is None else jnp.asarray(s)
    ts = None if s is None else torch.from_numpy(s)
    jout, jw = jda.decode_attention(jq, jk, jv, jnp.asarray(pos), js,
                                    window=window, k_scale=jks, v_scale=jvs,
                                    return_weights=True)
    tout, tw = tda.decode_attention(tq, tk, tv, pos, ts, window=window,
                                    k_scale=tks, v_scale=tvs,
                                    return_weights=True)
    assert tuple(tout.shape) == (B, H, D) and tuple(tw.shape) == (B, H, T)
    atol = 2e-4 if kind == "int8" else 1e-6
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=atol, err_msg="out")
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6, err_msg="weights")
    if kind != "int8":
        return
    # the logits bit for bit
    monkeypatch.setattr(jax.nn, "softmax", lambda x, axis=-1: x)
    _, jlogits = jda.decode_attention(jq, jk, jv, jnp.asarray(pos), js,
                                      window=window, k_scale=jks,
                                      v_scale=jvs, return_weights=True)
    t = window or T
    got = tda.decode_logits(tq, tk[:, :, :t], pos, ts, tks[:, :, :t])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlogits)[..., :t])


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_layer_cache_write_and_dense_kv_match_jax(dtype):
    """A prefill of 5 rows at position 3, then one row at 8, into JAX's
    zeros and into the port's copy of them (``layer_cache_from_numpy``):
    the stored rows and scales equal, ``dense_kv`` equal."""
    jdt = {"int8": jnp.int8, "float32": jnp.float32,
           "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jc = JCache.zeros(B, 12, H, D, jdt)
    tc = layer_cache_from_numpy(jc)
    zeros = LayerKVCache.zeros(B, 12, H, D, tdt)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b_ = getattr(tc, name), getattr(zeros, name)
        assert (a is None) == (b_ is None), name
        if a is not None:
            assert a.dtype == b_.dtype and a.shape == b_.shape, name
    assert tc.max_len == 12
    rng = np.random.RandomState(1)
    for pos, s in ((3, 5), (8, 1)):
        k = rng.randn(B, s, H, D).astype(np.float32)
        v = rng.randn(B, s, H, D).astype(np.float32)
        jc = jc.write(jnp.asarray(pos), jnp.asarray(k), jnp.asarray(v))
        tc.write(pos, torch.from_numpy(k), torch.from_numpy(v))
    want = layer_cache_from_numpy(jc)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b_ = getattr(tc, name), getattr(want, name)
        if b_ is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a.float().numpy(), b_.float().numpy(),
                                      err_msg=name)
    jk, jv = jc.dense_kv()
    tk, tv = tc.dense_kv()
    assert tuple(tk.shape) == (B, 12, H, D)
    for got, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
