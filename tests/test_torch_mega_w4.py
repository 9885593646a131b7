"""K2-w4, the nibble-packed int4 branch of the whole-trunk step: the port
against the JAX package on the CPU.  Its card tests are in the torch-only
``tests/test_torch_mega_w4_cuda.py``.

  * ``build_mega_decode_w4`` equals JAX's bit for bit (the packed bytes,
    and the folded group scales as float32 bits) at groups 128 and 64,
    and refuses a group that is not a multiple of the head width or does
    not divide din / 2;
  * ``fused_trunk_step_plain`` on JAX's w4 weights against JAX's Pallas
    kernel in interpret mode and against ``fused_trunk_step_reference``
    at the cases of ``tests/test_mega_step.py::
    test_mega_kernel_w4_matches_reference`` (rtol 2e-3 / atol 2e-4, its
    band), and within relative 0.25 of the int8-weight path (JAX's band
    for the 4-bit requantization);
  * the wrapper on a CPU tensor takes the plain version and counts no
    launch; ``w4_group`` refuses what the kernel cannot take;
  * ``ARTRSampler`` with the w4 trunk against JAX's sampler with
    ``VAE_GSLM_MEGA_W4`` set, under the deterministic protocol of
    ``tests/test_torch_mega_sampler.py``: 150 steps cross eight-step
    merges and the 128-position flush, and the token streams are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mega_step import D, L, _cache, _stack
from tests.test_torch_mega_sampler import (TP, _first_token_disagreement,
                                           _pin_initial_state, _run_both)
from tests.test_torch_mega_step import cache_to_torch, mega_lvtr_pair, t
from vae_gslm_tpu.ops import mega_step as jmega
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models.convert import mega_weights_from_numpy
from vae_gslm_tpu_torch.ops import mega_step as tmega

W4_CASES = [(0, 40, 128), (128, 140, 64)]     # (flushed, pos, group)
B = 8


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _inputs(group):
    m = _stack()
    jw = m.build_mega_decode_w4(group=group)
    cache = _cache(B, 2)
    x = jnp.asarray(np.random.RandomState(3).randn(B, D) * 0.3, jnp.float32)
    slopes = m.rpe.slopes[...]
    return m, (x, jw, cache, slopes), (t(x), mega_weights_from_numpy(jw),
                                       cache_to_torch(cache), t(slopes))


@pytest.mark.parametrize("group", [128, 64])
def test_build_mega_decode_w4_matches_jax_bitwise(group):
    jm, tm = mega_lvtr_pair(seed=4)
    jst, tst = jm.transformer, tm.transformer
    assert jst.build_mega_decode_w4(group) is None
    assert tst.build_mega_decode_w4(group) is None
    jst.quantize_weights_int8()
    tst.quantize_weights_int8()
    jw, tw = jst.build_mega_decode_w4(group), tst.build_mega_decode_w4(group)
    carried = mega_weights_from_numpy(jw)
    assert sorted(tw) == sorted(jw) == sorted(carried)
    assert tw["wq"].shape == (len(tst.layers), 128, 3 * 256)
    assert tw["g2"].shape == (len(tst.layers), 1024 // group, 256)
    for k in jw:
        assert tw[k].dtype == carried[k].dtype, k
        np.testing.assert_array_equal(_bits(tw[k].numpy()), _bits(jw[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_bits(carried[k].numpy()),
                                      _bits(tw[k].numpy()), err_msg=k)


@pytest.mark.parametrize("group", [32, 96, 256])
def test_build_mega_decode_w4_refuses_groups(group):
    """32 and 96 are not multiples of the head width 64 (the
    out-projection applies one group scale per head); 256 does not divide
    din / 2 = 128 of a dim-256 trunk."""
    _, tm = mega_lvtr_pair(seed=4)
    tm.transformer.quantize_weights_int8()
    with pytest.raises(ValueError):
        tm.transformer.build_mega_decode_w4(group)


@pytest.mark.parametrize("flushed,pos,group", W4_CASES)
@pytest.mark.parametrize("oracle", ["interpret_kernel", "reference"])
def test_plain_w4_matches_jax(flushed, pos, group, oracle):
    _, (x, jw, cache, slopes), targs = _inputs(group)
    if oracle == "reference":
        want = jmega.fused_trunk_step_reference(x, jw, cache, pos, slopes,
                                                flushed)
    else:
        want = jmega.fused_trunk_step(x, jw, cache, jnp.asarray(pos),
                                      slopes, flushed=flushed,
                                      interpret=True)
    got = tmega.fused_trunk_step_plain(*targs[:3], pos, targs[3], flushed)
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        assert g.dtype == (torch.float32 if name == "x" else torch.bfloat16)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("flushed,pos,group", W4_CASES)
def test_plain_w4_within_band_of_int8(flushed, pos, group):
    """The int4 requantization moves each output by at most a quarter of
    its largest magnitude against the int8 weights (JAX's band); ``a8``
    has no effect on the w4 branch."""
    m, _, (x, w4, cache, slopes) = _inputs(group)
    w8 = mega_weights_from_numpy(m.build_mega_decode())
    got = tmega.fused_trunk_step_plain(x, w4, cache, pos, slopes, flushed)
    again = tmega.fused_trunk_step_plain(x, w4, cache, pos, slopes, flushed,
                                         a8=True)
    ref = tmega.fused_trunk_step_plain(x, w8, cache, pos, slopes, flushed)
    for name, g, g2, r in zip(("x", "k_new", "v_new"), got, again, ref):
        np.testing.assert_array_equal(g.float().numpy(), g2.float().numpy())
        g, r = g.float().numpy(), r.float().numpy()
        rel = np.abs(g - r).max() / (np.abs(r).max() + 1e-9)
        assert rel < 0.25, f"{name}: w4 vs int8 rel {rel:.3f}"


def test_unpack_w4_sign_extends_both_nibbles():
    vals = np.arange(-8, 8)
    hi, lo = np.meshgrid(vals, vals, indexing="ij")
    packed = ((hi << 4) | (lo & 0xF)).astype(np.int8).reshape(1, -1)
    got = tmega.unpack_w4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.stack([hi.ravel(), lo.ravel()]))


def test_wrapper_w4_takes_plain_version_on_cpu():
    _, _, (x, w, cache, slopes) = _inputs(128)
    before = (tmega.fused_trunk_step.launches,
              tmega.fused_trunk_step.launches_w4)
    got = tmega.fused_trunk_step(x, w, cache, 140, slopes, 128)
    want = tmega.fused_trunk_step_plain(x, w, cache, 140, slopes, 128)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), wnt.float().numpy())
    assert (tmega.fused_trunk_step.launches,
            tmega.fused_trunk_step.launches_w4) == before


@pytest.mark.parametrize("groups,group", [(8, 64), (4, 128), (2, None),
                                          (1, None), (16, None), (3, None)])
def test_w4_group_refuses_what_the_kernel_cannot_take(groups, group):
    """At dim 512: groups of 64 and 128 are taken; the kernel has no
    instantiation for a group of 256, one group of 512 does not divide
    dim / 2 either, a group of 32 is not a multiple of the head width, and
    3 groups do not split the dim evenly."""
    w = {"gq": torch.zeros(L, groups, 3 * 512)}
    if group:
        assert tmega.w4_group(w, 512) == group
    else:
        with pytest.raises(ValueError):
            tmega.w4_group(w, 512)


def test_sampler_w4_setting(monkeypatch):
    """``mega_w4=None`` reads ``VAE_GSLM_MEGA_W4`` as JAX does; an int
    forces the group."""
    _, tm = mega_lvtr_pair(seed=3)
    for env, want in (("0", 0), ("", 0), ("64", 64), ("1", 128),
                      ("yes", 128)):
        monkeypatch.setenv("VAE_GSLM_MEGA_W4", env)
        assert ARTRSampler(tm, device="cpu").mega_w4 == want, env
    assert ARTRSampler(tm, device="cpu", mega_w4=64).mega_w4 == 64
    monkeypatch.delenv("VAE_GSLM_MEGA_W4")
    assert ARTRSampler(tm, device="cpu").mega_w4 == 0


def test_sampler_matches_jax_mega_w4(monkeypatch):
    """Group 64 (``VAE_GSLM_MEGA_W4=64`` for both packages), s8 x s8
    products per group: the 150-step token streams are equal.  Each
    activation group is requantized to int8 before every product, so a
    last-bit difference (float32 sums in XLA's order against the port's
    float64 sums) can flip one int8 step, as on the a8 path; latents are
    held to that path's band, atol 1e-2."""
    jm, tm = mega_lvtr_pair(seed=11)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_MEGA_W4", "64")
    calls = []
    build = type(tm.transformer).build_mega_decode_w4
    monkeypatch.setattr(type(tm.transformer), "build_mega_decode_w4",
                        lambda self, group=128: calls.append(group)
                        or build(self, group))
    sampler, jf, tf = _run_both(jm, tm, 150)
    assert sampler.use_mega and sampler.mega_w4 == 64 and calls == [64]
    assert tf.shape == jf.shape == (2, TP + 150, 1 + 4)
    assert _first_token_disagreement(tf, jf) >= 150
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=1e-2,
                               rtol=1e-2, err_msg="latents")
