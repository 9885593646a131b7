"""K2 at head widths 32 and 128: the port against the JAX package on the
CPU.  JAX's kernel takes any head width (``_kernel``'s ``head_dim``) and
its ``supports_mega_decode`` asks nothing of it; the port's kernel is
instantiated at 32, 64 and 128, and the int8-weight 8 x 128 and 32 x 32
trunks serve on K2 as they do in JAX.

  * ``fused_trunk_step_plain`` against JAX's Pallas kernel in interpret
    mode and against ``fused_trunk_step_reference`` on a dim-256 trunk of
    8 heads of 32 and 2 of 128 (``tests/test_mega_step.py``'s trunk with
    other heads), a8 and bf16 products and w4 weights, at rtol 2e-3 /
    atol 2e-4 (the JAX test's band);
  * the kernel's plans (``bf16_step_plan``, ``i8_step_plan``) at d1024
    for 8 x 128, 16 x 64 and 32 x 32 and B 1-32 on 114 and 132 SMs, and
    ``group_smem`` against the layout of ``GroupSmem<dh>``;
  * ``supports_mega_decode`` of the port against JAX's at each width.

The samplers at these widths are in
``tests/test_torch_mega_head_widths_sampler.py``."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_mega_step import (_pass_work, _tile_cover,
                                        cache_to_torch, t)
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.nn.transformer import TransformerLayerStack as JStack
from vae_gslm_tpu.ops import mega_step as jmega
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import mega_weights_from_numpy
from vae_gslm_tpu_torch.nn.transformer import TransformerLayerStack
from vae_gslm_tpu_torch.ops import mega_step as tmega

D, L = 256, 2
WIDTHS = {32: 8, 128: 2}                  # head width -> heads at dim 256
CASES = [(0, 40), (128, 140), (256, 300)]  # (flushed, pos)
B = 8


def _jstack(h):
    hp = JHparams.from_yaml(f"""
num_layers: {L}
bias: false
rpe: {{identifier: ALiBi, maxpos: 1024}}
layer:
    ffd_size: {4 * D}
    dim: {D}
    norm: {{identifier: RMSNorm, eps: 1.0e-6}}
    activation: {{identifier: GELU}}
    self_attn: {{nheads: {h}, causal: true}}
""")
    m = JStack(hp, rngs=nnx.Rngs(0))
    m.quantize_weights_int8()
    return m


def _jcache(b, nb, h, seed=1):
    """``tests/test_mega_step.py::_cache`` at ``h`` heads."""
    rng = np.random.RandomState(seed)
    dh, blk = D // h, jmega.BLK
    i8 = lambda *s: jnp.asarray(rng.randint(-127, 128, s), jnp.int8)
    sc = lambda *s: jnp.asarray(rng.rand(*s) * 0.02, jnp.float32)
    return {
        "k_cold": i8(L, nb, h, b, dh, blk), "v_cold": i8(L, nb, h, b, dh, blk),
        "kc_scale": sc(L, nb, h, b, blk), "vc_scale": sc(L, nb, h, b, blk),
        "k_tail": i8(L, h, b, jmega.TAIL, dh),
        "v_tail": i8(L, h, b, jmega.TAIL, dh),
        "kt_scale": sc(L, h, b, jmega.TAIL),
        "vt_scale": sc(L, h, b, jmega.TAIL),
        "k_stage": jnp.asarray(rng.randn(L, jmega.STAGE, h, b, dh) * 0.3,
                               jnp.bfloat16),
        "v_stage": jnp.asarray(rng.randn(L, jmega.STAGE, h, b, dh) * 0.3,
                               jnp.bfloat16),
    }


def _inputs(dh, group=0):
    h = WIDTHS[dh]
    m = _jstack(h)
    jw = m.build_mega_decode_w4(group=group) if group else \
        m.build_mega_decode()
    cache = _jcache(B, 2, h)
    x = jnp.asarray(np.random.RandomState(3).randn(B, D) * 0.3, jnp.float32)
    slopes = m.rpe.slopes[...]
    return (x, jw, cache, slopes), (t(x), mega_weights_from_numpy(jw),
                                    cache_to_torch(cache), t(slopes))


def _hold(got, want):
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        assert g.dtype == (torch.float32 if name == "x" else torch.bfloat16)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def _hold_layers(dh, flushed, pos, a8=False, group=0):
    """Each layer of the step in both packages on the same input (JAX's
    output of the layer before) against JAX's interpreted kernel and its
    reference.  Layer by layer, because the function itself amplifies a
    last-bit difference of its input: at width 128 (bf16, (256, 384)) the
    port's first layer differs from JAX's by float32 roundings (its sums
    are float64, XLA's float32), which flip an int8 step of a quantized
    activation in the second layer and move one row by 1.2e-3, while the
    second layer on JAX's own input agrees to 1.8e-7.  The cases are a
    tail and stage, a cold block, and two cold blocks; at a full tail with
    an empty stage, (256, 384), the a8 step at width 128 leaves the band
    on 21 outputs (4.7e-4) of its second layer on JAX's input: two GELU
    outputs of its FFN lie within 1e-5 of an int8 rounding tie, and the
    port's and XLA's float32 GELU differ there by an ulp (the FFN does not
    depend on the head width; the CUDA kernel and the plain version agree
    there on the card)."""
    (x, w, cache, slopes), (_, tw, tc, ts) = _inputs(dh, group)
    for li in range(L):
        one = lambda d: {k: v[li:li + 1] for k, v in d.items()}
        got = tmega.fused_trunk_step_plain(t(x), one(tw), one(tc), pos, ts,
                                           flushed, a8=a8)
        want = jmega.fused_trunk_step_reference(x, one(w), one(cache), pos,
                                                slopes, flushed, a8=a8)
        _hold(got, want)
        _hold(got, jmega.fused_trunk_step(
            x, one(w), one(cache), jnp.asarray(pos), slopes,
            flushed=flushed, interpret=True, a8=a8))
        x = want[0]


@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("dh", sorted(WIDTHS))
def test_plain_matches_jax_at_head_widths(dh, a8, flushed, pos):
    """a8 and bf16 products.  The softmax scale 1/sqrt(dh) is no power of
    two at 32 and 128, so its products round: both packages (and the CUDA
    kernel) multiply as ``(float(dot) * (q_scale * scale)) * k_scale``
    and ``float(dot) * scale``, the same roundings."""
    _hold_layers(dh, flushed, pos, a8=a8)


@pytest.mark.parametrize("dh,group", [(128, 128), (32, 64), (32, 128)])
def test_plain_w4_matches_jax_at_head_widths(dh, group):
    """The w4 step: a group is a multiple of the head width (the
    out-projection scales each head by its group's row), so width 128
    takes group 128 alone."""
    _hold_layers(dh, 128, 140, group=group)


def test_wrapper_names_the_widths_it_takes():
    """On a CUDA tensor the wrapper raises NotImplementedError naming the
    three widths for any other (here 16); the plans refuse it too, while
    the CPU's plain version takes any width."""
    with pytest.raises(NotImplementedError, match="32, 64 or 128"):
        tmega.head_dim(256, 16)
    with pytest.raises(NotImplementedError, match="32, 64 or 128"):
        tmega.bf16_step_plan(8, 256, 16, 132)
    with pytest.raises(NotImplementedError, match="32, 64 or 128"):
        tmega.i8_step_plan(8, 256, 16, 132)
    assert [tmega.head_dim(1024, h) for h in (32, 16, 8)] == [32, 64, 128]


def _group_smem_struct(dh):
    """``GroupSmem<dh>`` of ``csrc/mega_step.cu`` for ctypes, field by
    field."""
    parts = tmega.ATTN_THREADS // dh
    return type(f"GroupSmem{dh}", (ctypes.Structure,), {"_fields_": [
        ("qf", ctypes.c_float * dh), ("kc", ctypes.c_float * dh),
        ("vc", ctypes.c_float * dh),
        ("avred", ctypes.c_int * ((parts - 1) * dh if parts > 1 else 4)),
        ("dred", ctypes.c_double * 4), ("fred", ctypes.c_float * 4),
        ("s_st", ctypes.c_float * tmega.STAGE), ("q8", ctypes.c_int8 * dh),
        ("u8", ctypes.c_int8 * tmega.ATTN_THREADS),
        ("kv", ctypes.c_int8 * (tmega.kv_buffers(dh) * tmega.BLK * dh))]})


@pytest.mark.parametrize("dh", tmega.HEAD_DIMS)
def test_group_smem_mirrors_the_struct(dh):
    """``group_smem(dh)`` is the struct's size rounded up to its 16-byte
    alignment; width 128 keeps one K/V buffer (K, then V), so its scratch
    stays near width 64's and four groups fit the bf16 step's block."""
    size = ctypes.sizeof(_group_smem_struct(dh))
    assert tmega.group_smem(dh) == -(-size // 16) * 16
    assert tmega.kv_buffers(dh) == (1 if dh == 128 else 2)
    assert {d: tmega.group_smem(d) for d in tmega.HEAD_DIMS} == {
        32: 9200, 64: 17680, 128: 18272}


@pytest.mark.parametrize("h", [8, 16, 32])
@pytest.mark.parametrize("n_sm", [114, 132])
def test_plans_fit_at_d1024_for_every_width(h, n_sm):
    """The bf16 and a8/w4 plans at d1024 for 8 x 128, 16 x 64 and 32 x 32,
    B 1-32: the bf16 plan fits 232,448 bytes on 132 SMs at every B (on
    114 its weight slots outgrow the block at d1024 at every width, as
    ``bf16_step_fits`` says), the plan at 16 x 64 is no larger than
    before (202,960 bytes at B 32), and the a8 and w4 plans (groups 64
    and 128 where a multiple of the width) fit on both cards."""
    d, dh = 1024, 1024 // h
    for b in range(1, 33):
        plan = tmega.bf16_step_plan(b, d, h, n_sm)
        assert plan.region >= tmega.STEP_GROUPS * tmega.group_smem(dh)
        assert (plan.bytes <= tmega.SMEM_LIMIT) is (n_sm == 132)
        assert tmega.bf16_step_fits(b, d, h, n_sm) is (n_sm == 132)
        for group in (0, 64, 128):
            if group % dh:
                continue
            p8 = tmega.i8_step_plan(b, d, h, n_sm, group)
            assert p8.bytes <= tmega.SMEM_LIMIT, (b, group)
            assert p8.region >= tmega.STEP_GROUPS * tmega.group_smem(dh)
    if n_sm == 132 and h == 16:
        assert tmega.bf16_step_plan(32, d, h, n_sm).bytes == 202960


@pytest.mark.parametrize("h", [8, 32])
@pytest.mark.parametrize("b", [1, 8, 17, 32])
def test_plans_cover_every_column_at_head_widths(h, b):
    """At d1024 on 132 SMs: every output column of the bf16 step's
    products is one block's (``step_units``), the out-projection's
    per-head partial sums (h heads) fit the partial buffer and every
    head goes to one warp; every stored weight row of every column of
    the a8 and w4 steps lies in one tile of whole fold groups (the
    out-projection's: heads of ``dh``)."""
    d, dh, n_sm = 1024, 1024 // h, 132
    plan = tmega.bf16_step_plan(b, d, h, n_sm)
    for pi, (n, k) in enumerate(tmega.step_products(d)):
        seen = []
        for blk in range(n_sm):
            units = tmega.step_units(n, n_sm, blk)
            assert len(units) * tmega.STRIP_COLS * k <= plan.slot
            up = min(tmega.UNITS_PER_PASS, len(units))
            for bt0, ntp, nks, work in _pass_work(b, k, h if pi == 1 else 0):
                bw = tmega.TILE_ROWS * ntp
                need = (h * bw * up * 8 * 4 if pi == 1
                        else nks * bw * up * 8 * 8)
                assert need <= plan.part
                assert set(work) == {(bt0 + tt, it) for tt in range(ntp)
                                     for it in range(h if pi == 1
                                                     else k // 16)}
            seen += [u * tmega.UNIT_COLS + c for u in units
                     for c in range(tmega.UNIT_COLS)]
        assert sorted(seen) == list(range(n))
    for group in (0, 64, 128):
        if group % dh:
            continue
        p8 = tmega.i8_step_plan(b, d, h, n_sm, group)
        for p in range(4):
            cover = _tile_cover(p, d, group, p8, n_sm, dh)
            assert (cover == 1).all(), (p, group)


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("h", [8, 16, 32])
def test_supports_mega_decode_matches_jax(h):
    """At dim 1024 with 8 x 128, 16 x 64 and 32 x 32 heads: the port's
    predicate is JAX's, which asks nothing of the head width: both refuse
    float projections and take int8 ones (JAX's module built abstractly
    and filled with zeros, its int8 kernels set as zeros, as the port's
    weights are)."""
    hp = f"""
num_layers: 1
bias: false
rpe: {{identifier: ALiBi, maxpos: 1024}}
layer:
    ffd_size: 4096
    dim: 1024
    norm: {{identifier: RMSNorm, eps: 1.0e-6}}
    activation: {{identifier: GELU}}
    self_attn: {{nheads: {h}, causal: true}}
"""
    gdef, state = nnx.split(nnx.eval_shape(
        lambda: JStack(JHparams.from_yaml(hp), rngs=nnx.Rngs(0))))
    js = nnx.merge(gdef, jax.tree.map(lambda v: np.zeros(v.shape, v.dtype),
                                      state))
    ts = TransformerLayerStack(Hparams.from_yaml(hp))
    assert ts.layers[0].self_attn.head_dim == 1024 // h
    got = []
    for int8 in (False, True):
        if int8:
            for jl, tl in zip(js.layers, ts.layers):
                for jm, tm in ((jl.self_attn.in_proj, tl.self_attn.in_proj),
                               (jl.self_attn.out_proj,
                                tl.self_attn.out_proj),
                               (jl.linear1, tl.linear1),
                               (jl.linear2, tl.linear2)):
                    jm.kernel.value = np.zeros(jm.kernel.value.shape,
                                               np.int8)
                    tm.weight = torch.nn.Parameter(
                        torch.zeros(tm.weight.shape, dtype=torch.int8),
                        requires_grad=False)
        got.append((js.supports_mega_decode(), ts.supports_mega_decode()))
    assert got == [(False, False), (True, True)]
