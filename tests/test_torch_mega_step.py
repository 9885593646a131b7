"""K2, the whole-trunk mega step, and its cache upkeep: the port against
the JAX package on the CPU.  The card tests of the kernels are in the
torch-only ``tests/test_torch_mega_bf16.py`` and
``tests/test_torch_mega_w4_cuda.py`` (the card's machine has no flax).

  * ``fused_trunk_step_plain`` against the JAX Pallas kernel in interpret
    mode and against ``fused_trunk_step_reference``, on the weights, cache
    and ``(flushed, pos)`` cases of ``tests/test_mega_step.py``, with and
    without the s8 x s8 dense products, at rtol 2e-3 / atol 2e-4 (the
    JAX test's band; the two agree to about 4e-7 here);
  * ``quantize_int8``, ``build_mega_decode``, ``stage_append`` /
    ``merge_stage`` / ``flush_mega`` and ``mega_cache_from_prefill``
    exactly;
  * the sampler's merge / flush cadence, driven with a stand-in step,
    against JAX's ``_mega_scan_segments``, exactly;
  * the premise of the bf16 branch's persistent kernel: the plain
    version's float64 products round to the same float32 bits as a
    numpy float64 sum in the kernel's order (or its reverse), and the
    kernel's shared-memory plan (``bf16_step_plan``) covers every output
    column once within the H100's per-block limit;
  * the same for the a8/w4 persistent kernel: int32 partials of chunks
    in a shuffled order and the group-order float32 fold give the plain
    version's bits; its plan (``i8_step_plan``) covers every weight row
    of every column once, in whole fold groups, and fits every batch at
    dims 1024 and 1280 on 114 and 132 SMs; its scratch
    (``i8_workspace_bytes``) holds every partial;
  * the wrapper at a full tail with an empty stage (``pos == flushed +
    128``), as JAX's kernel takes it, against JAX's reference.

Also holds the mega-eligible tiny LVTR (``tests/test_torch_trunk.py``'s,
widened to dim 256 / ffd 1024 like ``tests/test_lvtr_step_parity.py``'s
``_mega_lvtr_hp``) that ``tests/test_torch_mega_sampler.py`` shares."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_mega_step import D, H, L, _cache, _stack
from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech.sampler import _mega_scan_segments
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.nn.attention import LayerKVCache as JCache
from vae_gslm_tpu.ops import mega_step as jmega
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import mega_scan_segments
from vae_gslm_tpu_torch.models.convert import (load_reference_lvtr,
                                               mega_weights_from_numpy)
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.nn.attention import LayerKVCache
from vae_gslm_tpu_torch.nn.transformer import TransformerLayerStack
from vae_gslm_tpu_torch.ops import mega_step as tmega

CASES = [(0, 0), (0, 5), (0, 40), (128, 140), (256, 300), (256, 384)]
B = 8


def mega_hp_dict(nheads=4):
    d = JHparams.from_yaml(TINY_YAML).to_dict()
    d["transformer"]["layer"]["dim"] = 256
    d["transformer"]["layer"]["ffd_size"] = 1024
    d["transformer"]["layer"]["self_attn"]["nheads"] = nheads
    return d


def mega_lvtr_pair(seed=0, nheads=4):
    """A JAX LVTR that K2 can take once quantized (dim 256, ``nheads``
    heads (4 of 64 by default), ffd 1024, ALiBi, RMSNorm, GELU, no bias)
    and the port's LVTR loaded from its export, both float32 on the
    CPU."""
    d = mega_hp_dict(nheads)
    jm = JLVTR(JHparams.from_dict(d), input_dim=N_MELS, rngs=nnx.Rngs(seed))
    tm = LVTR(Hparams.from_dict(d), input_dim=N_MELS, device="cpu")
    load_reference_lvtr(tm, export_torch_lvtr(jm))
    return jm, tm


def t(x):
    return torch.from_numpy(np.array(x))


def cache_to_torch(cache):
    """A JAX mega cache dict as torch tensors (bf16 stays bf16)."""
    out = {}
    for k, v in cache.items():
        if v.dtype == jnp.bfloat16:
            out[k] = t(v.astype(jnp.float32)).to(torch.bfloat16)
        else:
            out[k] = t(v)
    return out


def assert_cache_equal(tc, jc):
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32),
                                      err_msg=k)


def _inputs():
    m = _stack()
    w = m.build_mega_decode()
    cache = _cache(B, 2)
    x = jnp.asarray(np.random.RandomState(3).randn(B, D) * 0.3, jnp.float32)
    slopes = m.rpe.slopes[...]
    return (x, w, cache, slopes), (t(x), mega_weights_from_numpy(w),
                                   cache_to_torch(cache), t(slopes))


@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("oracle", ["interpret_kernel", "reference"])
def test_plain_matches_jax(flushed, pos, a8, oracle):
    (x, w, cache, slopes), targs = _inputs()
    if oracle == "reference":
        want = jmega.fused_trunk_step_reference(x, w, cache, pos, slopes,
                                                flushed, a8=a8)
    else:
        want = jmega.fused_trunk_step(x, w, cache, jnp.asarray(pos), slopes,
                                      flushed=flushed, interpret=True, a8=a8)
    got = tmega.fused_trunk_step_plain(*targs[:3], pos, targs[3], flushed,
                                       a8=a8)
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        assert g.dtype == (torch.float32 if name == "x" else torch.bfloat16)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_wrapper_takes_plain_version_on_cpu():
    _, (x, w, cache, slopes) = _inputs()
    before = tmega.fused_trunk_step.launches
    got = tmega.fused_trunk_step(x, w, cache, 140, slopes, 128, a8=True)
    want = tmega.fused_trunk_step_plain(x, w, cache, 140, slopes, 128,
                                        a8=True)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), wnt.float().numpy())
    assert tmega.fused_trunk_step.launches == before   # no kernel launch


def test_gelu_rational_matches_jax():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    np.testing.assert_allclose(tmega.gelu_rational(t(x)).numpy(),
                               np.asarray(jmega._gelu_exact(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_quantize_and_build_mega_decode_match_jax():
    jm, tm = mega_lvtr_pair(seed=4)
    jst, tst = jm.transformer, tm.transformer
    assert jst.build_mega_decode() is None and tst.build_mega_decode() is None
    assert not tst.supports_mega_decode()
    x = np.random.RandomState(0).randn(3, 16).astype(np.float32)
    jst.quantize_weights_int8()
    tst.quantize_weights_int8()
    assert tst.supports_mega_decode()
    pairs = [(jst.linear, tst.linear)]
    for jl, tl in zip(jst.layers, tst.layers):
        pairs += [(jl.self_attn.in_proj, tl.self_attn.in_proj),
                  (jl.self_attn.out_proj, tl.self_attn.out_proj),
                  (jl.linear1, tl.linear1), (jl.linear2, tl.linear2)]
    for jd, td in pairs:
        assert td.weight.dtype == torch.int8
        np.testing.assert_array_equal(td.weight.t().numpy(),
                                      np.asarray(jd.kernel[...]))
        np.testing.assert_array_equal(td.weight_scale.t().numpy(),
                                      np.asarray(jd.kernel_scale[...]))
    # the int8 forward upconverts in the compute dtype, as JAX's does
    np.testing.assert_allclose(tst.linear(t(x)).numpy(),
                               np.asarray(jst.linear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    jw, tw = jst.build_mega_decode(), tst.build_mega_decode()
    carried = mega_weights_from_numpy(jw)
    assert sorted(tw) == sorted(jw) == sorted(carried)
    for k in jw:
        assert tw[k].dtype == carried[k].dtype, k
        assert tw[k].is_contiguous(), k
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(carried[k].numpy(), tw[k].numpy())
    # the stacked prefill entries keep the int8 weight and its scale
    js, ts = jst.build_stacked_decode(), tst.build_stacked_decode()
    for name in ("qkv", "out", "ffn1", "ffn2"):
        np.testing.assert_array_equal(ts[name]["w"].numpy(),
                                      np.asarray(js[name]["w"]))
        np.testing.assert_array_equal(ts[name]["scale"].numpy(),
                                      np.asarray(js[name]["scale"]))


def test_stage_merge_flush_roundtrip_matches_jax():
    """The round trip of ``tests/test_mega_step.py``: 2 x 8 staged rows
    merged into the last two tail groups, then a flush into cold block
    1, in both packages."""
    b, dh = 2, D // H
    jc = _cache(b, 2, seed=7)
    tc = cache_to_torch(jc)
    flushed = 128
    rows = jnp.asarray(np.random.RandomState(9).randn(
        2 * jmega.STAGE, L, H, b, dh) * 0.5, jnp.bfloat16)
    trows = t(rows.astype(jnp.float32)).to(torch.bfloat16)
    pos0 = flushed + jmega.TAIL - 2 * jmega.STAGE
    rel0 = pos0 - flushed
    for j in range(2 * jmega.STAGE):
        slot = (rel0 + j) % jmega.STAGE
        jc = jmega.stage_append(jc, rows[j], -rows[j], slot)
        tc = tmega.stage_append(tc, trows[j], -trows[j], slot)
        if slot == jmega.STAGE - 1:
            tail_slot = ((rel0 + j) // jmega.STAGE) * jmega.STAGE
            jc = jmega.merge_stage(jc, tail_slot)
            tc = tmega.merge_stage(tc, tail_slot)
            assert_cache_equal(tc, jc)
    jc = jmega.flush_mega(jc, flushed)
    tc = tmega.flush_mega(tc, flushed)
    assert_cache_equal(tc, jc)


@pytest.mark.parametrize("prompt_len", [21, 136, 151])
def test_mega_cache_from_prefill_matches_jax(prompt_len):
    """Prompt lengths with stage rows only (21 = 16 tail + 5 stage), one
    cold block plus a tail group (136), and one cold block plus tail and
    stage rows (151)."""
    rng = np.random.RandomState(prompt_len)
    shape = (L, 2, H, prompt_len, D // H)
    k, v = (rng.randint(-127, 128, shape).astype(np.int8) for _ in "kv")
    ks, vs = ((rng.rand(*shape[:-1]) * 0.02).astype(np.float32)
              for _ in "kv")
    total = prompt_len + 40
    jc, jf = _stack().mega_cache_from_prefill(
        JCache(*map(jnp.asarray, (k, v, ks, vs))), prompt_len, total)
    tc, tf = TransformerLayerStack.mega_cache_from_prefill(
        LayerKVCache(*map(torch.from_numpy, (k, v, ks, vs))), prompt_len,
        total)
    assert tf == jf == prompt_len // 128 * 128
    assert_cache_equal(tc, jc)


def test_scan_cadence_matches_jax():
    """The merge / flush cadence of the port's Python loop against JAX's
    segmented scan.  A stand-in step appends rows that encode the
    position to the stage and returns, as the next frame, integer sums
    of the int8 tail and cold tiers it was handed; the frame streams are
    equal only if both loops merged and flushed before the same steps.
    From tail slot 123 (a partial group, then a flush at 256) over 150
    steps (merges, a second flush at 384, a partial group at the end)."""
    b, dh = 2, D // H
    jc = _cache(b, 3, seed=11)
    tc = cache_to_torch(jc)
    flushed, pos0, length = 128, 251, 150
    # integer rows with a row maximum of 127 quantize to themselves under
    # any rounding of the scale (XLA may turn x / scale into a reciprocal
    # multiply inside the jitted scan), so only the cadence is tested
    pattern = np.random.RandomState(12).randint(0, 255, (L, H, b, dh))
    jpat, tpat = jnp.asarray(pattern, jnp.int32), t(pattern)
    names = ("k_tail", "v_tail", "k_cold", "v_cold")

    def jstep(frame, cache, pos, flushed, key):
        sums = jnp.stack([cache[n].astype(jnp.int32).sum() for n in names])
        rows = ((jpat + pos) % 255 - 127).at[..., 0].set(127).astype(
            jnp.bfloat16)
        cache = jmega.stage_append(cache, rows, -rows,
                                   jax.lax.rem(pos - flushed, jmega.STAGE))
        return jnp.broadcast_to(sums.astype(jnp.float32), frame.shape), cache

    def tstep(frame, cache, pos, flushed):
        sums = torch.stack([cache[n].sum(dtype=torch.int64) for n in names])
        rows = (tpat + pos) % 255 - 127
        rows[..., 0] = 127
        rows = rows.to(torch.bfloat16)
        cache = tmega.stage_append(cache, rows, -rows,
                                   (pos - flushed) % tmega.STAGE)
        return sums.float().expand(frame.shape), cache

    frame = np.zeros((b, 1, len(names)), np.float32)
    jfr, jlast = _mega_scan_segments(
        None, jnp.asarray(frame), jc, flushed, pos0, length,
        jax.random.split(jax.random.PRNGKey(0), length), jstep)
    tfr, tlast = mega_scan_segments(t(frame), tc, flushed, pos0, length,
                                    tstep)
    # two flushes, at 256 and 384
    assert len(np.unique(np.asarray(jfr)[0, 1:, 2])) == 3
    np.testing.assert_array_equal(tfr.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


# ------------------------------------------- the bf16 step's design
def _kernel_order_sum(xb, w8, ks_n):
    """sum_k xb[k] w8[k, n] in float64 as ``k2_bf16_step_kernel`` adds
    it: chunk c (16 k) goes to warp c % ks_n; one m16n8k16 product adds
    the chunk's 16 products (k = 16 c + 4 t + s for its k index t + 4 s;
    here summed in that order) to the warp's sum; the warps' sums are
    added in warp order.  ``ks_n`` < 0 adds the warps' sums in
    reverse."""
    k = xb.shape[-1]
    prods = xb[..., :, None] * w8                     # (B, K, N), exact
    chunks = prods.reshape(xb.shape[0], k // 16, 4, 4, w8.shape[1])
    chunks = chunks.transpose(0, 1, 3, 2, 4)          # (B, c, s, t, N)
    chunks = chunks.reshape(xb.shape[0], k // 16, 16, w8.shape[1])
    n_warps = abs(ks_n)
    sums = []
    for ks in range(n_warps):
        acc = np.zeros((xb.shape[0], w8.shape[1]))
        for c in range(ks, k // 16, n_warps):
            part = np.zeros_like(acc)
            for i in range(16):
                part = part + chunks[:, c, i]
            acc = acc + part
        sums.append(acc)
    if ks_n < 0:
        sums = sums[::-1]
    total = np.zeros_like(sums[0])
    for part in sums:
        total = total + part
    return total


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("rows", ["random", "wide"])
@pytest.mark.parametrize("ks_n", [4, 16, -4])
def test_bf16_products_sum_exactly_in_any_order(k, rows, ks_n):
    """The bf16 branch's dense product (``_mm`` with ``a8=False``): bf16
    activations x int8 weights summed in float64 and rounded once.  A
    numpy float64 sum in the persistent kernel's order (chunks of 16 k
    over 4 or 16 warps, each chunk's 16 products summed, then added; the
    warps in order or reversed) rounds to the same float32 bits, on
    random rows and on RMS-normed rows whose magnitudes span 2^-24..2^6
    (the exact-sum premise that lets the kernel pick any order)."""
    rng = np.random.RandomState(k + len(rows))
    b, n = 8, 64
    if rows == "random":
        x = rng.randn(b, k).astype(np.float32)
    else:
        mag = np.exp2(rng.uniform(-24, 6, (b, k)))
        x = (np.sign(rng.randn(b, k)) * mag).astype(np.float32)
        x[:, ::97] = 0.0                               # GELU's exact zeros
        x = x / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True))
        x = x.astype(np.float32)
    w8 = rng.randint(-127, 128, (k, n)).astype(np.int8)
    xt = torch.from_numpy(x)
    got = tmega._mm(xt, torch.from_numpy(w8), torch.ones(n), a8=False)
    xb = xt.to(torch.bfloat16).double().numpy()
    want = _kernel_order_sum(xb, w8.astype(np.float64), ks_n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.astype(np.float32).view(np.int32))


def _pass_work(b, k, per_head_h=0):
    """The kernel's split of one pass: for each batch pass, {(batch
    tile, chunk or head): warp} over the 16 warps (``dense_phase``)."""
    nt_all = -(-b // tmega.TILE_ROWS)
    out = []
    for bt0 in range(0, nt_all, tmega.TILES_PER_PASS):
        ntp = min(tmega.TILES_PER_PASS, nt_all - bt0)
        nks = tmega.STEP_WARPS // ntp
        work = {}
        for w in range(tmega.STEP_WARPS):
            ntl, ks = w % ntp, w // ntp
            if ks >= nks:
                continue
            items = (range(ks, per_head_h, nks) if per_head_h else
                     range(ks, k // 16, nks))
            for it in items:
                assert (bt0 + ntl, it) not in work
                work[(bt0 + ntl, it)] = w
        out.append((bt0, ntp, nks, work))
    return out


@pytest.mark.parametrize("b", range(1, 33))
def test_bf16_step_plan_covers_every_column(b):
    """``bf16_step_plan`` (the Python mirror of ``step_plan`` in
    ``csrc/mega_step.cu``) at B = 1..32, flagship dim 1024 / 16 heads and
    the small model's 256 / 4, on an H100's 132 SMs: every product's
    output columns are taken by exactly one block (units of 8 columns:
    block, block + grid, ..), each in its 16-column weight strip; a
    block's strips of any product fit a weight slot; every pass's partial
    sums fit the partial buffer, beside the norm scale; every batch tile
    and every K chunk (or head)
    goes to exactly one warp; the whole
    plan fits the 232,448 bytes a block may use, and the grid is the
    occupancy x the SM count, as the launcher sizes it."""
    n_sm = 132
    for d, h in ((1024, 16), (256, 4)):
        plan = tmega.bf16_step_plan(b, d, h, n_sm)
        assert plan.bytes <= tmega.SMEM_LIMIT
        assert plan.slot % 1024 == 0 and plan.rows >= 4 * b
        assert plan.region >= tmega.STEP_GROUPS * tmega.group_smem(d // h)
        assert tmega.bf16_step_plan(b, d, h, n_sm, occupancy=2).grid == \
            2 * n_sm
        for occ in (1, 2):
            grid = occ * n_sm
            for pi, (n, k) in enumerate(tmega.step_products(d)):
                seen = []
                for blk in range(grid):
                    units = tmega.step_units(n, grid, blk)
                    assert len(units) * tmega.STRIP_COLS * k <= plan.slot
                    for j0 in range(0, len(units), tmega.UNITS_PER_PASS):
                        up = min(tmega.UNITS_PER_PASS, len(units) - j0)
                        cols = up * tmega.UNIT_COLS
                        for bt0, ntp, nks, work in _pass_work(
                                b, k, h if pi == 1 else 0):
                            bw = tmega.TILE_ROWS * ntp
                            need = (h * bw * cols * 4 if pi == 1 else
                                    nks * bw * cols * 8)
                            assert need <= plan.part
                            assert plan.part + 4 * d <= plan.region
                            want = {(bt0 + t, it) for t in range(ntp)
                                    for it in range(h if pi == 1
                                                    else k // 16)}
                            assert set(work) == want
                    seen += [u * tmega.UNIT_COLS + c for u in units
                             for c in range(tmega.UNIT_COLS)]
                assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("b, d, n_sm, slot, fits", [
    (32, 1024, 132, 65536, True),      # the flagship on an H100 SXM
    (1, 1024, 132, 65536, True),
    (32, 768, 114, 49152, True),
    (32, 1280, 132, 163840, False),    # FFN down: 2 units x 16 x 5120
    (32, 2048, 132, 262144, False),
    (32, 1024, 114, 131072, False),    # the flagship on an H100 PCIe
    (1, 1024, 114, 131072, False)])
def test_bf16_step_fits_at_the_plan_limits(b, d, n_sm, slot, fits):
    """``bf16_step_fits`` past the plan's limits: a weight slot holds the
    most units (8 columns over all K) that a block takes of one product,
    so wider dims or fewer SMs outgrow the 232,448 bytes a block may use
    (the sampler then routes such batches to the hybrid path), and the
    wrapper refuses such a call before it reaches the card."""
    h = d // 64
    plan = tmega.bf16_step_plan(b, d, h, n_sm)
    assert plan.slot == slot
    assert tmega.bf16_step_fits(b, d, h, n_sm) is fits
    assert (plan.bytes <= tmega.SMEM_LIMIT) is fits


@pytest.mark.parametrize("d, h", [(256, 4), (1024, 16), (2048, 32)])
@pytest.mark.parametrize("group", [0, 64, 128])
def test_workspace_holds_every_partial(d, h, group):
    """``i8_workspace_bytes`` against what the a8 (``group`` 0) and w4
    persistent step (``fused_trunk_step_i8_launch`` in
    ``csrc/mega_step.cu``) carves from it, derived here from the products
    and their tiles: the barrier's word; a8's int32 sums, one per row and
    output column of its widest one-dot product (FFN up's 4D); every
    partial a grouped product writes (one float32 term per fold group,
    row and output column: the out-projection's heads, w4's groups, over
    the tiles of each product) and the largest of those; the int8 rows
    (B, 4D); two arrays of per-row activation scales, each as wide as the
    most scales a row takes (heads, or FFN down's groups).  The dense
    partial sums of a tile never leave shared memory otherwise."""
    b = 32
    acc = 0 if group else 4 * d
    terms = 0
    for p in range(4):
        n, k, gsz = tmega.i8_geom(p, d, group, d // h)
        if not gsz:
            continue
        plan = tmega.i8_step_plan(b, d, h, 132, group)
        groups = set()
        for col, row, rows in tmega.i8_tiles(p, d, group, d // h,
                                             plan.splits[p]):
            halves = (0, k // 2) if group else (0,)
            for off in halves:
                groups.update(range((off + row) // gsz,
                                    (off + row + rows) // gsz))
        assert groups == set(range(k // gsz))
        terms = max(terms, len(groups) * n)
    n_scales = max(h, 4 * d // group if group else 1)
    need = (16 + 4 * b * acc + 4 * b * terms + b * 4 * d
            + 2 * 4 * b * n_scales)
    assert tmega.i8_workspace_bytes(b, d, h, group) >= need


def _tile_cover(p, d, group, plan, n_sm, dh=64):
    """Each stored row of each output column of product ``p``, and the
    tiles and pieces each block takes, as ``i8_issue`` walks them."""
    n, k, gsz = tmega.i8_geom(p, d, group, dh)
    kst = k // 2 if group else k
    tiles = tmega.i8_tiles(p, d, group, dh, plan.splits[p])
    cover = np.zeros((kst, n), np.int32)
    for col, row, rows in tiles:
        assert rows % tmega.I8_CHUNK == 0
        if gsz:                       # whole fold groups in every tile
            assert row % gsz == 0 and rows % gsz == 0
        cover[row:row + rows, col:col + tmega.I8_TILE] += 1
        assert tmega.i8_tile_bytes(p, d, group, dh, plan.bp,
                                   rows) <= plan.region
    for blk in range(n_sm):
        mine = tiles[blk::n_sm]
        for i in range(0, len(mine), plan.tp[p]):
            piece = mine[i:i + plan.tp[p]]
            assert sum(r for _, _, r in piece) * tmega.I8_TILE <= plan.slot
    return cover


@pytest.mark.parametrize("b", [1, 2, 8, 9, 17, 24, 32])
@pytest.mark.parametrize("group", [0, 64, 128])
def test_i8_step_plan_covers_every_column(b, group):
    """``i8_step_plan`` (the Python mirror of ``i8_plan`` in
    ``csrc/mega_step.cu``) for the a8 (``group`` 0) and w4 steps at the
    flagship's dim 1024 / 16 heads and dims 1280 and 2560, on an H100 SXM's
    132 SMs and a PCIe card's 114: every stored weight row of every output
    column lies in exactly one tile; each tile holds whole fold groups and
    whole 32-row chunks, and its int8 rows and scratch fit the region; a
    block's piece of tiles fits a weight slot; the whole plan fits the
    232,448 bytes a block may use."""
    for d in (1024, 1280, 2560):
        if group and d % (2 * group):
            continue
        for n_sm in (114, 132):
            plan = tmega.i8_step_plan(b, d, d // 64, n_sm, group)
            assert plan.bytes <= tmega.SMEM_LIMIT
            assert plan.slot % 1024 == 0 and plan.bp % 8 == 0 >= b - plan.bp
            assert plan.region >= tmega.STEP_GROUPS * tmega.group_smem(64)
            assert plan.region >= 20 * d + 4 * plan.nxs + 64
            for p in range(4):
                cover = _tile_cover(p, d, group, plan, n_sm)
                assert (cover == 1).all(), (d, n_sm, p)


@pytest.mark.parametrize("d", [1024, 1280])
@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("group", [0, 64, 128])
def test_i8_step_fits_at_the_plan_limits(d, n_sm, group):
    """The a8 and w4 steps take every batch up to the mega cap (32) at dim
    1024 and 1280 on 114 and 132 SMs: their tiles cut K as well as the
    columns, so a block's share shrinks with the card (where the bf16
    step's plan outgrows a block at dim 1280 on 132 SMs or dim 1024 on
    114), and the sampler never needs another route for them.  Even a
    one-SM card takes them: a block's tiles then stream through the two
    slots in pieces."""
    for b in range(1, 33):
        plan = tmega.i8_step_plan(b, d, d // 64, n_sm, group)
        assert plan.bytes <= tmega.SMEM_LIMIT
    plan = tmega.i8_step_plan(8, d, d // 64, 1, group)
    assert plan.bytes <= tmega.SMEM_LIMIT and max(plan.tp) >= 1


@pytest.mark.parametrize("n_sm", [1, 16, 114, 132])
def test_i8_rows_phase_takes_every_row(n_sm):
    """A rows phase of the a8/w4 step (``i8_rows``) finalizes, normalizes
    and quantizes each batch row in exactly one block, also where the grid
    has fewer blocks than rows (one SM, or an H100 slice of 16 SMs at the
    CLI's B = 32 chunks): block j takes rows j, j + G, ..."""
    for b in range(1, 33):
        taken = [r for blk in range(n_sm)
                 for r in tmega.i8_row_blocks(b, n_sm, blk)]
        assert sorted(taken) == list(range(b))


def _chunked_dot(x8, w8, rng, chunk=32):
    """sum_k x8[b, k] w8[k, n] as the kernel adds it: int32 partials of
    chunks of 32 k, taken in a shuffled order (warps, tiles and atomics
    add them in any order); every partial sum stays inside int32."""
    k = x8.shape[1]
    order = rng.permutation(k // chunk)
    acc = np.zeros((x8.shape[0], w8.shape[1]), np.int64)
    for c in order:
        sl = slice(c * chunk, (c + 1) * chunk)
        acc += x8[:, sl] @ w8[sl]
        assert np.abs(acc).max() < 2 ** 31
    return acc


def _emulated_mm(rng):
    """``_mm`` (a8) and ``_mm_w4`` as the a8/w4 step computes them: int32
    dots from shuffled chunks, then a8's float(dot) * (xs * s), or w4's
    terms float(dot_g) * (xs_g * g_g) added in group order from 0.0."""
    def mm(x, w8, scales, a8):
        assert a8
        x8, xs = tmega._quant_rows(x, 1e-8)
        dot = _chunked_dot(x8.numpy().astype(np.int64),
                           w8.numpy().astype(np.int64), rng)
        return torch.from_numpy(dot.astype(np.float32)) * (xs * scales)

    def mm_w4(x, wp, gscale):
        w8 = tmega.unpack_w4(wp).numpy().astype(np.int64)
        b, ng = x.shape[0], gscale.shape[0]
        gsz = w8.shape[0] // ng
        x8, xs = tmega._quant_rows(x.reshape(b, ng, gsz), 1e-8)
        x8 = x8.numpy().astype(np.int64)
        y = torch.zeros((b, w8.shape[1]))
        for gi in range(ng):
            dot = _chunked_dot(x8[:, gi], w8[gi * gsz:(gi + 1) * gsz], rng)
            y = y + (torch.from_numpy(dot.astype(np.float32))
                     * (xs[:, gi] * gscale[gi]))
        return y
    return mm, mm_w4


@pytest.mark.parametrize("kind", ["a8", "w4_64", "w4_128"])
def test_i8_split_sums_equal_the_plain_version(monkeypatch, kind):
    """The a8/w4 step's premise: its int32 partials (chunks of 32 inputs,
    summed in any order by warps, tiles and atomics) and its float32 fold
    of the group terms in group order give the plain version's bits.  The
    whole plain step with its dense products replaced by that emulation
    (shuffled chunk orders from a seed) equals the plain step bitwise, for
    a8 and for w4 at groups 64 and 128, at a cache state with cold, tail
    and stage rows."""
    from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4

    _, (x, w, cache, slopes) = _inputs()
    a8 = kind == "a8"
    if not a8:
        w = pack_mega_w4(w, int(kind.split("_")[1]), D // H)
    want = tmega.fused_trunk_step_plain(x, w, cache, 300, slopes, 256, a8=a8)
    mm, mm_w4 = _emulated_mm(np.random.RandomState(len(kind)))
    monkeypatch.setattr(tmega, "_mm", mm)
    monkeypatch.setattr(tmega, "_mm_w4", mm_w4)
    got = tmega.fused_trunk_step_plain(x, w, cache, 300, slopes, 256, a8=a8)
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        np.testing.assert_array_equal(g.float().numpy().view(np.int32),
                                      wnt.float().numpy().view(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("branch", ["a8", "bf16", "w4"])
def test_wrapper_takes_a_full_tail_as_jax(branch):
    """``pos == flushed + 128``: a full int8 tail and an empty stage, a
    state JAX's kernel takes (its tail mask is ``t < stage_base``, its
    stage mask ``j < pos``; ``tests/test_mega_step.py`` holds it at
    flushed 256).  The wrapper takes it on every branch; on the CPU its
    plain route agrees with ``fused_trunk_step_reference`` within the JAX
    test's band."""
    (jx, jw, jcache, jslopes), (x, w, cache, slopes) = _inputs()
    a8 = branch == "a8"
    if branch == "w4":
        jw = _stack().build_mega_decode_w4(group=128)
        w = mega_weights_from_numpy(jw)
    flushed, pos = 256, 256 + tmega.TAIL      # tests/test_mega_step.py's
    want = jmega.fused_trunk_step_reference(jx, jw, jcache, pos, jslopes,
                                            flushed, a8=a8)
    got = tmega.fused_trunk_step(x, w, cache, pos, slopes, flushed, a8=a8)
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), rtol=2e-3,
                                   atol=2e-4, err_msg=name)
