"""The float32 flash forward (K3, K4 and K5 in float32: ``fwd_f32`` in
``csrc/flash_attention.cu``): its launch plan on the CPU, and on a card
the kernel against its plain version at the shapes the one-pass design
makes likely to break.  Torch only (no JAX), so the card's machine runs
it as it is.

CPU: the plan fits an H100 block's 232,448 bytes at every launch of the
scoring, training and Tk 8192 calls; every (query tile, head, batch) is
one block and the longest causal walks go first; each walk covers every
key that can hold a probability; the online softmax of the design
(64-key tiles, ex2 of (x - m) log2 e, O rescaled as the max grows, one
division by l) agrees with the two-pass plain version at Tk 8192 to the
card gate's 1e-5 x max(1, max|ref|).  Card (``cuda``): Tq below one
query tile, Tq not a multiple of it, Tk 8192, lengths 0 and 1, causal
and not, ALiBi and not, K3/K4's lse; one launch a call."""
import math

import numpy as np
import pytest
import torch

from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa

H, D = 16, 64
# (b, h, tq, tk, causal): the scoring path's short batch (K3) and long
# batches (K5), the training call (K3/K4, 15 heads for K4), the long
# segment step (K5) and the envelope's longest key walk
CALLS = [(64, H, 973, 973, True), (64, H, 1750, 1750, True),
         (8, H, 640, 640, True), (8, 15, 640, 640, True),
         (2, H, 1536, 1536, True), (3, H, 96, 8192, False),
         (1, 2, 8192, 8192, True)]


@pytest.mark.parametrize("b,h,tq,tk,causal", CALLS)
def test_f32_plan_holds_every_launch(b, h, tq, tk, causal):
    """The plan fits the block limit and is the kernel's sum; the grid's
    blocks cover every (query tile, head, batch row) once and the tiles
    every query row once; in launch order (x fastest) the causal walks of
    full-length rows never grow."""
    plan = fa.f32_fwd_plan(64)
    assert plan.bytes <= fa.SMEM_LIMIT
    assert plan.bytes == 4 * (2 * 128 * 68 + 2 * 64 * 68 + 2 * 64 * 64)
    assert (plan.q_tile, plan.k_tile, plan.stages) == (128, 64, 2)
    gx, gy, gz = fa.f32_fwd_grid(b, h, tq, 64)
    assert gz * plan.q_tile >= tq > (gz - 1) * plan.q_tile
    order = [fa.f32_block_tile(x, y, z, gz) for z in range(gz)
             for y in range(gy) for x in range(gx)]
    assert len(set(order)) == len(order) == gz * h * b
    assert set(order) == {(qt, hh, bb) for qt in range(gz)
                          for hh in range(h) for bb in range(b)}
    rows = [r for qt in range(gz) for r in fa.f32_tile_rows(qt, tq, 64)]
    assert rows == list(range(tq))          # each query row in one tile
    walks = [fa.f32_key_tiles(qt, tq, tk, tk, causal, 64)
             for qt, _, _ in order]
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("tq,tk,causal", [(200, 200, True), (37, 300, True),
                                          (300, 37, True), (130, 257, False),
                                          (256, 256, True)])
def test_f32_key_tiles_cover_every_probability(tq, tk, causal):
    """Every key a row of the query tile can weigh (below its length,
    at or before it when causal; every key for a row of length 0) lies in
    the tiles the walk takes."""
    for length in (0, 1, 63, 64, 65, tk // 2, tk):
        for qt in range(-(-tq // 128)):
            n = fa.f32_key_tiles(qt, tq, length, tk, causal, 64)
            last = -1
            rows = fa.f32_tile_rows(qt, tq, 64)
            assert rows[-1] == tq - 1 - 128 * (-(-tq // 128) - 1 - qt)
            for r in rows:
                if length < 1:
                    last = tk - 1
                else:
                    top = min(length, tk) - 1
                    last = max(last, min(top, r) if causal else top)
            assert n == last // 64 + 1, (qt, length)


def test_fwd_args_by_dtype():
    """K3/K4/K5 launches take ``_plan_args`` in bf16 and the float32
    body's plan in float32."""
    plan = fa.f32_fwd_plan(64)
    q = torch.zeros(1, 640, 128)
    assert fa._fwd_args(q, 640, 64) == (plan.bytes, plan.q_tile, plan.stages)
    qb = q.to(torch.bfloat16)
    assert fa._fwd_args(qb, 640, 64) == fa._plan_args(qb, 640, 64)


def test_f32_forward_rejects_misaligned_views():
    """The float32 forward reads rows 16 bytes at a time: a view one
    float off a 16-byte boundary raises before any launch."""
    base = torch.zeros(1 + 2 * 70 * 3 * 128)[1:].view(2, 70, 3 * 128)
    q = base[..., :128].view(2, 70, 2, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        fa._strides("q", q, q.shape, q.dtype, q.device, aligned=True)
    fa._strides("q", q, q.shape, q.dtype, q.device)   # default: no rule


def _online(q, k, v, lengths, slopes, causal):
    """The one-pass body's arithmetic in float32 torch on (B, H, Tq, D)
    operands: 64-key tiles, m and l online, p = 2^((x - m) log2 e), O
    rescaled by 2^((m_old - m_new) log2 e) when the max grows, one
    division by l."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    s_all, _ = fa._logits(q, k, lengths, slopes, causal)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros((b, h, tq, 1))
    acc = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, 64):
        s = s_all[..., k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((s - m_new) * log2e)
        acc = acc * alpha + p @ v[:, :, k0:k0 + 64]
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return acc / l


@pytest.mark.parametrize("causal", [True, False])
def test_online_softmax_holds_the_gate_at_8192_keys(causal):
    """The online form against the plain version (normalised p before
    P.V) over 8192 keys, ALiBi on, lengths 8192, 0 and 1: within the
    card's gate, 1e-5 x max(1, max|ref|)."""
    rng = np.random.RandomState(5)
    b, h, tq, tk = 3, 1, 40, 8192
    q = torch.from_numpy(rng.randn(b, h, tq, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, h, tk, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, h, tk, D).astype(np.float32))
    lengths = torch.tensor([tk, 0, 1], dtype=torch.int32)
    slopes = -torch.tensor(alibi_slopes(8)[-1:])
    for sl in (slopes, None):
        got = _online(q, k, v, lengths, sl, causal)
        want = fa.flash_forward_tiled_plain(q, k, v, lengths, sl, causal)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the float32 flash forward needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bhtd(dev, b, tq, tk, h, seed):
    g = torch.Generator(dev).manual_seed(seed)
    xq = torch.randn((b, tq, h * D), generator=g, device=dev)
    xkv = torch.randn((b, tk, 2 * h * D), generator=g, device=dev)
    q = xq.view(b, tq, h, D).transpose(1, 2)
    k, v = (x.view(b, tk, h, D).transpose(1, 2) for x in xkv.chunk(2, -1))
    return q, k, v


def _hold(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


# (kernel, b, tq, tk, causal, lengths)
CARD_CASES = {
    "k5_tq_below_tile": ("k5", 3, 37, 300, True, [300, 0, 1]),
    "k5_tq_below_tile_cross": ("k5", 3, 37, 300, False, [300, 0, 1]),
    "k5_ragged_tq": ("k5", 3, 200, 200, True, [200, 1, 0]),
    "k5_ragged_1100": ("k5", 2, 1100, 1100, True, [1100, 1]),
    "k5_tk_8192_cross": ("k5", 3, 96, 8192, False, [8192, 0, 1]),
    "k5_tk_8192": ("k5", 1, 8192, 8192, True, [8192]),
    "k4_ragged": ("k4", 3, 300, 300, True, [300, 1, 0]),
    "k4_short": ("k4", 2, 5, 5, True, [5, 1]),
    "k3_ragged": ("k3", 3, 200, 200, True, [200, 0, 1]),
    "k3_1000": ("k3", 2, 1000, 1000, True, [1000, 1]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("alibi", [True, False])
def test_cuda_f32_forward_matches_plain(cuda_device, case, alibi):
    """The one-pass float32 body against the plain version at 1e-5 x
    max(1, max|ref|) (o, and lse for K3/K4), one launch a call."""
    kind, b, tq, tk, causal, lens = CARD_CASES[case]
    h = 2 if kind == "k3" or tq * tk > 4e6 else 3   # K3: a packed grouping
    dev = cuda_device
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev) if alibi else None
    if kind == "k3":
        g = torch.Generator(dev).manual_seed(tq)
        qkv = torch.randn((b, tq, 3 * h * D), generator=g, device=dev)
        q, k, v = qkv.chunk(3, dim=-1)
        before = fa.flash_forward_packed.launches
        o, lse = fa.flash_forward_packed(q, k, v, lengths, slopes, True, h)
        o_ref, lse_ref = fa.flash_forward_packed_plain(q, k, v, lengths,
                                                       slopes, True, h)
        torch.cuda.synchronize()
        assert fa.flash_forward_packed.launches == before + 1
        _hold(o, o_ref)
        _hold(lse, lse_ref)
        return
    q, k, v = _bhtd(dev, b, tq, tk, h, seed=tq + tk)
    if kind == "k4":
        before = fa.flash_forward_full.launches
        o, lse = fa.flash_forward_full(q, k, v, lengths, slopes, causal,
                                       with_stats=True)
        o_ref, lse_ref = fa.flash_forward_full_plain(q, k, v, lengths, slopes,
                                                     causal, with_stats=True)
        torch.cuda.synchronize()
        assert fa.flash_forward_full.launches == before + 1
        _hold(lse, lse_ref)
    else:
        before = fa.flash_forward_tiled.launches
        o = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
        o_ref = torch.cat([fa.flash_forward_tiled_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths[i:i + 1], slopes,
            causal) for i in range(b)])
        torch.cuda.synchronize()
        assert fa.flash_forward_tiled.launches == before + 1
    _hold(o, o_ref)
