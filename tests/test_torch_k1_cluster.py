"""K1's cluster design (``csrc/fused_decode.cu``): its plan on the CPU,
and on a card the kernel against its plain version at the cache states
the cluster makes likely to break.  Torch only (no JAX), so the card's
machine runs it as it is.

CPU: for 0 to 40 cold blocks every position block is owned by exactly
one CTA of a cluster of at most 8, each CTA's blocks fit its plan's
shared memory, every plane is requested up front whenever the planes
fit, and CTA 0 merges the blocks in the reference's order (cold blocks
0 .. nblk - 1, then the tail).  Card (``cuda``): an empty cold cache,
``pos == flushed``, more cold blocks than a portable cluster has CTAs,
B = 1 and 32, every head_dim the wrapper admits, float32 and bfloat16
q, at rtol 1e-3 / atol 1e-4; one launch a call; and the output
independent of the cluster's schedule (two calls, the same bits)."""
import math

import pytest
import torch

from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import fused_decode as fd


@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k1_plan_owns_every_block(d):
    for nblk in range(41):
        plan = fd.k1_plan(d, nblk)
        assert 1 <= plan.cluster <= fd.MAX_CLUSTER
        assert plan.cluster == min(nblk + 1, 8)
        assert plan.smem <= fd.SMEM_LIMIT and plan.slots >= 1
        owners = [fd.k1_owner(j, plan.cluster) for j in range(nblk + 1)]
        assert len(set(owners)) == nblk + 1          # each block once
        assert all(0 <= r < plan.cluster and 0 <= o < plan.owned
                   for r, o in owners)
        assert {r for r, _ in owners} == set(range(plan.cluster))
        per_cta = [sum(r == c for r, _ in owners)
                   for c in range(plan.cluster)]
        assert max(per_cta) == plan.owned
        # all K and V planes requested before the first product when
        # they fit (the flagship's head_dim 64 at up to 48 blocks)
        fixed = 352 + 5 * d + 256 + plan.owned * (1024 + 4 * d)
        if plan.owned == 1:                    # CTA 0's receive buffers
            fixed += nblk * (1024 + 4 * d)
        slot = 256 * d + 1024
        if fixed + 2 * plan.owned * slot <= fd.SMEM_LIMIT:
            assert plan.slots == min(2 * plan.owned, fd.MAX_SLOTS)
        assert plan.smem == fixed + plan.slots * slot


def test_k1_merge_order_is_the_reference_order():
    """CTA 0 adds the blocks' terms (and sums their e into l) in block
    order, cold blocks from 0 and the tail last, as
    ``fused_decode_attention_plain`` adds them after ``e_self * v_new``;
    each comes from the CTA that owns it."""
    for nblk in range(41):
        plan = fd.k1_plan(64, nblk)
        order = fd.k1_merge_order(nblk)
        assert order == list(range(nblk)) + [nblk]
        assert [fd.k1_owner(j, plan.cluster) for j in order] == [
            (j % plan.cluster, j // plan.cluster) for j in range(nblk + 1)]


def test_k1_plan_covers_the_rollout():
    """The rollout's cache states (150 -> 650 positions: 0 to 2 cold
    blocks) at the flagship head_dim: clusters of 1 to 3 CTAs, one
    block each, every plane in flight at once."""
    for pos in range(151, 651):
        nblk = pos // 256
        plan = fd.k1_plan(64, nblk)
        assert (plan.cluster, plan.owned, plan.slots) == (nblk + 1, 1, 2)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1's CUDA kernel needs an NVIDIA GPU (sm_90a)")
    return torch.device("cuda")


def _inputs(dev, b, h, d, nb, dtype, seed=0, layers=2):
    g = torch.Generator(dev).manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02

    cache = (i8(layers, nb, b, h, d, 256), i8(layers, nb, b, h, d, 256),
             sc(layers, nb, b, h, 256), sc(layers, nb, b, h, 256),
             i8(layers, b, h, 256, d), i8(layers, b, h, 256, d),
             sc(layers, b, h, 256), sc(layers, b, h, 256))
    qkv = torch.randn((b, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = qkv.view(b, 3, h, d).unbind(1)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    return cache, q, k, v, slopes


# (b, h, d, cold capacity, flushed, pos)
CARD_CASES = {
    "empty_cold_pos0": (8, 16, 64, 1, 0, 0),
    "empty_cold": (8, 16, 64, 3, 0, 151),
    "pos_eq_flushed": (8, 16, 64, 3, 256, 256),
    "pos_eq_flushed_2": (8, 16, 64, 3, 512, 512),
    "rollout_2_blocks": (8, 16, 64, 3, 512, 650),
    "b1": (1, 16, 64, 3, 256, 400),
    "b32": (32, 16, 64, 3, 512, 600),
    "nine_blocks": (2, 4, 64, 12, 9 * 256, 9 * 256 + 77),
    "forty_blocks": (2, 4, 64, 41, 40 * 256, 40 * 256 + 255),
    "d16": (4, 4, 16, 12, 10 * 256, 10 * 256 + 3),
    "d32": (4, 4, 32, 3, 512, 700),
    "d128": (4, 4, 128, 10, 9 * 256, 9 * 256 + 100),
    "d256": (4, 2, 256, 3, 512, 600),
    "d256_ring": (2, 2, 256, 12, 11 * 256, 11 * 256 + 9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_k1_cluster_matches_plain(cuda_device, case, dtype):
    """rtol 1e-3 / atol 1e-4 (the exp and the sums of the plain version
    run in another order, which can flip one requantized probability);
    one launch a call; a second call gives the same bits."""
    b, h, d, nb, flushed, pos = CARD_CASES[case]
    cache, q, k, v, slopes = _inputs(cuda_device, b, h, d, nb, dtype,
                                     seed=pos)
    plan = fd.k1_plan(d, flushed // 256)
    for li in (0, 1):
        before = fd.fused_decode_attention.launches
        got = fd.fused_decode_attention(q, *cache, pos, li, slopes, k, v,
                                        flushed)
        again = fd.fused_decode_attention(q, *cache, pos, li, slopes, k, v,
                                          flushed)
        want = fd.fused_decode_attention_plain(q, *cache, pos, li, slopes,
                                               k, v, flushed)
        torch.cuda.synchronize()
        assert fd.fused_decode_attention.launches == before + 2
        assert torch.equal(got, again)
        assert math.isfinite(got.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4,
                                   msg=f"{case} {plan}")
