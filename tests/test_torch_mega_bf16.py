"""K2 on int8 weights on a card: the persistent kernels (one cooperative
launch a step: ``k2_bf16_step_kernel`` for the bf16 branch,
``k2_i8_step_kernel`` for the s8 x s8 branch) against their plain
version.

Imports only torch, numpy and the port, so that it runs on a machine
with a card and no JAX model stack.  Inputs are made here from a seed: a
two-layer trunk of dim 256 (4 heads of 64; 8 of 32 and 2 of 128 for the
other head widths) with int8 weights and column scales, a random
three-tier cache, at the ``(flushed, pos)`` cases of
``tests/test_torch_mega_step.py`` (``CASES``), the last a full tail with
an empty stage.  The designs' premises and the kernels' shared-memory
plans are held on the CPU there; these cases skip without a card."""
import math

import numpy as np
import pytest
import torch

from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import mega_step as tmega

# tests/test_torch_mega_step.py's (flushed, pos) cases: (256, 384) is a
# full tail with an empty stage, which JAX's kernel takes
CASES = [(0, 0), (0, 5), (0, 40), (128, 140), (256, 300), (256, 384)]
D, H, L, NB = 256, 4, 2, 2


def _inputs(b, dev, seed=0, d=D, nl=L, h=None):
    """x, int8 weights with column scales, a three-tier cache of NB cold
    blocks, ALiBi slopes: numpy draws from ``seed``, moved to ``dev``; a
    trunk of ``nl`` layers of dim ``d`` and ``h`` heads (heads of 64 by
    default)."""
    rng = np.random.RandomState(seed)
    D, L, H = d, nl, h or d // 64
    dh = D // H

    def i8(*shape):
        return torch.from_numpy(
            rng.randint(-127, 128, shape).astype(np.int8))

    def u(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy((lo + (hi - lo) * rng.rand(*shape))
                                .astype(np.float32))

    w = {}
    for name, s, din, dout in (
            ("wq", "sq", D, 3 * D), ("wo", "so", D, D),
            ("w1", "s1", D, 4 * D), ("w2", "s2", 4 * D, D)):
        w[name] = i8(L, din, dout)
        w[s] = u(L, dout, lo=0.5, hi=1.0) / (127 * math.sqrt(din))
    w["n1"], w["n3"] = u(L, D, lo=0.8, hi=1.2), u(L, D, lo=0.8, hi=1.2)
    for name, n in (("bq", 3 * D), ("bo", D), ("b1", 4 * D), ("b2", D)):
        w[name] = u(L, n, lo=-0.1, hi=0.1)
    blk, tail, stage = tmega.BLK, tmega.TAIL, tmega.STAGE
    cache = {
        "k_cold": i8(L, NB, H, b, dh, blk),
        "v_cold": i8(L, NB, H, b, dh, blk),
        "kc_scale": u(L, NB, H, b, blk, hi=0.02),
        "vc_scale": u(L, NB, H, b, blk, hi=0.02),
        "k_tail": i8(L, H, b, tail, dh), "v_tail": i8(L, H, b, tail, dh),
        "kt_scale": u(L, H, b, tail, hi=0.02),
        "vt_scale": u(L, H, b, tail, hi=0.02),
        "k_stage": (torch.from_numpy(rng.randn(L, stage, H, b, dh)) * 0.3
                    ).to(torch.bfloat16),
        "v_stage": (torch.from_numpy(rng.randn(L, stage, H, b, dh)) * 0.3
                    ).to(torch.bfloat16),
    }
    x = torch.from_numpy(rng.randn(b, D).astype(np.float32))
    slopes = -torch.tensor(alibi_slopes(H))
    return (x.to(dev), {k: v.to(dev) for k, v in w.items()},
            {k: v.to(dev) for k, v in cache.items()}, slopes.to(dev))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("b", [1, 9, 17, 32])
def test_cuda_bf16_step_matches_plain(cuda_device, flushed, pos, b):
    """The persistent kernel (one launch, counted under
    ``launches_bf16``) against its plain version at B 1, 9, 17 (a ragged
    last batch tile) and 32, rtol 2e-3 / atol 2e-4 as the a8 test."""
    x, w, cache, slopes = _inputs(b, cuda_device, seed=b)
    args = (x, w, cache, pos, slopes, flushed)
    before = tmega.fused_trunk_step.launches_bf16
    got = tmega.fused_trunk_step(*args, a8=False)
    want = tmega.fused_trunk_step_plain(*args, a8=False)
    torch.cuda.synchronize()
    assert tmega.fused_trunk_step.launches_bf16 == before + 1
    _hold(got, want)


def _hold(got, want):
    """K2's band against the plain version: rtol 2e-3 / atol 2e-4."""
    for name, g, wnt in zip(("x", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   wnt.float().cpu().numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("a8", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, flushed, pos, a8):
    """B = 8, the serving default's batch, with and without the s8 x s8
    products: the kernel and its plain version round the same exact int32
    or float64 sums; the band is the JAX test's.  Each call is one launch,
    counted under its branch."""
    x, w, cache, slopes = _inputs(8, cuda_device, seed=3)
    args = (x, w, cache, pos, slopes, flushed)
    k2 = tmega.fused_trunk_step
    before = (k2.launches, k2.launches_bf16)
    got = k2(*args, a8=a8)
    want = tmega.fused_trunk_step_plain(*args, a8=a8)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_bf16) == (before[0] + a8,
                                               before[1] + (not a8))
    _hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 9, 17, 32])
def test_cuda_a8_step_matches_plain_at_any_batch(cuda_device, b):
    """The s8 x s8 branch (``mega_a8=True`` forces it at any B up to the
    mega cap) at ragged and full batch tiles of 8 rows, at a cold block,
    tail and stage rows and at a full tail."""
    x, w, cache, slopes = _inputs(b, cuda_device, seed=b)
    for flushed, pos in ((128, 140), (256, 384)):
        args = (x, w, cache, pos, slopes, flushed)
        got = tmega.fused_trunk_step(*args, a8=True)
        want = tmega.fused_trunk_step_plain(*args, a8=True)
        torch.cuda.synchronize()
        _hold(got, want)


def one_launch(call, kernel: str):
    """A profiler window around one call records one launch of ``kernel``
    and no other kernel, beside the memset that zeroes its scratch words
    (a window that records nothing is taken again: torch.profiler windows
    on the H100 have lost launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Memset")}
        if kernels:
            break
    assert len(kernels) == 1, kernels
    (name, count), = kernels.items()
    assert kernel in name and count == 1


@pytest.mark.cuda
def test_cuda_a8_step_is_one_launch(cuda_device):
    x, w, cache, slopes = _inputs(8, cuda_device)
    one_launch(lambda: tmega.fused_trunk_step(x, w, cache, 300, slopes, 256,
                                              a8=True), "k2_i8_step_kernel")


@pytest.mark.cuda
def test_cuda_bf16_step_is_one_launch(cuda_device):
    """A bf16 call is one kernel on the card (``one_launch``)."""
    x, w, cache, slopes = _inputs(12, cuda_device)
    one_launch(lambda: tmega.fused_trunk_step(x, w, cache, 300, slopes, 256,
                                              a8=False),
               "k2_bf16_step_kernel")


# (heads, B, a8) at dim 256: head widths 32 and 128, the a8 branch at B 1,
# 2 and 8 (the serving default's batches) and the bf16 branch at B 17 and
# 32 (the CLI's chunks)
WIDTH_CASES = [(h, b, b <= 8) for h in (8, 2) for b in (1, 2, 8, 17, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("h,b,a8", WIDTH_CASES)
def test_cuda_step_matches_plain_at_head_widths(cuda_device, flushed, pos,
                                                h, b, a8):
    """K2's instantiations at head widths 32 (8 heads) and 128 (2 heads;
    one K/V buffer an attention group) against the plain version, one
    launch a call under its branch's count; the band is the JAX test's."""
    x, w, cache, slopes = _inputs(b, cuda_device, seed=b + h, h=h)
    args = (x, w, cache, pos, slopes, flushed)
    k2 = tmega.fused_trunk_step
    before = (k2.launches, k2.launches_bf16)
    got = k2(*args, a8=a8)
    want = tmega.fused_trunk_step_plain(*args, a8=a8)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_bf16) == (before[0] + a8,
                                               before[1] + (not a8))
    _hold(got, want)
