"""K2-w4 on a card: the persistent kernel (``k2_i8_step_kernel`` on
nibble-packed int4 weights, one cooperative launch a step) against its
plain version, and the a8/w4 kernel at wide dims.

Imports only torch, numpy and the port, so that it runs on a machine with
a card and no JAX model stack.  The weights are
``tests/test_torch_mega_bf16.py``'s int8 trunk (dim 256, 4 heads of 64)
packed by the port's ``pack_mega_w4``, which the CPU tests hold bit for
bit against JAX's ``build_mega_decode_w4``; these cases skip without a
card."""
import pytest
import torch

# by its module name, as pytest imports test files: the card's machine has
# a ``tests`` package of its own that shadows this directory
from test_torch_mega_bf16 import CASES, _hold, _inputs, one_launch
from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4
from vae_gslm_tpu_torch.ops import mega_step as tmega

# tests/test_torch_mega_w4.py's (flushed, pos, group) cases, then every
# cache state of CASES at both groups
W4_CASES = ([(0, 40, 128), (128, 140, 64)]
            + [(f, p, g) for f, p in CASES for g in (64, 128)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _w4_inputs(b, group, dev, seed=3, h=4):
    x, w, cache, slopes = _inputs(b, dev, seed=seed, h=h)
    return x, pack_mega_w4(w, group, 256 // h), cache, slopes


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos,group", W4_CASES)
def test_cuda_w4_kernel_matches_plain(cuda_device, flushed, pos, group):
    """B = 8: the kernel and its plain version sum the same exact int32
    group dots in group order in float32; the band is the JAX test's.
    One launch, counted under ``launches_w4``."""
    x, w, cache, slopes = _w4_inputs(8, group, cuda_device)
    args = (x, w, cache, pos, slopes, flushed)
    before = tmega.fused_trunk_step.launches_w4
    got = tmega.fused_trunk_step(*args)
    want = tmega.fused_trunk_step_plain(*args)
    torch.cuda.synchronize()
    assert tmega.fused_trunk_step.launches_w4 == before + 1
    _hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 17, 32])
@pytest.mark.parametrize("group", [64, 128])
def test_cuda_w4_step_matches_plain_at_any_batch(cuda_device, b, group):
    """Ragged and full batch tiles up to the mega cap (the CLI's chunks are
    B = 32), at a cold block, tail and stage rows and at a full tail."""
    x, w, cache, slopes = _w4_inputs(b, group, cuda_device, seed=b)
    for flushed, pos in ((128, 140), (256, 384)):
        args = (x, w, cache, pos, slopes, flushed)
        got = tmega.fused_trunk_step(*args)
        want = tmega.fused_trunk_step_plain(*args)
        torch.cuda.synchronize()
        _hold(got, want)


@pytest.mark.cuda
def test_cuda_w4_step_is_one_launch(cuda_device):
    x, w, cache, slopes = _w4_inputs(8, 128, cuda_device)
    one_launch(lambda: tmega.fused_trunk_step(x, w, cache, 300, slopes, 256),
               "k2_i8_step_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("d, group", [(1280, 0), (1280, 64), (2048, 0),
                                      (2560, 128)])
def test_cuda_i8_step_at_wide_dims(cuda_device, d, group):
    """One layer at dims whose plans take the tile paths the small trunk
    does not: several tiles in one weight piece (dim 1280, a8's FFN up) and
    several pieces of one product streamed through the two slots (dims
    2048 and 2560), a8 and w4, at B 8 and 32."""
    for b in (8, 32):
        x, w, cache, slopes = _inputs(b, cuda_device, seed=d + b, d=d, nl=1)
        if group:
            w = pack_mega_w4(w, group, 64)
        args = (x, w, cache, 140, slopes, 128)
        got = tmega.fused_trunk_step(*args, a8=not group)
        want = tmega.fused_trunk_step_plain(*args, a8=not group)
        torch.cuda.synchronize()
        _hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("flushed,pos", CASES)
@pytest.mark.parametrize("h,group", [(2, 128), (8, 64), (8, 128)])
@pytest.mark.parametrize("b", [8, 32])
def test_cuda_w4_step_matches_plain_at_head_widths(cuda_device, flushed,
                                                   pos, h, group, b):
    """K2-w4 at head width 128 (2 heads: group 128 only, a multiple of the
    width) and 32 (8 heads: groups 64 and 128), one launch a call."""
    x, w, cache, slopes = _w4_inputs(b, group, cuda_device, seed=b + h, h=h)
    args = (x, w, cache, pos, slopes, flushed)
    before = tmega.fused_trunk_step.launches_w4
    got = tmega.fused_trunk_step(*args)
    want = tmega.fused_trunk_step_plain(*args)
    torch.cuda.synchronize()
    assert tmega.fused_trunk_step.launches_w4 == before + 1
    _hold(got, want)
