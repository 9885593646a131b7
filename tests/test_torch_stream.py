"""K7: the port's weight-stream probe ``ops/stream.py::stream_sums``
against its definition in numpy, on the CPU.  ``tools/bench_slope.py``
runs its benchmark at import, so its kernel ``k_block`` is written out
here in numpy: each layer's BlockSpec slice ``w[l]``, of which the kernel
writes ``sum(w[l, :8, :128], axis=0, keepdims=True)[:, :1]`` to the one
(1, 1) output, the last layer's value remaining.  The port also returns
each whole slice's int32 sum.  The ``cuda`` case holds the kernel
against the plain version on a card, exactly."""
import numpy as np
import pytest
import torch

from vae_gslm_tpu_torch.ops.stream import stream_sums, stream_sums_plain


def _k_block(w: np.ndarray) -> np.ndarray:
    out = None
    for layer in range(w.shape[0]):
        out = np.sum(w[layer, :8, :128].astype(np.int32), axis=0,
                     keepdims=True)[:, :1]
    return out


@pytest.mark.parametrize("shape", [(3, 16, 256), (2, 8, 128)])
def test_stream_sums_match_numpy(shape):
    w = np.random.RandomState(0).randint(-127, 128, shape).astype(np.int8)
    sums, tile = stream_sums(torch.from_numpy(w))
    assert sums.dtype == tile.dtype == torch.int32
    np.testing.assert_array_equal(
        sums.numpy(), w.astype(np.int64).sum(axis=(1, 2)).astype(np.int32))
    np.testing.assert_array_equal(tile.numpy(), _k_block(w))


def test_stream_sums_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        stream_sums(torch.zeros((2, 4, 128), dtype=torch.int8))
    with pytest.raises(TypeError):
        stream_sums(torch.zeros((2, 8, 128), dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_stream_sums_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU (sm_90a)")
    g = torch.Generator("cuda").manual_seed(0)
    w = torch.randint(-127, 128, (4, 1024, 12288), generator=g,
                      device="cuda", dtype=torch.int8)
    got, want = stream_sums(w), stream_sums_plain(w)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
