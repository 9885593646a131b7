"""Weight-stream probe (port of ``tools/bench_slope.py::mk_stream``).

``stream_sums`` is the wrapper of the hand-written Hopper kernel
``csrc/stream.cu``, which replaces the Pallas kernel ``k_block`` that
``mk_stream`` launches over the 16 layers of a (16, 1024, 12288) int8
stack.  The TPU kernel's BlockSpec streams each layer slice on chip and
the kernel writes only the int32 sum of the first column of the slice's
``[:8, :128]`` tile; on the card the kernel itself reads every byte, so it
returns the per-layer int32 sums of the whole slices beside that tile sum
(of the last layer, whose value JAX's output keeps).  Its time is the time
to stream the stack: ``scripts/bench_slope.py`` measures it.

On a CPU tensor the wrapper computes ``stream_sums_plain``; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def stream_sums_plain(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-layer sums (L,) int32, the last layer's tile sum (1, 1)
    int32) of an (L, R, C) int8 stack."""
    sums = w.sum(dim=(1, 2), dtype=torch.int64).to(torch.int32)
    tile = w[-1, :8, :128].sum(dim=0, keepdim=True,
                                dtype=torch.int32)[:, :1]
    return sums, tile


_LAUNCH = None


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from .build import load

        fn = load("stream").stream_sums_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def stream_sums(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (L, R, C) int8, contiguous, R >= 8, C >= 128, R * C a multiple of
    16.  Returns ``stream_sums_plain``'s two tensors."""
    if w.dim() != 3 or w.dtype != torch.int8:
        raise TypeError(f"w: {w.dtype} of shape {tuple(w.shape)}, expected "
                        "an (L, R, C) int8 stack")
    nl, rows, cols = w.shape
    if rows < 8 or cols < 128 or (rows * cols) % 16:
        raise ValueError(f"w: shape {tuple(w.shape)}, the kernel takes R >= "
                         "8, C >= 128 and R * C a multiple of 16")
    if w.device.type == "cpu":
        return stream_sums_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"no stream_sums for {w.device}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("w: the kernel reads a contiguous, 16-byte aligned "
                         "stack")
    out = torch.zeros(nl + 1, dtype=torch.int32, device=w.device)
    err = _launcher()(w.data_ptr(), out.data_ptr(), nl, rows, cols,
                      torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_sums launch failed: CUDA error {err}")
    stream_sums.launches += 1
    return out[:nl], out[nl:].reshape(1, 1)


stream_sums.launches = 0
