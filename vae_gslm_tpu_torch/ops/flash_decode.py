"""Single-query decode attention over an int8 per-layer KV cache that
reads only the filled 256-key blocks (port of
``vae_gslm_tpu/ops/flash_decode.py``).

``flash_decode_int8`` (head-major ``(B, H, T, D)`` cache, the port's
per-layer layout) wraps the hand-written Hopper kernel
``csrc/flash_decode.cu``, which replaces the Pallas kernel
``flash_decode_int8_tm`` (``_kernel``).  It takes JAX's arguments and
contract and reads the cache in place: JAX's ``swapaxes`` to the
time-minor ``(B, H, D, T)`` layout exists only for the TPU's DMA, so the
port has no time-minor entry point (a time-minor cache is the head-major
one's ``transpose(2, 3)``).

What it computes (float32; q is not quantized): for each of the
``ceil((pos + 1) / 256)`` key blocks,
``s = (q . k) / sqrt(D) * k_scale + slope * |t - pos|`` masked to
``t <= pos``, an online softmax (running max ``m``, sum ``l``), and
``acc += (e * v_scale) . v``; the result is ``acc / l``.  T must be a
multiple of 256.  The kernel is a template on the head width D,
instantiated at 32, 64 and 128 (``HEAD_DIMS``); the scale stays
``1 / sqrt(D)``.

On a CPU tensor a wrapper computes ``flash_decode_int8_plain``, the same
math in torch ops summed block by block; on a CUDA tensor it launches the
kernel or raises, and counts into ``flash_decode_int8.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

BLK = 256
HEAD_DIMS = (32, 64, 128)   # the kernel's instantiations
NEG_INF = -1e30


def flash_decode_int8_plain(q, k_i8, v_i8, k_scale, v_scale, pos: int,
                            slopes) -> torch.Tensor:
    """Plain PyTorch version over the head-major cache."""
    b, h, d = q.shape
    qf = q.float()
    scale = 1.0 / math.sqrt(d)
    slopes_f = slopes.float()[None, :, None]
    dev = q.device
    m = torch.full((b, h, 1), NEG_INF, device=dev)
    l = torch.zeros((b, h, 1), device=dev)
    acc = torch.zeros((b, h, d), device=dev)
    for i in range((pos + BLK) // BLK):
        sl = slice(i * BLK, (i + 1) * BLK)
        s = torch.matmul(qf[:, :, None], k_i8[:, :, sl].float().transpose(
            -1, -2))[:, :, 0] * scale
        s = s * k_scale[:, :, sl].float()
        t_idx = torch.arange(i * BLK, (i + 1) * BLK, device=dev)
        s = s + slopes_f * (t_idx - pos).abs().float()[None, None]
        s = torch.where(t_idx[None, None] <= pos, s,
                        torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        ev = e * v_scale[:, :, sl].float()
        acc = acc * corr + torch.matmul(ev[:, :, None],
                                        v_i8[:, :, sl].float())[:, :, 0]
        m = m_new
    return acc / l


_LAUNCH = None


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from .build import load

        fn = load("flash_decode").flash_decode_int8_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads a contiguous, 16-byte "
                         "aligned tensor")


def flash_decode_int8(q, k, v, k_scale, v_scale, pos: int,
                      slopes) -> torch.Tensor:
    """q (B, H, D) float32 or bfloat16 (each batch row a contiguous
    (H, D) block, so a view of the fused qkv projection needs no copy);
    caches (B, H, T, D) int8 with T % 256 == 0; scales (B, H, T)
    float32; ``pos`` a host int; slopes (H,) negative ALiBi slopes.
    Returns (B, H, D) float32."""
    b, h, d = q.shape
    t = k.shape[2]
    if t % BLK:
        raise ValueError(f"cache length {t} is not a multiple of {BLK}")
    if not 0 <= pos < t:
        raise ValueError(f"pos={pos} outside the cache [0, {t})")
    if q.device.type == "cpu":
        return flash_decode_int8_plain(q, k, v, k_scale, v_scale, pos,
                                       slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode_int8 for {q.device}")
    dev = q.device
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {d}: the kernel takes head_dim 32, 64 or 128 "
            "(other widths are not ported: ROADMAP.md)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32/bfloat16")
    if q.stride()[1:] != (d, 1):
        raise ValueError(f"q: strides {q.stride()}, each batch row must be "
                         "a contiguous (H, D) block")
    for name, x in (("k", k), ("v", v)):
        _check(name, x, torch.int8, (b, h, t, d), dev)
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, x, torch.float32, (b, h, t), dev)
    _check("slopes", slopes, torch.float32, (h,), dev)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    err = _launcher()(
        q.data_ptr(), int(q.dtype == torch.bfloat16), q.stride(0),
        k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        slopes.data_ptr(), out.data_ptr(), b, h, t, d, pos, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_int8 launch failed: CUDA error "
                           f"{err}")
    flash_decode_int8.launches += 1
    return out


flash_decode_int8.launches = 0
