"""Autoregressive speech continuation (port of ``ARTRSampler`` from
``vae_gslm_tpu/inference/speech/sampler.py``, hybrid path).

The port serves every batch through the hybrid int8 decode: a stacked
int8 prefill, conversion to the cold/tail cache, then one
``LVTR.step_hybrid`` per generated frame with one tail -> cold flush
each time 256 positions have filled the tail.  The JAX package's
segmented ``lax.scan`` becomes a Python loop.  Its batch crossovers
(mega kernel at B <= 32, lane-packed per-layer cache at B = 64, base
per-layer at B >= 128) were measured on a TPU and do not carry over;
the per-layer and mega paths wait for later slices (ROADMAP.md).

Randomness: one ``torch.Generator`` consumed in this order: encoder
noise, initial AR state, prefill step (prior noise, token Gumbel
noise), each AR step (the same two), then the diffusion decode (start
noise, one noise tensor per DDIM step).  ``jax.random`` streams cannot
be reproduced; at temperature 0 and a near-zero token temperature the
output is deterministic and matches the JAX sampler.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import torch

from ...core.device import resolve_device
from ...core.masked import Masked
from ...ops.fused_decode import TAIL


def hybrid_scan_segments(model, frame: torch.Tensor, cache: dict,
                         flushed: int, pos0: int, length: int,
                         step_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``length`` AR steps from position ``pos0`` over the hybrid cache,
    flushing the tail into the cold cache whenever it is full (at
    ``pos - flushed == 256``).  ``step_fn`` is ``(frame, cache, pos,
    flushed) -> (next, cache)``.  Returns (frames (B, length, C), the
    frame after the last)."""
    frames = []
    pos = pos0
    for _ in range(length):
        if pos - flushed == TAIL:
            cache = model.transformer.flush_hybrid(cache, flushed)
            flushed += TAIL
        frames.append(frame[:, 0])
        frame, cache = step_fn(frame, cache, pos, flushed)
        pos += 1
    return torch.stack(frames, dim=1), frame


class ARTRSampler:
    """Sampler for the LVTR family on the hybrid int8 decode path.

    ``kv_dtype`` must be ``torch.int8`` (the hybrid cache); the float
    caches, ``quantize_weights`` (int8 weights) and ``return_attn``
    raise ``NotImplementedError`` until their slices land."""

    def __init__(self, model, kv_dtype=torch.int8,
                 quantize_weights: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        if kv_dtype != torch.int8:
            raise NotImplementedError(
                "only the int8 KV cache (hybrid decode) is ported; float "
                "caches wait for the per-layer path (ROADMAP.md, Queue 1)")
        if quantize_weights:
            raise NotImplementedError(
                "int8 weights run the mega path (K2), which is slice 2 "
                "(ROADMAP.md, Queue 2)")
        self.device = resolve_device(device)
        if getattr(model, "utterance_net", None) is not None:
            raise NotImplementedError("utterance conditioning (ROADMAP.md)")
        if not model.transformer.supports_stacked_decode():
            raise NotImplementedError(
                "the hybrid path needs a pre-LN RMSNorm trunk")
        self.model = model
        self.kv_dtype = kv_dtype

    def prefill(self, enc: Masked, length: int, stacked: dict, generator,
                **kw):
        """The stacked int8 prefill over [initial state, prompt], then the
        conversion to the cold/tail cache.  Returns (first generated
        frame, cache, flushed)."""
        model = self.model
        b, tp = enc.value.shape[0], enc.value.shape[1]
        pre_cache = model.init_cache(b, tp + 1, dtype=torch.int8)
        out, pre_cache = model.step(enc.value, pre_cache, 0, generator,
                                    push_init_state=True, stacked=stacked,
                                    **kw)
        cache, flushed = model.transformer.hybrid_cache_from_prefill(
            pre_cache, tp + 1, tp + 1 + length)
        return out[:, -1:], cache, flushed

    @torch.no_grad()
    def __call__(self, length: int, prior: Masked,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0,
                 token_temperature: float = 1.0,
                 truncated_norm: Optional[Tuple[float, float]] = None,
                 encoder_temperature: float = 1.0,
                 return_attn: bool = False,
                 timings: Optional[dict] = None) -> Dict[str, Masked]:
        """Continue the prompt ``prior`` ([token, mel] frames) by
        ``length`` frames.  Returns ``{"frames": prompt latents +
        continuation, "output": the diffusion-decoded mel}``.  With a
        ``timings`` dict, the wall seconds of the stages (encode_prefill,
        ar_loop, diffusion) are stored in it, the device synchronised
        at each stage boundary."""
        if return_attn:
            raise NotImplementedError(
                "return_attn runs the per-layer path (ROADMAP.md)")
        if prior.value.device != self.device:
            raise ValueError(f"prior is on {prior.value.device}, the "
                             f"sampler on {self.device}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        model = self.model
        kw = dict(temperature=temperature,
                  token_temperature=token_temperature,
                  truncated_norm=truncated_norm)
        clock = _StageClock(timings, self.device)
        enc = model.encode(prior, generator,
                           temperature=encoder_temperature)
        stacked = model.transformer.build_stacked_decode()
        frame, cache, flushed = self.prefill(enc, length, stacked,
                                             generator, **kw)
        clock.lap("encode_prefill")

        def step_fn(frame, cache, pos, flushed):
            return model.step_hybrid(frame, stacked, cache, pos, flushed,
                                     generator, **kw)

        frames, _ = hybrid_scan_segments(model, frame, cache, flushed,
                                         enc.value.shape[1] + 1, length,
                                         step_fn)
        clock.lap("ar_loop")
        full = torch.cat([enc.value, frames.to(enc.value.dtype)], dim=1)
        full_m = Masked.from_lengths(full, enc.lengths + length)
        mel = model.decode(full_m, generator)
        clock.lap("diffusion")
        return {"output": mel, "frames": full_m}


class _StageClock:
    """Wall seconds per stage into ``timings`` (when given), with a
    device synchronisation at each stage boundary."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings, self.device = timings, device
        if timings is not None:
            self._sync()
            self.t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        self._sync()
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now
