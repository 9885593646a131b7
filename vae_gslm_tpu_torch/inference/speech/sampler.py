"""Autoregressive speech continuation (port of ``ARTRSampler`` from
``vae_gslm_tpu/inference/speech/sampler.py``, hybrid and mega paths).

Both paths start with a stacked int8 prefill, then run one step per
generated frame in a Python loop (the JAX package's segmented
``lax.scan``):

  * **mega** (``quantize_weights=True`` and a K2-eligible trunk, B <=
    ``mega_max_batch``): the prefill cache becomes the three-tier mega
    cache and each step is one ``LVTR.step_mega`` (the whole trunk as one
    K2 call); every 8 steps the bf16 stage merges into the int8 tail and
    every 128 the tail moves to a cold block.  With ``mega_w4`` (JAX's
    ``VAE_GSLM_MEGA_W4``) the trunk runs on nibble-packed int4 weights
    (``build_mega_decode_w4``) through K2-w4.  For ``mega_max_batch`` < B
    <= 2 x ``mega_max_batch`` the batch runs as sequential chunks of
    ``mega_max_batch``; beyond that the per-layer path, not ported yet,
    would serve it (ROADMAP.md, Queue 1, "The per-layer decode path").
  * **hybrid** (bf16 weights, or int8 weights the mega path cannot
    take): the cold/tail cache and one ``LVTR.step_hybrid`` (K1 per
    layer) per frame, with a tail -> cold flush every 256 positions.

The batch gates are JAX's (mega at B <= 32, chunks of 32 up to B = 64,
the s8 x s8 dense products at B <= 8).  They were measured on a TPU and
are kept so that the port computes what JAX computes at each batch; the
H100's own crossovers wait for a measurement (ROADMAP.md).

Randomness: one ``torch.Generator`` consumed in this order: encoder
noise, initial AR state, prefill step (prior noise, token Gumbel
noise), each AR step (the same two), then the diffusion decode (start
noise, one noise tensor per DDIM step).  Chunks consume it one after
the other.  ``jax.random`` streams cannot be reproduced; at temperature
0 and a near-zero token temperature the output is deterministic and
matches the JAX sampler.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple, Union

import torch

from ...core.device import resolve_device
from ...core.masked import Masked
from ...ops import mega_step
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


def mega_scan_segments(frame: torch.Tensor, cache: dict, flushed: int,
                       pos0: int, length: int,
                       step_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``length`` AR steps from position ``pos0`` over the mega cache,
    with JAX's cadence: before a step, a full tail (``pos - flushed ==
    128``) moves to the next cold block; after the step at ``pos``, when
    ``pos + 1 - flushed`` is a multiple of 8, the stage merges into tail
    slot ``pos + 1 - flushed - 8``.  ``step_fn`` as in
    ``hybrid_scan_segments``."""
    frames = []
    pos = pos0
    for _ in range(length):
        if pos - flushed == mega_step.BLK:
            cache = mega_step.flush_mega(cache, flushed)
            flushed += mega_step.BLK
        frames.append(frame[:, 0])
        frame, cache = step_fn(frame, cache, pos, flushed)
        pos += 1
        if (pos - flushed) % mega_step.STAGE == 0:
            cache = mega_step.merge_stage(
                cache, pos - flushed - mega_step.STAGE)
    return torch.stack(frames, dim=1), frame


class ARTRSampler:
    """Sampler for the LVTR family on the hybrid and mega paths.

    ``kv_dtype`` must be ``torch.int8``; the float caches and
    ``return_attn`` raise ``NotImplementedError`` until the per-layer
    slice lands.  ``quantize_weights=True`` converts the trunk to
    weight-only int8 in place (inference only) and serves through K2
    when the trunk is eligible (``supports_mega_decode``).
    ``mega_max_batch`` is the largest batch one mega run takes (JAX's
    ``VAE_GSLM_MEGA_MAX_BATCH``); ``mega_a8`` forces the s8 x s8 dense
    products on or off (default: B <= 8).  ``mega_w4`` is the scale group
    of the nibble-packed int4 trunk (0: int8 weights); None reads
    ``VAE_GSLM_MEGA_W4`` as JAX does ("0" or "" off, "64" group 64,
    anything else group 128)."""

    def __init__(self, model, kv_dtype=torch.int8,
                 quantize_weights: bool = False, mega_max_batch: int = 32,
                 mega_a8: Optional[bool] = None,
                 mega_w4: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        if kv_dtype != torch.int8:
            raise NotImplementedError(
                "only the int8 KV cache (hybrid and mega decode) is ported; "
                "float caches wait for the per-layer path (ROADMAP.md, "
                "Queue 1)")
        self.device = resolve_device(device)
        if not model.transformer.supports_stacked_decode():
            raise NotImplementedError(
                "the hybrid and mega paths need a pre-LN RMSNorm trunk")
        if quantize_weights:
            model.transformer.quantize_weights_int8()
        self.model = model
        self.kv_dtype = kv_dtype
        self.use_mega = model.transformer.supports_mega_decode()
        self.mega_max_batch = mega_max_batch
        self.mega_a8 = mega_a8
        if mega_w4 is None:
            env = os.environ.get("VAE_GSLM_MEGA_W4", "0")
            mega_w4 = 0 if env in ("0", "") else 64 if env == "64" else 128
        self.mega_w4 = mega_w4

    def prefill(self, enc: Masked, length: int, stacked: dict, generator,
                mega: bool = False, **kw):
        """The stacked int8 prefill over [initial state, prompt], then the
        conversion to the mega cache (``mega``) or the hybrid cold/tail
        cache.  Returns (first generated frame, cache, flushed)."""
        model = self.model
        b, tp = enc.value.shape[0], enc.value.shape[1]
        pre_cache = model.init_cache(b, tp + 1, dtype=torch.int8)
        out, pre_cache = model.step(enc.value, pre_cache, 0, generator,
                                    push_init_state=True, stacked=stacked,
                                    **kw)
        tr = model.transformer
        convert = (tr.mega_cache_from_prefill if mega
                   else tr.hybrid_cache_from_prefill)
        cache, flushed = convert(pre_cache, tp + 1, tp + 1 + length)
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
        ar_loop, diffusion; summed over chunks) are stored in it, the
        device synchronised at each stage boundary."""
        if return_attn:
            raise NotImplementedError(
                "return_attn runs the per-layer path (ROADMAP.md)")
        if prior.value.device != self.device:
            raise ValueError(f"prior is on {prior.value.device}, the "
                             f"sampler on {self.device}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        kw = dict(temperature=temperature,
                  token_temperature=token_temperature,
                  truncated_norm=truncated_norm)
        b = prior.value.shape[0]
        cap = self.mega_max_batch
        if self.use_mega and b > cap:
            if b > 2 * cap:
                raise NotImplementedError(
                    f"B={b} > 2 x mega_max_batch ({cap}): the JAX package "
                    "serves it through the per-layer decode path, not "
                    "ported yet (ROADMAP.md, Queue 1)")
            return self._chunked(length, prior, generator, kw,
                                 encoder_temperature, timings)
        model = self.model
        clock = _StageClock(timings, self.device)
        # JAX conditions the decoder on the prompt's utterance embedding
        u_c = (model.encode_utterance(prior)
               if getattr(model, "utterance_net", None) is not None
               else None)
        enc = model.encode(prior, generator,
                           temperature=encoder_temperature)
        stacked = model.transformer.build_stacked_decode()
        mega = self.use_mega
        frame, cache, flushed = self.prefill(enc, length, stacked,
                                             generator, mega=mega, **kw)
        clock.lap("encode_prefill")
        pos0 = enc.value.shape[1] + 1
        if mega:
            weights = (model.transformer.build_mega_decode_w4(self.mega_w4)
                       if self.mega_w4
                       else model.transformer.build_mega_decode())

            def step_fn(frame, cache, pos, flushed):
                return model.step_mega(frame, weights, cache, pos, flushed,
                                       generator, a8=self.mega_a8, **kw)

            frames, _ = mega_scan_segments(frame, cache, flushed, pos0,
                                           length, step_fn)
        else:
            def step_fn(frame, cache, pos, flushed):
                return model.step_hybrid(frame, stacked, cache, pos,
                                         flushed, generator, **kw)

            frames, _ = hybrid_scan_segments(model, frame, cache, flushed,
                                             pos0, length, step_fn)
        clock.lap("ar_loop")
        full = torch.cat([enc.value, frames.to(enc.value.dtype)], dim=1)
        full_m = Masked.from_lengths(full, enc.lengths + length)
        mel = model.decode(full_m, generator, u_c=u_c)
        clock.lap("diffusion")
        return {"output": mel, "frames": full_m}

    def _chunked(self, length: int, prior: Masked, generator, kw: dict,
                 encoder_temperature: float,
                 timings: Optional[dict]) -> Dict[str, Masked]:
        """Sequential chunks of ``mega_max_batch`` rows, concatenated."""
        cap = self.mega_max_batch
        outs = []
        for i in range(0, prior.value.shape[0], cap):
            sub = Masked(prior.value[i:i + cap], prior.lengths[i:i + cap],
                         prior.time_axis)
            sub_t = {} if timings is not None else None
            outs.append(self(length, sub, generator,
                             encoder_temperature=encoder_temperature,
                             timings=sub_t, **kw))
            for name, sec in (sub_t or {}).items():
                timings[name] = timings.get(name, 0.0) + sec
        return {k: Masked(torch.cat([o[k].value for o in outs]),
                          torch.cat([o[k].lengths for o in outs]),
                          outs[0][k].time_axis) for k in outs[0]}


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
