"""Autoregressive speech continuation (port of ``ARTRSampler`` and
``DiscreteARSampler`` from ``vae_gslm_tpu/inference/speech/sampler.py``;
the token LM's sampler is at the end of this module).

Every route encodes the prompt, prefills a KV cache with [initial state,
prompt] and runs one step per generated frame in a Python loop (the JAX
package's segmented ``lax.scan``), then decodes by diffusion.  Routes:

| weights | KV cache | B | route |
|---|---|---|---|
| int8 | int8 | <= 32 / <= 64 | mega / chunked mega |
| int8 | int8 | > 64 | per-layer int8 (JAX's route) |
| bf16 | int8 | any | hybrid K1 (the port's choice) |
| any | float (None, bf16, f32) | any | per-layer float |
| any | any, with ``return_attn`` | any | per-layer, one full-window segment |

  * **mega** (``quantize_weights=True`` and a K2-eligible trunk,
    JAX's ``supports_mega_decode``, B <= ``mega_max_batch``; on a card
    K2 is built for head widths 32, 64 and 128, the shipped 8 x 128,
    16 x 64 and 32 x 32 trunks): a stacked int8 prefill, converted to the
    three-tier mega cache; each step is one ``LVTR.step_mega`` (the whole
    trunk as one K2 call); every 8 steps the bf16 stage merges into the
    int8 tail and every 128 the tail moves to a cold block.  With
    ``mega_w4`` (JAX's ``VAE_GSLM_MEGA_W4``) the trunk runs on
    nibble-packed int4 weights through K2-w4.  For ``mega_max_batch`` < B
    <= 2 x ``mega_max_batch`` the batch runs as sequential chunks of
    ``mega_max_batch``; beyond that, per layer, as in JAX.
  * **hybrid** (an int8 cache with bf16 weights, or int8 weights the
    mega path cannot take, among them a mega batch whose K2-bf16 step
    does not fit a block of the card: ``mega_step.bf16_step_fits``, dim
    1280 on 132 SMs or dim 1024 on 114; a pre-LN RMSNorm trunk): a
    stacked int8 prefill converted to the cold/tail cache, then one
    ``LVTR.step_hybrid`` (K1 per layer) per frame, with a tail -> cold
    flush every 256 positions.  JAX caps this route at B = 32
    (``VAE_GSLM_HYBRID_MAX_BATCH``); the port takes it at any batch.
  * **per-layer** (float caches, int8 beyond the mega batches, trunks
    the stacked paths cannot take, ``return_attn``): one ``LayerKVCache``
    per layer (``kv_dtype`` None: float, as below; int8 with per-row
    scales), prefilled by ``LVTR.step`` over [initial state,
    prompt], then one ``LVTR.step`` per frame through
    ``decode_attention``.  The scan runs in ``decode_segments`` segments
    (JAX's ``_n_segments``: at most 8, one per 48 steps); segment i's
    steps attend over ``cache[:window_i]``, ``window_i = min(ceil64(tp + 1
    + end_i), max_len)``.  With ``return_attn`` one full-window segment,
    and ``outputs["attn"]`` holds the generated steps' maps, (B, L, H,
    steps, max_len) float32 (rounded to bfloat16 per step, as JAX's scan
    rows are).  With ``flash_decode=True`` an int8 per-layer step's
    attention is K6 (``ops/flash_decode.py``): the caches are then
    allocated at ``max_len`` rounded up to a multiple of 256, and no
    window applies (K6 reads only the blocks up to ``pos``).  JAX's
    samplers never call K6; the option exists to run it on the path it
    was written for.

JAX sends float caches at B <= 32 through its stacked single-token step
(``TransformerLayerStack._decode_stacked_step``) when the trunk is
pre-LN RMSNorm, and that stacked cache is float32 for ``kv_dtype`` None.
The port takes the per-layer route there, with the same float32 cache
(``per_layer_kv_dtype``), so the V product runs on float32 weights as in
JAX; past B = 32, or on a trunk the stacked step cannot take, ``None``
is the compute dtype, as JAX's per-layer caches are.  JAX's lane-packed
per-layer layout (``VAE_GSLM_PACKED_CACHE``), which its ``auto`` picks
on a TPU only, is not ported.  The batch gates are JAX's (mega at B <=
32, chunks of 32 up to B = 64, the s8 x s8 dense products at B <= 8);
they were measured on a TPU, and the H100's own crossovers wait for a
measurement (ROADMAP.md).

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


def n_segments(length: int, cap: int = 8) -> int:
    """JAX's ``_n_segments``: the windowed scan's segment count, at most
    ``cap`` (``VAE_GSLM_DECODE_SEGMENTS``) and one per 48 steps."""
    return max(1, min(cap, length // 48))


def segment_windows(pos0: int, length: int, n_seg: int, max_len: int):
    """The windowed scan's segments as ``(start, end, window)``: the steps
    ``start <= i < end`` (at positions ``pos0 + i``) attend over
    ``cache[:window]``, ``window = min(ceil64(pos0 + end), max_len)``."""
    out, start = [], 0
    for i in range(n_seg):
        end = round(length * (i + 1) / n_seg)
        out.append((start, end, min(-(-(pos0 + end) // 64) * 64, max_len)))
        start = end
    return out


# The batch cap of JAX's stacked routes: ``VAE_GSLM_HYBRID_MAX_BATCH``'s
# default.
HYBRID_MAX_BATCH = 32


def per_layer_kv_dtype(kv_dtype, batch: int, transformer):
    """The per-layer caches' dtype: ``kv_dtype``, but float32 for
    ``kv_dtype`` None where JAX would take its stacked step (B <=
    ``HYBRID_MAX_BATCH``, a pre-LN RMSNorm trunk), whose float cache is
    float32."""
    if (kv_dtype is None and batch <= HYBRID_MAX_BATCH
            and transformer.supports_stacked_decode()):
        return torch.float32
    return kv_dtype


class ARTRSampler:
    """Sampler for the LVTR family (routes in the module docstring).

    ``kv_dtype``: None (JAX's default: a float cache in the policy's
    compute dtype), a float dtype, or ``torch.int8``.
    ``quantize_weights=True`` converts the trunk to weight-only int8 in
    place (inference only) and, with an int8 cache, serves through K2
    when the trunk is eligible (``supports_mega_decode``).
    ``mega_max_batch`` is the largest batch one mega run takes (JAX's
    ``VAE_GSLM_MEGA_MAX_BATCH``); ``mega_a8`` forces the s8 x s8 dense
    products on or off (default: B <= 8).  ``mega_w4`` is the scale group
    of the nibble-packed int4 trunk (0: int8 weights); None reads
    ``VAE_GSLM_MEGA_W4`` as JAX does ("0" or "" off, "64" group 64,
    anything else group 128).  ``flash_decode`` puts K6 under the
    per-layer int8 step (no other route changes).  ``decode_segments``
    caps the per-layer scan's segments (None reads
    ``VAE_GSLM_DECODE_SEGMENTS``, default 8)."""

    def __init__(self, model, kv_dtype=None,
                 quantize_weights: bool = False, mega_max_batch: int = 32,
                 mega_a8: Optional[bool] = None,
                 mega_w4: Optional[int] = None,
                 flash_decode: bool = False,
                 decode_segments: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        int8_kv = kv_dtype == torch.int8
        if not (kv_dtype is None or int8_kv or kv_dtype.is_floating_point):
            raise ValueError(f"kv_dtype {kv_dtype}: None, a float dtype or "
                             "torch.int8")
        if flash_decode and not int8_kv:
            raise ValueError("flash_decode (K6) takes the int8 per-layer "
                             "cache")
        if quantize_weights:
            model.transformer.quantize_weights_int8()
        self.model = model
        self.kv_dtype = kv_dtype
        self.use_mega = int8_kv and model.transformer.supports_mega_decode()
        self.use_hybrid = (int8_kv and not self.use_mega
                           and model.transformer.supports_stacked_decode())
        self.mega_max_batch = mega_max_batch
        self.mega_a8 = mega_a8
        if mega_w4 is None:
            env = os.environ.get("VAE_GSLM_MEGA_W4", "0")
            mega_w4 = 0 if env in ("0", "") else 64 if env == "64" else 128
        self.mega_w4 = mega_w4
        self.flash_decode = flash_decode
        if decode_segments is None:
            decode_segments = int(os.environ.get("VAE_GSLM_DECODE_SEGMENTS",
                                                 "8"))
        self.decode_segments = decode_segments

    def route(self, batch: int, return_attn: bool = False) -> str:
        """"mega", "chunked" (mega in chunks), "hybrid" or "per_layer"."""
        if return_attn or self.kv_dtype != torch.int8:
            return "per_layer"
        if self.use_mega:
            cap = self.mega_max_batch
            if batch <= 2 * cap and not self._mega_fits(min(batch, cap)):
                return "hybrid"
            return ("mega" if batch <= cap else "chunked"
                    if batch <= 2 * cap else "per_layer")
        return "hybrid" if self.use_hybrid else "per_layer"

    def _mega_fits(self, batch: int) -> bool:
        """Whether K2 takes a mega batch (or chunk) of ``batch`` rows on
        this device.  Its bf16 branch (int8 weights without ``mega_a8``:
        B > 8 by default) needs the persistent step's shared-memory plan
        to fit a block of this card (``mega_step.bf16_step_fits``); the
        a8 and w4 branches (whose plan streams a block's tiles in pieces,
        so it fits every dim up to 8192 on any SM count), and the CPU's
        plain version, take any."""
        a8 = batch <= 8 if self.mega_a8 is None else self.mega_a8
        if self.device.type != "cuda" or self.mega_w4 or a8:
            return True
        tr = self.model.transformer
        return mega_step.bf16_step_fits(batch, tr.dim,
                                        tr.layers[0].self_attn.nheads,
                                        mega_step.sm_count(self.device))

    def per_layer_kv_dtype(self, batch: int):
        """The per-layer caches' dtype (``per_layer_kv_dtype``)."""
        return per_layer_kv_dtype(self.kv_dtype, batch,
                                  self.model.transformer)

    def prefill(self, enc: Masked, length: int, stacked: dict, generator,
                mega: bool = False, **kw):
        """The stacked int8 prefill over [initial state, prompt], then the
        conversion to the mega cache (``mega``) or the hybrid cold/tail
        cache.  Returns (first generated frame, cache, flushed)."""
        model = self.model
        b, tp = enc.value.shape[0], enc.value.shape[1]
        pre_cache = model.init_cache(b, tp + 1, dtype=torch.int8,
                                     stacked=True)
        out, pre_cache = model.step(enc.value, pre_cache, 0, generator,
                                    push_init_state=True, stacked=stacked,
                                    **kw)
        tr = model.transformer
        convert = (tr.mega_cache_from_prefill if mega
                   else tr.hybrid_cache_from_prefill)
        cache, flushed = convert(pre_cache, tp + 1, tp + 1 + length)
        return out[:, -1:], cache, flushed

    def prefill_per_layer(self, enc: Masked, length: int, generator, **kw):
        """The per-layer caches (``max_len`` = prompt + 1 + ``length``,
        rounded up to a multiple of 256 for K6) prefilled over [initial
        state, prompt].  Returns (first generated frame, caches)."""
        b, tp = enc.value.shape[0], enc.value.shape[1]
        max_len = tp + 1 + length
        if self.flash_decode:
            max_len = -(-max_len // 256) * 256
        caches = self.model.init_cache(b, max_len,
                                       dtype=self.per_layer_kv_dtype(b))
        out, caches = self.model.step(enc.value, caches, 0, generator,
                                      push_init_state=True, **kw)
        return out[:, -1:], caches

    def per_layer_scan(self, frame: torch.Tensor, caches: list, pos0: int,
                       length: int, generator, return_attn: bool = False,
                       **kw):
        """``length`` per-layer AR steps from position ``pos0`` in the
        windowed segments (one full-window segment with ``return_attn``;
        no window on the K6 route).  Returns (frames (B, length, C), the
        maps (B, L, H, length, max_len) float32 or None)."""
        max_len = pos0 + length
        n_seg = 1 if return_attn else n_segments(length,
                                                 self.decode_segments)
        frames, rows = [], []
        pos = pos0
        for start, end, window in segment_windows(pos0, length, n_seg,
                                                  max_len):
            for _ in range(start, end):
                frames.append(frame[:, 0])
                res = self.model.step(
                    frame, caches, pos, generator,
                    window=None if self.flash_decode else window,
                    return_attn=return_attn, flash_decode=self.flash_decode,
                    **kw)
                frame, caches = res[:2]
                if return_attn:          # (L, B, H, 1, T) -> (L, B, H, T)
                    rows.append(res[2][:, :, :, 0].to(torch.bfloat16))
                pos += 1
        attn = None
        if return_attn:
            attn = torch.stack(rows).permute(2, 1, 3, 0, 4).float()
        return torch.stack(frames, dim=1), attn

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
        continuation, "output": the diffusion-decoded mel}``, with
        ``return_attn`` also ``"attn"`` (B, L, H, length, max_len).  With
        a ``timings`` dict, the wall seconds of the stages (encode_prefill,
        ar_loop, diffusion; summed over chunks) are stored in it, the
        device synchronised at each stage boundary."""
        if prior.value.device != self.device:
            raise ValueError(f"prior is on {prior.value.device}, the "
                             f"sampler on {self.device}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        kw = dict(temperature=temperature,
                  token_temperature=token_temperature,
                  truncated_norm=truncated_norm)
        route = self.route(prior.value.shape[0], return_attn)
        if route == "chunked":
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
        pos0 = enc.value.shape[1] + 1
        attn = None
        if route == "per_layer":
            frame, caches = self.prefill_per_layer(enc, length, generator,
                                                   **kw)
            clock.lap("encode_prefill")
            frames, attn = self.per_layer_scan(frame, caches, pos0, length,
                                               generator, return_attn, **kw)
        else:
            stacked = model.transformer.build_stacked_decode()
            mega = route == "mega"
            frame, cache, flushed = self.prefill(enc, length, stacked,
                                                 generator, mega=mega, **kw)
            clock.lap("encode_prefill")
            if mega:
                weights = (
                    model.transformer.build_mega_decode_w4(self.mega_w4)
                    if self.mega_w4
                    else model.transformer.build_mega_decode())

                def step_fn(frame, cache, pos, flushed):
                    return model.step_mega(frame, weights, cache, pos,
                                           flushed, generator,
                                           a8=self.mega_a8, **kw)

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
        out = {"output": mel, "frames": full_m}
        if return_attn:
            out["attn"] = attn
        return out

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


class DiscreteARSampler:
    """Sampler for the token LM (JAX :555-698): SOS and the prompt
    prefilled, then one ``DiscreteAR`` step per generated token.  Routes:

      * **hybrid** (``kv_dtype`` int8, a trunk the stacked paths take, B
        <= ``HYBRID_MAX_BATCH``, JAX's default cap): the stacked int8
        prefill converted to the cold/tail cache, then ``DiscreteAR.step_hybrid`` (K1 per layer on the card)
        with a tail -> cold flush every 256 positions;
      * **per-layer** (otherwise): one ``LayerKVCache`` per layer of
        ``per_layer_kv_dtype`` (float32 for ``kv_dtype`` None at B <= 32,
        where JAX takes its stacked float step: the port has that step,
        ``TransformerLayerStack.decode_stacked`` on a float cache, and
        this sampler keeps the per-layer route; ROADMAP Queue 1 item 2),
        prefilled, then the windowed segments of ``ARTRSampler``'s
        per-layer scan at JAX's default cap of 8 segments.

    The draws come from one ``torch.Generator``: the prefill's token,
    then each step's.  ``__call__`` returns the prompt and the
    continuation as one ``Masked`` ((B, T) tokens; [token, f0] (B, T, 2)
    with f0; codes (B, T, n) with RVQ)."""

    def __init__(self, model, kv_dtype=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if not (kv_dtype is None or kv_dtype == torch.int8
                or kv_dtype.is_floating_point):
            raise ValueError(f"kv_dtype {kv_dtype}: None, a float dtype or "
                             "torch.int8")
        self.model = model
        self.kv_dtype = kv_dtype

    def route(self, batch: int) -> str:
        """"hybrid" or "per_layer"."""
        if (self.kv_dtype == torch.int8 and batch <= HYBRID_MAX_BATCH
                and self.model.transformer.supports_stacked_decode()):
            return "hybrid"
        return "per_layer"

    def _inputs(self, prior: Masked):
        """(ids, f0 or None, [SOS, prompt] as the step's input)."""
        model = self.model
        if model.f0 is not None:
            ids = prior.value[..., 0].long()
            f0 = prior.value[..., 1:].float()
        else:
            ids, f0 = prior.value.long(), None
        b = ids.shape[0]
        inp = torch.cat([model.initial_state(b), ids], dim=1)
        if f0 is not None:
            f0_in = torch.cat([torch.zeros((b, 1, 1), device=f0.device), f0],
                              dim=1)
            inp = torch.cat([inp[..., None].float(), f0_in], dim=-1)
        return ids, f0, inp

    @torch.no_grad()
    def __call__(self, length: int, prior_tokens: Masked,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0) -> Masked:
        """Continue the prompt ``prior_tokens`` by ``length`` tokens."""
        if prior_tokens.value.device != self.device:
            raise ValueError(f"the prompt is on {prior_tokens.value.device},"
                             f" the sampler on {self.device}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        model = self.model
        ids, f0, inp = self._inputs(prior_tokens)
        b, tp = ids.shape[0], ids.shape[1]
        pos0 = tp + 1
        if self.route(b) == "hybrid":
            stacked = model.transformer.build_stacked_decode()
            pre = model.init_cache(b, pos0, dtype=torch.int8, stacked=True)
            out, pre = model.step(inp, pre, 0, generator,
                                  temperature=temperature, stacked=stacked)
            cache, flushed = model.transformer.hybrid_cache_from_prefill(
                pre, pos0, pos0 + length)

            def step_fn(frame, cache, pos, flushed):
                return model.step_hybrid(frame, stacked, cache, pos, flushed,
                                         generator, temperature=temperature)

            frames, _ = hybrid_scan_segments(model, out[:, -1:], cache,
                                             flushed, pos0, length, step_fn)
        else:
            max_len = pos0 + length
            caches = model.init_cache(b, max_len, dtype=per_layer_kv_dtype(
                self.kv_dtype, b, model.transformer))
            out, caches = model.step(inp, caches, 0, generator,
                                     temperature=temperature)
            frame, rows, pos = out[:, -1:], [], pos0
            n_seg = n_segments(length)
            for start, end, window in segment_windows(pos0, length, n_seg,
                                                      max_len):
                for _ in range(start, end):
                    rows.append(frame[:, 0])
                    frame, caches = model.step(frame, caches, pos, generator,
                                               temperature=temperature,
                                               window=window)
                    pos += 1
            frames = torch.stack(rows, dim=1)
        return self._assemble(ids, f0, frames, prior_tokens.lengths, length)

    @staticmethod
    def _assemble(ids: torch.Tensor, f0: Optional[torch.Tensor],
                  frames: torch.Tensor, lengths: torch.Tensor,
                  length: int) -> Masked:
        if f0 is not None:
            prior = torch.cat([ids[..., None].float(), f0], dim=-1)
            full = torch.cat([prior, frames.float()], dim=1)
        else:
            full = torch.cat([ids, frames.to(ids.dtype)], dim=1)
        return Masked.from_lengths(full, lengths + length)
