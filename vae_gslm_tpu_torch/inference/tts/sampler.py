"""Text-to-speech sampler with end-of-speech stopping (port of
``ARTRTTSSampler`` from ``vae_gslm_tpu/inference/tts/sampler.py``).

The batch stays fixed, as in JAX: an ``active`` mask freezes the rows
that have ended, each row's length is recorded at its first EOS at or
after ``min_frames``, the frames are masked past it and diffusion-
decoded.  Step 0 runs the initial state at position 0; step i (at
position i + 1) emits frame i and reads the EOS of the hidden it gives.
Routes (JAX's rule without a mesh):

  * **stacked** (B <= ``HYBRID_MAX_BATCH``, no ``return_attn``, a trunk
    that ``supports_stacked_decode(allow_cross=True)``): the memory's
    per-layer cross-attention K/V built once (``build_stacked_memory``),
    a float32 stacked cache, and one ``decode_stacked`` single-token step
    a frame (``TransformerLayerStack._decode_stacked_step``);
  * **per-layer** (otherwise): per-layer caches in the compute dtype and
    ``TransformerLayerStack.decode`` over the ``project_memory``-ed
    memory, which with ``return_attn`` also returns every step's maps.

Neither route launches a port kernel: JAX runs both in plain XLA.  The
self- and cross-attention maps come back as (B, L, H, Q, KV) float32,
each step's row rounded to bfloat16 as JAX's scan rows are, with Q =
``max_frames + 1``, beside the text encoder's ``text_self_attn`` (B, L,
H, Tt, Tt).  Without ``return_attn`` the loop stops once every row has
ended (checked every ``STOP_CHECK`` steps): the frames it would still
emit are zeros, so the outputs keep JAX's shapes and values.

Randomness: one ``torch.Generator`` consumed in this order: the initial
state, each step's prior noise, then the diffusion decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ...core.device import resolve_device
from ...core.masked import Masked
from ..speech.sampler import HYBRID_MAX_BATCH, _StageClock

STOP_CHECK = 8          # steps between the checks for every row ended


class ARTRTTSSampler:
    def __init__(self, model, device: Union[str, torch.device] = "cuda"):
        self.model = model
        self.device = resolve_device(device)

    def route(self, batch: int, return_attn: bool = False) -> str:
        """"stacked" or "per_layer" (the module docstring's rule)."""
        if (not return_attn and batch <= HYBRID_MAX_BATCH
                and self.model.transformer.supports_stacked_decode(
                    allow_cross=True)):
            return "stacked"
        return "per_layer"

    def _step(self, frame, memory, caches, pos, generator, temperature,
              eos_threshold, return_attn, stacked, mem_kv):
        """One AR step (JAX's ``_tts_step``): the next frame (B, 1, C),
        the caches, each row's EOS (B,) and, with ``return_attn``, the
        step's maps (L, B, H, KV) in bfloat16."""
        tr = self.model.transformer
        attn = None
        if stacked is not None:
            h, caches = tr.decode_stacked(frame, stacked, caches, pos,
                                          memory_kv=mem_kv)
        else:
            res = tr.decode(frame, caches, pos, memory=memory,
                            return_attn=return_attn)
            h, caches = res[:2]
            if return_attn:
                attn = {k: v[:, :, :, 0].to(torch.bfloat16)
                        for k, v in res[2].items()}
        nxt = self.model._sample_next(h, generator, temperature, 1.0, None)
        eos = self.model.is_eos(Masked.full(h), eos_threshold)[:, -1]
        return nxt, caches, eos, attn

    @torch.no_grad()
    def __call__(self, text: Masked, spkr: Masked,
                 generator: Optional[torch.Generator] = None,
                 max_frames: int = 500, min_frames: int = 1,
                 temperature: float = 1.0, eos_threshold: float = 0.5,
                 return_attn: bool = False,
                 timings: Optional[dict] = None) -> Dict[str, Any]:
        """Speech for the symbol ids ``text`` (B, Tt) in the voice of the
        reference mels ``spkr``.  Returns ``{"output": mel, "frames":
        latents (B, max_frames, C) masked to "lengths" (B,)}``, with
        ``return_attn`` also ``"self_attn"``, ``"cross_attn"`` and
        ``"text_self_attn"``.  With a ``timings`` dict the wall seconds of
        the stages (condition, ar_loop, diffusion; the device synchronised
        at each boundary) and the AR steps run (``ar_steps``) are stored
        in it."""
        if text.value.device != self.device:
            raise ValueError(f"text is on {text.value.device}, the sampler "
                             f"on {self.device}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        model = self.model
        tr = model.transformer
        clock = _StageClock(timings, self.device)
        outputs: Dict[str, Any] = {}
        if return_attn:
            memory, _, text_attn = model.encode_condition(text, spkr,
                                                          return_attn=True)
            outputs["text_self_attn"] = text_attn.transpose(0, 1)
        else:
            memory, _ = model.encode_condition(text, spkr)
        memory = tr.project_memory(memory)
        b = text.value.shape[0]
        stacked = mem_kv = None
        if self.route(b, return_attn) == "stacked":
            stacked = tr.build_stacked_decode(allow_cross=True)
            mem_kv = tr.build_stacked_memory(memory)
        caches = model.init_cache(b, max_frames + 1,
                                  stacked=stacked is not None)
        args = (temperature, eos_threshold, return_attn, stacked, mem_kv)
        frame, caches, _, attn0 = self._step(
            model.initial_state(generator, b), memory, caches, 0, generator,
            *args)
        clock.lap("condition")
        active = torch.ones(b, dtype=torch.bool, device=self.device)
        lengths = torch.full((b,), max_frames, dtype=torch.int32,
                             device=self.device)
        frames = torch.zeros((b, max_frames, frame.shape[-1]),
                             dtype=frame.dtype, device=self.device)
        rows = [attn0] if return_attn else None
        steps = 0
        for i in range(max_frames):
            pos = i + 1
            frames[:, i] = torch.where(active[:, None], frame[:, 0], 0.0)
            frame, caches, eos, attn = self._step(frame, memory, caches,
                                                  pos, generator, *args)
            steps += 1
            if return_attn:
                rows.append(attn)
            done = active & eos & (i >= min_frames)
            lengths = torch.where(done, torch.full_like(lengths, pos),
                                  lengths)
            active = active & ~done
            if (not return_attn and steps % STOP_CHECK == 0
                    and not bool(active.any())):
                break
        clock.lap("ar_loop")
        if return_attn:
            for name in rows[0]:
                # (Q, L, B, H, KV) -> (B, L, H, Q, KV)
                outputs[name] = torch.stack([r[name] for r in rows]).permute(
                    2, 1, 3, 0, 4).float()
        out = Masked.from_lengths(frames, lengths)
        mel = model.decode(out.apply_mask(), generator)
        clock.lap("diffusion")
        if timings is not None:
            timings["ar_steps"] = steps
        outputs.update(output=mel, frames=out, lengths=lengths)
        return outputs
