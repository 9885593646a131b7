"""Speech continuation from a checkpoint directory and a corpus (port of
``vae_gslm_tpu/inference/speech/inferer.py``, the LVTR branch).

Each batch of the test set: log-mels on the inferer's device, a
``sample_prior_length`` s prompt with the token channel first, the
``ARTRSampler`` continuation of ``sample_length`` s (stacked int8
prefill, the AR loop, DDIM with the utterance embedding), HiFi-GAN, and
one numbered WAV per row, whose trailing short segment the VAD trims.

The VAD is pyannote's when ``vad.auth_token`` is set and the package is
installed (``build_pyannote_vad``, imported lazily); otherwise the
energy VAD applies the same trailing-segment rule, with a warning when a
token was given, as JAX does.  Nothing is downloaded unless the caller's
pyannote does so.

A config whose ``model.identifier`` ends in ``discrete.DiscreteAR`` takes
the token LM branch (``type`` "hubert"): the checkpoint's ``hubert.path``
names the frozen ``HuBERTIO`` codec, the prompt is the first
``sample_prior_length`` s of the tokens (``sample_prior_tokens`` of the
deduplicated tokens when the codec deduplicates; with f0 the [token, f0]
channels), ``DiscreteARSampler`` continues it (built without
``kv_dtype``, as JAX's is: ``kv_cache_dtype`` and ``weight_dtype`` apply
to the LVTR only), and the codec decodes it (HuBERT DDIM, then HiFi-GAN;
with the prompt's mel as the speaker crop where the codec takes one).
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...core.masked import Masked
from ...data import audio as audio_lib
from ...data.dataset import DiscreteTokenDataset, MelSpecDataset
from ...data.loader import DataLoader
from ...hparams.hp import Hparams
from ...models.vocoder.vocoder import HiFiGAN, HuBERTIO
from ..inferer import BaseInferer
from .sampler import ARTRSampler, DiscreteARSampler

log = logging.getLogger(__name__)


def energy_vad_segments(wave: np.ndarray, sr: int, frame: float = 0.03,
                        threshold_db: float = -40.0, min_gap: float = 0.2):
    """Energy-based VAD: a list of [start_sec, end_sec] speech segments,
    those closer than ``min_gap`` merged."""
    n = int(sr * frame)
    if len(wave) < n:
        return []
    frames = wave[: len(wave) // n * n].reshape(-1, n)
    db = 10 * np.log10(np.mean(frames ** 2, -1) + 1e-10)
    active = db > threshold_db
    segs = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            segs.append([start * frame, i * frame])
            start = None
    if start is not None:
        segs.append([start * frame, len(active) * frame])
    merged = []
    for s in segs:
        if merged and s[0] - merged[-1][1] < min_gap:
            merged[-1][1] = s[1]
        else:
            merged.append(s)
    return merged


def build_pyannote_vad(auth_token: str):
    """The pyannote VAD pipeline, or None when pyannote is not
    installed (the caller then takes :func:`energy_vad_segments`)."""
    try:
        from pyannote.audio import Model
        from pyannote.audio.pipelines import VoiceActivityDetection
    except ImportError:
        return None
    model = Model.from_pretrained("pyannote/segmentation-3.0",
                                  use_auth_token=auth_token)
    pipeline = VoiceActivityDetection(segmentation=model)
    pipeline.instantiate({"min_duration_on": 0.0, "min_duration_off": 0.0})
    return pipeline


def vad_trim(wave: np.ndarray, sr: int, segments) -> np.ndarray:
    """Cut the wave 4000 samples after the last speech segment, or after
    the one before it when the last is shorter than 1.5 s."""
    if len(segments) < 1:
        return wave
    start, end = segments[-1]
    if (end - start) < 1.5 and len(segments) >= 2:
        end = segments[-2][1]
    end = int(end * sr)
    end = min(end + 4000, len(wave))
    return wave[:end]


class SpeechInferer(BaseInferer):
    """``hp`` is an infer config (``configs/infer/speech/vae-gslm.yaml``):
    ``ckpt_path`` (``hp.yaml`` + ``last-cpt.npz``), ``data``,
    ``output_dir``, the sampling operating point, ``diffusion``
    overrides, ``kv_cache_dtype``/``weight_dtype`` and ``vad``.  The
    precision policy is the caller's (``scripts/infer.py`` sets it from
    ``precision``)."""

    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp, device)
        self.mel_rescale = None
        if self.hp_model.training.has("mel_rescale"):
            self.mel_rescale = self.hp_model.training.mel_rescale
        if hp.model.identifier.endswith("discrete.DiscreteAR"):
            self.type = "hubert"
            self.hp_model.hubert.check_arg_in_hparams("path")
            self.codec = HuBERTIO.from_pretrained(
                self.hp_model.hubert.path, hp_rescale=self.mel_rescale,
                device=self.device)
            self.deduplicate = self.codec.model.deduplicate
            self.load_model(hp_vq=self.codec.hp_vq)
            self.model.set_soundstream(self.codec)
            self.input_key = ("dedup_tokens" if self.deduplicate
                              else "tokens")
            self.sampler = DiscreteARSampler(self.model, device=self.device)
            decoder = self.codec.model.decoder
        else:
            self.type = "lvtr"
            self.vocoder = HiFiGAN.from_pretrained(
                self.hp_model.vocoder.path, hp_rescale=self.mel_rescale,
                device=self.device)
            self.load_model(input_dim=self.vocoder.hp.n_mels)
            self.input_key = "mel"
            self.sampler = ARTRSampler(
                self.model,
                kv_dtype=(torch.int8
                          if hp.get("kv_cache_dtype", None) == "int8"
                          else None),
                quantize_weights=hp.get("weight_dtype", None) == "int8",
                device=self.device)
            decoder = self.model.decoder
        self.use_tokens = getattr(self.model, "use_tokens", False)
        if self.use_tokens:
            self.hp_hubert = Hparams(
                deduplicate=False,
                sample_rate=self.hp_model.hubert.sample_rate)
        if hp.has("diffusion"):
            decoder.override_sampling(
                hp.diffusion.get("sampling_timesteps", None),
                hp.diffusion.get("ddim_sampling_eta", None))
        self.vad_pipeline = None
        self.use_vad = hp.has("vad")
        if self.use_vad and hp.vad.get("auth_token", None) is not None:
            self.vad_pipeline = build_pyannote_vad(hp.vad.auth_token)
            if self.vad_pipeline is None:
                log.warning("pyannote unavailable; using energy VAD")
        self.sampled = 0

    def test_dataloader(self) -> DataLoader:
        if self.type == "hubert":
            dataset = DiscreteTokenDataset(
                self.hp.data, self.codec.hp, self.codec.model.hp.hubert,
                self.mel_rescale, device=self.device)
            self.token_sample_rate = dataset.token_sample_rate
        elif self.use_tokens:
            dataset = DiscreteTokenDataset(
                self.hp.data, self.vocoder.hp, self.hp_hubert,
                self.mel_rescale, device=self.device)
        else:
            dataset = MelSpecDataset(self.hp.data, self.vocoder.hp,
                                     self.mel_rescale, device=self.device)
        self.mel_sample_rate = dataset.melspec.sample_rate
        self.hp.data.sampler.drop_last = False
        return self.get_dataloader(self.hp.data, dataset)

    def _segments(self, wave: np.ndarray, sr: int):
        if self.vad_pipeline is not None:
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                audio_lib.save_wav(f.name, wave, sr)
                vad = self.vad_pipeline(f.name)
            return [[t.start, t.end] for t in vad.get_timeline()]
        return energy_vad_segments(wave, sr)

    def prompt(self, batch) -> Masked:
        """The first ``sample_prior_length`` s of each row ([token, mel]
        frames with tokens), lengths clipped to the prompt, on the
        inferer's device."""
        dev = self.device
        mel = batch["mel"]
        prior_length = int(self.hp.sample_prior_length
                           * self.mel_sample_rate)
        prior_v = mel.value[:, :prior_length].to(dev)
        if self.use_tokens:
            toks = batch["tokens"].value[:, :prior_length, None]
            prior_v = torch.cat([toks.to(dev, torch.float32), prior_v], -1)
        return Masked(prior_v, mel.lengths.to(dev).clamp(max=prior_length),
                      1)

    def token_prompt(self, batch) -> Tuple[Masked, int]:
        """The token LM's prompt on the inferer's device and the number of
        tokens to continue it by: ``sample_prior_tokens`` and
        ``sample_tokens`` of the deduplicated tokens, else the first
        ``sample_prior_length`` s of the tokens and ``sample_length`` s;
        with f0 the [token, f0] channels."""
        hp = self.hp
        prior = batch[self.input_key]
        if self.deduplicate:
            prior_length, length = hp.sample_prior_tokens, hp.sample_tokens
        else:
            prior_length = int(hp.sample_prior_length
                               * self.token_sample_rate)
            length = int(hp.sample_length * self.token_sample_rate)
        prior_v = prior.value[:, :prior_length].to(self.device)
        if self.model.f0 is not None:
            f0 = batch["f0"].value[:, :prior_length].to(self.device)
            prior_v = torch.stack([prior_v.float(), f0.float()], dim=-1)
        return Masked(prior_v, prior.lengths.to(self.device).clamp(
            max=prior_length), 1), length

    @torch.no_grad()
    def _test_step_tokens(self, batch, generator: torch.Generator,
                          timings: Optional[Dict[str, float]]) -> Masked:
        prior, length = self.token_prompt(batch)
        t0 = time.perf_counter()
        full = self.sampler(length, prior, generator,
                            temperature=self.hp.temperature)
        if timings is not None:
            self.synchronize()
            t1 = time.perf_counter()
            timings["ar_loop"] = timings.get("ar_loop", 0.0) + t1 - t0
        dec_kw = {}
        if self.codec.model.hp.has("spkr"):
            mel_len = int(self.hp.sample_prior_length * self.mel_sample_rate)
            mel = batch["mel"]
            dec_kw["spkr"] = Masked(mel.value[:, :mel_len].to(self.device),
                                    mel.lengths.to(self.device).clamp(
                                        max=mel_len), 1)
        audio = self.model.decode(full, generator, **dec_kw)
        if timings is not None:
            self.synchronize()
            timings["codec"] = (timings.get("codec", 0.0)
                                + time.perf_counter() - t1)
        return audio

    @torch.no_grad()
    def test_step(self, batch, generator: torch.Generator,
                  timings: Optional[Dict[str, float]] = None) -> Masked:
        """One batch continued and vocoded: the wave (B, samples) with its
        lengths.  With ``timings``, the sampler's stage seconds and the
        vocoder's (the token LM: ``ar_loop`` and ``codec``) are added to
        it."""
        if self.type == "hubert":
            return self._test_step_tokens(batch, generator, timings)
        hp = self.hp
        length = int(hp.sample_length * self.mel_sample_rate
                     * self.model.sample_ratio)
        stages = {} if timings is not None else None
        samples = self.sampler(
            length, self.prompt(batch), generator,
            temperature=hp.temperature,
            token_temperature=hp.get("token_temperature", 1.0),
            truncated_norm=hp.get("truncated_norm", None),
            encoder_temperature=hp.get("encoder_temperature", 1.0),
            timings=stages)
        t0 = time.perf_counter()
        audio = self.vocoder.decode(samples["output"])
        if timings is not None:
            self.synchronize()
            stages["vocoder"] = time.perf_counter() - t0
            for name, sec in stages.items():
                timings[name] = timings.get(name, 0.0) + sec
        return audio

    def run(self, seed: int = 0, max_batches: Optional[int] = None,
            timings: Optional[Dict[str, float]] = None) -> int:
        """Continue every batch of the test set (at most ``max_batches``),
        drawing from one generator seeded ``seed``, and write
        ``{output_dir}/{n}.wav`` for the n-th row, rewritten trimmed when
        the VAD trim shortens it.  Returns the number of WAVs written so
        far.  With ``timings``, the seconds waiting for data
        (``data``), in the sampler's stages and the vocoder, and writing
        WAVs (``write``, with the VAD) are added to it."""
        os.makedirs(self.hp.output_dir, exist_ok=True)
        generator = torch.Generator(self.device).manual_seed(seed)
        sr = self.hp.data.sample_rate
        batches = iter(self.test_dataloader())
        try:
            i = 0
            while max_batches is None or i < max_batches:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                if timings is not None:
                    self.synchronize()
                    timings["data"] = (timings.get("data", 0.0)
                                       + time.perf_counter() - t0)
                audio = self.test_step(batch, generator, timings)
                t1 = time.perf_counter()
                waves = audio.value.float().cpu().numpy()
                lens = audio.lengths.cpu().numpy()
                for b in range(waves.shape[0]):
                    self.sampled += 1
                    fn = os.path.join(self.hp.output_dir,
                                      f"{self.sampled}.wav")
                    wave = waves[b, : lens[b]]
                    audio_lib.save_wav(fn, wave, sr)
                    if self.use_vad:
                        trimmed = vad_trim(wave, sr,
                                           self._segments(wave, sr))
                        if len(trimmed) < len(wave):
                            audio_lib.save_wav(fn, trimmed, sr)
                if timings is not None:
                    timings["write"] = (timings.get("write", 0.0)
                                        + time.perf_counter() - t1)
                i += 1
        finally:
            batches.close()
        return self.sampled
