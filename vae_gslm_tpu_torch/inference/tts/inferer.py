"""Text-to-speech from a checkpoint directory (port of
``vae_gslm_tpu/inference/tts/inferer.py``).

The symbol table is ``{ckpt_path}/symbols.json`` (written by
``LVTTSTrainer``), the model the checkpoint's ``LVTTS``; each batch of
the test set is sampled by ``ARTRTTSSampler`` from its text, in the
voice of its ``cropped_mel`` speaker reference, up to
``max_sample_length`` s (at least ``min_sample_length`` s before an end
of speech counts), decoded by the HiFi-GAN and written as ``N.wav``
beside the re-vocoded reference recording ``N_c.wav`` and its text
``N.txt``.  ``diffusion`` overrides the decoder's DDIM steps and eta.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import torch

from ...core.masked import Masked
from ...data import audio as audio_lib
from ...data.dataset import MelSpecDataset
from ...data.loader import DataLoader
from ...data.symbols import Symbols
from ...hparams.hp import Hparams
from ...models.vocoder.vocoder import HiFiGAN
from ..inferer import BaseInferer
from .sampler import ARTRTTSSampler


class TTSInferer(BaseInferer):
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp, device)
        hp.check_arg_in_hparams("max_sample_length", "min_sample_length",
                                "temperature", "eos_threshold")
        self.mel_rescale = None
        if self.hp_model.training.has("mel_rescale"):
            self.mel_rescale = self.hp_model.training.mel_rescale
        self.vocoder = HiFiGAN.from_pretrained(
            self.hp_model.vocoder.path, hp_rescale=self.mel_rescale,
            device=self.device)
        self.symbols = Symbols.load(os.path.join(hp.ckpt_path,
                                                 "symbols.json"))
        self.load_model(symbols=self.symbols,
                        input_dim=self.vocoder.hp.n_mels)
        self.sampler = ARTRTTSSampler(self.model, device=self.device)
        if hp.has("diffusion"):
            self.model.decoder.override_sampling(
                hp.diffusion.get("sampling_timesteps", None),
                hp.diffusion.get("ddim_sampling_eta", None))
        self.sampled = 0

    def test_dataloader(self) -> DataLoader:
        dataset = MelSpecDataset(self.hp.data, self.vocoder.hp,
                                 self.mel_rescale, device=self.device)
        dataset.symbols = self.symbols
        self.mel_sample_rate = dataset.melspec.sample_rate
        self.hp.data.sampler.drop_last = False
        return self.get_dataloader(self.hp.data, dataset)

    def _rows(self, batch, key: str) -> Masked:
        x = batch[key]
        return Masked(x.value.to(self.device),
                      x.lengths.to(self.device, torch.int32), 1)

    @torch.no_grad()
    def test_step(self, batch, generator: torch.Generator,
                  timings: Optional[Dict[str, float]] = None):
        """One batch: (the sampled audio, the re-vocoded reference audio),
        each a ``Masked`` wave.  With ``timings`` the sampler's stage
        seconds (and ``ar_steps``) and the vocoder's are added to it."""
        rate = self.mel_sample_rate * self.model.sample_ratio
        stages = {} if timings is not None else None
        samples = self.sampler(
            self._rows(batch, "text"), self._rows(batch, "cropped_mel"),
            generator, max_frames=int(self.hp.max_sample_length * rate),
            min_frames=int(self.hp.min_sample_length * rate),
            temperature=self.hp.temperature,
            eos_threshold=self.hp.eos_threshold, timings=stages)
        t0 = time.perf_counter()
        audio = self.vocoder.decode(samples["output"])
        cond = self.vocoder.decode(self._rows(batch, "mel"))
        if timings is not None:
            self.synchronize()
            stages["vocoder"] = time.perf_counter() - t0
            for name, val in stages.items():
                timings[name] = timings.get(name, 0.0) + val
        return audio, cond

    def run(self, seed: int = 0, max_batches: Optional[int] = None,
            timings: Optional[Dict[str, float]] = None) -> int:
        """Every batch of the test set (at most ``max_batches``), drawing
        from one generator seeded ``seed``: ``{output_dir}/{n}.wav``,
        ``{n}_c.wav`` and ``{n}.txt`` for the n-th row.  Returns the
        number of rows written so far."""
        os.makedirs(self.hp.output_dir, exist_ok=True)
        generator = torch.Generator(self.device).manual_seed(seed)
        sr = self.hp.data.sample_rate
        batches = iter(self.test_dataloader())
        try:
            for i, batch in enumerate(batches):
                if max_batches is not None and i >= max_batches:
                    break
                self._write(batch, *self.test_step(batch, generator,
                                                   timings), sr)
        finally:
            batches.close()
        return self.sampled

    def _write(self, batch, audio: Masked, cond: Masked, sr: int) -> None:
        waves = audio.value.float().cpu().numpy()
        lens = audio.lengths.cpu().numpy()
        c_waves = cond.value.float().cpu().numpy()
        c_lens = cond.lengths.cpu().numpy()
        texts = batch.get("text_written_form", [""] * len(waves))
        for b in range(len(waves)):
            self.sampled += 1
            base = os.path.join(self.hp.output_dir, str(self.sampled))
            audio_lib.save_wav(f"{base}.wav", waves[b, : lens[b]], sr)
            audio_lib.save_wav(f"{base}_c.wav", c_waves[b, : c_lens[b]], sr)
            with open(f"{base}.txt", "w") as f:
                f.write(texts[b])
