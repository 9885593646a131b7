"""Token-LM-only continuation inferer (port of
``vae_gslm_tpu/inference/speech/hubert.py``): ``SpeechInferer``'s token LM
branch whatever ``model.identifier`` says, which also writes the decoded
prompt as ``{n}_ov.wav`` beside each continuation ``{n}.wav`` (no VAD
trim).  The prompt decoded is the first ``sample_prior_length`` s of the
tokens, as JAX's.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

from ...core.masked import Masked
from ...data import audio as audio_lib
from ...hparams.hp import Hparams
from .inferer import SpeechInferer as _SpeechInferer


class SpeechInferer(_SpeechInferer):
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        hp.model.identifier = "models.speech.discrete.DiscreteAR"
        super().__init__(hp, device)

    @torch.no_grad()
    def run(self, seed: int = 0, max_batches: Optional[int] = None,
            timings: Optional[Dict[str, float]] = None) -> int:
        """Continue every batch (at most ``max_batches``) from one
        generator seeded ``seed``: the prompt decoded, then the
        continuation.  Returns the number of continuations written."""
        os.makedirs(self.hp.output_dir, exist_ok=True)
        generator = torch.Generator(self.device).manual_seed(seed)
        sr = self.hp.data.sample_rate
        dev = self.device
        batches = iter(self.test_dataloader())
        try:
            for i, batch in enumerate(batches):
                if max_batches is not None and i >= max_batches:
                    break
                prior_length = int(self.hp.sample_prior_length
                                   * self.token_sample_rate)
                toks = batch["tokens"]
                prior = Masked(toks.value[:, :prior_length].to(dev),
                               toks.lengths.to(dev).clamp(max=prior_length),
                               1)
                prior_decoded = self.model.decode(prior, generator)
                audio = self.test_step(batch, generator, timings)
                for b in range(audio.value.shape[0]):
                    self.sampled += 1
                    base = os.path.join(self.hp.output_dir,
                                        str(self.sampled))
                    for path, wave in (
                            (f"{base}.wav", audio),
                            (f"{base}_ov.wav", prior_decoded)):
                        n = int(wave.lengths[b])
                        audio_lib.save_wav(path, wave.value[b, :n].float()
                                           .cpu().numpy(), sr)
        finally:
            batches.close()
        return self.sampled
