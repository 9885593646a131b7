"""Pseudo-likelihood estimator (port of
``vae_gslm_tpu/inference/speech/likelihood.py``).

Batches ``LVTR.likelihood`` over an evaluation set into one score per
utterance: the token log-prob per frame for the tokenised LVTR, the
latent log-density per frame otherwise; a config whose
``model.identifier`` ends in ``discrete.DiscreteAR`` scores the token
LM's ``likelihood`` (the mean token log-prob, with f0 where the model
has it) on the tokens, deduplicated where the frozen codec
deduplicates.  Mels are computed on the
estimator's device; the utterances are scored whole (no crop unless the
data config asks for one), so a batch padded past 1024 frames runs the
q-tiled attention kernel (K5) in every layer and a shorter one the
packed kernel (K3).  The JAX estimator applies no precision policy and
no int8 weights: its path runs float32, and the port's ``run`` runs under
the float32 policy (TF32 off) whatever the caller's policy is.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...core.masked import Masked
from ...core.precision import Policy, policy_scope
from ...data.dataset import DiscreteTokenDataset, MelSpecDataset
from ...data.loader import DataLoader
from ...hparams.hp import Hparams
from ...models.vocoder.vocoder import HiFiGAN, HuBERTIO
from ..inferer import BaseInferer


class LikelihoodEstimator(BaseInferer):
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
        else:
            self.type = "lvtr"
            self.vocoder = HiFiGAN.from_pretrained(
                self.hp_model.vocoder.path, hp_rescale=self.mel_rescale,
                device=self.device)
            self.load_model(input_dim=self.vocoder.hp.n_mels)
            self.input_key = "mel"
        self.use_tokens = getattr(self.model, "use_tokens", False)
        if self.use_tokens:
            self.hp_hubert = Hparams(
                deduplicate=False,
                sample_rate=self.hp_model.hubert.sample_rate)
        self.scores: list = []

    def test_dataloader(self) -> DataLoader:
        if self.type == "hubert":
            dataset = DiscreteTokenDataset(
                self.hp.data, self.codec.hp, self.codec.model.hp.hubert,
                self.mel_rescale, device=self.device)
        elif self.use_tokens:
            dataset = DiscreteTokenDataset(
                self.hp.data, self.vocoder.hp, self.hp_hubert,
                self.mel_rescale, device=self.device)
        else:
            dataset = MelSpecDataset(self.hp.data, self.vocoder.hp,
                                     self.mel_rescale, device=self.device)
        self.hp.data.sampler.drop_last = False
        return self.get_dataloader(self.hp.data, dataset)

    def model_input(self, batch) -> Masked:
        """[token, mel] frames (or mels) of a collated batch on the
        estimator's device."""
        dev = self.device
        mel = batch[self.input_key]
        mel = Masked(mel.value.to(dev), mel.lengths.to(dev), 1)
        if not self.use_tokens:
            return mel
        tok = batch["tokens"]
        return Masked(tok.value[..., None].to(dev, torch.float32),
                      tok.lengths.to(dev), 1).cat(mel)

    @torch.no_grad()
    def test_step(self, batch, generator: torch.Generator) -> torch.Tensor:
        if self.type == "hubert":
            dev = self.device
            toks = batch[self.input_key]
            f0 = batch.get("f0")
            if f0 is not None:
                f0 = Masked(f0.value.to(dev), f0.lengths.to(dev), 1)
            return self.model.likelihood(
                Masked(toks.value.to(dev), toks.lengths.to(dev), 1), f0=f0)
        return self.model.likelihood(self.model_input(batch), generator)

    def run(self, seed: int = 0, max_batches: Optional[int] = None,
            timings: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Scores of the evaluation set in sampler order, float32.  The
        initial AR states are drawn from one generator seeded ``seed``.
        With ``timings``, the seconds spent waiting for data and in the
        model are added under ``data`` and ``model`` (the device
        synchronised at each boundary) and the batch count under
        ``batches``."""
        with policy_scope(Policy()):
            return self._run(seed, max_batches, timings)

    def _run(self, seed: int, max_batches: Optional[int],
             timings: Optional[Dict[str, float]]) -> np.ndarray:
        loader = self.test_dataloader()
        generator = torch.Generator(self.device).manual_seed(seed)
        self.scores = []
        batches = iter(loader)
        i = 0
        while max_batches is None or i < max_batches:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            self.synchronize()
            t1 = time.perf_counter()
            score = self.test_step(batch, generator)
            self.synchronize()
            t2 = time.perf_counter()
            self.scores.append(score.float().cpu().numpy())
            if timings is not None:
                timings["data"] = timings.get("data", 0.0) + t1 - t0
                timings["model"] = timings.get("model", 0.0) + t2 - t1
                timings["batches"] = timings.get("batches", 0) + 1
            i += 1
        batches.close()
        self.scores = (np.concatenate(self.scores) if self.scores
                       else np.zeros((0,), np.float32))
        return self.scores
