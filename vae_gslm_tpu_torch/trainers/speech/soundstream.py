"""SoundStream mel-autoencoder trainer (port of
``vae_gslm_tpu/trainers/speech/soundstream.py``).

The loss of a micro-batch is the masked L1 between the reconstruction
and the mels, per valid frame and mel channel of the batch, plus the
quantizer's loss (commit and codebook, summed over the valid frames).
``run_step`` takes micro-batches stacked on a leading accumulation axis,
sums their gradients (and the ranks') and takes one optimizer step under
the policy of ``trainer.precision`` (float32 turns TF32 off); the metrics
are the last micro-batch's (``rec_loss``, ``aux_loss``), as JAX's.
Validation logs the mean ``rec_loss`` over at most ``limit_val_batches``
batches.  Checkpoints, resume (the compact npz of ``model``, or the
port's full state) are ``BaseTrainer``'s.  The frozen HiFi-GAN
(``hp.vocoder.path``, a local directory) gives the mel settings.  No
kernel runs on this path.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ...core.device import resolve_device
from ...core.losses import masked_l1_loss
from ...core.precision import policy_for_precision, policy_scope
from ...data.dataset import MelSpecDataset
from ...hparams.hp import Hparams
from ...models.speech.soundstream import SoundStream
from ...models.vocoder.vocoder import HiFiGAN
from ...training.optimizer import create_optimizer
from ...training.trainer import BaseTrainer, init_weights

BATCH_KEYS = ("mel",)


class SoundStreamTrainer(BaseTrainer):
    """Runs on CUDA unless ``device="cpu"``; a rank of a process group
    passes its own device."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
        hp.check_arg_in_hparams("vocoder")
        hp.vocoder.check_arg_in_hparams("path")
        self.mel_rescale = (hp.training.mel_rescale
                            if hp.training.has("mel_rescale") else None)
        self.vocoder = HiFiGAN.from_pretrained(
            hp.vocoder.path, hp_rescale=self.mel_rescale, device=self.device)
        self.model = SoundStream(
            hp.model, input_dim=self.vocoder.hp.n_mels, device=self.device,
            generator=torch.Generator(self.device).manual_seed(seed))
        init_weights(self.model, hp.training.get("init_std", 1.0),
                     torch.Generator(self.device).manual_seed(seed))
        self.names, self.params = zip(*self.model.named_parameters())
        self.place_params()
        self.opt, self.lr_schedule = create_optimizer(
            hp.training, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))

    def _make_dataset(self, hp_data: Hparams, name: str):
        return MelSpecDataset(hp_data, self.vocoder.hp, self.mel_rescale,
                              name=name, device=self.device)

    def train_dataloader(self):
        return self.get_dataloader(
            self.hp.data.train,
            self._make_dataset(self.hp.data.train, "train dataset"))

    def val_dataloader(self):
        return self.get_dataloader(
            self.hp.data.val,
            self._make_dataset(self.hp.data.val, "validation dataset"))

    def _loss_fn(self, batch):
        """(loss, metrics) of one micro-batch; the metrics detached."""
        out = self.model(batch["mel"])
        rec = masked_l1_loss(out["reconstruction"], batch["mel"],
                             time_reduction=True, batch_reduction=True)
        return rec + out["aux_loss"], {"rec_loss": rec.detach(),
                                       "aux_loss": out["aux_loss"].detach()}

    def run_step(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step over the stacked micro-batches."""
        batch = self.to_device(stacked, BATCH_KEYS)
        with policy_scope(self.policy):
            return self.step_micro_batches(batch,
                                           lambda mb, i: self._loss_fn(mb))

    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        if self.logger is None:
            return
        limit = self.hp.trainer.get("limit_val_batches", 8)
        total, count = 0.0, 0
        with policy_scope(self.policy):
            for i, batch in enumerate(self.val_dataloader()):
                if i >= limit:
                    break
                _, m = self._loss_fn(self.to_device(batch, BATCH_KEYS))
                total += float(m["rec_loss"])
                count += 1
        if count:
            self.logger.log_scalar("val/rec_loss", total / count, step)
