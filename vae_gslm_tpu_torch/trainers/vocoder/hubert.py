"""HuBERT token -> mel decoder trainer (port of
``vae_gslm_tpu/trainers/vocoder/hubert.py``).

The loss of a micro-batch is the diffusion reconstruction loss of the
mels given the tokens (with the speaker crop ``cropped_mel`` and ``f0``
where the model takes them), plus, in dedup mode, the L1 between the
duration predictor's output and log(1 + count) of each deduplicated
token, per valid token of the batch.  ``run_step`` sums the
micro-batches' gradients (and the ranks') and takes one optimizer step;
micro-batch i draws its diffusion step and noise from the trainer's
generator (``draws[i]`` may give them).  The metrics are the last
micro-batch's, as JAX's.  Validation averages the losses per batch and
renders the first batch's reconstructions through the frozen HiFi-GAN.
Checkpoints, resume and the full state are ``BaseTrainer``'s.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ...core.device import resolve_device
from ...core.losses import masked_l1_loss
from ...core.masked import Masked
from ...core.precision import policy_for_precision, policy_scope
from ...data.dataset import DiscreteTokenDataset
from ...hparams.hp import Hparams
from ...models.vocoder.hubert import HuBERT
from ...models.vocoder.vocoder import HiFiGAN
from ...training.optimizer import create_optimizer
from ...training.trainer import RANK_SEED_STRIDE, BaseTrainer, init_weights

Draws = Dict[str, torch.Tensor]
BATCH_KEYS = ("tokens", "mel", "cropped_mel", "dedup_tokens", "counts",
              "f0")


class HuBERTDecoderTrainer(BaseTrainer):
    """``hp.vocoder.path`` names the frozen HiFi-GAN's directory.  Runs on
    CUDA unless ``device="cpu"``."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
        hp.check_arg_in_hparams("vocoder", "logging")
        hp.vocoder.check_arg_in_hparams("path")
        self.mel_rescale = (hp.training.mel_rescale
                            if hp.training.has("mel_rescale") else None)
        self.vocoder = HiFiGAN.from_pretrained(
            hp.vocoder.path, hp_rescale=self.mel_rescale, device=self.device)
        mel_rate = (float(self.vocoder.hp.sample_rate)
                    / self.vocoder.hp.hop_length)
        self.model = HuBERT(
            hp.model, input_dim=self.vocoder.hp.n_mels,
            mel_sample_rate=mel_rate, device=self.device,
            generator=torch.Generator(self.device).manual_seed(seed))
        init_weights(self.model, hp.training.get("init_std", 1.0),
                     torch.Generator(self.device).manual_seed(seed))
        self.deduplicate = hp.model.hubert.deduplicate
        self.names, self.params = zip(*self.model.named_parameters())
        self.place_params()
        self.opt, self.lr_schedule = create_optimizer(
            hp.training, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.rng = torch.Generator(self.device).manual_seed(
            seed + 1 + RANK_SEED_STRIDE * self.data_index)

    def _make_dataset(self, hp_data: Hparams, name: str):
        return DiscreteTokenDataset(hp_data, self.vocoder.hp,
                                    self.hp.model.hubert, self.mel_rescale,
                                    name=name, device=self.device)

    def train_dataloader(self):
        ds = self._make_dataset(self.hp.data.train, "train dataset")
        return self.get_dataloader(self.hp.data.train, ds)

    def val_dataloader(self):
        ds = self._make_dataset(self.hp.data.val, "validation dataset")
        return self.get_dataloader(self.hp.data.val, ds)

    # --------------------------------------------------------------- step
    def _loss_fn(self, batch: Dict[str, Masked],
                 draws: Optional[Draws] = None):
        """(loss, metrics) of one micro-batch; the metrics detached."""
        draws = draws or {}
        out = self.model(batch["tokens"], batch["mel"], self.rng,
                         spkr=batch.get("cropped_mel"),
                         dedup_x=batch.get("dedup_tokens"),
                         f0=batch.get("f0"), t=draws.get("t"),
                         noise=draws.get("noise"))
        rec = out["diffusion_loss"]
        loss = rec
        metrics = {"rec_loss": rec.detach()}
        if self.deduplicate:
            counts = batch["counts"]
            log_dur = Masked(torch.log1p(counts.value.float()),
                             counts.lengths, 1)
            dp_loss = masked_l1_loss(log_dur.expand_dim(),
                                     out["duration_prediction"],
                                     time_reduction=True,
                                     batch_reduction=True)
            loss = loss + dp_loss
            metrics["dp_loss"] = dp_loss.detach()
        return loss, metrics

    def run_step(self, stacked: Dict[str, Any],
                 draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step over the stacked micro-batches; ``draws[i]``
        replaces micro-batch i's diffusion draws (``t``, ``noise``)."""
        batch = self.to_device(stacked, BATCH_KEYS)
        with policy_scope(self.policy):
            return self.step_micro_batches(
                batch,
                lambda mb, i: self._loss_fn(mb, draws[i] if draws else None))

    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        """The losses averaged over at most ``limit_val_batches`` batches,
        then the first batch's reconstructions as audio."""
        if self.logger is None:
            return
        limit = self.hp.trainer.get("limit_val_batches", 8)
        totals: Dict[str, float] = {}
        count, first = 0, None
        with policy_scope(self.policy):
            for i, batch in enumerate(self.val_dataloader()):
                if i >= limit:
                    break
                _, m = self._loss_fn(self.to_device(batch, BATCH_KEYS))
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
                if first is None:
                    first = batch
            if count:
                self.logger.log_scalars(
                    {f"val/{k}": v / count for k, v in totals.items()}, step)
            if first is not None and self.hp.logging.num_samples > 0:
                self._log_audio(first, step)

    def _log_audio(self, batch, step: int) -> None:
        b = self.to_device(batch, BATCH_KEYS)
        num = min(self.hp.logging.num_samples, b["tokens"].value.shape[0])

        def rows(x: Optional[Masked]) -> Optional[Masked]:
            return (None if x is None
                    else Masked(x.value[:num], x.lengths[:num], 1))

        cond = self.model.encode(
            rows(b["tokens"]),
            spkr=(rows(b.get("cropped_mel"))
                  if self.model.spkr_net is not None else None),
            f0=rows(b.get("f0")))
        audio = self.vocoder.decode(self.model.decode(cond, self.rng))
        sr = self.hp.data.train.sample_rate
        for i in range(num):
            ln = int(audio.lengths[i])
            self.logger.log_audio(f"reconstruct/{i}", audio.value[i, :ln]
                                  .float().cpu().numpy(), step, sr)
