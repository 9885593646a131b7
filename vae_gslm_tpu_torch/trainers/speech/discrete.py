"""DiscreteAR (token LM baseline) trainer (port of
``vae_gslm_tpu/trainers/speech/discrete.py``).

The loss of a micro-batch is the token cross-entropy summed over the
valid positions (``kld``), plus half the summed f0 L1 where the model
has an f0 head, on ``dedup_tokens`` when the frozen ``HuBERTIO`` codec
deduplicates, else ``tokens``.  ``run_step`` takes micro-batches stacked
on a leading accumulation axis, sums their gradients (and, over ``W``
ranks, the ranks', as JAX's token-sum loss over the global batch does)
and takes one optimizer step under the policy of ``trainer.precision``
(``16-mixed``: the trunk's attention through K3/K3b in bfloat16 on the
card).  Like JAX's, the returned metrics are the last micro-batch's,
``kld`` and ``f0_loss`` per valid token.  Validation logs the mean CE
per token and continues the first batch's prompts through
``DiscreteARSampler`` (a float cache: JAX's trainer passes no
``kv_dtype``), decoded by the codec.  Checkpoints, resume and the full
state are ``BaseTrainer``'s (the compact npz of ``model``).
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ...core.device import resolve_device
from ...core.losses import masked_ce_loss, masked_l1_loss
from ...core.masked import Masked
from ...core.precision import policy_for_precision, policy_scope
from ...data.dataset import DiscreteTokenDataset
from ...hparams.hp import Hparams
from ...inference.speech.sampler import DiscreteARSampler
from ...models.speech.discrete import DiscreteAR
from ...models.vocoder.vocoder import HuBERTIO
from ...parallel import mesh
from ...training.optimizer import create_optimizer
from ...training.trainer import (RANK_SEED_STRIDE, BaseTrainer,
                                 fuse_microbatches, init_weights)


class DiscreteARTrainer(BaseTrainer):
    """``hp.hubert.path`` names the frozen ``HuBERTIO`` codec's directory.
    Runs on CUDA unless ``device="cpu"``; a rank of a process group passes
    its own device."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
        self.mel_rescale = None
        if hp.training.has("mel_rescale"):
            hp.training.mel_rescale.check_arg_in_hparams("mean", "std")
            self.mel_rescale = hp.training.mel_rescale
        hp.check_arg_in_hparams("hubert", "logging")
        hp.hubert.check_arg_in_hparams("path")
        self.codec = HuBERTIO.from_pretrained(
            hp.hubert.path, hp_rescale=self.mel_rescale, device=self.device)
        self.model = DiscreteAR(
            hp.model, self.codec.hp_vq, input_dim=self.codec.hp.n_mels,
            device=self.device,
            generator=torch.Generator(self.device).manual_seed(seed))
        init_weights(self.model, hp.training.get("init_std", 1.0),
                     torch.Generator(self.device).manual_seed(seed))
        self.model.set_soundstream(self.codec)
        self.deduplicate = self.codec.model.deduplicate
        self.token_key = "dedup_tokens" if self.deduplicate else "tokens"
        self.sampler = DiscreteARSampler(self.model, device=self.device)
        self.names, self.params = zip(*self.model.named_parameters())
        mesh.replicate(self.params)
        self.opt, self.lr_schedule = create_optimizer(
            hp.training, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.fuse_accumulation = bool(hp.training.get("fuse_accumulation",
                                                      False))
        self.rng = torch.Generator(self.device).manual_seed(
            seed + 1 + RANK_SEED_STRIDE * self.rank)

    # --------------------------------------------------------------- data
    def _make_dataset(self, hp_data: Hparams, name: str):
        return DiscreteTokenDataset(hp_data, self.codec.hp,
                                    self.codec.model.hp.hubert,
                                    self.mel_rescale, name=name,
                                    device=self.device)

    def train_dataloader(self):
        ds = self._make_dataset(self.hp.data.train, "train dataset")
        return self.get_dataloader(self.hp.data.train, ds)

    def val_dataloader(self):
        ds = self._make_dataset(self.hp.data.val, "validation dataset")
        self.val_token_sample_rate = ds.token_sample_rate
        return self.get_dataloader(self.hp.data.val, ds)

    # --------------------------------------------------------------- step
    @property
    def batch_keys(self):
        return (self.token_key, "f0")

    def _loss_fn(self, batch: Dict[str, Masked], *_):
        """(loss, metrics) of one micro-batch; the metrics are detached
        token sums."""
        out = self.model(batch[self.token_key], f0=batch.get("f0"))
        kld = masked_ce_loss(out["logits"], out["labels"])
        loss = kld
        metrics = {"kld": kld.detach(),
                   "length": out["logits"].lengths.sum()}
        if self.model.f0 is not None:
            f0_loss = masked_l1_loss(out["f0"], batch["f0"])
            loss = loss + f0_loss * 0.5
            metrics["f0_loss"] = f0_loss.detach()
        return loss, metrics

    def prepare_batch(self, stacked: Dict[str, Any]) -> Dict[str, Masked]:
        """The step's keys, fused if ``fuse_accumulation``, on the
        model's device."""
        batch = {k: v for k, v in stacked.items() if k in self.batch_keys}
        if self.fuse_accumulation:
            batch = fuse_microbatches(batch)
        return self.to_device(batch, self.batch_keys)

    def run_step(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step; ``kld`` (and ``f0_loss``) come back per
        valid token of the last micro-batch."""
        batch = self.prepare_batch(stacked)
        with policy_scope(self.policy):
            metrics = self.step_micro_batches(batch, self._loss_fn)
        n = metrics.pop("length")
        for k in ("kld", "f0_loss"):
            if k in metrics:
                metrics[k] = metrics[k] / n
        return metrics

    # ---------------------------------------------------------- validation
    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        """The CE per valid token over at most ``limit_val_batches``
        batches, then the first batch's continuations as audio."""
        if self.logger is None:
            return
        loader = self.val_dataloader()
        limit = self.hp.trainer.get("limit_val_batches", 8)
        total, length, first = 0.0, 0.0, None
        with policy_scope(self.policy):
            for i, batch in enumerate(loader):
                if i >= limit:
                    break
                _, m = self._loss_fn(self.to_device(batch, self.batch_keys))
                total += float(m["kld"])
                length += float(m["length"])
                if first is None:
                    first = batch
            if length:
                self.logger.log_scalar("val/kld", total / length, step)
            if first is not None and self.hp.logging.num_samples > 0:
                self._log_audio(first, step)

    def _log_audio(self, batch, step: int) -> None:
        hpl = self.hp.logging
        toks = batch[self.token_key]
        num = min(hpl.num_samples, toks.value.shape[0])
        prior_len = int(hpl.sample_prior_length * self.val_token_sample_rate)
        length = int(hpl.sample_length * self.val_token_sample_rate)
        prior = Masked(toks.value[:num, :prior_len].to(self.device),
                       toks.lengths[:num].to(self.device).clamp(
                           max=prior_len), 1)
        full = self.sampler(length, prior, self.rng,
                            temperature=hpl.temperature)
        audio = self.model.decode(full, self.rng)
        sr = self.hp.data.train.sample_rate
        for i in range(num):
            ln = int(audio.lengths[i])
            self.logger.log_audio(f"samples/{i}", audio.value[i, :ln].float()
                                  .cpu().numpy(), step, sr)
