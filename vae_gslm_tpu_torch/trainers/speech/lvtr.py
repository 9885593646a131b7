"""LVTR (VAE-GSLM) training step (port of the step of
``vae_gslm_tpu/trainers/speech/lvtr.py``).

beta-VAE weighting (``fixed_beta`` splits reconstruction against KLD),
the KLD zero/warm-up schedule by global step, loss = rec * scale +
(log_q * entropy_weight - log_p) * kld_weight + CE * token_kld_weight *
kld_weight.  ``run_step`` takes micro-batches stacked on a leading
accumulation axis (``training/trainer.py::stack_batches``), sums their
gradients (the losses are masked sums, as in the reference's repeated
backward) and takes one optimizer step under the policy of
``trainer.precision``.  Like the JAX ``run_step`` it leaves
``global_step`` to the caller (JAX's ``fit``).  Data, ``fit``,
checkpoints and validation audio wait for a later slice (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...core.device import resolve_device
from ...core.losses import masked_loss
from ...core.masked import Masked
from ...core.precision import policy_for_precision, policy_scope
from ...hparams.hp import Hparams
from ...models.speech.lvtr import LVTR
from ...training.optimizer import create_optimizer, global_norm
from ...training.trainer import fuse_microbatches, init_weights

Draws = Dict[str, torch.Tensor]
_BATCH_KEYS = ("mel", "tokens", "cropped_mel_utt", "cropped_mel")
_SUM_KEYS = ("kld", "rec_loss", "token_kld", "length")


class LVTRTrainer:
    """``hp.vocoder.path`` names a directory with the vocoder's
    ``hp.yaml``, from which the model's mel width is read (the vocoder's
    weights serve validation, not the step).  Runs on CUDA unless
    ``device="cpu"``."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.hp = hp
        hp.check_arg_in_hparams("vocoder", "training", "trainer")
        hp.vocoder.check_arg_in_hparams("path")
        tr = hp.training
        self.rec_loss_scale = tr.get("rec_loss_scale", 1.0)
        self.kld_scale = tr.get("kld_scale", 1.0)
        fixed_beta = tr.get("fixed_beta", None)
        if fixed_beta is not None:
            if tr.get("scale_rec_beta", True):
                self.rec_loss_scale *= 1 - fixed_beta
            self.kld_scale *= fixed_beta
        self.mel_rescale = None
        if tr.has("mel_rescale"):
            tr.mel_rescale.check_arg_in_hparams("mean", "std")
            self.mel_rescale = tr.mel_rescale
        voc_hp = Hparams.from_yamlfile(os.path.join(hp.vocoder.path,
                                                    "hp.yaml"))
        voc_hp.check_arg_in_hparams("model", "feature")
        self.model = LVTR(hp.model, input_dim=voc_hp.feature.n_mels,
                          device=self.device,
                          generator=torch.Generator(
                              self.device).manual_seed(seed))
        hp.check_arg_in_hparams("logging")
        hp.logging.check_arg_in_hparams("num_samples", "temperature",
                                        "sample_length",
                                        "sample_prior_length", "plot_attn")
        init_weights(self.model, tr.get("init_std", 1.0),
                     torch.Generator(self.device).manual_seed(seed))
        self.zero_kld = tr.scheduler.get("zero_kld", 0)
        self.warmup_kld = tr.scheduler.get("warmup_kld", 0)
        self.entropy_weight = tr.get("entropy_weight", 1.0)
        self.token_kld_weight = tr.get("token_kld_weight", 1.0)
        self.use_tokens = self.model.use_tokens
        if self.use_tokens:
            hp.check_arg_in_hparams("hubert")
            hp.hubert.check_arg_in_hparams("sample_rate")
        # JAX warm-starts the encoder from a compact checkpoint and then
        # zeroes its gradients; the checkpoint format is not ported yet.
        if hp.model.encoder.get("init_from_ckpt", None) is not None:
            raise NotImplementedError(
                "encoder.init_from_ckpt needs the compact checkpoint "
                "loader, not ported yet (ROADMAP.md)")
        self.freeze_encoder = False
        self.names, self.params = zip(*self.model.named_parameters())
        self.opt, self.lr_schedule = create_optimizer(
            tr, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.fuse_accumulation = bool(tr.get("fuse_accumulation", False))
        self.global_step = 0
        self.rng = torch.Generator(self.device).manual_seed(seed + 1)

    # --------------------------------------------------------------- step
    def _model_input(self, batch: Dict[str, Masked]) -> Masked:
        if self.use_tokens:
            tokens = batch["tokens"].expand_dim()
            return Masked(tokens.value.float(), tokens.lengths,
                          1).cat(batch["mel"])
        return batch["mel"]

    def _kwargs(self, batch: Dict[str, Masked]) -> Dict[str, Any]:
        kw = {}
        if self.model.utterance_net is not None:
            kw["utterance"] = batch["cropped_mel_utt"]
        if "cropped_mel" in batch:
            kw["diff_input"] = batch["cropped_mel"]
        return kw

    def _loss_fn(self, batch: Dict[str, Masked], kld_weight: float,
                 generator: Optional[torch.Generator],
                 draws: Optional[Draws] = None):
        """(loss, metrics) of one micro-batch; the metrics are detached."""
        out = self.model(self._model_input(batch), generator, draws=draws,
                         **self._kwargs(batch))
        kld = masked_loss(out["log_q"] * self.entropy_weight, out["log_p"],
                          fn=lambda x, y: x - y)
        rec = out["rec_loss"]
        loss = rec * self.rec_loss_scale + kld * kld_weight
        metrics = {
            "kld": kld,
            "rec_loss": rec,
            "log_p": -out["log_p"].mean(),
            "log_q": -out["log_q"].mean(),
            "length": out["log_p"].lengths.sum(),
            "logstd": out["logstd"],
            "q_logstd": out["q_logstd"],
            "q_mean_abs": out["q_mean_abs"],
        }
        if self.use_tokens:
            token_kld = out["ce_loss"]
            loss = loss + token_kld * self.token_kld_weight * kld_weight
            metrics["token_kld"] = token_kld
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _kld_weight(self, step: int) -> float:
        """The KLD weight at ``step``, in float32 like the JAX one."""
        w = np.float32(self.kld_scale)
        if self.warmup_kld > 0:
            mult = np.float32(step - self.zero_kld) / np.float32(
                self.warmup_kld)
            if self.zero_kld < step + 1 <= self.warmup_kld:
                w = np.float32(self.kld_scale) * mult
        if self.zero_kld > 0 and step <= self.zero_kld:
            w = np.float32(0.0)
        return float(w)

    def train_step(self, stacked: Dict[str, Masked],
                   draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step over the stacked micro-batches (on the
        model's device): gradients summed over them, metrics aggregated
        as JAX does (token sums add up, the other statistics are weighted
        by each micro-batch's valid length).  ``draws[i]`` replaces
        micro-batch ``i``'s random draws (``LVTR.forward``)."""
        kld_weight = self._kld_weight(self.global_step)
        for p in self.params:
            p.grad = None
        per_mb = []
        for i in range(next(iter(stacked.values())).value.shape[0]):
            mb = {k: v.micro(i) for k, v in stacked.items()}
            loss, metrics = self._loss_fn(mb, kld_weight, self.rng,
                                          draws[i] if draws else None)
            loss.backward()
            per_mb.append(metrics)
        n_mb = torch.stack([m["length"] for m in per_mb])
        metrics = {}
        for k in per_mb[0]:
            v = torch.stack([m[k] for m in per_mb])
            metrics[k] = (v.sum(0) if k in _SUM_KEYS
                          else (v * n_mb).sum(0) / n_mb.sum())
        grads = [p.grad for p in self.params]
        if self.freeze_encoder:
            for name, g in zip(self.names, grads):
                if g is not None and name.startswith(("encoder_net.",
                                                      "encoder_head.")):
                    g.zero_()
        metrics["kld_weight"] = kld_weight
        metrics["grad_norm"] = global_norm(
            [g for g in grads if g is not None])
        metrics["lr"] = self.lr_schedule(self.global_step)
        self.opt.step(grads)
        return metrics

    def prepare_batch(self, stacked: Dict[str, Any]) -> Dict[str, Masked]:
        """The step's keys, fused if ``fuse_accumulation``, on the
        model's device."""
        batch = {k: v for k, v in stacked.items() if k in _BATCH_KEYS}
        if self.fuse_accumulation:
            batch = fuse_microbatches(batch)
        return {k: Masked(v.value.to(self.device),
                          v.lengths.to(self.device, torch.int32),
                          v.time_axis) for k, v in batch.items()}

    def run_step(self, stacked: Dict[str, Any],
                 draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step; ``kld``, ``rec_loss`` and ``token_kld``
        come back per valid token."""
        batch = self.prepare_batch(stacked)
        with policy_scope(self.policy):
            metrics = self.train_step(batch, draws)
        n = metrics.pop("length")
        for k in ("kld", "rec_loss", "token_kld"):
            if k in metrics:
                metrics[k] = metrics[k] / n
        return metrics
