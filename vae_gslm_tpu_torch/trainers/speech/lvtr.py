"""LVTR (VAE-GSLM) trainer (port of
``vae_gslm_tpu/trainers/speech/lvtr.py``).

beta-VAE weighting (``fixed_beta`` splits reconstruction against KLD),
the KLD zero/warm-up schedule by global step, loss = rec * scale +
(log_q * entropy_weight - log_p) * kld_weight + CE * token_kld_weight *
kld_weight, the optional encoder warm start from a compact checkpoint
with the encoder frozen, validation with reconstruction and
prior-continuation audio, compact checkpoints and the full state.
``run_step`` takes micro-batches stacked on a leading accumulation axis
(``training/trainer.py::stack_batches``), sums their gradients (the
losses are masked sums, as in the reference's repeated backward) and
takes one optimizer step under the policy of ``trainer.precision``.
Like the JAX ``run_step`` it leaves ``global_step`` to the caller
(``fit``).

Over ``W`` ranks each data row of ranks runs the step on its own rows.
JAX's loss is a token sum over the global batch, so the gradient is the
SUM over the data ranks of each row's summed micro-batch gradients, in
one all-reduce after accumulation (not the mean
``DistributedDataParallel`` takes; ``BaseTrainer.reduce_grads``, which
also sums the pipeline stages and reduce-scatters FSDP slices);
clipping, ``grad_norm`` and AdamW act on that sum, identically on every
rank of a slice.  The metrics are reduced the same way (token sums
summed, the others weighted by the global valid length), so every rank
logs the same numbers.  Each data row draws its noise from a generator
seeded by the seed and its data index, so its model and pipe ranks draw
alike.
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
from ...data.dataset import DiscreteTokenDataset, MelSpecDataset
from ...hparams.hp import Hparams
from ...inference.speech.sampler import ARTRSampler
from ...models.speech.lvtr import LVTR
from ...models.vocoder.vocoder import HiFiGAN
from ...training.checkpoint import load_compact
from ...training.optimizer import create_optimizer
from ...training.trainer import (RANK_SEED_STRIDE, BaseTrainer,
                                 bucket_pad_batch, fuse_microbatches,
                                 init_weights)

Draws = Dict[str, torch.Tensor]
_BATCH_KEYS = ("mel", "tokens", "cropped_mel_utt", "cropped_mel")
_SUM_KEYS = ("kld", "rec_loss", "token_kld", "length")
_FROZEN = ("encoder_net.", "encoder_head.")


class LVTRTrainer(BaseTrainer):
    """``hp.vocoder.path`` names a directory with the vocoder's
    ``hp.yaml``, from which the model's mel width and the datasets'
    feature settings are read; its weights are loaded when validation
    first renders audio.  Runs on CUDA unless ``device="cpu"``; a rank of
    a process group passes its own device (``parallel/mesh.py::
    rank_device``)."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
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
        self.voc_hp = Hparams.from_yamlfile(os.path.join(hp.vocoder.path,
                                                         "hp.yaml"))
        self.voc_hp.check_arg_in_hparams("model", "feature")
        self._vocoder: Optional[HiFiGAN] = None
        self.model = LVTR(hp.model, input_dim=self.voc_hp.feature.n_mels,
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
            self.hp_hubert = Hparams(deduplicate=False,
                                     sample_rate=hp.hubert.sample_rate)
        # optional encoder warm start (the reference's lvtr.py:57-64): the
        # compact checkpoint's weights, the encoder's gradients zeroed
        self.freeze_encoder = False
        init_from = hp.model.encoder.get("init_from_ckpt", None)
        if init_from is not None:
            load_compact(self.model, init_from)
            self.freeze_encoder = True
        self.names, self.params = zip(*self.model.named_parameters())
        self.place_params()
        self.opt, self.lr_schedule = create_optimizer(
            tr, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.fuse_accumulation = bool(tr.get("fuse_accumulation", False))
        self.rng = torch.Generator(self.device).manual_seed(
            seed + 1 + RANK_SEED_STRIDE * self.data_index)

    @property
    def vocoder(self) -> HiFiGAN:
        if self._vocoder is None:
            self._vocoder = HiFiGAN.from_pretrained(
                self.hp.vocoder.path, hp_rescale=self.mel_rescale,
                device=self.device)
        return self._vocoder

    # --------------------------------------------------------------- data
    def _make_dataset(self, hp_data: Hparams, name: str):
        feat = self.voc_hp.feature
        if self.use_tokens:
            return DiscreteTokenDataset(hp_data, feat, self.hp_hubert,
                                        self.mel_rescale, name=name,
                                        device=self.device)
        return MelSpecDataset(hp_data, feat, self.mel_rescale, name=name,
                              device=self.device)

    def train_dataloader(self):
        ds = self._make_dataset(self.hp.data.train, "train dataset")
        self.train_dataset = ds
        return self.get_dataloader(self.hp.data.train, ds)

    def val_dataloader(self):
        ds = self._make_dataset(self.hp.data.val, "validation dataset")
        self.val_dataset = ds
        self.val_mel_sample_rate = ds.melspec.sample_rate
        return self.get_dataloader(self.hp.data.val, ds)

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

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """The global batch's metrics from every rank's, in one
        all-reduce: token sums summed, the others weighted by each
        rank's valid length.  The same all-reduce sums the ranks'
        SIGTERM flags into ``_stop_agreed``."""
        keys = list(metrics)
        n = metrics["length"].float()
        vals = self.all_reduce_metrics(torch.stack(
            [metrics[k].float() if k in _SUM_KEYS
             else metrics[k].float() * n for k in keys]))
        total = vals[keys.index("length")]
        return {k: v if k in _SUM_KEYS else v / total
                for k, v in zip(keys, vals)}

    def train_step(self, stacked: Dict[str, Masked],
                   draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step over the stacked micro-batches (on the
        model's device): gradients summed over them and over the ranks,
        metrics aggregated as JAX does (token sums add up, the other
        statistics are weighted by each micro-batch's valid length).
        ``draws[i]`` replaces micro-batch ``i``'s random draws
        (``LVTR.forward``) and holds this rank's rows."""
        kld_weight = self._kld_weight(self.global_step)
        per_mb = self.backward_micro_batches(
            stacked, lambda mb, i: self._loss_fn(
                mb, kld_weight, self.rng, draws[i] if draws else None))
        n_mb = torch.stack([m["length"] for m in per_mb])
        metrics = {}
        for k in per_mb[0]:
            v = torch.stack([m[k] for m in per_mb])
            metrics[k] = (v.sum(0) if k in _SUM_KEYS
                          else (v * n_mb).sum(0) / n_mb.sum())
        grads = self.step_grads()
        if self.world_size > 1:
            grads = self.reduce_grads(grads)
            metrics = self._reduce_metrics(metrics)
        if self.freeze_encoder:
            for name, g in zip(self.names, grads):
                if g is not None and name.startswith(_FROZEN):
                    g.zero_()
        metrics["kld_weight"] = kld_weight
        metrics["grad_norm"] = self.grad_norm(grads)
        metrics["lr"] = self.lr_schedule(self.global_step)
        self.opt.step(grads, norm_fn=self.grad_norm)
        return metrics

    def prepare_batch(self, stacked: Dict[str, Any]) -> Dict[str, Masked]:
        """The step's keys, fused if ``fuse_accumulation``, on the
        model's device."""
        batch = {k: v for k, v in stacked.items() if k in _BATCH_KEYS}
        if self.fuse_accumulation:
            batch = fuse_microbatches(batch)
        return self.to_device(batch, _BATCH_KEYS)

    def run_step(self, stacked: Dict[str, Any],
                 draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step; ``kld``, ``rec_loss`` and ``token_kld``
        come back per valid token of the global batch."""
        batch = self.prepare_batch(stacked)
        with policy_scope(self.policy):
            metrics = self.train_step(batch, draws)
        n = metrics.pop("length")
        for k in ("kld", "rec_loss", "token_kld"):
            if k in metrics:
                metrics[k] = metrics[k] / n
        return metrics

    # ---------------------------------------------------------- validation
    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        """Token-sum losses per valid token over at most
        ``limit_val_batches`` batches (time padded to a multiple of 256),
        then audio from the first batch."""
        limit = self.hp.trainer.get("limit_val_batches", 50)
        loader = self.val_dataloader()
        totals: Dict[str, float] = {}
        length_total, n_batches, first = 0.0, 0, None
        with policy_scope(self.policy):
            for i, batch in enumerate(loader):
                if i >= limit:
                    break
                vb = self.to_device(bucket_pad_batch(
                    {k: v for k, v in batch.items() if k in _BATCH_KEYS}),
                    _BATCH_KEYS)
                _, m = self._loss_fn(vb, 1.0, self.rng)
                length_total += float(m["length"])
                for k in ("kld", "rec_loss", "token_kld"):
                    if k in m:
                        totals[k] = totals.get(k, 0.0) + float(m[k])
                n_batches += 1
                if first is None:
                    first = batch
        if self.logger is not None and n_batches:
            self.logger.log_scalars(
                {f"val/{k}": v / length_total for k, v in totals.items()},
                step)
        if first is not None:
            self._log_audio_samples(first, step)

    @torch.no_grad()
    def _log_audio_samples(self, batch, step: int) -> None:
        """Re-vocoded, reconstructed, shuffled-speaker and prior-
        continuation audio of the batch's first ``num_samples`` rows
        (the reference's ``lvtr.py:182-274``), the continuation through
        the port's hybrid sampler, all through the HiFi-GAN."""
        if self.logger is None:
            return
        hpl = self.hp.logging
        if hpl.plot_attn:
            raise NotImplementedError(
                "plot_attn draws the sampler's attention maps with JAX's "
                "inference/plots.py, which needs matplotlib; that module is "
                "not ported (ROADMAP.md, Queue 1 item 2)")
        num = min(hpl.num_samples, batch["mel"].value.shape[0])
        if num == 0:
            return
        dev, g = self.device, self.rng
        vocoder = self.vocoder

        def rows(key):
            x = batch[key]
            return Masked(x.value[:num].to(dev), x.lengths[:num].to(dev), 1)

        mel = rows("mel")
        model_input = mel
        if self.use_tokens:
            tok = rows("tokens")
            model_input = Masked(tok.value[..., None].float(), tok.lengths,
                                 1).cat(mel)
        with policy_scope(self.policy):
            u_c = None
            if self.model.utterance_net is not None:
                u_c = self.model.utterance_pool(self.model.utterance_net(
                    rows("cropped_mel_utt")))
            enc = self.model.encode(model_input, g)
            rec_audio = vocoder.decode(self.model.decode(enc, g, u_c=u_c))
            re_vocoded = vocoder.decode(mel)
            s_rec_audio = None
            if u_c is not None and num > 1:
                perm = torch.from_numpy(
                    np.random.RandomState(step).permutation(num)).to(dev)
                s_rec_audio = vocoder.decode(
                    self.model.decode(enc, g, u_c=u_c[perm]))
            prior_len = int(hpl.sample_prior_length
                            * self.val_mel_sample_rate)
            length = int(hpl.sample_length * self.val_mel_sample_rate
                         * self.model.sample_ratio)
            prior = Masked(model_input.value[:, :prior_len],
                           model_input.lengths.clamp(max=prior_len), 1)
            # a float KV cache, as JAX's trainer samples (kv_dtype None)
            samples = ARTRSampler(self.model, kv_dtype=None, device=dev)(
                length, prior, g, temperature=hpl.temperature)
            sampled_audio = vocoder.decode(samples["output"])
        sr = self.hp.data.train.sample_rate
        artifacts = [("re_vocoded", re_vocoded), ("reconstruct", rec_audio),
                     ("samples", sampled_audio)]
        if s_rec_audio is not None:
            artifacts.append(("shuffled_rec", s_rec_audio))
        for i in range(num):
            for tag, audio in artifacts:
                ln = int(audio.lengths[i])
                self.logger.log_audio(f"{tag}/{i}",
                                      audio.value[i, :ln].float().cpu()
                                      .numpy(), step, sr)
