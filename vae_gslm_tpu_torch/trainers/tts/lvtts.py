"""LVTTS (text-to-speech) trainer (port of
``vae_gslm_tpu/trainers/tts/lvtts.py``).

The loss of a micro-batch is rec * ``rec_loss_scale`` + KLD + the EOS
BCE (``core/losses.py::eos_loss``), plus InfoNCE * its weight when
``training.infoNCE`` is set (JAX's variant: the posterior's samples
against the detached ``sample_q``; its module rides on the model as
``infoNCE``, so the checkpoint carries it).  ``run_step`` takes
micro-batches stacked on a leading accumulation axis, sums their
gradients (and, over ranks, the ranks') and takes one optimizer step
under the policy of ``trainer.precision`` (``16-mixed``: the trunk's
causal self-attention through K3/K3b in bfloat16 on the card; the text
encoder and the cross-attention are dense).  Like JAX's, the returned
metrics are the last micro-batch's, ``kld`` and ``rec_loss`` per valid
frame.  Validation logs the losses per valid frame and renders the first
batch's re-vocoded, reconstructed and sampled audio (``ARTRTTSSampler``)
through the HiFi-GAN of ``hp.vocoder.path``, loaded from that local
directory; ``plot_attn`` raises (it needs matplotlib).  The text symbol
table comes from the training set and is saved beside every checkpoint
as ``symbols.json``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import torch

from ...core.device import resolve_device
from ...core.losses import eos_loss, masked_loss
from ...core.masked import Masked
from ...core.precision import policy_for_precision, policy_scope
from ...data.dataset import MelSpecDataset
from ...hparams.hp import Hparams
from ...inference.tts.sampler import ARTRTTSSampler
from ...models.tts.lvtr import LVTTS
from ...models.vocoder.vocoder import HiFiGAN
from ...nn.contrastive import InfoNCE
from ...parallel import mesh
from ...training.checkpoint import save_compact
from ...training.optimizer import create_optimizer
from ...training.trainer import (RANK_SEED_STRIDE, BaseTrainer,
                                 fuse_microbatches, init_weights)

Draws = Dict[str, torch.Tensor]
_BATCH_KEYS = ("mel", "text", "cropped_mel")


class LVTTSTrainer(BaseTrainer):
    """``hp.vocoder.path`` names a directory with the vocoder's
    ``hp.yaml`` (the mel width and the datasets' feature settings) and
    weights.  Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
        hp.check_arg_in_hparams("vocoder", "training", "trainer", "logging")
        hp.vocoder.check_arg_in_hparams("path")
        hp.logging.check_arg_in_hparams("num_samples", "temperature",
                                        "max_sample_length",
                                        "min_sample_length", "plot_attn")
        tr = hp.training
        self.mel_rescale = None
        if tr.has("mel_rescale"):
            tr.mel_rescale.check_arg_in_hparams("mean", "std")
            self.mel_rescale = tr.mel_rescale
        self.voc_hp = Hparams.from_yamlfile(os.path.join(hp.vocoder.path,
                                                         "hp.yaml"))
        self.voc_hp.check_arg_in_hparams("model", "feature")
        self._vocoder: Optional[HiFiGAN] = None
        self.train_dataset = MelSpecDataset(
            hp.data.train, self.voc_hp.feature, self.mel_rescale,
            name="train dataset", device=self.device)
        self.symbols = self.train_dataset.symbols
        self.model = LVTTS(hp.model, self.symbols,
                           input_dim=self.voc_hp.feature.n_mels,
                           device=self.device,
                           generator=torch.Generator(
                               self.device).manual_seed(seed))
        self.infoNCE_weight = 1.0
        if tr.has("infoNCE"):
            with torch.device(self.device):
                self.model.infoNCE = InfoNCE(
                    tr.infoNCE, hp.model.latent_dim, hp.model.latent_dim,
                    torch.Generator(self.device).manual_seed(seed + 7))
            self.infoNCE_weight = tr.infoNCE.get("weight", 1.0)
        init_weights(self.model, tr.get("init_std", 1.0),
                     torch.Generator(self.device).manual_seed(seed))
        self.rec_loss_scale = tr.get("rec_loss_scale", 1.0)
        self.sampler = ARTRTTSSampler(self.model, device=self.device)
        self.names, self.params = zip(*self.model.named_parameters())
        mesh.replicate(self.params)
        self.opt, self.lr_schedule = create_optimizer(
            tr, hp.trainer.total_steps, self.params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.fuse_accumulation = bool(tr.get("fuse_accumulation", False))
        self.rng = torch.Generator(self.device).manual_seed(
            seed + 1 + RANK_SEED_STRIDE * self.rank)

    @property
    def vocoder(self) -> HiFiGAN:
        if self._vocoder is None:
            self._vocoder = HiFiGAN.from_pretrained(
                self.hp.vocoder.path, hp_rescale=self.mel_rescale,
                device=self.device)
        return self._vocoder

    # --------------------------------------------------------------- data
    def train_dataloader(self):
        return self.get_dataloader(self.hp.data.train, self.train_dataset)

    def val_dataloader(self):
        ds = MelSpecDataset(self.hp.data.val, self.voc_hp.feature,
                            self.mel_rescale, name="validation dataset",
                            device=self.device)
        ds.symbols = self.symbols
        self.val_mel_sample_rate = ds.melspec.sample_rate
        return self.get_dataloader(self.hp.data.val, ds)

    # --------------------------------------------------------------- step
    def _loss_fn(self, batch: Dict[str, Masked],
                 generator: Optional[torch.Generator],
                 draws: Optional[Draws] = None, nce_r=None):
        """(loss, metrics) of one micro-batch; the metrics are detached
        sums.  ``draws`` replaces the forward's draws (``LVTR.forward``),
        ``nce_r`` InfoNCE's subset draw."""
        model = self.model
        out = model(batch["mel"], generator, text=batch["text"],
                    spkr=batch["cropped_mel"], draws=draws)
        kld = masked_loss(out["log_q"], out["log_p"], fn=lambda x, y: x - y)
        rec = out["rec_loss"]
        e_loss = eos_loss(out["eos"])
        loss = rec * self.rec_loss_scale + kld + e_loss
        metrics = {"kld": kld, "rec_loss": rec, "eos_loss": e_loss,
                   "length": out["log_p"].lengths.sum()}
        if getattr(model, "infoNCE", None) is not None:
            sq = out["sample_q"]
            nce = model.infoNCE(out["q_z"].sample,
                                Masked(sq.value.detach(), sq.lengths, 1),
                                generator, r=nce_r)
            loss = loss + nce * self.infoNCE_weight
            metrics["infoNCE"] = nce
        return loss, {k: v.detach() for k, v in metrics.items()}

    def prepare_batch(self, stacked: Dict[str, Any]) -> Dict[str, Masked]:
        """The step's keys, fused if ``fuse_accumulation``, on the
        model's device."""
        batch = {k: v for k, v in stacked.items() if k in _BATCH_KEYS}
        if self.fuse_accumulation:
            batch = fuse_microbatches(batch)
        return self.to_device(batch, _BATCH_KEYS)

    def run_step(self, stacked: Dict[str, Any],
                 draws: Optional[List[Draws]] = None) -> Dict[str, Any]:
        """One optimizer step; ``kld`` and ``rec_loss`` come back per
        valid frame of the last micro-batch.  ``draws[i]`` replaces
        micro-batch ``i``'s draws."""
        batch = self.prepare_batch(stacked)
        with policy_scope(self.policy):
            metrics = self.step_micro_batches(
                batch, lambda mb, i: self._loss_fn(
                    mb, self.rng, draws[i] if draws else None))
        n = metrics.pop("length")
        for k in ("kld", "rec_loss"):
            metrics[k] = metrics[k] / n
        return metrics

    # ---------------------------------------------------------- validation
    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        """The losses per valid frame over at most ``limit_val_batches``
        batches, then the first batch's audio."""
        if self.logger is None:
            return
        limit = self.hp.trainer.get("limit_val_batches", 8)
        totals: Dict[str, float] = {}
        length, first = 0.0, None
        with policy_scope(self.policy):
            for i, batch in enumerate(self.val_dataloader()):
                if i >= limit:
                    break
                _, m = self._loss_fn(self.to_device(batch, _BATCH_KEYS),
                                     self.rng)
                length += float(m["length"])
                for k in ("kld", "rec_loss"):
                    totals[k] = totals.get(k, 0.0) + float(m[k])
                if first is None:
                    first = batch
            if length:
                self.logger.log_scalars(
                    {f"val/{k}": v / length for k, v in totals.items()},
                    step)
            if first is not None:
                self._log_audio_samples(first, step)

    def _log_audio_samples(self, batch, step: int) -> None:
        """Re-vocoded, reconstructed (posterior sample through the
        diffusion decoder) and sampled audio of the batch's first
        ``num_samples`` rows (the reference's ``lvtts.py:156-208``)."""
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
        rows = {k: Masked(batch[k].value[:num].to(dev),
                          batch[k].lengths[:num].to(dev, torch.int32), 1)
                for k in _BATCH_KEYS}
        mel, text, spkr = rows["mel"], rows["text"], rows["cropped_mel"]
        vocoder = self.vocoder
        out = self.model(mel, g, text=text, spkr=spkr)
        rec_audio = vocoder.decode(self.model.decode(out["sample_q"], g))
        re_vocoded = vocoder.decode(mel)
        rate = self.val_mel_sample_rate * self.model.sample_ratio
        samples = self.sampler(
            text, spkr, g, max_frames=int(hpl.max_sample_length * rate),
            min_frames=int(hpl.min_sample_length * rate),
            temperature=hpl.temperature,
            eos_threshold=hpl.get("eos_threshold", 0.5))
        sampled_audio = vocoder.decode(samples["output"])
        sr = self.hp.data.train.sample_rate
        for i in range(num):
            for tag, audio in (("re_vocoded", re_vocoded),
                               ("reconstruct", rec_audio),
                               ("samples", sampled_audio)):
                ln = int(audio.lengths[i])
                self.logger.log_audio(f"{tag}/{i}", audio.value[i, :ln]
                                      .float().cpu().numpy(), step, sr)

    # -------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str) -> None:
        """The compact npz, with ``hp.yaml`` and ``symbols.json`` beside
        it and in the logger's checkpoint directory."""
        save_compact(self.model, path)
        dirs = {os.path.dirname(path)}
        if self.logger is not None:
            dirs.add(self.logger.ckpt_path)
        for d in dirs:
            self.hp.save(os.path.join(d, "hp.yaml"))
            self.symbols.save(os.path.join(d, "symbols.json"))
