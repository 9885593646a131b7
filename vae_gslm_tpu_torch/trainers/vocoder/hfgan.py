"""HiFi-GAN GAN trainer (port of ``vae_gslm_tpu/trainers/vocoder/hfgan.py``).

Two Adam optimizers, the generator's and the discriminators' (MPD plus
MSD or MRD), each on a schedule over ``total_steps // 2``: ``fit``'s
``global_step`` counts one ``run_step``, which holds one step of each.
A step, in JAX's order: the log-mel of the audio (``data/features.py``,
the DFT-basis STFT, differentiable), y_hat = G(mel); the D step (the
LSGAN loss on the real wave and on a detached y_hat; the real feature
maps of this pass kept, detached) and its Adam update; then the G step
against the UPDATED discriminators: LSGAN generator loss, feature loss
against the kept real maps, and the masked L1 between the log-mels of
y_hat and of the audio times ``mel_loss_weight``, then the G update.
JAX recomputes G(mel) inside its G loss; the generator's parameters do
not change between the two uses, so the port keeps one forward's graph.

Over ``W`` ranks each rank takes its own rows.  JAX's losses are means
over the global batch, so each gradient set is summed over the ranks in
one flat all-reduce and divided by ``W``: two all-reduces a step.  The
mel loss is a sum over the valid frames of the global batch divided by
their count, which rides the D step's all-reduce, so the result is the
global loss for any lengths.  The metrics and the ranks' SIGTERM flags
ride the same two all-reduces.

The weights are drawn on the CPU from ``seed`` (the generator) and
``seed + 1`` (the discriminators), then moved to the trainer's device,
so the card and the CPU start from the same weights.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.losses import masked_l1_loss
from ...core.masked import Masked
from ...core.precision import policy_for_precision, policy_scope
from ...data.dataset import StandardDataset
from ...data.features import MelSpecFeatureProcessor
from ...hparams.hp import Hparams
from ...models.vocoder.hfgan import (Generator, MultiPeriodDiscriminator,
                                     MultiResolutionDiscriminator,
                                     MultiScaleDiscriminator,
                                     discriminator_loss, feature_loss,
                                     generator_loss)
from ...parallel import mesh
from ...training.checkpoint import load_compact, save_compact
from ...training.optimizer import AdamOptimizer, create_optimizer
from ...training.trainer import BaseTrainer

METRICS = ("mel", "G", "feature", "D")


class _Discriminators(nn.Module):
    """MPD plus MSD (``model.msd`` set) or MRD, under JAX's attribute names
    (``mpd``, ``msrd``)."""

    def __init__(self, hp: Hparams, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(hp.model.mpd, device, generator)
        if hp.model.get("msd", False):
            self.msrd = MultiScaleDiscriminator(hp.model.msd, device,
                                                generator)
        else:
            hp.model.check_arg_in_hparams("mrd")
            self.msrd = MultiResolutionDiscriminator(hp.model.mrd, device,
                                                     generator)

    def forward(self, wave: torch.Tensor):
        f_out, f_fmap = self.mpd(wave)
        s_out, s_fmap = self.msrd(wave)
        return f_out, f_fmap, s_out, s_fmap


def _detached(maps):
    return [[m.detach() for m in d] for d in maps]


class HiFiGANTrainer(BaseTrainer):
    """Runs on CUDA unless ``device="cpu"``; a rank of a process group
    passes its own device (``parallel/mesh.py::rank_device``)."""

    def __init__(self, hp: Hparams, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(hp)
        self.device = resolve_device(device)
        hp.model.check_arg_in_hparams("mpd", "generator")
        hp.training.check_arg_in_hparams("generator", "discriminator",
                                         "mel_loss_weight")
        hp.check_arg_in_hparams("logging", "feature")
        self.generator = Generator(
            hp.model.generator, device="cpu",
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.disc = _Discriminators(
            hp, device="cpu",
            generator=torch.Generator().manual_seed(seed + 1)).to(self.device)
        self.features = MelSpecFeatureProcessor(hp.feature,
                                                device=self.device)
        self.g_names, self.g_params = zip(*self.generator.named_parameters())
        self.d_names, self.d_params = zip(*self.disc.named_parameters())
        mesh.replicate(self.g_params + self.d_params)
        self.half_steps = hp.trainer.total_steps // 2
        self.opt_g, self.sched_g = create_optimizer(
            hp.training.generator, self.half_steps, self.g_params)
        self.opt_d, self.sched_d = create_optimizer(
            hp.training.discriminator, self.half_steps, self.d_params)
        self.policy = policy_for_precision(hp.trainer.get("precision",
                                                          "32"))
        self.mel_loss_weight = float(hp.training.mel_loss_weight)

    # --------------------------------------------------------------- data
    def train_dataloader(self):
        ds = StandardDataset(self.hp.data.train, name="train dataset")
        return self.get_dataloader(self.hp.data.train, ds)

    def val_dataloader(self):
        ds = StandardDataset(self.hp.data.val, name="validation dataset")
        return self.get_dataloader(self.hp.data.val, ds)

    # --------------------------------------------------------------- step
    def _encode_mel(self, audio: Masked) -> Masked:
        """The log-mel of a wave, with gradients (JAX :99-102)."""
        return self.features.encode(audio)

    def _audio(self, audio: Masked) -> Masked:
        return Masked(audio.value.to(self.device, torch.float32),
                      audio.lengths.to(self.device, torch.int32), 1)

    def train_step(self, audio: Masked) -> Dict[str, torch.Tensor]:
        """One D step and one G step on ``audio`` (this rank's rows, on
        the device); each parameter's ``grad`` is left holding the
        gradient its optimizer took."""
        w = self.world_size
        mel = self._encode_mel(audio)
        y_hat = self.generator(mel)
        y_hat_mel = self._encode_mel(y_hat)
        # ---- D step; the real feature maps are kept from before the
        # update, detached
        f_r, fmap_f_r, s_r, fmap_s_r = self.disc(audio.value)
        f_g, _, s_g, _ = self.disc(y_hat.value.detach())
        d_loss = discriminator_loss(f_r, f_g) + discriminator_loss(s_r, s_g)
        d_grads = list(torch.autograd.grad(d_loss, self.d_params))
        fmaps_r = (_detached(fmap_f_r), _detached(fmap_s_r))
        del f_r, fmap_f_r, s_r, fmap_s_r, f_g, s_g
        stats = torch.stack([d_loss.detach(),
                             y_hat_mel.lengths.sum().float()])
        mesh.all_reduce_sum(d_grads + [stats])
        d_metric, frames = stats[0] / w, stats[1]
        self._apply(self.opt_d, self.d_params, d_grads)
        # ---- G step against the updated discriminators
        f_g, fmap_f_g, s_g, fmap_s_g = self.disc(y_hat.value)
        loss_fm = (feature_loss(fmaps_r[0], fmap_f_g)
                   + feature_loss(fmaps_r[1], fmap_s_g))
        loss_gen = generator_loss(f_g) + generator_loss(s_g)
        # this rank's share of sum |mel diff| / frames of the global batch,
        # times W: the all-reduce's sum over ranks divided by W is the
        # global masked L1 (time and batch reduction)
        loss_mel = masked_l1_loss(y_hat_mel, mel) * w / frames
        total = loss_gen + loss_fm + loss_mel * self.mel_loss_weight
        g_grads = list(torch.autograd.grad(total, self.g_params))
        vals = torch.stack([loss_mel.detach(), loss_gen.detach(),
                            loss_fm.detach(),
                            loss_mel.new_tensor(float(self._preempted))])
        mesh.all_reduce_sum(g_grads + [vals])
        self._stop_agreed = bool(vals[3] > 0)
        self._apply(self.opt_g, self.g_params, g_grads)
        return {"mel": vals[0] / w, "G": vals[1] / w,
                "feature": vals[2] / w, "D": d_metric}

    def _apply(self, opt: AdamOptimizer, params: Sequence[nn.Parameter],
               grads: List[torch.Tensor]) -> None:
        if self.world_size > 1:
            torch._foreach_div_(grads, float(self.world_size))
        for p, g in zip(params, grads):
            p.grad = g
        opt.step(grads)

    def run_step(self, stacked_batch: Dict[str, Any]) -> Dict[str, Any]:
        """One G+D step on the batch's ``audio`` (the stacked axis
        collapsed: GAN training has no accumulation), under the policy of
        ``trainer.precision``."""
        audio = stacked_batch["audio"]
        audio = self._audio(Masked(
            audio.value.reshape((-1,) + tuple(audio.value.shape[2:])),
            audio.lengths.reshape(-1), 1))
        with policy_scope(self.policy):
            return self.train_step(audio)

    # ---------------------------------------------------------- validation
    @torch.no_grad()
    def validation_run(self, step: int) -> None:
        """The mel L1 over at most ``limit_val_batches`` batches, and the
        first ``num_samples`` original and reconstructed clips."""
        if self.logger is None:
            return
        limit = self.hp.trainer.get("limit_val_batches", 8)
        num_samples = self.hp.logging.num_samples
        sr = self.hp.data.train.sample_rate
        total, count, logged = 0.0, 0, 0
        with policy_scope(self.policy):
            for i, batch in enumerate(self.val_dataloader()):
                if i >= limit:
                    break
                audio = self._audio(batch["audio"])
                mel = self._encode_mel(audio)
                y_hat = self.generator(mel)
                total += float(masked_l1_loss(
                    self._encode_mel(y_hat), mel, time_reduction=True,
                    batch_reduction=True))
                count += 1
                while logged < num_samples and logged < len(audio.value):
                    for tag, wave in (("original", audio.value),
                                      ("reconstruct", y_hat.value)):
                        self.logger.log_audio(
                            f"{tag}/{logged}",
                            wave[logged].float().cpu().numpy(), step, sr)
                    logged += 1
        if count:
            self.logger.log_scalar("val/mel", total / count, step)

    # ------------------------------------------------ state and checkpoints
    def _sets(self):
        return (("g", self.g_names, self.g_params, self.opt_g),
                ("d", self.d_names, self.d_params, self.opt_d))

    def _train_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"step": self.global_step}
        for key, names, params, opt in self._sets():
            state[f"{key}_params"] = dict(zip(names, params))
            state[f"opt_{key}"] = {"mu": dict(zip(names, opt.mu)),
                                   "nu": dict(zip(names, opt.nu)),
                                   "count": opt.count}
        return state

    @torch.no_grad()
    def _apply_train_state(self, state: Dict[str, Any]) -> None:
        """Load a full state strictly: both parameter sets and both
        optimizers' moments and counts, then the step."""
        for key, names, params, opt in self._sets():
            opt_state = state[f"opt_{key}"]
            for what, got, dst in ((f"{key}_params", state[f"{key}_params"],
                                    params),
                                   (f"opt_{key}.mu", opt_state["mu"],
                                    opt.mu),
                                   (f"opt_{key}.nu", opt_state["nu"],
                                    opt.nu)):
                if sorted(got) != sorted(names):
                    raise ValueError(
                        f"full state's {what} names differ from the "
                        f"model's: missing {sorted(set(names) - set(got))[:5]}"
                        f", extra {sorted(set(got) - set(names))[:5]}")
                for name, t in zip(names, dst):
                    if got[name].shape != t.shape:
                        raise ValueError(
                            f"full state's {what}[{name}] has shape "
                            f"{tuple(got[name].shape)}, the model "
                            f"{tuple(t.shape)}")
                    t.copy_(got[name])
            opt.count = int(opt_state["count"])
        self.global_step = int(state["step"])

    def resume(self, path: str) -> None:
        """From a compact npz: the generator only (the reference compact
        contract holds no discriminator), its optimizer started afresh,
        the discriminators and their optimizer kept; or the port's full
        state (both sets and both optimizers, exact)."""
        if not path.endswith(".npz"):
            self.restore_full_state(path)
            return
        load_compact(self.generator, path)
        mesh.replicate(self.g_params)
        self.opt_g, self.sched_g = create_optimizer(
            self.hp.training.generator, self.half_steps, self.g_params)

    def save_checkpoint(self, path: str) -> None:
        """The generator's compact npz (JAX's contract, weight-norm g/v)
        and ``hp.yaml`` beside it and in the logger's checkpoint
        directory, so the directory loads as ``HiFiGAN.from_pretrained``."""
        save_compact(self.generator, path)
        if self.logger is not None:
            self.hp.save(os.path.join(self.logger.ckpt_path, "hp.yaml"))
        self.hp.save(os.path.join(os.path.dirname(path), "hp.yaml"))
