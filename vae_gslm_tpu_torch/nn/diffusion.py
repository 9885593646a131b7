"""Gaussian diffusion decoder (port of ``vae_gslm_tpu/nn/diffusion.py``):
the training loss and the samplers.

Schedules are computed in float64 with numpy and stored float32, as in
the JAX package.  The JAX ``lax.scan`` samplers become Python loops;
the per-step DDIM coefficients are computed on the host in float32.
Noise comes from an explicit ``torch.Generator``: one ``randn`` of the
image shape per sampling step, drawn even where eta makes it unused;
the training loss draws the step ``t`` per example, then the noise.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.losses import masked_l1_loss, masked_l2_loss
from ..core.masked import Masked
from ..hparams.hp import Hparams


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


def scaled_linear_beta_schedule(timesteps: int, hp: Hparams) -> np.ndarray:
    beta_start = hp.get("beta_start", 0.0015)
    beta_end = hp.get("beta_end", 0.0195)
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps,
                       dtype=np.float64) ** 2


def cosine_beta_schedule(timesteps: int, hp: Hparams) -> np.ndarray:
    s = hp.get("s", 0.008)
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


def _schedule(betas: np.ndarray) -> dict:
    """float32 schedule buffers (reference ``ddpm.py:186-218``): all
    eleven of the JAX package's ``DiffusionSchedule``, whose sorted stack
    is its checkpoint's ``schedule`` variable."""
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return {k: v.astype(np.float32) for k, v in dict(
        betas=betas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        posterior_variance=post_var,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
        posterior_log_variance_clipped=np.log(np.clip(post_var, 1e-20,
                                                      None)),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas)
        / (1.0 - ac)).items()}


def _extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = buf[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


class GaussianDiffusion1D(nn.Module):
    """Diffusion wrapper around a conditional denoiser
    ``model(x_t: Masked, t: (B,), cond: Masked) -> Masked``."""

    def __init__(self, model: nn.Module, hp: Hparams):
        super().__init__()
        self.model = model
        self.objective = hp.get("objective", "pred_noise")
        self.loss_type = hp.get("loss_type", "l1")
        self.clamp_range = hp.get("clamp_range", [-1, 1])
        self.ddim_sampling_eta = hp.get("ddim_sampling_eta", 1.0)
        ident = hp.beta_schedule.identifier
        if ident == "linear":
            betas = linear_beta_schedule(hp.timesteps)
        elif ident == "scaled_linear":
            betas = scaled_linear_beta_schedule(hp.timesteps,
                                                hp.beta_schedule)
        elif ident == "cosine":
            betas = cosine_beta_schedule(hp.timesteps, hp.beta_schedule)
        else:
            raise ValueError(f"unknown beta schedule {ident}")
        self.num_timesteps = int(betas.shape[0])
        self.sampling_timesteps = hp.get("sampling_timesteps",
                                         None) or self.num_timesteps
        if self.sampling_timesteps > self.num_timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self._host = _schedule(betas)
        for name, buf in self._host.items():
            self.register_buffer(name, torch.tensor(buf),
                                 persistent=False)

    def override_sampling(self, sampling_timesteps: Optional[int] = None,
                          ddim_sampling_eta: Optional[float] = None):
        """Inference overrides (``speech/inferer.py:54-67``)."""
        if sampling_timesteps is not None:
            self.sampling_timesteps = sampling_timesteps
        if ddim_sampling_eta is not None:
            self.ddim_sampling_eta = ddim_sampling_eta

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.num_timesteps

    def model_predictions(self, x: Masked, t: torch.Tensor,
                          cond: Masked) -> Tuple[Masked, Masked]:
        out = self.model(x, t, cond)
        xv, ov = x.value.float(), out.value.float()
        nd = xv.dim()
        if self.objective == "pred_noise":
            pred_noise = ov
            x_start = (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * xv
                       - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)
                       * ov)
        elif self.objective == "pred_x0":
            x_start = ov
            pred_noise = ((_extract(self.sqrt_recip_alphas_cumprod, t, nd)
                           * xv - ov)
                          / _extract(self.sqrt_recipm1_alphas_cumprod, t,
                                     nd))
        else:
            raise ValueError(self.objective)
        mk = lambda v: Masked(v, out.lengths, 1).apply_mask()  # noqa: E731
        return mk(pred_noise), mk(x_start)

    # -- training ----------------------------------------------------------
    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        nd = x_start.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd)
                * noise)

    @property
    def loss_fn(self):
        if self.loss_type == "l1":
            return masked_l1_loss
        if self.loss_type == "l2":
            return masked_l2_loss
        raise ValueError(f"invalid loss type {self.loss_type}")

    def p_losses(self, x_start: Masked, t: torch.Tensor, cond: Masked,
                 noise: torch.Tensor) -> torch.Tensor:
        x = self.q_sample(x_start.value.float(), t, noise)
        x = Masked(x, x_start.lengths, 1).apply_mask()
        model_out = self.model(x, t, cond)
        if self.objective == "pred_noise":
            target = Masked(noise, x_start.lengths, 1).apply_mask()
        else:
            target = x_start
        return self.loss_fn(model_out, target)

    def forward(self, img: Masked, cond: Masked,
                generator: Optional[torch.Generator],
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The summed masked training loss at a uniform random step per
        example.  ``t`` (B,) and ``noise`` (the image's shape) replace
        the draws from ``generator``, which are taken in that order."""
        dev = img.value.device
        b = img.value.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(img.value.shape, generator=generator,
                                device=dev)
        return self.p_losses(img, t.to(dev), cond, noise.to(dev).float())

    # -- sampling ----------------------------------------------------------
    def _clamp(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(self.clamp_range[0], self.clamp_range[1])

    def ddim_sample(self, start: Masked, cond: Masked,
                    generator: Optional[torch.Generator]) -> Masked:
        """DDIM with eta (reference ``ddpm.py:284-321``): times from
        an int64 cast of ``linspace(-1, T-1, steps+1)``; the last step
        returns ``x_start``; the mask is reapplied every step."""
        total, steps = self.num_timesteps, self.sampling_timesteps
        eta = np.float32(self.ddim_sampling_eta)
        times = np.linspace(-1, total - 1, steps + 1).astype(np.int64)
        times = list(reversed(times.tolist()))
        ac = self._host["alphas_cumprod"]
        one = np.float32(1.0)
        img = start.value.float()
        mask = start.expanded_mask()
        b = img.shape[0]
        for time, time_next in zip(times[:-1], times[1:]):
            t_b = torch.full((b,), time, dtype=torch.int32,
                             device=img.device)
            pred_noise, x_start = self.model_predictions(
                Masked(img, start.lengths, 1), t_b, cond)
            xs = Masked(self._clamp(x_start.value), start.lengths,
                        1).apply_mask().value
            alpha = ac[time]
            alpha_next = ac[time_next] if time_next >= 0 else one
            sigma = eta * np.sqrt(np.maximum(
                (one - alpha / alpha_next) * (one - alpha_next)
                / (one - alpha), np.float32(0.0)))
            c = np.sqrt(np.maximum(one - alpha_next - sigma ** 2,
                                   np.float32(0.0)))
            noise = torch.randn(img.shape, generator=generator,
                                device=img.device)
            if time_next < 0:
                img = xs
            else:
                img = (xs * float(np.sqrt(alpha_next))
                       + float(c) * pred_noise.value
                       + float(sigma) * noise)
            img = torch.where(mask, img, torch.zeros((), device=img.device))
        return Masked(img, start.lengths, 1)

    def p_sample_loop(self, start: Masked, cond: Masked,
                      generator: Optional[torch.Generator]) -> Masked:
        """Strided ancestral sampler (reference ``ddpm.py:266-282``)."""
        stride = self.num_timesteps // self.sampling_timesteps
        img = start.value.float()
        mask = start.expanded_mask()
        b, nd = img.shape[0], img.dim()
        for t in reversed(range(0, self.num_timesteps, stride)):
            t_b = torch.full((b,), t, dtype=torch.int32, device=img.device)
            _, x_start = self.model_predictions(
                Masked(img, start.lengths, 1), t_b, cond)
            xs = self._clamp(x_start.value)
            mean = (_extract(self.posterior_mean_coef1, t_b, nd) * xs
                    + _extract(self.posterior_mean_coef2, t_b, nd) * img)
            logvar = _extract(self.posterior_log_variance_clipped, t_b, nd)
            noise = torch.randn(img.shape, generator=generator,
                                device=img.device)
            if t == 0:
                noise = torch.zeros_like(noise)
            img = mean + torch.exp(0.5 * logvar) * noise
            img = torch.where(mask, img, torch.zeros((), device=img.device))
        return Masked(img, start.lengths, 1)

    def sample(self, start: Masked, cond: Masked,
               generator: Optional[torch.Generator]) -> Masked:
        if self.is_ddim_sampling:
            return self.ddim_sample(start, cond, generator)
        return self.p_sample_loop(start, cond, generator)
