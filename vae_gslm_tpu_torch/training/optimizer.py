"""Optimizer and learning-rate schedule (port of
``vae_gslm_tpu/training/optimizer.py``, which builds them from optax).

Adam or AdamW by identifier, the update order of the JAX optax chain:
optional clip by global norm, then (Adam) L2 added into the gradient
(coupled) or (AdamW) decoupled decay added to the Adam step, masked to
parameters with ``ndim != 1`` when norms and biases are excluded, then
the scheduled learning rate.  The schedule is the reference pipeline
warmup -> flat -> {linear_decay | triangle, constant, cosine(min_lr)} ->
optional ``finish_steps`` floor; like ``optax.join_schedules`` each
segment after a boundary is called with ``step - boundary``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..hparams.hp import Hparams


def make_schedule(hp: Hparams, total_steps: int, base_lr: float
                  ) -> Callable[[int], float]:
    """The reference scheduler pipeline as one function of the step."""
    hp.check_arg_in_hparams("identifier")
    schedules, boundaries, milestone = [], [], 0
    if hp.get("warmup_steps", 0) > 0:
        w = hp.warmup_steps
        schedules.append(lambda t: base_lr * t / max(1, w))
        milestone += w
        boundaries.append(milestone)
    if hp.has("flat_steps"):
        schedules.append(lambda t: base_lr)
        milestone += hp.flat_steps
        boundaries.append(milestone)
    if not total_steps > milestone:
        raise ValueError(f"total_steps {total_steps} must exceed the "
                         f"warmup and flat steps ({milestone})")
    main_steps = total_steps - milestone - hp.get("finish_steps", 0)
    ident = hp.identifier
    if ident in ("linear_decay", "triangle"):
        schedules.append(lambda t: base_lr * max(
            0.0, (main_steps - t) / main_steps))
    elif ident == "constant":
        schedules.append(lambda t: base_lr)
    elif ident == "cosine":
        min_lr = hp.get("min_lr", 0.0)
        schedules.append(lambda t: min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * min(t, main_steps) / main_steps)))
    else:
        raise NotImplementedError(ident)
    if hp.has("finish_steps"):
        # an absolute floor at min_lr, as in the JAX package
        if not hp.get("min_lr", 0):
            raise ValueError("finish_steps needs a nonzero min_lr")
        schedules.append(lambda t: hp.min_lr)
        milestone += main_steps
        boundaries.append(milestone)

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return float(out)

    return schedule


class AdamOptimizer:
    """Adam with optax's moment and bias-correction arithmetic, updating
    ``params`` in place.  ``step`` takes one gradient per parameter
    (None counts as zeros) and consumes one learning-rate step; its
    ``norm_fn`` gives the clipping norm of the gradients (``global_norm``
    by default; a trainer whose ranks hold slices passes its own)."""

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, decoupled: bool,
                 decay_mask: Sequence[bool],
                 clip_norm: Optional[float] = None):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.decoupled = weight_decay, decoupled
        self.decay_mask = list(decay_mask)
        self.clip_norm = clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _decay(self, updates: List[torch.Tensor]) -> None:
        ups = [u for u, m in zip(updates, self.decay_mask) if m]
        ps = [p for p, m in zip(self.params, self.decay_mask) if m]
        if ups:
            torch._foreach_add_(ups, ps, alpha=self.weight_decay)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             norm_fn: Optional[Callable] = None) -> None:
        g = [torch.zeros_like(p) if x is None else x.detach().clone()
             for p, x in zip(self.params, grads)]
        if self.clip_norm is not None:
            norm = float((norm_fn or global_norm)(g))
            if not norm < self.clip_norm:
                torch._foreach_div_(g, norm)
                torch._foreach_mul_(g, self.clip_norm)
        if self.weight_decay and not self.decoupled:
            self._decay(g)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        updates = torch._foreach_div(mu_hat, nu_hat)
        if self.weight_decay and self.decoupled:
            self._decay(updates)
        lr = self.schedule(self.count - 1)
        torch._foreach_add_(self.params, updates, alpha=-lr)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (float32)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def create_optimizer(hp: Hparams, total_steps: int,
                     params: Sequence[torch.Tensor]
                     ) -> Tuple[AdamOptimizer, Callable[[int], float]]:
    """(optimizer over ``params``, schedule) from an ``hp.training``
    block."""
    hp.check_arg_in_hparams("optimizer", "scheduler")
    ohp = hp.optimizer
    ohp.check_arg_in_hparams("identifier", "lr", "beta1", "beta2")
    schedule = make_schedule(hp.scheduler, total_steps, ohp.lr)
    params = list(params)
    exclude = ohp.get("exclude_norm_and_bias_from_weight_decay", False)
    mask = [p.dim() != 1 or not exclude for p in params]
    if ohp.identifier == "Adam":
        wd, decoupled = ohp.get("weight_decay", 0.0), False
    elif ohp.identifier == "AdamW":
        wd, decoupled = ohp.get("weight_decay", 0.01), True
    else:
        raise NotImplementedError(ohp.identifier)
    opt = AdamOptimizer(params, schedule, ohp.beta1, ohp.beta2,
                        ohp.get("eps", 1e-8), wd, decoupled, mask,
                        clip_norm=hp.get("gradient_clip_val", None))
    return opt, schedule
