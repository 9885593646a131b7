"""Masked sequence losses (port of ``vae_gslm_tpu/core/losses.py``).

The reference's order: the elementwise loss is averaged over channels,
summed over time, then optionally reduced over time and/or batch.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .masked import Masked

Tensor = torch.Tensor


def masked_loss(x: Masked, y: Masked, fn: Callable[[Tensor, Tensor], Tensor],
                time_reduction: bool = False, batch_reduction: bool = False,
                batch_weight: Optional[Tensor] = None) -> Tensor:
    """Per-example ``fn(x, y).mean(channels).sum(time)``, then: time and
    batch ``sum / total length``; time only ``(per_example /
    length).mean()``; batch only ``per_example.mean()``; neither
    ``per_example.sum()``."""
    a = x.flatten().apply_mask().value
    b = y.flatten().apply_mask().value
    out = fn(a, b).mean(-1).sum(-1)
    if batch_weight is not None:
        out = out * batch_weight
    lengths = x.lengths
    if time_reduction and batch_reduction:
        return out.sum() / lengths.sum()
    if time_reduction:
        return (out / lengths).mean()
    if batch_reduction:
        return out.mean()
    return out.sum()


def masked_l1_loss(x: Masked, y: Masked, **kw) -> Tensor:
    return masked_loss(x, y, lambda a, b: (a - b).abs(), **kw)


def masked_l2_loss(x: Masked, y: Masked, **kw) -> Tensor:
    return masked_loss(x, y, lambda a, b: (a - b).square(), **kw)


def masked_ce_loss(logits: Masked, labels: Masked,
                   reduction: str = "sum") -> Tensor:
    """Token cross-entropy over valid positions (float32 log-softmax)."""
    logp = F.log_softmax(logits.value.float(), dim=-1)
    nll = -logp.gather(-1, labels.value.long()[..., None])[..., 0]
    mask = labels.mask()
    nll = torch.where(mask, nll, torch.zeros((), device=nll.device))
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.sum() / mask.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction}")
