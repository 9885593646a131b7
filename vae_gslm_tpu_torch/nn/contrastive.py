"""Contrastive losses: InfoNCE and CPC (port of
``vae_gslm_tpu/nn/contrastive.py``).

The weights are drawn from the constructor's ``generator``.  Static
shapes as in JAX: invalid frames are masked out of the softmax
(-1e30) and out of the sum, instead of gathered away.  Each loss draws
from an explicit ``torch.Generator``; the draw may be given instead
(InfoNCE's uniform ``r`` over the B*T frames, CPC's ``neg_idx`` per
predictor), so that a test can feed JAX's draws.  Parameter names follow
the reference (``linear1``/``linear2``, ``predictors.{k}``/
``linearp.{k}``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from .linear import Dense

NEG_INF = -1e30


def _reset(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Draw the dense layers torch-style from ``generator`` (the caller's
    module may re-draw them as a whole)."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)


class InfoNCE(nn.Module):
    """Frame-level InfoNCE over (possibly subsampled) valid frames: with
    ``num_negatives`` below B*T, the frames of the smallest uniform draws
    (invalid frames drawn as 2, so last) form a static-size subset."""

    def __init__(self, hp: Hparams, dim1: int, dim2: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("dim", "num_negatives")
        self.max_neg = hp.num_negatives
        self.middle_dim = hp.dim
        self.linear1 = Dense(dim1, hp.dim)
        self.linear2 = Dense(dim2, hp.dim)
        _reset(self, generator)

    def forward(self, q: Masked, p: Masked,
                generator: Optional[torch.Generator] = None,
                r: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The summed loss over the kept valid frames; ``r`` (B*T,)
        replaces the uniform draw from ``generator``."""
        mask = q.mask().reshape(-1)
        b, t = q.value.shape[:2]
        qv = q.value.reshape(b * t, -1)
        pv = p.value.reshape(b * t, -1)
        if self.max_neg is not None and self.max_neg < b * t:
            if r is None:
                r = torch.rand((b * t,), generator=generator,
                               device=qv.device)
            r = torch.where(mask, r.to(qv.device).float(),
                            torch.full_like(r, 2.0, dtype=torch.float32))
            idx = torch.argsort(r, stable=True)[: self.max_neg]
            qv, pv, mask = qv[idx], pv[idx], mask[idx]
        logits = (self.linear1(qv) @ self.linear2(pv).T).float()
        logits = logits / math.sqrt(self.middle_dim)
        logits = torch.where(mask[None, :], logits,
                             torch.full_like(logits, NEG_INF))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.diagonal()
        return torch.where(mask, nll, torch.zeros_like(nll)).sum()


class CPC(nn.Module):
    """Multi-step predictive contrastive loss: predictor k scores frame
    t of ``q`` against frame t + k of ``p`` and ``num_negatives`` frames
    drawn uniformly from the whole (shifted) batch."""

    def __init__(self, hp: Hparams, dim1: int, dim2: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_predictors", "num_negatives", "dim")
        self.max_neg = hp.num_negatives
        self.num_predictors = hp.num_predictors
        self.middle_dim = hp.dim
        self.predictors = nn.ModuleList([Dense(dim1, hp.dim)
                                         for _ in range(hp.num_predictors)])
        self.linearp = nn.ModuleList([Dense(dim2, hp.dim)
                                      for _ in range(hp.num_predictors)])
        _reset(self, generator)

    def forward(self, q: Masked, p: Masked,
                generator: Optional[torch.Generator] = None,
                neg_idx: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """The summed loss of every predictor; ``neg_idx[k]`` (B*(T-k),
        num_negatives) replaces predictor k's draw from ``generator``."""
        losses = 0.0
        for k in range(self.num_predictors):
            qk, pk = (q, p) if k == 0 else (q.pop(k), p.pop_left(k))
            mask = qk.mask().reshape(-1)
            b, t = qk.value.shape[:2]
            qv = self.predictors[k](qk.value.reshape(b * t, -1))
            pv = self.linearp[k](pk.value.reshape(b * t, -1))
            if neg_idx is None:
                idx = torch.randint(0, b * t, (b * t, self.max_neg),
                                    generator=generator, device=qv.device)
            else:
                idx = neg_idx[k].to(qv.device).long()
            cand = torch.cat([pv[:, None], pv[idx]], dim=1)
            logits = torch.einsum("nc,nmc->nm", qv, cand).float()
            logits = logits / math.sqrt(self.middle_dim)
            nll = -torch.log_softmax(logits, dim=-1)[:, 0]
            losses = losses + torch.where(mask, nll,
                                          torch.zeros_like(nll)).sum()
        return losses
