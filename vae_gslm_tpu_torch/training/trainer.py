"""What a training step needs from the base trainer (port of parts of
``vae_gslm_tpu/training/trainer.py``): the reference weight init and the
stacking of micro-batches for gradient accumulation.  The mesh, data
loaders, ``fit`` and checkpoints wait for a later slice (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..core.masked import Masked
from ..nn.attention import SelfAttention
from ..nn.linear import Dense, Embedding, uniform_
from ..nn.transformer import TransformerLayerStack

Batch = Dict[str, Masked]


@torch.no_grad()
def init_weights(model: nn.Module, init_std: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> None:
    """Reference init (``training_lib/trainer.py:113-125``), the JAX
    package's rules drawn from ``generator``: zero every dense bias;
    attention projections uniform +-init_std/sqrt(dim/3); embeddings
    uniform +-1; the stacks' ``set_uniform`` (a learned position table,
    none for ALiBi)."""
    for m in model.modules():
        if isinstance(m, Dense) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, SelfAttention):
            std = init_std / math.sqrt(m.dim / 3)
            for proj in (m.in_proj, m.out_proj):
                uniform_(proj.weight, std, generator)
        if isinstance(m, Embedding):
            uniform_(m.weight, 1.0, generator)
        if isinstance(m, TransformerLayerStack):
            m.set_uniform(init_std / math.sqrt(m.dim / 3), generator)


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Micro-batches stacked on a new leading accumulation axis."""
    return {k: Masked.stack([b[k] for b in batches]) for k in batches[0]}


def fuse_microbatches(stacked: Batch) -> Batch:
    """(accum, B, ...) -> (1, accum * B, ...): the summed gradients of
    the micro-batches are the gradient of one fused batch (the losses
    are masked sums), up to the per-micro-batch random draws."""
    def f(x: torch.Tensor) -> torch.Tensor:
        return x.reshape((1, x.shape[0] * x.shape[1]) + tuple(x.shape[2:]))

    return {k: Masked(f(v.value), f(v.lengths), v.time_axis)
            for k, v in stacked.items()}
