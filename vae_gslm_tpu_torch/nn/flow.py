"""Affine coupling flow (port of ``TensorLogdet``, ``LinearCoupling``
and ``CouplingStack`` from ``vae_gslm_tpu/nn/flow.py``).

``forward`` (training) maps latents through the couplings and sums
their masked log-scales into the log-determinant; ``reverse`` (the AR
sampler) maps prior samples back.  The conv and spline couplings wait
for a later slice (ROADMAP.md).  The reference's
``_max, _min = scale_range`` unpack order is preserved.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from .activations import get_activation
from .linear import Dense, FiLM
from .norms import get_norm


class TensorLogdet(NamedTuple):
    tensor: Masked
    logdet: Union[float, torch.Tensor]


def _bounded_logscale(logs: torch.Tensor, scale_range) -> torch.Tensor:
    _max, _min = scale_range
    std = torch.sigmoid(logs) * (_max - _min) + _min
    return torch.log(std)


class LinearCoupling(nn.Module):
    def __init__(self, dim: int, flip: bool, hp: Hparams,
                 condition_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("hidden_dim", "activation", "mean_only",
                                "norm")
        self.mean_only = hp.mean_only
        self.film = (FiLM(hp.hidden_dim, in_dim=condition_dim)
                     if condition_dim is not None else None)
        bias = hp.get("bias", True)
        self.linear1 = Dense(dim // 2, hp.hidden_dim, bias=bias)
        self.linear2 = Dense(hp.hidden_dim,
                             dim // 2 if hp.mean_only else dim, bias=bias)
        self.norm = get_norm(hp.hidden_dim, hp.norm)
        self.activation = get_activation(hp.activation)
        self.flip = flip
        self.scale_range = hp.get("scale_range", None)
        self.detach_coupling = hp.get("detach_coupling", False)
        self.half = dim // 2

    def _stats(self, x0: torch.Tensor, c: Optional[torch.Tensor]):
        h = self.norm(self.linear1(x0))
        if c is not None and self.film is not None:
            h = self.film(h, c)
        stats = self.linear2(self.activation(h)).float()
        if self.mean_only:
            return stats, torch.zeros_like(stats)
        m, logs = stats[..., :self.half], stats[..., self.half:]
        if self.scale_range is not None:
            logs = _bounded_logscale(logs, self.scale_range)
        return m, logs

    def forward(self, x: TensorLogdet,
                c: Optional[Masked] = None) -> TensorLogdet:
        xm = x.tensor
        x0 = xm.value[..., :self.half]
        x1 = xm.value[..., self.half:]
        if self.flip:
            x0, x1 = x1, x0
        inp = x0.detach() if self.detach_coupling else x0
        m, logs = self._stats(inp, c.value if c is not None else None)
        x1 = m + x1.float() * torch.exp(logs)
        ret = torch.cat([x0.float(), x1], dim=-1)
        logs_masked = torch.where(xm.expanded_mask(), logs,
                                  torch.zeros((), device=logs.device))
        return TensorLogdet(Masked(ret, xm.lengths, xm.time_axis),
                            x.logdet + logs_masked)

    def reverse(self, x: Masked, c: Optional[Masked] = None) -> Masked:
        x0 = x.value[..., :self.half]
        x1 = x.value[..., self.half:]
        m, logs = self._stats(x0, c.value if c is not None else None)
        x1 = (x1.float() - m) * torch.exp(-logs)
        if self.flip:
            x0, x1 = x1, x0
        ret = torch.cat([x0.float(), x1], dim=-1)
        return Masked(ret, x.lengths, x.time_axis)


class CouplingStack(nn.Module):
    """Stack of couplings, all flipped; ``forward`` runs them in order
    and accumulates the log-determinant, ``reverse`` runs them
    backwards."""

    def __init__(self, dim: int, hp: Hparams,
                 condition_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer")
        if hp.num_layers % 2:
            raise ValueError("the coupling stack needs an even depth")
        identifier = hp.get("identifier", "LinearCoupling")
        if identifier != "LinearCoupling":
            raise NotImplementedError(
                f"{identifier} is not ported yet (ROADMAP.md, Queue 1)")
        self.layers = nn.ModuleList([
            LinearCoupling(dim, True, hp.layer, condition_dim=condition_dim)
            for _ in range(hp.num_layers)])

    def forward(self, x: TensorLogdet,
                c: Optional[Masked] = None) -> TensorLogdet:
        for layer in self.layers:
            x = layer(x, c=c)
        return x

    def reverse(self, x: Masked, c: Optional[Masked] = None) -> Masked:
        for layer in reversed(self.layers):
            x = layer.reverse(x, c=c)
        return x
