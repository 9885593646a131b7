"""Conditional denoiser of the diffusion decoder (port of
``TimeEmbedding`` and ``ConditionalBottleNeckUNet`` from
``vae_gslm_tpu/nn/unet.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from .activations import get_activation
from .conv import BottleNeckResNet
from .linear import Dense
from .positions import SinCos


class TimeEmbedding(nn.Module):
    """SinCos(t) -> Linear -> act -> Linear."""

    def __init__(self, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("activation", "maxpos", "dim")
        bias = hp.get("bias", True)
        self.lin1 = Dense(hp.dim, hp.dim, bias=bias)
        self.lin2 = Dense(hp.dim, hp.dim, bias=bias)
        self.act = get_activation(hp.activation)
        self.embedding = SinCos(hp.dim, maxpos=hp.maxpos)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(self.embedding.get(t))))


class ConditionalBottleNeckUNet(nn.Module):
    """Linear cond projection + ``BottleNeckResNet(x, c, t)``."""

    def __init__(self, cond_dim: int, noise_dim: int, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("unet", "time_embedding")
        hp.unet.check_arg_in_hparams("conditional")
        hp.unet.time_dim = hp.time_embedding.dim
        self.cond_net = Dense(cond_dim, hp.unet.condition_dim)
        self.time_embedding = TimeEmbedding(hp.time_embedding)
        self.unet = BottleNeckResNet(hp.unet, input_dim=noise_dim,
                                     output_dim=noise_dim)

    def forward(self, noise: Masked, t: torch.Tensor,
                cond: Masked) -> Masked:
        te = self.time_embedding(t)
        c = Masked(self.cond_net(cond.value), cond.lengths, 1).apply_mask()
        return self.unet(noise, c, te)

    @property
    def sample_ratio(self) -> float:
        return self.unet.sample_ratio
