"""Conditional denoisers of the diffusion decoder (port of
``TimeEmbedding``, ``ConditionalUNet`` and ``ConditionalBottleNeckUNet``
from ``vae_gslm_tpu/nn/unet.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from .activations import get_activation
from .conv import BottleNeckResNet, ResNet
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


class ConditionalUNet(nn.Module):
    """A cond ``ResNet`` over [cond, time embedding], a noise projection
    and a conditional ``ResNet`` (reference ``unet.py:29-64``)."""

    def __init__(self, cond_dim: int, noise_dim: int, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("cond_net", "unet", "time_embedding")
        if hp.unet.has("resample_rates"):
            raise ValueError("the conditional unet keeps its length: no "
                             "resample_rates")
        self.cond_net = ResNet(hp.cond_net,
                               input_dim=cond_dim + hp.time_embedding.dim,
                               output_dim=hp.unet.layer.hidden_channels)
        self.time_embedding = TimeEmbedding(hp.time_embedding)
        self.noise_linear = Dense(noise_dim, hp.unet.layer.in_channels)
        self.unet = ResNet(hp.unet, output_dim=noise_dim, conditional=True)

    def forward(self, noise: Masked, t: torch.Tensor,
                cond: Masked) -> Masked:
        b, tc, _ = cond.value.shape
        te = self.time_embedding(t)[:, None].expand(b, tc, -1)
        c = Masked(torch.cat([cond.value, te.to(cond.value.dtype)], -1),
                   cond.lengths, 1).apply_mask()
        c = self.cond_net(c)
        n = Masked(self.noise_linear(noise.value), noise.lengths,
                   1).apply_mask()
        return self.unet(n, c)

    @property
    def sample_ratio(self) -> float:
        return self.cond_net.sample_ratio


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
