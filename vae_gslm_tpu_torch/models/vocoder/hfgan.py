"""HiFi-GAN generator for inference (port of ``Generator`` and
``ResBlock`` from ``vae_gslm_tpu/models/vocoder/hfgan.py``).

Weight norm is folded: every conv holds a plain ``weight``/``bias``
under the reference's key names (``conv_pre``, ``ups.{i}``,
``resblocks.{i}.convs1.{j}``, ``conv_post``);
``models/convert.py::load_reference_generator`` folds the reference's
``g``/``v`` pairs.  The JAX package's space-to-depth path for the small
late-stage channel counts is a TPU lane-layout device that computes
the same function, so the port runs the plain convolutions.  The
discriminators (training) wait for a later slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked, resize_length
from ...core.precision import get_policy
from ...hparams.hp import Hparams
from ...nn.conv import get_padding

LRELU_SLOPE = 0.1


class _Conv(nn.Module):
    """Folded-weight NCW conv (``weight`` (out, in, k)), policy dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.padding, self.dilation = padding, dilation

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.01, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding, dilation=self.dilation)


class _ConvT(nn.Module):
    """Folded-weight transposed conv (``weight`` (in, out, k)) with the
    torch ``padding``/``output_padding`` semantics of the reference."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int, padding: int, output_padding: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.01, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        return F.conv_transpose1d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class ResBlock(nn.Module):
    """MRF residual block (reference ``hfgan.py:43-88``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            _Conv(channels, channels, kernel_size,
                  padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            _Conv(channels, channels, kernel_size,
                  padding=get_padding(kernel_size, 1))
            for _ in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)),
                                 LRELU_SLOPE))
            x = xt + x
        return x


class Generator(nn.Module):
    """HiFi-GAN generator, mel (B, T, 80) -> wave (B, T * prod(rates)).
    ``device`` defaults to CUDA and raises without it."""

    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        hp.check_arg_in_hparams("resblock_kernel_sizes", "upsample_rates",
                                "in_channels", "upsample_initial_channel",
                                "kernel_size", "upsample_kernel_sizes",
                                "resblock_dilation_sizes")
        self.hp = hp
        self.num_kernels = len(hp.resblock_kernel_sizes)
        uic = hp.upsample_initial_channel
        with torch.device(dev):
            self.conv_pre = _Conv(hp.in_channels, uic, hp.kernel_size,
                                  padding=get_padding(hp.kernel_size))
            ups, resblocks = [], []
            for i, (u, k) in enumerate(zip(hp.upsample_rates,
                                           hp.upsample_kernel_sizes)):
                ups.append(_ConvT(uic // (2 ** i), uic // (2 ** (i + 1)), k,
                                  u, padding=u // 2 + u % 2,
                                  output_padding=u % 2))
                ch = uic // (2 ** (i + 1))
                for kk, dd in zip(hp.resblock_kernel_sizes,
                                  hp.resblock_dilation_sizes):
                    resblocks.append(ResBlock(ch, kk, dd))
            self.ups = nn.ModuleList(ups)
            self.resblocks = nn.ModuleList(resblocks)
            self.conv_post = _Conv(ch, 1, hp.kernel_size,
                                   padding=get_padding(hp.kernel_size))
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        for m in self.modules():
            if isinstance(m, (_Conv, _ConvT)):
                m.reset_parameters(generator)

    @torch.no_grad()
    def forward(self, mel: Masked) -> Masked:
        total = int(np.prod(self.hp.upsample_rates))
        lengths = resize_length(mel.lengths, float(total))
        x = self.conv_pre(mel.value.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                xs = r if xs is None else xs + r
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return Masked(torch.tanh(x.float())[:, 0], lengths, 1)
