"""HiFi-GAN generator, discriminators and GAN losses (port of
``vae_gslm_tpu/models/vocoder/hfgan.py``).

Every conv is weight-normed as in the JAX package: ``weight_g``,
``weight_v`` and ``bias`` under the reference's state-dict names, in
torch layouts (``weight_v`` (out, in/groups, k) for ``WNConv1d``, (in,
out, k) for ``WNConvT1d``, (out, in, kh, kw) for ``WNConv2d``; ``weight_g``
(n, 1, ...) for dim 0 of ``weight_v``), and the kernel is
``g * v / sqrt(sum(v^2 over every axis but dim 0) + 1e-12)``: the JAX
rule (its last kernel axis is the torch dim 0), which torch's own
``weight_norm`` lacks (no epsilon).  ``remove_weight_norm`` folds the
pair into a plain ``weight`` once, as the JAX package does for inference
(``HiFiGAN.from_pretrained``); a folded conv runs the plain torch conv on
that weight.  Convs read the active precision policy at call time.

The JAX package runs NWC/NHWC; the port runs NCW/NCHW, so feature maps
are the JAX ones with the channel axis moved to dim 1.  JAX's
space-to-depth path for the generator's small late-stage channel counts
is a TPU lane-layout device that computes the same function, so the port
runs the plain convolutions.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked, resize_length
from ...core.precision import get_policy
from ...data.features import hann_window
from ...hparams.hp import Hparams
from ...nn.conv import get_padding

LRELU_SLOPE = 0.1
INIT_STD = 0.01                 # 1-D convs' v, as JAX draws it
Tensor = torch.Tensor
Maps = List[List[Tensor]]


def wn_kernel(g: Tensor, v: Tensor) -> Tensor:
    """``g * v / ||v||``, the norm over every axis of ``v`` but dim 0 with
    1e-12 inside the root (JAX's ``_vnorm``)."""
    norm = torch.sqrt(v.square().sum(dim=tuple(range(1, v.dim())),
                                     keepdim=True) + 1e-12)
    return g * v / norm


class _WNConv(nn.Module):
    """A weight-normed conv: ``weight_g``/``weight_v``/``bias``, or after
    ``remove_weight_norm`` ``weight``/``bias``."""

    def __init__(self, shape: Sequence[int], out_ch: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(*shape))
        self.weight_g = nn.Parameter(torch.empty(
            (shape[0],) + (1,) * (len(shape) - 1)))
        self.bias = nn.Parameter(torch.empty(out_ch))

    @property
    def weight_norm(self) -> bool:
        return "weight_v" in self._parameters

    def kernel(self) -> Tensor:
        if not self.weight_norm:
            return self.weight
        return wn_kernel(self.weight_g, self.weight_v)

    @torch.no_grad()
    def _set_init(self, v: Tensor, bound: float,
                  generator: Optional[torch.Generator]) -> None:
        self.weight_v.copy_(v)       # g = ||v||: the kernel starts at v
        self.weight_g.copy_(torch.sqrt(v.square().sum(
            dim=tuple(range(1, v.dim())), keepdim=True) + 1e-12))
        self.bias.uniform_(-bound, bound, generator=generator)

    @torch.no_grad()
    def remove_weight_norm(self) -> None:
        """Fold g/v into ``weight`` (float32, as JAX's ``kernel()``)."""
        if not self.weight_norm:
            return
        w = self.kernel().detach().clone()
        del self.weight_g, self.weight_v
        self.weight = nn.Parameter(w)

    def _wb(self) -> Tuple[Tensor, Tensor]:
        dt = get_policy().compute_dtype
        return self.kernel().to(dt), self.bias.to(dt)


class WNConv1d(_WNConv):
    """Weight-normed NCW conv, ``weight_v`` (out, in/groups, k), g per
    output channel, v drawn N(0, 0.01) as JAX draws it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1):
        super().__init__((out_ch, in_ch // groups, kernel_size), out_ch)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.fan_in = in_ch // groups * kernel_size

    def reset_parameters(self, generator=None) -> None:
        v = torch.empty_like(self.weight_v).normal_(0.0, INIT_STD,
                                                     generator=generator)
        self._set_init(v, 1.0 / math.sqrt(self.fan_in), generator)

    def forward(self, x: Tensor) -> Tensor:
        w, b = self._wb()
        return F.conv1d(x.to(w.dtype), w, b, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class WNConvT1d(_WNConv):
    """Weight-normed transposed conv, ``weight_v`` (in, out, k), g per
    input channel (torch's ConvTranspose weight-norm dim 0).  JAX runs a
    VALID transposed conv and crops (padding, padding - output_padding):
    torch's ``padding``/``output_padding`` compute exactly that."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int, padding: int = 0, output_padding: int = 0):
        super().__init__((in_ch, out_ch, kernel_size), out_ch)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.fan_in = out_ch * kernel_size

    def reset_parameters(self, generator=None) -> None:
        v = torch.empty_like(self.weight_v).normal_(0.0, INIT_STD,
                                                     generator=generator)
        self._set_init(v, 1.0 / math.sqrt(self.fan_in), generator)

    def forward(self, x: Tensor) -> Tensor:
        w, b = self._wb()
        return F.conv_transpose1d(x.to(w.dtype), w, b, stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class WNConv2d(_WNConv):
    """Weight-normed NCHW conv, ``weight_v`` (out, in, kh, kw), g per
    output channel; v and bias uniform in +-1/sqrt(fan_in)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1),
                 padding=(0, 0)):
        kh, kw = kernel_size
        super().__init__((out_ch, in_ch, kh, kw), out_ch)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.fan_in = in_ch * kh * kw

    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        v = torch.empty_like(self.weight_v).uniform_(
            -bound, bound, generator=generator)
        self._set_init(v, bound, generator)

    def forward(self, x: Tensor) -> Tensor:
        w, b = self._wb()
        return F.conv2d(x.to(w.dtype), w, b, stride=self.stride,
                        padding=self.padding)


WN_CONVS = (WNConv1d, WNConvT1d, WNConv2d)


def leaky_relu(x: Tensor, slope: float = LRELU_SLOPE) -> Tensor:
    return F.leaky_relu(x, slope)


class ResBlock(nn.Module):
    """MRF residual block (reference ``hfgan.py:43-88``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            WNConv1d(channels, channels, kernel_size, 1,
                     padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            WNConv1d(channels, channels, kernel_size, 1,
                     padding=get_padding(kernel_size, 1))
            for _ in dilation])

    def forward(self, x: Tensor) -> Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(leaky_relu(c1(leaky_relu(x))))
            x = xt + x
        return x


class _Built(nn.Module):
    """Modules built on ``device``, every weight-normed conv drawn in
    module order from ``generator`` (a generator on that device; seed 0
    when None)."""

    def _init(self, device, generator) -> None:
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        for m in self.modules():
            if isinstance(m, WN_CONVS):
                m.reset_parameters(generator)

    def remove_weight_norm(self) -> None:
        for m in self.modules():
            if isinstance(m, WN_CONVS):
                m.remove_weight_norm()


class Generator(_Built):
    """HiFi-GAN generator, mel (B, T, n_mels) -> wave (B, T * prod(rates)),
    trainable (``forward`` keeps the graph; ``HiFiGAN.decode`` runs it
    under ``no_grad``).  ``device`` defaults to CUDA and raises without
    it."""

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
            self.conv_pre = WNConv1d(hp.in_channels, uic, hp.kernel_size, 1,
                                     padding=get_padding(hp.kernel_size))
            ups, resblocks = [], []
            for i, (u, k) in enumerate(zip(hp.upsample_rates,
                                           hp.upsample_kernel_sizes)):
                ups.append(WNConvT1d(uic // (2 ** i), uic // (2 ** (i + 1)),
                                     k, u, padding=u // 2 + u % 2,
                                     output_padding=u % 2))
                ch = uic // (2 ** (i + 1))
                for kk, dd in zip(hp.resblock_kernel_sizes,
                                  hp.resblock_dilation_sizes):
                    resblocks.append(ResBlock(ch, kk, dd))
            self.ups = nn.ModuleList(ups)
            self.resblocks = nn.ModuleList(resblocks)
            self.conv_post = WNConv1d(ch, 1, hp.kernel_size, 1,
                                      padding=get_padding(hp.kernel_size))
        self._init(dev, generator)

    def forward(self, mel: Masked) -> Masked:
        total = int(np.prod(self.hp.upsample_rates))
        lengths = resize_length(mel.lengths, float(total))
        x = self.conv_pre(mel.value.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            xs = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                xs = r if xs is None else xs + r
            x = xs / self.num_kernels
        x = self.conv_post(leaky_relu(x, 0.01))
        return Masked(torch.tanh(x.float())[:, 0], lengths, 1)


# ---------------------------------------------------------------- disc
class DiscriminatorP(nn.Module):
    """Period discriminator (``hfgan.py:166-205``): the wave reflect-padded
    to a multiple of ``period``, folded to (B, 1, T/p, p), 2-D convs over
    the T/p axis."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = [(1, 64), (64, 128), (128, 256), (256, 512)]
        convs = [WNConv2d(i, o, (kernel_size, 1), (stride, 1),
                          (get_padding(kernel_size), 0)) for i, o in chans]
        convs.append(WNConv2d(512, 1024, (kernel_size, 1), (1, 1),
                              (get_padding(kernel_size), 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, wave: Tensor) -> Tuple[Tensor, List[Tensor]]:
        b, t = wave.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            wave = F.pad(wave[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = wave.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for layer in self.convs:
            x = leaky_relu(layer(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class _Multi(_Built):
    """Sub-discriminators run in order on the wave: (outputs, feature
    maps), one list entry each."""

    def forward(self, wave: Tensor) -> Tuple[List[Tensor], Maps]:
        outs, fmaps = [], []
        for d in self.discriminators:
            o, f = d(wave)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("periods")
        dev = resolve_device(device)
        with torch.device(dev):
            self.discriminators = nn.ModuleList([
                DiscriminatorP(p) for p in hp.periods])
        self._init(dev, generator)


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs (``hfgan.py:229-256``)."""

    SPEC = [(1, 128, 15, 1, 7, 1), (128, 128, 41, 2, 20, 4),
            (128, 256, 41, 2, 20, 16), (256, 512, 41, 4, 20, 16),
            (512, 1024, 41, 4, 20, 16), (1024, 1024, 41, 1, 20, 16),
            (1024, 1024, 5, 1, 2, 1)]

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList([
            WNConv1d(i, o, k, s, padding=p, groups=g)
            for i, o, k, s, p, g in self.SPEC])
        self.conv_post = WNConv1d(1024, 1, 3, 1, padding=1)

    def forward(self, wave: Tensor) -> Tuple[Tensor, List[Tensor]]:
        x = wave[:, None]
        fmap = []
        for layer in self.convs:
            x = leaky_relu(layer(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def avg_pool1d(x: Tensor, window: int = 4, stride: int = 2,
               padding: int = 2) -> Tensor:
    """torch AvgPool1d(count_include_pad=True) on (B, T)."""
    return F.avg_pool1d(x[:, None], window, stride, padding,
                        count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(_Multi):
    """Scale i > 0 sees the wave pooled i times."""

    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_scales")
        dev = resolve_device(device)
        with torch.device(dev):
            self.discriminators = nn.ModuleList([
                DiscriminatorS() for _ in range(hp.num_scales)])
        self._init(dev, generator)

    def forward(self, wave: Tensor) -> Tuple[List[Tensor], Maps]:
        outs, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                wave = avg_pool1d(wave)
            o, f = d(wave)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


class DiscriminatorR(nn.Module):
    """Resolution discriminator: 2-D convs over the STFT magnitude
    (``hfgan.py:284-348``), laid out (B, 1, frames, bins); stride (1, 2)
    acts on bins."""

    def __init__(self, resolution: Sequence[int]):
        super().__init__()
        self.resolution = tuple(resolution)
        self.convs = nn.ModuleList([
            WNConv2d(1, 32, (3, 9), (1, 1), (1, 4)),
            WNConv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            WNConv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            WNConv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            WNConv2d(32, 32, (3, 3), (1, 1), (1, 1)),
        ])
        self.conv_post = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1))
        n_fft, _, win = self.resolution
        window = np.zeros(n_fft, np.float32)
        left = (n_fft - win) // 2
        window[left: left + win] = hann_window(win)
        self.register_buffer("window", torch.tensor(window),
                             persistent=False)

    def spectrogram(self, wave: Tensor) -> Tensor:
        """|rfft| of Hann-windowed frames at ``hop`` after a reflect pad
        of (n_fft - hop) / 2: (B, frames, bins).  torch's complex ``abs``
        has a zero gradient at a zero bin, as JAX's does."""
        n_fft, hop, _ = self.resolution
        pad = int((n_fft - hop) / 2)
        x = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(1, n_fft, hop)
        return torch.fft.rfft(frames * self.window, n=n_fft).abs()

    def forward(self, wave: Tensor) -> Tuple[Tensor, List[Tensor]]:
        x = self.spectrogram(wave.float())[:, None]
        fmap = []
        for layer in self.convs:
            x = leaky_relu(layer(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiResolutionDiscriminator(_Multi):
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("resolutions")
        dev = resolve_device(device)
        with torch.device(dev):
            self.discriminators = nn.ModuleList([
                DiscriminatorR(r) for r in hp.resolutions])
        self._init(dev, generator)


# ---------------------------------------------------------------- losses
def feature_loss(fmap_r: Maps, fmap_g: Maps) -> Tensor:
    """2 x the sum over every feature map of mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2.0


def discriminator_loss(real_outs: List[Tensor], gen_outs: List[Tensor]
                       ) -> Tensor:
    """LSGAN: mean (1 - D(y))^2 + mean D(y_hat)^2, summed."""
    loss = 0.0
    for dr, dg in zip(real_outs, gen_outs):
        loss = loss + (1.0 - dr.float()).square().mean()
        loss = loss + dg.float().square().mean()
    return loss


def generator_loss(disc_outs: List[Tensor]) -> Tensor:
    loss = 0.0
    for dg in disc_outs:
        loss = loss + (1.0 - dg.float()).square().mean()
    return loss
