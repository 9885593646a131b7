"""1-D convolution stacks (port of ``vae_gslm_tpu/nn/conv.py``): the
residual-block family, the uniform-width ``ResNet``, ``BottleNeckResNet``
and the conv-norm-act ``CNNStack``.

The JAX package runs NWC (``(B, T, C)``).  PyTorch's convolutions are
NCW, so the stacks transpose once at their edges: ``ResNet`` and
``BottleNeckResNet`` take and return ``(B, T, C)`` Masked values like
the JAX modules and run every block inside on ``(B, C, T)``.  Blocks
normalise over the channel axis (``dim=1``).  Weights keep the
reference's torch layouts and state-dict names (``Conv1d.weight`` (out,
in/groups, k)).
Asymmetric causal/future padding is an explicit ``F.pad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.masked import Masked, resize_length
from ..core.precision import get_policy
from ..hparams.hp import Hparams
from .activations import get_activation
from .linear import Dense, FiLM, uniform_
from .norms import get_norm

Padding = Union[int, Tuple[int, int]]


def get_padding(kernel_size: int, dilation: int = 1, stride: int = 1,
                causal: bool = False, future: bool = False) -> Padding:
    """Same formula as the reference ``utils/helpers.py:138-145``."""
    padding = int(((kernel_size - 1) * dilation + 1 - stride) / 2)
    if causal:
        return (padding * 2, 0)
    if future:
        return (0, padding * 2)
    return padding


def _pad_pair(padding: Padding) -> Tuple[int, int]:
    if isinstance(padding, (tuple, list)):
        return tuple(padding)
    return (padding, padding)


class Conv1d(nn.Module):
    """NCW conv with torch-style init and (left, right) padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: Padding = 0, groups: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.fan_in = in_ch // groups * kernel_size
        self.stride, self.groups, self.dilation = stride, groups, dilation
        self.padding = _pad_pair(padding)

    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        x = x.to(dt)
        if any(self.padding):
            x = F.pad(x, self.padding)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv1d(x, self.weight.to(dt), b, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)


class ConvTranspose1d(nn.Module):
    """NCW transposed conv with the reference's pad-then-crop
    semantics; weight (in, out, k) as torch stores it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: Padding = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.fan_in = out_ch * kernel_size
        self.stride = stride
        self.crop = _pad_pair(padding)

    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        y = F.conv_transpose1d(x.to(dt), self.weight.to(dt),
                               stride=self.stride)
        left, right = self.crop
        y = y[..., left: y.shape[-1] - right]
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None]
        return y


class LayerScale(nn.Module):
    """Per-channel scale; ``gamma`` is (1, C, 1) as in the reference."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.full((1, dim, 1), float(eps)))

    def reset_parameters(self, generator=None) -> None:
        nn.init.constant_(self.gamma, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gamma.to(x.dtype) * x


class Dropout(nn.Module):
    """JAX's ``Dropout``: the identity at rate 0 or when
    ``deterministic`` (which every call in the conv stacks leaves at its
    default, as in JAX); otherwise each element is kept with probability
    1 - rate, drawn from ``generator`` (or given as the bool ``keep``),
    and scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate <= 0.0 or deterministic:
            return x
        p = 1.0 - self.rate
        if keep is None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < p
        kept = x / torch.tensor(p, device=x.device)
        return torch.where(keep, kept, torch.zeros((), device=x.device)
                           ).to(x.dtype)


class ResidualBlock(nn.Module):
    """Depthwise-separable residual block on NCW values:
    h = layer_scale(dropout(conv3(act(conv2(norm(conv1(x))))))) +
    shortcut(x)."""

    def __init__(self, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("in_channels", "hidden_channels",
                                "kernel_size", "norm", "activation")
        aux = hp.get("aux_in_channels", 0) or 0
        padding = get_padding(hp.kernel_size,
                              causal=hp.get("causal_padding", False),
                              future=hp.get("future_padding", False))
        cin, chid = hp.in_channels, hp.hidden_channels
        self.norm = get_norm(cin, hp.norm)
        self.act = get_activation(hp.activation)
        self.conv1 = Conv1d(cin, cin, hp.kernel_size, padding=padding,
                            groups=cin)
        self.conv2 = Conv1d(cin + aux, chid, 1)
        self.conv3 = Conv1d(chid, cin, 1)
        self.dropout = Dropout(hp.get("dropout", 0.0))
        self.shortcut = (nn.ModuleList([Conv1d(cin, cin, 1)])
                         if hp.get("shortcut", False) else None)
        if hp.has("layer_scale"):
            hp.layer_scale.check_arg_in_hparams("eps")
            self.layer_scale = LayerScale(cin, hp.layer_scale.eps)
        else:
            self.layer_scale = None

    def _tail(self, h: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.conv3(h))
        if self.layer_scale is not None:
            h = self.layer_scale(h)
        if self.shortcut is not None:
            xv = self.act(self.shortcut[0](xv))
        return h + xv

    def forward(self, x: Masked) -> Masked:
        h = self.act(self.conv2(self.norm(self.conv1(x.value), dim=1)))
        return dataclasses.replace(x, value=self._tail(h, x.value))


def _condition(block, h: torch.Tensor, c: Masked) -> torch.Tensor:
    """conv2 over the block's conditioned features (FiLM or concat)."""
    if block.condition_type == "film":
        return block.conv2(block.film(h, c.value))
    return block.conv2(torch.cat([h, c.value.to(h.dtype)], dim=1))


class ConditionalResidualBlock(ResidualBlock):
    """FiLM- or concat-conditioned block (reference
    ``conv/layers.py:196-228``)."""

    def __init__(self, hp: Hparams):
        if hp.get("condition_type", "film") != "film":
            hp.aux_in_channels = hp.get("in_dim", hp.in_channels)
        super().__init__(hp)
        self.condition_type = hp.get("condition_type", "film")
        if self.condition_type == "film":
            self.film = FiLM(hp.in_channels, in_dim=hp.get("in_dim", None),
                             time_first=False)

    def forward(self, x: Masked, c: Masked) -> Masked:
        h = self.norm(self.conv1(x.value), dim=1)
        h = self.act(_condition(self, h, c))
        return dataclasses.replace(x, value=self._tail(h, x.value))


class TemporalResidualBlock(ResidualBlock):
    """Diffusion-time conditioned block (reference
    ``conv/layers.py:231-256``)."""

    def __init__(self, hp: Hparams):
        super().__init__(hp)
        hp.check_arg_in_hparams("time_dim")
        self.time_emb = Dense(hp.time_dim, hp.in_channels)

    def forward(self, x: Masked, t: torch.Tensor) -> Masked:
        te = self.time_emb(self.act(t))[:, :, None]
        h = self.act(self.conv2(self.norm(self.conv1(x.value) + te, dim=1)))
        return dataclasses.replace(x, value=self._tail(h, x.value))


class TCResidualBlock(ResidualBlock):
    """Time + condition block (reference ``conv/layers.py:259-295``)."""

    def __init__(self, hp: Hparams):
        if hp.get("condition_type", "film") != "film":
            hp.aux_in_channels = hp.get("in_dim", hp.in_channels)
        super().__init__(hp)
        self.condition_type = hp.get("condition_type", "film")
        if self.condition_type == "film":
            self.film = FiLM(hp.in_channels, in_dim=hp.get("in_dim", None),
                             time_first=False)
        hp.check_arg_in_hparams("time_dim")
        self.time_emb = Dense(hp.time_dim, hp.in_channels)

    def forward(self, x: Masked, c: Masked, t: torch.Tensor) -> Masked:
        te = self.time_emb(self.act(t))[:, :, None]
        h = self.norm(self.conv1(x.value) + te, dim=1)
        h = self.act(_condition(self, h, c))
        return dataclasses.replace(x, value=self._tail(h, x.value))


class Upsample(nn.Module):
    """norm -> transposed conv, x stride lengths."""

    def __init__(self, n_channels: int, kernel_size: int, stride: int,
                 norm_hp: Hparams, causal_padding: bool = False,
                 future_padding: bool = False,
                 out_channels: Optional[int] = None):
        super().__init__()
        padding = get_padding(kernel_size, stride=stride,
                              causal=causal_padding, future=future_padding)
        self.norm = get_norm(n_channels, norm_hp)
        self.conv = ConvTranspose1d(n_channels, out_channels or n_channels,
                                    kernel_size, stride, padding=padding)
        self.stride = stride

    def forward(self, x: Masked) -> Masked:
        lengths = resize_length(x.lengths, float(self.stride))
        return Masked(self.conv(self.norm(x.value, dim=1)), lengths, 2)


class Downsample(nn.Module):
    """norm -> strided conv, / stride lengths."""

    def __init__(self, n_channels: int, kernel_size: int, stride: int,
                 norm_hp: Hparams, causal_padding: bool = False,
                 future_padding: bool = False,
                 out_channels: Optional[int] = None):
        super().__init__()
        padding = get_padding(kernel_size, stride=stride,
                              causal=causal_padding, future=future_padding)
        self.norm = get_norm(n_channels, norm_hp)
        self.conv = Conv1d(n_channels, out_channels or n_channels,
                           kernel_size, stride=stride, padding=padding)
        self.stride = stride

    def forward(self, x: Masked) -> Masked:
        lengths = resize_length(x.lengths, 1.0 / float(self.stride))
        return Masked(self.conv(self.norm(x.value, dim=1)), lengths, 2)


def _sample_ratio(resample_rates: Sequence[int]) -> float:
    ret = 1.0
    for rate in resample_rates:
        ret = ret * rate if rate > 0 else ret / -rate
    return ret


class ResNet(nn.Module):
    """Uniform-width residual conv stack (reference
    ``conv/layers.py:298-383``): ``num_layers`` blocks of ``hp.layer``
    (conditional blocks with ``conditional``), each followed by an
    up- or downsampling at its ``resample_rates`` entry.  Takes and
    returns ``(B, T, C)``; runs NCW inside."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None,
                 conditional: bool = False):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer")
        self.hp = hp
        n = hp.num_layers
        causal_padding = hp.layer.get("causal_padding", False)
        rates = hp.get("resample_rates", [1] * n)
        ksizes = hp.get("resample_ksize", [3] * n)
        if len(rates) != n:
            raise ValueError("resample_rates must have num_layers entries")
        block = ConditionalResidualBlock if conditional else ResidualBlock
        self.layers = nn.ModuleList([block(hp.layer) for _ in range(n)])
        cin = hp.layer.in_channels
        samples = []
        for rk, rate in zip(ksizes, rates):
            if not isinstance(rate, int) or rate == 0:
                raise ValueError(f"bad resample rate {rate!r}")
            if rate in (1, -1):
                samples.append(None)
            else:
                sample = Upsample if rate > 1 else Downsample
                samples.append(sample(cin, rk, abs(rate), hp.layer.norm,
                                      causal_padding=causal_padding))
        self.samples = nn.ModuleList(samples)
        self.linear = (Dense(input_dim, cin)
                       if input_dim is not None else None)
        self.out_linear = (Dense(cin, output_dim)
                           if output_dim is not None else None)
        self.final_norm = (get_norm(cin, hp.layer.norm)
                           if hp.get("final_norm", False) else None)
        self.first_norm = (get_norm(cin, hp.layer.norm)
                           if hp.get("first_norm", False) else None)
        self.conditional = conditional

    def forward(self, x: Masked, c: Optional[Masked] = None) -> Masked:
        if self.linear is not None:
            x = Masked(self.linear(x.value), x.lengths, 1).apply_mask()
        if self.first_norm is not None:
            x = dataclasses.replace(x, value=self.first_norm(x.value))
        x = x.transpose()                      # (B, C, T) from here on
        c = c.transpose() if c is not None else None
        for sample, layer in zip(self.samples, self.layers):
            x = layer(x, c) if self.conditional else layer(x)
            if sample is not None:
                x = sample(x)
        if self.final_norm is not None:
            x = dataclasses.replace(x, value=self.final_norm(x.value, dim=1))
        x = x.transpose()
        if self.out_linear is not None:
            x = Masked(self.out_linear(x.value), x.lengths, 1)
        return x.apply_mask()

    @property
    def sample_ratio(self) -> float:
        return _sample_ratio(self.hp.get("resample_rates",
                                         [1] * self.hp.num_layers))


class BottleNeckResNet(nn.Module):
    """Variable-width bottleneck stack with UNet skips and an
    ``upward_layer`` boundary (reference ``conv/layers.py:386-540``).
    Takes and returns ``(B, T, C)``; runs NCW inside."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer", "init_channel",
                                "out_channels", "hidden_channels",
                                "resample_rates", "resample_ksize")
        self.hp = hp
        n = hp.num_layers
        upward_boundary = 10 ** 12
        if hp.has("upward_layer"):
            upward_boundary = hp.upward_layer.boundary
            if upward_boundary >= n:
                raise ValueError("upward_layer.boundary must be < "
                                 "num_layers")
        out_channels = hp.out_channels
        in_channels = ([hp.init_channel] + list(out_channels))[:-1]
        hidden_channels = hp.hidden_channels
        if hp.has("conditional"):
            hp.check_arg_in_hparams("condition_dim")
            hp.layer.in_dim = hp.condition_dim
            if hp.has("upward_layer"):
                hp.upward_layer.in_dim = hp.condition_dim
        conditional = hp.get("conditional", [False] * n)
        self.time_dim = hp.get("time_dim", None)
        self.skip_connection = hp.get("skip_connection", [None] * n)
        self.skip_concat = hp.get("connection_type", None) == "concat"
        if not (len(hp.resample_rates) == len(out_channels)
                == len(hidden_channels) == len(self.skip_connection) == n):
            raise ValueError("per-layer lists must have num_layers entries")
        layers, samples, skip_conv = [], [], []
        for i in range(n):
            c_layer = hp.layer if i < upward_boundary else hp.upward_layer
            causal_padding = c_layer.get("causal_padding", False)
            future_padding = c_layer.get("future_padding", False)
            c_layer.in_channels = in_channels[i]
            c_layer.hidden_channels = hidden_channels[i]
            c_layer.aux_in_channels = 0
            if self.skip_connection[i] is not None and self.skip_concat:
                skip_conv.append(Conv1d(in_channels[i] * 2, in_channels[i],
                                        1))
            else:
                skip_conv.append(None)
            if conditional[i] and self.time_dim is not None:
                c_layer.time_dim = self.time_dim
                layers.append(TCResidualBlock(c_layer))
            elif conditional[i]:
                layers.append(ConditionalResidualBlock(c_layer))
            elif self.time_dim is not None:
                c_layer.time_dim = self.time_dim
                layers.append(TemporalResidualBlock(c_layer))
            else:
                layers.append(ResidualBlock(c_layer))
            rk, rate = hp.resample_ksize[i], hp.resample_rates[i]
            if not isinstance(rate, int) or rate == 0:
                raise ValueError(f"bad resample rate {rate!r}")
            kw = dict(causal_padding=causal_padding,
                      future_padding=future_padding,
                      out_channels=out_channels[i])
            if rate in (1, -1):
                if in_channels[i] != out_channels[i]:
                    raise ValueError("a rate-1 layer keeps its width")
                samples.append(None)
            elif rate > 1:
                samples.append(Upsample(in_channels[i], rk, rate,
                                        c_layer.norm, **kw))
            else:
                samples.append(Downsample(in_channels[i], rk, -rate,
                                          c_layer.norm, **kw))
        self.layers = nn.ModuleList(layers)
        self.samples = nn.ModuleList(samples)
        self.skip_conv = nn.ModuleList(skip_conv)
        self.conditional = conditional
        self.linear = (Dense(input_dim, hp.init_channel)
                       if input_dim is not None else None)
        self.out_linear = (Dense(out_channels[-1], output_dim)
                           if output_dim is not None else None)
        self.final_norm = (get_norm(out_channels[-1], hp.layer.norm)
                           if hp.get("final_norm", False) else None)
        self.first_norm = (get_norm(hp.layer.in_channels, hp.layer.norm)
                           if hp.get("first_norm", False) else None)

    def forward(self, x: Masked, c: Optional[Masked] = None,
                t: Optional[torch.Tensor] = None) -> Masked:
        if self.linear is not None:
            x = Masked(self.linear(x.value), x.lengths, 1).apply_mask()
        if self.first_norm is not None:
            x = dataclasses.replace(x, value=self.first_norm(x.value))
        x = x.transpose()                      # (B, C, T) from here on
        c = c.transpose() if c is not None else None
        records = [x]
        for sample, layer, cond, skip, skp in zip(
                self.samples, self.layers, self.conditional,
                self.skip_connection, self.skip_conv):
            if cond and self.time_dim is not None:
                x = layer(x, c, t)
            elif cond:
                x = layer(x, c)
            elif self.time_dim is not None:
                x = layer(x, t)
            else:
                x = layer(x)
            if sample is not None:
                x = sample(x)
            if skip is not None:
                if not self.skip_concat:
                    x = x + records[skip]
                else:
                    x = x.cat(records[skip])
                    x = dataclasses.replace(x, value=skp(x.value))
            records.append(x)
        if self.final_norm is not None:
            x = dataclasses.replace(x, value=self.final_norm(x.value, dim=1))
        x = x.transpose()
        if self.out_linear is not None:
            x = Masked(self.out_linear(x.value), x.lengths, 1)
        return x.apply_mask()

    @property
    def sample_ratio(self) -> float:
        return _sample_ratio(self.hp.resample_rates)


class ConvNormAct(nn.Module):
    """conv | transposed conv -> norm -> act on NCW values (reference
    ``conv/layers.py:543-607``).  ``stride < 0``: strided downsampling
    conv; ``stride > 1``: transposed-conv upsampling; lengths follow
    through ``resize_length``; the dropout is JAX's (``Dropout``)."""

    def __init__(self, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("in_channels", "out_channels", "kernel_size",
                                "stride", "norm", "activation")
        padding = get_padding(hp.kernel_size,
                              causal=hp.get("causal_padding", False),
                              future=hp.get("future_padding", False))
        self.norm = get_norm(hp.out_channels, hp.norm)
        self.act = get_activation(hp.activation)
        if hp.stride < 0 or hp.stride == 1:
            stride = -hp.stride if hp.stride < 0 else hp.stride
            self.conv = Conv1d(hp.in_channels, hp.out_channels,
                               hp.kernel_size, stride=stride,
                               padding=padding)
            self.stride_ratio = 1.0 / float(stride)
        else:
            self.conv = ConvTranspose1d(hp.in_channels, hp.out_channels,
                                        hp.kernel_size, stride=hp.stride,
                                        padding=padding)
            self.stride_ratio = float(hp.stride)
        self.dropout = Dropout(hp.get("dropout", 0.0))

    def forward(self, x: Masked) -> Masked:
        h = self.dropout(self.act(self.norm(self.conv(x.value), dim=1)))
        if self.stride_ratio != 1.0:
            return Masked(h, resize_length(x.lengths, self.stride_ratio), 2)
        return dataclasses.replace(x, value=h)


class CNNStack(nn.Module):
    """Conv-norm-act pyramid (reference ``conv/layers.py:610-652``; the
    utterance encoder).  Takes and returns ``(B, T, C)``; runs NCW
    inside, unmasked between layers as in JAX."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer", "init_channel",
                                "out_channels", "resample_rates",
                                "resample_ksize")
        self.hp = hp
        n = hp.num_layers
        in_channels = ([hp.init_channel] + list(hp.out_channels))[:-1]
        if len(hp.resample_rates) != n:
            raise ValueError("resample_rates must have num_layers entries")
        layers = []
        for i in range(n):
            c_layer = hp.layer
            c_layer.in_channels = in_channels[i]
            c_layer.out_channels = hp.out_channels[i]
            c_layer.kernel_size = hp.resample_ksize[i]
            c_layer.stride = hp.resample_rates[i]
            layers.append(ConvNormAct(c_layer))
        self.layers = nn.ModuleList(layers)
        self.linear = (Dense(input_dim, hp.init_channel)
                       if input_dim is not None else None)
        self.out_linear = (Dense(hp.out_channels[-1], output_dim)
                           if output_dim is not None else None)

    def forward(self, x: Masked) -> Masked:
        if self.linear is not None:
            x = Masked(self.linear(x.value), x.lengths, 1).apply_mask()
        x = x.transpose()                      # (B, C, T) from here on
        for layer in self.layers:
            x = layer(x)
        x = x.transpose()
        if self.out_linear is not None:
            x = Masked(self.out_linear(x.value), x.lengths, 1)
        return x.apply_mask()

    @property
    def sample_ratio(self) -> float:
        return _sample_ratio(self.hp.resample_rates)
