"""Dense layers, embeddings (one table, or ``RVQEmbedding``'s sum of
per-quantizer tables), FiLM, the residual MLP stack, the time pool, the
Gaussian head and the straight-through Gumbel-softmax head (port of
``vae_gslm_tpu/nn/linear.py``).

Weights keep the reference's torch layout and state-dict names
(``weight`` (out, in), ``bias``).  Matmuls run in the policy's compute
dtype; distribution math (logstd, sampling) runs float32.  Random draws
take an explicit ``torch.Generator`` where JAX takes a key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.masked import Masked
from ..core.precision import get_policy
from ..hparams.hp import Hparams
from .activations import get_activation, identity
from .norms import get_norm


def uniform_(t: torch.Tensor, bound: float, generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """Linear layer with torch-style default init, policy-aware compute.

    ``quantize_int8()`` converts the weight in place to int8 with one
    float32 scale per output feature (``weight_scale`` (out, 1)), the
    inference-only mode of the JAX package; the forward then upconverts
    it in the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.register_buffer("weight_scale", None)

    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.in_dim)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    @torch.no_grad()
    def quantize_int8(self) -> None:
        """Symmetric int8 per output feature: the amax runs over the input
        axis of the (out, in) weight (JAX's per-column scale of its
        (in, out) kernel), ``round(w / scale)`` with scale
        ``max(amax, 1e-8) / 127`` divided by a tensor."""
        if self.weight.dtype == torch.int8:
            return
        w = self.weight.float()
        amax = w.abs().amax(dim=1, keepdim=True)
        scale = amax.clamp(min=1e-8) / torch.tensor(127.0, device=w.device)
        self.weight = nn.Parameter(torch.round(w / scale).to(torch.int8),
                                   requires_grad=False)
        self.weight_scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        w = self.weight.to(dt)
        if self.weight.dtype == torch.int8:
            w = w * self.weight_scale.to(dt)
        return F.linear(x.to(dt), w, b)


class Linear(nn.Module):
    """Masked Linear with fused activation; the reference nests the
    dense layer as ``.linear`` (state-dict key ``<name>.linear.weight``)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 activation: Callable = identity):
        super().__init__()
        self.linear = Dense(in_dim, out_dim, bias=bias)
        self.activation = activation

    def forward(self, x: Masked) -> Masked:
        return dataclasses.replace(
            x, value=self.activation(self.linear(x.value)))


class Embedding(nn.Module):
    """Token embedding that zeroes padded positions."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        return self.weight.to(dt)[ids.long()]

    def forward(self, ids: Masked) -> Masked:
        return Masked(self.lookup(ids.value), ids.lengths, 1).apply_mask()


class RVQEmbedding(nn.Module):
    """Sum of per-quantizer codebook embeddings of ids (B, T, n):
    ``tables`` (n, codebook, dim)."""

    def __init__(self, num_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.tables = nn.Parameter(torch.empty(num_quantizers, codebook_size,
                                               dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.tables.normal_(generator=generator)

    def forward(self, ids: Masked) -> Masked:
        dt = get_policy().compute_dtype
        idx = ids.value.long()
        tabs = self.tables.to(dt)
        out = tabs[0][idx[..., 0]]
        for i in range(1, self.num_quantizers):
            out = out + tabs[i][idx[..., i]]
        return Masked(out, ids.lengths, 1).apply_mask()


class LinearBlock(nn.Module):
    """Residual MLP block: x + linear2(act(norm2(linear1(act(norm1(x))))))
    (reference ``linear/layers.py:196-234``)."""

    def __init__(self, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("hidden_dim", "activation", "norm")
        bias = hp.get("bias", True)
        d = hp.hidden_dim
        self.linear1 = Dense(d, d, bias=bias)
        self.linear2 = Dense(d, d, bias=bias)
        self.norm1 = get_norm(d, hp.norm)
        self.norm2 = get_norm(d, hp.norm)
        self.activation = get_activation(hp.activation)

    def forward(self, x: Masked) -> Masked:
        r = self.linear1(self.activation(self.norm1(x.value)))
        r = self.linear2(self.activation(self.norm2(r)))
        return Masked(x.value + r, x.lengths, 1).apply_mask()


class LinearLayerStack(nn.Module):
    """``LinearBlock``s with optional in/out projections (reference
    ``linear/layers.py:237-257``)."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer")
        d = hp.layer.hidden_dim
        self.layers = nn.ModuleList([LinearBlock(hp.layer)
                                     for _ in range(hp.num_layers)])
        self.linear = Dense(input_dim, d) if input_dim is not None else None
        self.out_linear = (Dense(d, output_dim) if output_dim is not None
                           else None)

    def forward(self, x: Masked) -> Masked:
        if self.linear is not None:
            x = Masked(self.linear(x.value), x.lengths, 1).apply_mask()
        for layer in self.layers:
            x = layer(x)
        if self.out_linear is not None:
            x = Masked(self.out_linear(x.value), x.lengths, 1).apply_mask()
        return x


class FiLM(nn.Module):
    """Feature-wise linear modulation.  ``time_first`` (channel-last
    input, the flow couplings) holds an ``nn.Linear``-layout weight;
    otherwise a 1x1 ``Conv1d``-layout weight applied along channel
    axis 1 (the NCW conv blocks), as the reference does."""

    def __init__(self, dim: int, in_dim: Optional[int] = None,
                 time_first: bool = True, bias: bool = True):
        super().__init__()
        in_dim = dim if in_dim is None else in_dim
        self.dim = dim
        self.time_first = time_first
        if time_first:
            self.linear = Dense(in_dim, 2 * dim, bias=bias)
        else:
            from .conv import Conv1d
            self.linear = Conv1d(in_dim, 2 * dim, 1, bias=bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        wb = self.linear(c)
        axis = -1 if self.time_first else 1
        weight, bias = wb.split(self.dim, dim=axis)
        return weight * x + bias


class TimeAggregation(nn.Module):
    """Masked mean-pool over time: (B, T, C) -> (B, C)."""

    def forward(self, x: Masked) -> torch.Tensor:
        return x.time_mean()


@dataclasses.dataclass
class GaussianOutput:
    mean: Masked
    logstd: Masked
    sample: Masked


def truncated_normal(lo: float, hi: float, shape, generator,
                     device) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by the inverse CDF."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa
    a, b = cdf(lo), cdf(hi)
    u = torch.rand(shape, generator=generator, device=device)
    u = (a + (b - a) * u).clamp(min=1e-7, max=1.0 - 1e-7)
    return torch.special.ndtri(u).clamp(lo, hi)


class GaussianParameterize(nn.Module):
    """Mean/logstd heads + reparameterised sampling (the VAE posterior
    head q(z|x) and the AR prior head p(z_t|z_<t)).  The heads are
    named ``mean``/``logstd`` like the reference's state dict;
    ``fix_mean`` is the JAX package's fixed-``mean`` option."""

    def __init__(self, in_dim: int, dim: int, bias: bool = True,
                 std: Optional[float] = None,
                 std_range: Optional[Tuple[float, float]] = None,
                 truncated_norm: Optional[Tuple[float, float]] = None,
                 total_std: Optional[float] = None,
                 normalization: bool = False,
                 fix_mean: Optional[float] = None):
        super().__init__()
        self.dim = dim
        self.fix_mean = fix_mean
        self.mean = Dense(in_dim, dim, bias=bias) if fix_mean is None \
            else None
        self.std = std
        self.logstd = Dense(in_dim, dim, bias=bias) if std is None else None
        if std_range is not None and (std is not None
                                      or len(std_range) != 2):
            raise ValueError("std_range needs two values and no fixed std")
        if total_std is not None and (std is not None
                                      or std_range is not None):
            raise ValueError("total_std excludes std and std_range")
        self.std_range = std_range
        self.total_std = total_std
        self.truncated_norm = truncated_norm
        self.normalization = normalization

    def _stats(self, xv: torch.Tensor):
        if self.mean is not None:
            mean = self.mean(xv).float()
        else:
            mean = torch.full(xv.shape[:-1] + (self.dim,), self.fix_mean,
                              dtype=torch.float32, device=xv.device)
        if self.normalization:
            mean = mean / mean.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        if self.logstd is not None:
            logstd = self.logstd(xv).float()
            if self.std_range is not None:
                _max, _min = self.std_range
                std = torch.sigmoid(logstd) * (_max - _min) + _min
                logstd = torch.log(std)
        else:
            logstd = torch.full_like(mean, math.log(self.std))
        if self.total_std is not None:
            std = torch.exp(logstd)
            std = std / std.sum(-1, keepdim=True)
            std = std * self.total_std * std.shape[-1]
            logstd = torch.log(std)
        return mean, logstd

    def forward(self, x: Masked, generator: Optional[torch.Generator],
                temperature: float = 1.0,
                truncated_norm: Optional[Tuple[float, float]] = None,
                noise: Optional[torch.Tensor] = None) -> GaussianOutput:
        """``noise`` replaces the draw from ``generator`` (the tests hand
        both packages the same standard-normal tensor)."""
        mean, logstd = self._stats(x.value)
        tn = truncated_norm if truncated_norm is not None \
            else self.truncated_norm
        if noise is not None:
            noise = noise.to(mean.device, torch.float32)
        elif tn is not None:
            noise = truncated_normal(tn[0], tn[1], mean.shape, generator,
                                     mean.device)
        else:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        sample = mean + noise * torch.exp(logstd) * temperature
        return GaussianOutput(mean=Masked(mean, x.lengths, 1),
                              logstd=Masked(logstd, x.lengths, 1),
                              sample=Masked(sample, x.lengths, 1))


class GumbelSoftMaxParameterize(nn.Module):
    """Straight-through Gumbel-softmax head (reference
    ``linear/layers.py:13-51``): logits over ``num_codebooks`` scaled by
    1/sqrt(in_dim), a Gumbel-perturbed softmax at ``temperature``, its
    one-hot argmax in the forward with the soft gradient, projected by
    ``encode_linear``.  The uniform draw comes from ``generator`` or is
    given as ``u``."""

    def __init__(self, in_dim: int, num_codebooks: int, codebook_dim: int,
                 temperature: float = 1.0):
        super().__init__()
        self.in_dim = in_dim
        self.in_linear = Dense(in_dim, num_codebooks, bias=False)
        self.encode_linear = Dense(num_codebooks, codebook_dim, bias=False)
        self.temperature = temperature

    def forward(self, x: Masked, generator: Optional[torch.Generator],
                temperature: Optional[float] = None,
                u: Optional[torch.Tensor] = None) -> dict:
        logits = self.in_linear(x.value).float()
        logits = logits / torch.tensor(math.sqrt(self.in_dim))
        if temperature is None:
            temperature = self.temperature
        if u is None:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
        eps = 1e-20
        gumbel = -torch.log(-torch.log(u.to(logits.device) + eps) + eps)
        y = torch.softmax((logits + gumbel) / torch.tensor(temperature),
                          dim=-1)
        y_hard = F.one_hot(y.argmax(dim=-1), y.shape[-1]).to(y.dtype)
        y_st = y + (y_hard - y).detach()
        return dict(
            logits=Masked(logits, x.lengths, 1).apply_mask(-1000.0),
            output=Masked(self.encode_linear(y_st), x.lengths,
                          1).apply_mask(),
            gumbel_prob=Masked(y, x.lengths, 1).apply_mask())
