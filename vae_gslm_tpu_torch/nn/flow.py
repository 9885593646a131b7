"""Coupling flows (port of ``TensorLogdet``, ``LinearCoupling``,
``ConvCoupling``, ``RationalQuadraticSplineCoupling`` and
``CouplingStack`` from ``vae_gslm_tpu/nn/flow.py``).

``forward`` (training) maps latents through the couplings and sums
their masked log-determinants; ``reverse`` (the AR sampler) maps prior
samples back.  The reference's ``_max, _min = scale_range`` unpack order
is preserved.  ``ConvCoupling.reverse`` runs the same conv path as its
forward (the reference's calls layers it never defined); the spline
reshapes its statistics to (B, T, dim/2, 3 bins - 1), as JAX does, and
runs its math in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from .activations import get_activation
from .conv import Conv1d, get_padding
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


class ConvCoupling(nn.Module):
    """Affine coupling whose statistics come from a conv over time of
    [x0, condition] (reference ``flow/layers.py:102-196``, B T C here:
    the convs run NCW inside)."""

    def __init__(self, dim: int, flip: bool, hp: Hparams,
                 condition_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("hidden_dim", "activation", "mean_only",
                                "norm", "kernel_size")
        self.mean_only = hp.mean_only
        self.condition_dim = condition_dim
        padding = get_padding(hp.kernel_size,
                              causal=hp.get("causal_padding", False),
                              future=hp.get("future_padding", False))
        self.conv1 = Conv1d(dim // 2 + (condition_dim or 0), hp.hidden_dim,
                            hp.kernel_size, padding=padding,
                            bias=bool(hp.get("bias", False)))
        self.conv2 = Conv1d(hp.hidden_dim,
                            dim // 2 if hp.mean_only else dim, 1,
                            bias=bool(hp.get("bias", True)))
        self.norm = get_norm(hp.hidden_dim, hp.norm)
        self.activation = get_activation(hp.activation)
        self.flip = flip
        self.scale_range = hp.get("scale_range", None)
        self.detach_coupling = hp.get("detach_coupling", False)
        self.half = dim // 2

    def _stats(self, x0: torch.Tensor, c: Optional[torch.Tensor]):
        inp = x0
        if c is not None and self.condition_dim is not None:
            inp = torch.cat([x0, c.to(x0.dtype)], dim=-1)
        h = self.norm(self.conv1(inp.transpose(1, 2)), dim=1)
        stats = self.conv2(self.activation(h)).transpose(1, 2).float()
        if self.mean_only:
            return stats, torch.zeros_like(stats)
        m, logs = stats[..., :self.half], stats[..., self.half:]
        if self.scale_range is not None:
            logs = _bounded_logscale(logs, self.scale_range)
        return m, logs

    forward = LinearCoupling.forward
    reverse = LinearCoupling.reverse


class RationalQuadraticSplineCoupling(nn.Module):
    """Monotonic rational-quadratic spline coupling (reference
    ``flow/spline.py:21-218``): ``num_bins`` bins on [-tail_bound,
    tail_bound], the identity outside; float32 math.  An input on a knot
    belongs to the bin that starts there (``x >= knot``), as in JAX."""

    def __init__(self, dim: int, flip: bool, hp: Hparams,
                 condition_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("hidden_dim", "activation", "num_bins",
                                "tail_bound", "norm")
        self.min_bin_width = hp.get("min_bin_width", 1e-3)
        self.min_bin_height = hp.get("min_bin_height", 1e-3)
        self.min_bin_derivative = hp.get("min_bin_derivative", 1e-3)
        self.condition_dim = condition_dim
        self.num_bins = hp.num_bins
        self.hidden_dim = hp.hidden_dim
        self.linear1 = Dense(dim // 2 + (condition_dim or 0), hp.hidden_dim,
                             bias=bool(hp.get("bias", False)))
        self.linear2 = Dense(hp.hidden_dim,
                             (self.num_bins * 3 - 1) * (dim // 2),
                             bias=bool(hp.get("bias", True)))
        self.norm = get_norm(hp.hidden_dim, hp.norm)
        self.activation = get_activation(hp.activation)
        self.flip = flip
        self.tail_bound = hp.tail_bound
        self.half = dim // 2

    def _stats(self, x0: torch.Tensor, c: Optional[torch.Tensor]):
        inp = x0
        if c is not None and self.condition_dim is not None:
            inp = torch.cat([x0, c.to(x0.dtype)], dim=-1)
        stats = self.linear2(self.activation(self.norm(self.linear1(inp))))
        stats = stats.float().reshape(stats.shape[:-1] + (
            self.half, self.num_bins * 3 - 1))
        nb = self.num_bins
        return stats[..., :nb], stats[..., nb:2 * nb], stats[..., 2 * nb:]

    def _edges(self, u: torch.Tensor, lo: float, hi: float,
               min_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Knots (..., bins + 1) from lo to hi and bin sizes (..., bins)
        of unnormalized sizes ``u``."""
        sizes = torch.softmax(u / torch.tensor(math.sqrt(self.hidden_dim)),
                              dim=-1)
        sizes = min_size + (1 - min_size * self.num_bins) * sizes
        cum = torch.cat([torch.zeros_like(sizes[..., :1]),
                         torch.cumsum(sizes, dim=-1)], dim=-1)
        cum = (hi - lo) * cum + lo
        cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                         torch.full_like(cum[..., :1], hi)], dim=-1)
        return cum, cum[..., 1:] - cum[..., :-1]

    def knots(self, uw, uh, ud):
        """(cumw, widths, cumh, heights, derivatives) of the statistics."""
        tb = self.tail_bound
        cumw, widths = self._edges(uw, -tb, tb, self.min_bin_width)
        cumh, heights = self._edges(uh, -tb, tb, self.min_bin_height)
        const = torch.full_like(ud[..., :1], math.log(
            math.exp(1 - self.min_bin_derivative) - 1))
        ud = torch.cat([const, ud, const], dim=-1)
        derivs = self.min_bin_derivative + torch.logaddexp(
            ud, torch.zeros_like(ud))
        return cumw, widths, cumh, heights, derivs

    def bins(self, knots: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The bin of each x: the count of knots <= x (the last knot
        raised by 1e-6) less one, clipped to the bins (..., 1)."""
        knots = torch.cat([knots[..., :-1], knots[..., -1:] + 1e-6], dim=-1)
        idx = (x[..., None] >= knots).sum(dim=-1) - 1
        return idx.clamp(0, self.num_bins - 1)[..., None]

    def _spline(self, inputs: torch.Tensor, uw, uh, ud, inverse: bool):
        tb = self.tail_bound
        cumw, widths, cumh, heights, derivs = self.knots(uw, uh, ud)
        idx = self.bins(cumh if inverse else cumw, inputs)

        def take(a):
            return a.gather(-1, idx)[..., 0]

        in_cumw, in_w, in_cumh, in_h = (take(a) for a in (cumw, widths,
                                                          cumh, heights))
        in_delta = take(heights / widths)
        in_d, in_d1 = take(derivs), take(derivs[..., 1:])
        common = in_d + in_d1 - 2 * in_delta
        if inverse:
            y = inputs - in_cumh
            a = y * common + in_h * (in_delta - in_d)
            b = in_h * in_d - y * common
            c = -in_delta * y
            disc = b.square() - 4 * a * c
            theta = (2 * c) / (-b - torch.sqrt(disc.clamp(min=0.0)))
            outputs = theta * in_w + in_cumw
        else:
            theta = (inputs - in_cumw) / in_w
        t1m = theta * (1 - theta)
        denom = in_delta + common * t1m
        if not inverse:
            num = in_h * (in_delta * theta.square() + in_d * t1m)
            outputs = in_cumh + num / denom
        dnum = in_delta.square() * (in_d1 * theta.square()
                                    + 2 * in_delta * t1m
                                    + in_d * (1 - theta).square())
        logabsdet = torch.log(dnum) - 2 * torch.log(denom)
        if inverse:
            logabsdet = -logabsdet
        interior = (inputs >= -tb) & (inputs <= tb)
        zero = torch.zeros((), device=inputs.device)
        return (torch.where(interior, outputs, inputs),
                torch.where(interior, logabsdet, zero))

    def forward(self, x: TensorLogdet,
                c: Optional[Masked] = None) -> TensorLogdet:
        xm = x.tensor
        x0 = xm.value[..., :self.half].float()
        x1 = xm.value[..., self.half:].float()
        if self.flip:
            x0, x1 = x1, x0
        w, h, d = self._stats(x0, c.value if c is not None else None)
        x1, logdet = self._spline(x1, w, h, d, inverse=False)
        logdet = torch.where(xm.expanded_mask(), logdet,
                             torch.zeros((), device=logdet.device))
        return TensorLogdet(Masked(torch.cat([x0, x1], dim=-1), xm.lengths,
                                   xm.time_axis), x.logdet + logdet)

    def reverse(self, x: Masked, c: Optional[Masked] = None) -> Masked:
        x0 = x.value[..., :self.half].float()
        x1 = x.value[..., self.half:].float()
        w, h, d = self._stats(x0, c.value if c is not None else None)
        x1, _ = self._spline(x1, w, h, d, inverse=True)
        if self.flip:
            x0, x1 = x1, x0
        return Masked(torch.cat([x0, x1], dim=-1), x.lengths, x.time_axis)


COUPLINGS = {"RationalQuadraticSplineCoupling":
             RationalQuadraticSplineCoupling,
             "LinearCoupling": LinearCoupling,
             "ConvCoupling": ConvCoupling}


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
        if identifier not in COUPLINGS:
            raise ValueError(f"{identifier} is not supported")
        self.layers = nn.ModuleList([
            COUPLINGS[identifier](dim, True, hp.layer,
                                  condition_dim=condition_dim)
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
