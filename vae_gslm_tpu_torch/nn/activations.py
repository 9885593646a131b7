"""Activation factory (port of ``vae_gslm_tpu/nn/activations.py``)."""
from __future__ import annotations

import functools
from typing import Callable

import torch.nn.functional as F

from ..hparams.hp import Hparams


def gelu(x):
    # The exact (erf) formulation, like torch nn.GELU's default.
    return F.gelu(x, approximate="none")


def leaky_relu(x, slope):
    return F.leaky_relu(x, negative_slope=slope)


def identity(x):
    return x


def get_activation(hp: Hparams) -> Callable:
    ident = hp.identifier
    if ident == "ReLU":
        return F.relu
    if ident == "SELU":
        return F.selu
    if ident == "GELU":
        return gelu
    if ident == "LeakyRELU":
        return functools.partial(leaky_relu, slope=hp.slope)
    if ident == "SiLU":
        return F.silu
    raise ValueError(f"{ident} is not a known activation")
