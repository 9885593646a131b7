"""Weights carried into the port from the reference's state dicts.

The port's modules use the reference's state-dict names and torch
layouts, so loading is a rename of a few top-level prefixes plus a
strict ``load_state_dict``: every port parameter must be covered and
no key may be left over.  ``load_reference_lvtr`` takes exactly what
``vae_gslm_tpu/models/convert_torch.py::export_torch_lvtr`` returns (or
a reference checkpoint's state dict); ``load_reference_generator``
takes the reference HiFi-GAN generator's state dict in either
weight-norm form (``weight_g``/``weight_v`` or
``parametrizations.weight.original0/1``) or with weight norm removed,
and folds it.  ``mega_weights_from_numpy`` carries the int8 K2 weights
of a JAX ``build_mega_decode()`` dict across as they are.  None of them
imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from ..ops.mega_step import WEIGHT_KEYS

# reference top-level prefix -> port attribute
_LVTR_PREFIXES = (("encoder.0.", "encoder_net."),
                  ("encoder.1.", "encoder_head."),
                  ("transformer.0.", "transformer."),
                  ("transformer.1.", "prior_head."),
                  ("utterance_encoder.0.", "utterance_net."))


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.tensor(np.asarray(v))


def _rename(key: str) -> str:
    for old, new in _LVTR_PREFIXES:
        if key.startswith(old):
            return new + key[len(old):]
    return key


def load_reference_lvtr(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference-keyed LVTR state dict into the port."""
    model.load_state_dict({_rename(k): _tensor(v) for k, v in sd.items()},
                          strict=True)


def _fold(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight norm (dim=0): w = g * v / ||v||, the norm over every
    axis but the first, with the JAX package's 1e-12 inside the root."""
    g, v = g.double(), v.double()
    norm = torch.sqrt(v.square().sum(dim=tuple(range(1, v.dim())),
                                     keepdim=True) + 1e-12)
    return (g.reshape((-1,) + (1,) * (v.dim() - 1)) * v / norm).float()


def load_reference_generator(gen: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference HiFi-GAN generator state dict, folding
    weight norm into plain ``weight`` tensors."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for key in gen.state_dict():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "bias":
            out[key] = sd.pop(key)
        elif f"{prefix}.weight_g" in sd:
            out[key] = _fold(sd.pop(f"{prefix}.weight_g"),
                             sd.pop(f"{prefix}.weight_v"))
        elif f"{prefix}.parametrizations.weight.original0" in sd:
            out[key] = _fold(
                sd.pop(f"{prefix}.parametrizations.weight.original0"),
                sd.pop(f"{prefix}.parametrizations.weight.original1"))
        else:
            out[key] = sd.pop(key)
    if sd:
        raise KeyError(f"unexpected generator keys: {sorted(sd)}")
    gen.load_state_dict(out, strict=True)


def mega_weights_from_numpy(d: Mapping,
                            device: Union[str, torch.device] = "cpu"
                            ) -> Dict[str, torch.Tensor]:
    """The port's K2 weights dict from the arrays of a JAX
    ``TransformerLayerStack.build_mega_decode()`` dict (numpy or array
    likes): the same (L, din, dout) int8 weights and float32 vectors,
    contiguous, with nothing requantized."""
    extra = sorted(set(d) - set(WEIGHT_KEYS))
    if extra:
        raise KeyError(f"unexpected mega weight keys: {extra}")
    out = {}
    for key in WEIGHT_KEYS:
        v = np.array(d[key])          # a writable, contiguous copy
        want = np.int8 if key.startswith("w") else np.float32
        if v.dtype != want:
            raise TypeError(f"{key}: dtype {v.dtype}, expected {want}")
        out[key] = torch.from_numpy(v).to(device)
    return out
