"""Compact checkpoints (port of the compact track of
``vae_gslm_tpu/training/checkpoint.py``).

The deployment contract is the JAX package's: model-only parameters in
``{dir}/last-cpt.npz`` beside ``{dir}/hp.yaml``, the npz a flat
``flax path -> array`` dict (``models/convert.py::to_flat``), so a
checkpoint written by either package loads into the other.  Loading is
strict (``models/convert.py::load_flat``), where the JAX loader skips
missing or extra keys.

The full train state (parameters, AdamW moments and step, for an exact
resume) is the port's own: one file written by ``torch.save`` from
plain tensors and numbers (``save_train_state``), read back with
``weights_only=True``.  JAX's is an Orbax directory, which cannot be
read without Orbax, so a resume across the two packages goes through
the compact npz, which both trainers' ``resume`` accept.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..models.convert import load_flat, to_flat


def save_compact(model: nn.Module, path: str) -> None:
    """Save a model's parameters (an LVTR, a DiscreteAR, a HuBERT decoder
    or a HiFi-GAN generator) as ``path`` (npz) in the JAX package's flat
    contract."""
    np.savez(path, **to_flat(model))


def load_compact(model: nn.Module, path: str) -> None:
    """Strictly load a compact npz into ``model`` in place."""
    with np.load(path) as data:
        load_flat(model, {k: data[k] for k in data.files})


def get_last_ckpt(directory: str) -> str:
    """Newest ``*-cpt.npz`` or ``*-cpt.ckpt`` by its ``step=`` number
    (``last-cpt.*`` sorts first); raises if there is none."""
    cands = list(Path(directory).glob("*-cpt.npz")) + \
        list(Path(directory).glob("*-cpt.ckpt"))
    if not cands:
        raise FileNotFoundError(f"no compact checkpoint in {directory}")

    def step_of(p: Path):
        m = re.findall(r"step=(\d+)", p.stem)
        return int(m[0]) if m else -1

    return str(sorted(cands, key=step_of)[-1])


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` (nested dicts and lists of tensors and numbers;
    tensors are copied to the CPU) to ``path``, through a temporary
    file and a rename, so a reader never sees a half-written file."""
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [cpu(v) for v in x]
        return x

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(cpu(state), tmp)
    os.replace(tmp, path)


def restore_train_state(path: str) -> Dict[str, Any]:
    """The state ``save_train_state`` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
