"""Compact checkpoints (port of the compact track of
``vae_gslm_tpu/training/checkpoint.py``).

The deployment contract is the JAX package's: model-only parameters in
``{dir}/last-cpt.npz`` beside ``{dir}/hp.yaml``, the npz a flat
``flax path -> array`` dict (``models/convert.py::to_flat``), so a
checkpoint written by either package loads into the other.  Loading is
strict (``models/convert.py::load_flat``), where the JAX loader skips
missing or extra keys.  The Orbax full train state is not ported.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
from torch import nn

from ..models.convert import load_flat, to_flat


def save_compact(model: nn.Module, path: str) -> None:
    """Save an LVTR's or a HiFi-GAN generator's parameters as ``path``
    (npz) in the JAX package's flat contract."""
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
