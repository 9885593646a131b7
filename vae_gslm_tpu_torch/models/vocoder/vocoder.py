"""The HiFi-GAN vocoder wrapper and its pretrained-checkpoint loading (port
of ``HiFiGAN`` in ``vae_gslm_tpu/models/vocoder/vocoder.py``).

The checkpoint directory contract is the JAX package's: ``{path}/hp.yaml``
(``feature`` and ``model.generator``) and ``{path}/last-cpt.npz`` (the
JAX compact npz, weight-norm ``g``/``v`` pairs) or ``last-cpt.ckpt`` (a
reference torch state dict), else the newest ``*-cpt.*``.  The weights
load into the weight-normed generator, whose norm ``from_pretrained``
then folds (JAX ``vocoder.py:149-161``), so decoding runs plain convs on
folded weights.  ``HuBERTIO`` waits for the discrete-AR slice
(ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ...core.masked import Masked
from ...hparams.hp import Hparams
from ...training.checkpoint import get_last_ckpt, load_compact, save_compact
from ..convert import load_reference_generator
from .hfgan import Generator


def find_ckpt(path: str) -> str:
    for name in ("last-cpt.npz", "last-cpt.ckpt"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return p
    return get_last_ckpt(path)


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint file's flat state dict (``state_dict`` unwrapped
    where the file nests it)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


class HiFiGAN:
    """``hp`` is the feature config (the mel frontend the vocoder was
    trained on); ``decode`` un-rescales a mel and runs the generator.
    ``device`` defaults to CUDA and raises without it."""

    def __init__(self, hp: Hparams, hp_rescale: Optional[Hparams] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.hp = hp.feature
        self.full_hp = hp
        self.hp_rescale = hp_rescale
        self.model = Generator(hp.model.generator, device=device,
                               generator=generator)

    def match_spec(self, hp: Hparams) -> bool:
        return hp == self.hp

    @torch.no_grad()
    def decode(self, signal: Masked) -> Masked:
        if self.hp_rescale is not None:
            signal = Masked(signal.value * self.hp_rescale.std
                            + self.hp_rescale.mean, signal.lengths,
                            1).apply_mask()
        return self.model(signal).apply_mask()

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "HiFiGAN":
        hp = Hparams.from_yamlfile(os.path.join(path, "hp.yaml"))
        hp.check_arg_in_hparams("model", "feature")
        hp.model.check_arg_in_hparams("generator")
        voc = cls(hp, **kwargs)
        ckpt = find_ckpt(path)
        if ckpt.endswith(".npz"):
            load_compact(voc.model, ckpt)
        else:
            load_reference_generator(voc.model, load_torch_state_dict(ckpt))
        voc.model.remove_weight_norm()
        return voc

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.full_hp.save(os.path.join(path, "hp.yaml"))
        save_compact(self.model, os.path.join(path, "last-cpt.npz"))
