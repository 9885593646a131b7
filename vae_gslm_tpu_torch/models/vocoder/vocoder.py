"""The vocoder wrappers and their pretrained-checkpoint loading (port of
``HiFiGAN`` and ``HuBERTIO`` in ``vae_gslm_tpu/models/vocoder/vocoder.py``).

The checkpoint directory contract is the JAX package's: ``{path}/hp.yaml``
(``feature`` and ``model.generator``) and ``{path}/last-cpt.npz`` (the
JAX compact npz, weight-norm ``g``/``v`` pairs) or ``last-cpt.ckpt`` (a
reference torch state dict), else the newest ``*-cpt.*``.  The weights
load into the weight-normed generator, whose norm ``from_pretrained``
then folds (JAX ``vocoder.py:149-161``), so decoding runs plain convs on
folded weights.

``HuBERTIO`` is the token LM's frozen codec: the HuBERT token -> mel
decoder (``hubert.py``) in front of a HiFi-GAN.  Its directory holds
``hp.yaml`` (``model``, the decoder's config, and ``vocoder.path``, the
HiFi-GAN's directory) and the decoder's ``last-cpt.npz`` (JAX's compact
contract) or ``last-cpt.ckpt`` (a reference state dict, through
``models/convert.py::load_reference_hubert_decoder``).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ...core.masked import Masked
from ...hparams.hp import Hparams
from ...training.checkpoint import get_last_ckpt, load_compact, save_compact
from ..convert import load_reference_generator, load_reference_hubert_decoder
from .hfgan import Generator
from .hubert import HuBERT


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


class HuBERTIO:
    """HiFi-GAN + HuBERT token -> mel codec.  ``decode`` takes tokens (B,
    T) to waves; ``encode_mel`` is the identity, as in JAX.  ``device``
    defaults to CUDA and raises without it; the decoder's weights are
    drawn from ``generator`` until a checkpoint replaces them."""

    def __init__(self, hp: Hparams, hp_rescale: Optional[Hparams] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.vocoder = HiFiGAN.from_pretrained(hp.vocoder.path,
                                               hp_rescale=hp_rescale,
                                               device=device)
        self.hp = self.vocoder.hp
        self.full_hp = hp
        self.model = HuBERT(hp.model, self.hp.n_mels,
                            self.hp.sample_rate / self.hp.hop_length,
                            device=device, generator=generator)
        self.hp_vq = Hparams(num_quantizers=1,
                             codebook_size=hp.model.hubert.vocab_size,
                             dim=hp.model.embedding_dim)

    def match_spec(self, hp: Hparams) -> bool:
        return hp == self.hp

    @torch.no_grad()
    def decode(self, signal: Masked,
               generator: Optional[torch.Generator] = None,
               spkr: Optional[Masked] = None,
               f0: Optional[Masked] = None) -> Masked:
        """Tokens (B, T) -> the condition -> a mel by diffusion (drawing
        from ``generator``, seed 0 when omitted) -> the wave."""
        if generator is None:
            generator = torch.Generator(signal.value.device).manual_seed(0)
        cond = self.model.encode(signal, spkr, f0)
        return self.vocoder.decode(self.model.decode(cond, generator))

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "HuBERTIO":
        hp = Hparams.from_yamlfile(os.path.join(path, "hp.yaml"))
        hp.check_arg_in_hparams("model", "vocoder")
        voc = cls(hp, **kwargs)
        ckpt = find_ckpt(path)
        if ckpt.endswith(".npz"):
            load_compact(voc.model, ckpt)
        else:
            load_reference_hubert_decoder(voc.model,
                                          load_torch_state_dict(ckpt))
        return voc

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.full_hp.save(os.path.join(path, "hp.yaml"))
        save_compact(self.model, os.path.join(path, "last-cpt.npz"))

    def encode_mel(self, mel: Masked) -> Masked:
        return mel

    @property
    def sample_ratio(self) -> float:
        return self.model.sample_ratio
