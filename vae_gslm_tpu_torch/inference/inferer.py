"""Base inferer: the checkpoint-directory contract (port of
``vae_gslm_tpu/inference/inferer.py``).

``{ckpt_path}/hp.yaml`` is the train-time config and the source of truth
at inference; the model class comes from the inference config's dotted
``model.identifier`` (``scripts/registry.py``); its weights from
``{ckpt_path}/last-cpt.npz`` (the JAX compact contract, loaded strictly)
or, failing that, the newest ``*-cpt.*`` there, where a ``.ckpt`` is a
reference torch state dict (the released artifacts) of an LVTR or a
DiscreteAR.  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
from typing import Any, Union

import torch

from ..core.device import resolve_device
from ..data.loader import DataLoader, get_dataloader
from ..hparams.hp import Hparams
from ..models.convert import load_reference_discrete_ar, load_reference_lvtr
from ..models.speech.discrete import DiscreteAR
from ..models.speech.lvtr import LVTR
from ..models.vocoder.vocoder import load_torch_state_dict
from ..parallel.mesh import process_count, process_index
from ..scripts.registry import resolve
from ..training.checkpoint import get_last_ckpt, load_compact


class BaseInferer:
    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        hp.check_arg_in_hparams("ckpt_path")
        self.hp = hp
        self.device = resolve_device(device)
        self.hp_model = Hparams.from_yamlfile(
            os.path.join(hp.ckpt_path, "hp.yaml"))

    def load_model(self, *args, **kwargs) -> Any:
        """Build ``hp.model.identifier`` from the checkpoint's model config
        on the inferer's device and load its weights."""
        cls = resolve(self.hp.model.identifier)
        model = cls(self.hp_model.model, *args, device=self.device, **kwargs)
        ckpt = os.path.join(self.hp.ckpt_path, "last-cpt.npz")
        if not os.path.exists(ckpt):
            ckpt = get_last_ckpt(self.hp.ckpt_path)
        if ckpt.endswith(".npz"):
            load_compact(model, ckpt)
        elif isinstance(model, LVTR):
            load_reference_lvtr(model, load_torch_state_dict(ckpt))
        elif isinstance(model, DiscreteAR):
            load_reference_discrete_ar(model, load_torch_state_dict(ckpt))
        else:
            raise NotImplementedError(
                f"torch checkpoints of {type(model).__name__}")
        self.model = model
        return model

    def get_dataloader(self, hp: Hparams, dataset) -> DataLoader:
        trainer = self.hp.get("trainer", None)
        distributed = bool(trainer.get("distributed", False)) \
            if trainer is not None else False
        return get_dataloader(hp, dataset, distributed, process_count(),
                              process_index())

    def synchronize(self) -> None:
        """Wait for the inferer's device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
