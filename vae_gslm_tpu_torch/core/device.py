"""Device selection for the port's entry points.

Builders and samplers default to ``"cuda"``.  Without a CUDA device
they raise instead of falling back to the CPU; callers that mean the
CPU (the CPU tests) ask for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vae_gslm_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    if dev.index is None:      # "cuda" -> "cuda:<current>", as tensors say
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
