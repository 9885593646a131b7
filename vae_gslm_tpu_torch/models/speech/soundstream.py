"""SoundStream-style mel autoencoder with a vector-quantized bottleneck
(port of ``vae_gslm_tpu/models/speech/soundstream.py``): a
``BottleNeckResNet`` encoder to the quantizer's width, the quantizer
(``nn/vq.py``) and a ``BottleNeckResNet`` decoder back to the mels.  No
kernel runs here: convolutions, norms and the code search are plain
PyTorch, as JAX leaves them to XLA."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked
from ...hparams.hp import Hparams
from ...nn.conv import BottleNeckResNet
from ...nn.vq import get_vector_quantizer
from .lvtr import init_parameters


class SoundStream(nn.Module):
    """``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` to run on the CPU.  Parameters are drawn from
    ``generator`` (seed 0 when omitted)."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hp.check_arg_in_hparams("encoder", "decoder", "quantizer")
        dev = resolve_device(device)
        self.hp = hp
        with torch.device(dev):
            self.encoder = BottleNeckResNet(hp.encoder, input_dim=input_dim,
                                            output_dim=hp.quantizer.dim)
            self.quantizer = get_vector_quantizer(hp.quantizer)
            self.decoder = BottleNeckResNet(hp.decoder,
                                            input_dim=hp.quantizer.dim,
                                            output_dim=input_dim)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        init_parameters(self, generator)

    @property
    def sample_ratio(self) -> float:
        return self.encoder.sample_ratio

    def forward(self, x: Masked) -> Dict[str, object]:
        """Mels (B, T, n_mels) -> ``reconstruction`` (Masked mels) and
        ``aux_loss`` (the quantizer's loss)."""
        z = self.encoder(x)
        vq = self.quantizer(z)
        return {"reconstruction": self.decoder(vq.quantized),
                "aux_loss": vq.loss}
