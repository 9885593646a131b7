"""LVTTS, the text-to-speech LVTR (port of
``vae_gslm_tpu/models/tts/lvtr.py``).

The LVTR's trunk cross-attends over a text memory: the symbols'
``Embedding`` (the pad row zeroed) through a non-causal
``TransformerLayerStack`` (dense attention, no kernel), projected by the
trunk's ``memory_linear``.  A ``BottleNeckResNet`` over a speaker
reference mel, mean-pooled over time, gives the speaker embedding; the
``eos_head`` (a ``LinearLayerStack`` to one logit) reads the trunk's
output.  ``spkr_film`` is built and, as in JAX and the reference, never
applied; it is kept for the checkpoint's shape.  Randomness as in
``LVTR``: one ``torch.Generator`` consumed in call order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ...core.masked import Masked
from ...hparams.hp import Hparams
from ...nn.conv import BottleNeckResNet
from ...nn.linear import Embedding, FiLM, LinearLayerStack, TimeAggregation
from ...nn.transformer import TransformerLayerStack
from ..speech.lvtr import LVTR


class LVTTS(LVTR):
    """``symbols``: the text symbol table (``data/symbols.py``);
    ``device`` and ``generator`` as ``LVTR``'s."""

    def __init__(self, hp: Hparams, symbols, input_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        hp.check_arg_in_hparams("text", "eos", "spkr")
        hp.text.check_arg_in_hparams("embedding_dim", "encoder")
        hp.spkr.check_arg_in_hparams("embedding_dim")
        hp.transformer.layer.check_arg_in_hparams("cross_attn")
        self._symbols = (symbols.num_symbols, symbols.pad_idx)
        super().__init__(hp, input_dim, device, generator,
                         memory_dim=hp.text.encoder.layer.dim)
        with torch.no_grad():                 # padding_idx: the pad row 0
            self.text_embedding.weight[self.pad_idx] = 0.0

    def _build(self, hp: Hparams, input_dim: Optional[int],
               memory_dim: Optional[int]) -> None:
        super()._build(hp, input_dim, memory_dim)
        num_symbols, self.pad_idx = self._symbols
        tr_dim = hp.transformer.layer.dim
        self.text_embedding = Embedding(num_symbols, hp.text.embedding_dim)
        self.text_encoder = TransformerLayerStack(
            hp.text.encoder, input_dim=hp.text.embedding_dim)
        self.eos_head = LinearLayerStack(hp.eos, input_dim=tr_dim,
                                         output_dim=1)
        self.spkr_encoder = BottleNeckResNet(
            hp.spkr, input_dim=input_dim, output_dim=hp.spkr.embedding_dim)
        self.spkr_pool = TimeAggregation()
        self.spkr_film = FiLM(tr_dim, in_dim=hp.spkr.embedding_dim,
                              time_first=True, bias=False)

    def encode_condition(self, text: Masked, spkr: Masked,
                         return_attn: bool = False):
        """The text memory (B, Tt, text dim) and the pooled speaker
        embedding (B, E); with ``return_attn`` also the text encoder's
        self-attention maps stacked over layers, (L, B, H, Tt, Tt)."""
        spkr_emb = self.spkr_pool(self.spkr_encoder(spkr))
        emb = self.text_embedding(Masked(text.value.long(), text.lengths, 1))
        if return_attn:
            res = self.text_encoder.run(emb, return_attn=True)
            return res["output"], spkr_emb, torch.stack(res["self_attn"])
        return self.text_encoder(emb), spkr_emb

    def forward(self, x: Masked, generator: Optional[torch.Generator],
                text: Optional[Masked] = None, spkr: Optional[Masked] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                **kwargs) -> Dict[str, Any]:
        """``LVTR.forward`` over the text memory, plus ``"eos"`` (B, T)
        logits and ``"condition"`` (the memory)."""
        memory, _ = self.encode_condition(text, spkr)
        out = super().forward(x, generator, c=memory, draws=draws, **kwargs)
        eos = self.eos_head(out["transformer_latent"])
        out["eos"] = Masked(eos.value[..., 0], eos.lengths, 1)
        out["condition"] = memory
        return out

    def is_eos(self, latent: Masked, threshold: float = 0.5) -> torch.Tensor:
        """Whether each frame's end-of-speech probability passes
        ``threshold``, (B, T) bool."""
        eos = self.eos_head(latent).value[..., 0]
        return torch.sigmoid(eos.float()) > threshold
