"""HuBERT semantic-token -> mel diffusion decoder (port of
``vae_gslm_tpu/models/vocoder/hubert.py``).

Token embedding (with an optional f0 scalar channel and a speaker
embedding: a ``CNNStack`` over a mel crop, time-pooled) -> the
``embed_encoder`` ``ResNet`` -> a ``GaussianDiffusion1D`` over
``ConditionalBottleNeckUNet`` that denoises mels.  In dedup mode a
duration-predictor ``ResNet`` (``dp``) predicts each deduplicated
token's log duration and ``encode`` repeats the embeddings by it
(``length_regulate``: one cumsum, compare and gather into a static
buffer, as JAX does).

Attribute names are JAX's (``embedding``, ``spkr_net``, ``embed_encoder``,
``dp``, ``decoder``), so the compact checkpoint maps through
``models/convert.py::to_flat``/``load_flat``; the reference state dict
(``spkr_encoder.0.`` for ``spkr_net.``) loads through
``load_reference_hubert_decoder``.  Randomness comes from one
``torch.Generator``: ``forward`` draws the diffusion step ``t`` then the
noise (either may be given), ``decode`` the start noise then one noise
tensor per diffusion step (the start may be given).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked, resize_length
from ...hparams.hp import Hparams
from ...nn.conv import CNNStack, ResNet
from ...nn.diffusion import GaussianDiffusion1D
from ...nn.linear import Embedding, TimeAggregation
from ...nn.unet import ConditionalBottleNeckUNet
from ..speech.lvtr import init_parameters


def length_regulate(x: torch.Tensor, durations: torch.Tensor,
                    max_len: int) -> Masked:
    """Frames ``x`` (B, S, C) repeated by integer ``durations`` (B, S)
    into a (B, max_len, C) buffer; lengths min(sum durations, max_len)."""
    ends = torch.cumsum(durations, dim=-1)
    t = torch.arange(max_len, device=x.device)
    idx = (ends[:, None, :] <= t[None, :, None]).sum(-1)
    idx = idx.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    lengths = torch.clamp(ends[:, -1], max=max_len).to(torch.int32)
    return Masked(out, lengths, 1).apply_mask()


def interpolate_linear(x: Masked, ratio: float) -> Masked:
    """Linear time interpolation by ``ratio`` (torch's ``F.interpolate``
    with ``align_corners=False``, computed as JAX computes it)."""
    t = x.value.shape[1]
    s = int(t * ratio)
    dev = x.value.device
    pos = (torch.arange(s, device=dev, dtype=torch.float32) + 0.5) \
        * (t / s) - 0.5
    lo = torch.floor(pos).to(torch.int64).clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    w = (pos - lo).clamp(0.0, 1.0)[None, :, None]
    xv = x.value
    out = xv[:, lo] * (1.0 - w) + xv[:, hi] * w
    return Masked.from_lengths(out, resize_length(x.lengths, ratio))


class HuBERT(nn.Module):
    """``device`` defaults to CUDA and raises without it; parameters are
    drawn from ``generator`` (seed 0 when omitted)."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 mel_sample_rate: Optional[float] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        hp.check_arg_in_hparams("hubert", "embed_encoder", "decoder")
        with torch.device(dev):
            self._build(hp, input_dim)
        self.mel_sample_rate = mel_sample_rate
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        init_parameters(self, generator)

    def _build(self, hp: Hparams, input_dim: Optional[int]) -> None:
        self.hp = hp
        self.input_dim = input_dim
        self.embedding = Embedding(hp.hubert.vocab_size, hp.embedding_dim)
        self.deduplicate = hp.hubert.deduplicate
        embed_dim = hp.embedding_dim
        if hp.has("spkr"):
            self.spkr_net = CNNStack(hp.spkr, input_dim=input_dim,
                                     output_dim=hp.spkr.embedding_dim)
            self.spkr_pool = TimeAggregation()
            embed_dim += hp.spkr.embedding_dim
        else:
            self.spkr_net = None
        self.f0 = True if hp.has("f0") else None
        if self.f0:
            embed_dim += 1
        self.embed_encoder = ResNet(hp.embed_encoder, input_dim=embed_dim,
                                    output_dim=hp.embedding_dim)
        if self.deduplicate:
            hp.check_arg_in_hparams("duration_predictor")
            self.dp = ResNet(hp.duration_predictor, input_dim=embed_dim,
                             output_dim=1)
        denoiser = ConditionalBottleNeckUNet(hp.embedding_dim, input_dim,
                                             hp.decoder.cond_unet)
        self.decoder = GaussianDiffusion1D(denoiser, hp.decoder.diffusion)
        self.diff_scaling = hp.decoder.diffusion.get("input_scale", 1.0)
        self.interpolate_ratio = hp.get("interpolate_ratio", None)

    @property
    def sample_ratio(self) -> float:
        return float(self.mel_sample_rate) / float(
            self.hp.hubert.sample_rate)

    def _spkr_embed(self, spkr: Optional[Masked]) -> Optional[torch.Tensor]:
        if self.spkr_net is None:
            return None
        return self.spkr_pool(self.spkr_net(spkr))

    @staticmethod
    def _cat_spkr(x: Masked, spkr_emb: Optional[torch.Tensor]) -> Masked:
        if spkr_emb is None:
            return x
        return x.cat(spkr_emb[:, None].expand(-1, x.value.shape[1], -1))

    def _cat_aux(self, x: Masked, spkr_emb: Optional[torch.Tensor],
                 f0: Optional[Masked]) -> Masked:
        if self.f0 is not None and f0 is not None:
            x = x.cat(f0.value[:, : x.value.shape[1], None])
        return self._cat_spkr(x, spkr_emb)

    def forward(self, x: Masked, x_mel: Masked,
                generator: Optional[torch.Generator],
                spkr: Optional[Masked] = None,
                dedup_x: Optional[Masked] = None,
                f0: Optional[Masked] = None,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, Union[torch.Tensor, Masked]]:
        """Training forward: the summed diffusion loss of ``x_mel`` given
        the tokens ``x`` (with the speaker crop ``spkr`` and ``f0``), the
        condition, and in dedup mode the duration prediction of
        ``dedup_x``.  ``t`` and ``noise`` replace the diffusion draws."""
        spkr_emb = self._spkr_embed(spkr)
        emb = self._cat_aux(self.embedding(x), spkr_emb, f0)
        cond = self.embed_encoder(emb)
        if self.interpolate_ratio is not None:
            cond = interpolate_linear(cond, self.interpolate_ratio)
        scaled = dataclasses.replace(
            x_mel, value=x_mel.value / self.diff_scaling)
        out = {"diffusion_loss": self.decoder(scaled, cond, generator, t=t,
                                              noise=noise),
               "condition": cond}
        if self.deduplicate:
            out["duration_prediction"] = self.dp(
                self._cat_spkr(self.embedding(dedup_x), spkr_emb))
        return out

    def encode(self, x: Masked, spkr: Optional[Masked] = None,
               f0: Optional[Masked] = None,
               max_len: Optional[int] = None) -> Masked:
        """Tokens -> the diffusion condition.  In dedup mode the predicted
        durations (exp(dp) - 1, at least 1, rounded up) repeat each
        token's embedding into a buffer of ``max_len`` frames (4 per
        token by default)."""
        spkr_emb = self._spkr_embed(spkr)
        if self.deduplicate:
            demb = self._cat_spkr(self.embedding(x), spkr_emb)
            dp = self.dp(demb)
            duration = torch.exp(dp.value.float()) - 1.0
            duration = torch.ceil(torch.clamp(duration, min=1.0))
            duration = torch.where(dp.expanded_mask(), duration,
                                   torch.zeros_like(duration))
            duration = duration[..., 0].to(torch.int64)
            if max_len is None:
                max_len = int(demb.value.shape[1] * 4)
            out = length_regulate(demb.value, duration, max_len)
        else:
            out = self._cat_aux(self.embedding(x), spkr_emb, f0)
        out = self.embed_encoder(out)
        if self.interpolate_ratio is not None:
            out = interpolate_linear(out, self.interpolate_ratio)
        return out

    @torch.no_grad()
    def decode(self, cond: Masked, generator: Optional[torch.Generator],
               start: Optional[Masked] = None) -> Masked:
        """Condition -> mel by diffusion; ``start`` replaces the drawn
        start noise (tests share one start)."""
        if start is None:
            intr = float(self.interpolate_ratio or 1.0)
            out_len = int(cond.value.shape[1] / intr * self.sample_ratio)
            noise = torch.randn(
                (cond.value.shape[0], out_len, self.input_dim),
                generator=generator, device=cond.value.device)
            start = Masked.from_lengths(
                noise, resize_length(cond.lengths, self.sample_ratio)
            ).apply_mask()
        out = self.decoder.sample(start, cond.apply_mask(), generator)
        return dataclasses.replace(out, value=out.value * self.diff_scaling)
