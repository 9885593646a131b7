"""LVTR, the VAE-GSLM model, on the speech-continuation path (port of
``vae_gslm_tpu/models/speech/lvtr.py``).

What the port runs: ``encode`` (mel -> [token, latent] frames),
``step`` (the stacked prefill), ``step_hybrid`` (one AR step over the
hybrid int8 cache), ``step_mega`` (one AR step through K2 with int8
weights) and ``decode`` (diffusion back to mels).  Training,
``likelihood``, the utterance encoder and the other encoders wait for a
later slice (ROADMAP.md).

Randomness comes from one ``torch.Generator`` that the caller passes
and that is consumed in call order: ``encode`` draws the posterior
noise; ``step``/``step_hybrid``/``step_mega`` draw the prior noise, then
the Gumbel noise of the token draw; ``decode`` draws the start noise,
then one noise tensor per diffusion step.  Token ids ride as floats in channel
0 of the frames.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked, resize_length
from ...hparams.hp import Hparams
from ...nn.conv import BottleNeckResNet
from ...nn.diffusion import GaussianDiffusion1D
from ...nn.flow import CouplingStack
from ...nn.linear import Embedding, GaussianParameterize, Linear
from ...nn.transformer import TransformerLayerStack
from ...nn.unet import ConditionalBottleNeckUNet


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter from ``generator`` with each leaf's own
    torch-style rule (uniform +-1/sqrt(fan_in), normal embeddings,
    unit norms)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(generator)


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max draw over the last axis, the method of
    ``jax.random.categorical``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class LVTR(nn.Module):
    """``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` to run on the CPU.  Parameters are drawn from
    ``generator`` (seed 0 when omitted)."""

    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        hp.check_arg_in_hparams("encoder", "decoder", "transformer",
                                "latent_dim")
        if hp.has("utterance_encoder"):
            raise NotImplementedError(
                "the utterance encoder is not ported yet (ROADMAP.md)")
        with torch.device(dev):
            self._build(hp, input_dim)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        init_parameters(self, generator)

    def _build(self, hp: Hparams, input_dim: Optional[int]) -> None:
        self.hp = hp
        self.input_dim = input_dim
        self.latent_dim = hp.latent_dim
        enc_id = hp.encoder.get("identifier", "ResNet")
        if enc_id != "BottleNeckResNet":
            raise NotImplementedError(
                f"the {enc_id} encoder is not ported yet (ROADMAP.md)")
        self.encoder_net = BottleNeckResNet(hp.encoder, input_dim=input_dim,
                                            output_dim=hp.latent_dim)
        self.encoder_head = GaussianParameterize(
            hp.latent_dim, hp.latent_dim,
            std=hp.encoder.get("fix_std", None),
            std_range=hp.encoder.get("std_range", None),
            truncated_norm=hp.encoder.get("truncated_norm", None),
            total_std=hp.encoder.get("total_std", None),
            normalization=hp.encoder.get("normalization", False))
        self.tokens_hp = hp.get("tokens", None)
        self.use_tokens = self.tokens_hp is not None
        tr_dim = hp.transformer.layer.dim
        if self.use_tokens:
            self.tokens_hp.check_arg_in_hparams("embedding_dim",
                                                "vocab_size")
            self.token_embedding_dim = self.tokens_hp.embedding_dim
            self.token_embedding = Embedding(self.tokens_hp.vocab_size,
                                             self.tokens_hp.embedding_dim)
            self.token_predictor = Linear(tr_dim, self.tokens_hp.vocab_size)
            self.token_fuser = Linear(hp.latent_dim,
                                      self.tokens_hp.embedding_dim,
                                      activation=F.relu)
            self.token_spliter = Linear(tr_dim, tr_dim, activation=F.relu)
            self.q_spliter = Linear(tr_dim, tr_dim, activation=F.relu)
        diff_cond_dim = (self.tokens_hp.embedding_dim if self.use_tokens
                         else hp.latent_dim)
        dec_id = hp.decoder.diffusion.get("identifier", "ConditionalUNet")
        if dec_id != "ConditionalBottleNeckUNet":
            raise NotImplementedError(
                f"the {dec_id} denoiser is not ported yet (ROADMAP.md)")
        hp.decoder.check_arg_in_hparams("cond_unet")
        self.decoder = GaussianDiffusion1D(
            ConditionalBottleNeckUNet(diff_cond_dim, input_dim,
                                      hp.decoder.cond_unet),
            hp.decoder.diffusion)
        self.diff_scaling = hp.decoder.diffusion.get("input_scale", 1.0)
        if hp.transformer.has("flow"):
            cond_dim = tr_dim if hp.transformer.flow.get(
                "conditional", False) else None
            self.transformer_flow = CouplingStack(
                hp.latent_dim, hp.transformer.flow, condition_dim=cond_dim)
        else:
            self.transformer_flow = None
        self.transformer = TransformerLayerStack(
            hp.transformer,
            input_dim=(self.tokens_hp.embedding_dim if self.use_tokens
                       else hp.latent_dim))
        self.prior_head = GaussianParameterize(
            tr_dim, hp.latent_dim, std=hp.transformer.get("fix_std", None),
            std_range=hp.transformer.get("std_range", None),
            fix_mean=hp.transformer.get("fix_mean", None))

    @property
    def sample_ratio(self) -> float:
        return self.encoder_net.sample_ratio

    def initial_state(self, generator: Optional[torch.Generator],
                      bsize: int, nfeat: Optional[int] = None
                      ) -> torch.Tensor:
        """The uniform(-1, 1) initial AR state (B, 1, nfeat)."""
        if nfeat is None:
            nfeat = (self.token_embedding_dim if self.use_tokens
                     else self.latent_dim)
        dev = self.transformer.layers[0].linear1.weight.device
        u = torch.rand((bsize, 1, nfeat), generator=generator, device=dev)
        return u * 2.0 - 1.0

    def init_cache(self, batch: int, max_len: int, dtype=torch.int8,
                   stacked: bool = True):
        if not stacked:
            raise NotImplementedError(
                "the per-layer cache is not ported yet (ROADMAP.md)")
        return self.transformer.init_stacked_cache(batch, max_len, dtype)

    def _fuse_frames(self, xv: torch.Tensor) -> torch.Tensor:
        if not self.use_tokens:
            return xv
        emb = self.token_embedding.lookup(xv[..., 0])
        return emb + F.relu(self.token_fuser.linear(xv[..., 1:]))

    def _sample_next(self, h: torch.Tensor, generator, temperature: float,
                     token_temperature: float,
                     truncated_norm: Optional[Tuple[float, float]]
                     ) -> torch.Tensor:
        """Prior head, flow reverse and token draw on the trunk output."""
        hm = Masked.full(h)
        q_split = self.q_spliter(hm) if self.use_tokens else hm
        z = self.prior_head(q_split, generator, temperature=temperature,
                            truncated_norm=truncated_norm)
        sample_z = z.sample
        if self.transformer_flow is not None:
            sample_z = self.transformer_flow.reverse(sample_z, c=q_split)
        out = sample_z.value
        if self.use_tokens:
            logits = self.token_predictor(
                self.token_spliter(hm)).value.float()
            tok = categorical(logits / token_temperature, generator)
            out = torch.cat([tok[..., None].float(), out], dim=-1)
        return out

    @torch.no_grad()
    def step(self, xv: torch.Tensor, cache, pos: int,
             generator: Optional[torch.Generator],
             temperature: float = 1.0, token_temperature: float = 1.0,
             truncated_norm: Optional[Tuple[float, float]] = None,
             push_init_state: bool = False, stacked: Optional[dict] = None):
        """Prefill over the stacked int8 cache: frames xv (B, S, C) at
        [pos, pos+S); with ``push_init_state`` the initial state is
        prepended (S' = S + 1).  Returns next frames (B, S', C) and the
        cache."""
        if stacked is None:
            raise NotImplementedError(
                "the per-layer step is not ported yet (ROADMAP.md)")
        fused = self._fuse_frames(xv)
        if push_init_state:
            init = self.initial_state(generator, xv.shape[0])
            fused = torch.cat([init.to(fused.dtype), fused], dim=1)
        h, cache = self.transformer.decode_stacked(fused, stacked, cache,
                                                   pos)
        return self._sample_next(h, generator, temperature,
                                 token_temperature, truncated_norm), cache

    @torch.no_grad()
    def step_hybrid(self, xv: torch.Tensor, stacked: dict, cache: dict,
                    pos: int, flushed: int,
                    generator: Optional[torch.Generator],
                    temperature: float = 1.0,
                    token_temperature: float = 1.0,
                    truncated_norm: Optional[Tuple[float, float]] = None):
        """One AR step over the hybrid cold/tail cache."""
        h, cache = self.transformer.decode_hybrid(
            self._fuse_frames(xv), stacked, cache, pos, flushed)
        return self._sample_next(h, generator, temperature,
                                 token_temperature, truncated_norm), cache

    @torch.no_grad()
    def step_mega(self, xv: torch.Tensor, weights: dict, cache: dict,
                  pos: int, flushed: int,
                  generator: Optional[torch.Generator],
                  temperature: float = 1.0,
                  token_temperature: float = 1.0,
                  truncated_norm: Optional[Tuple[float, float]] = None,
                  a8: Optional[bool] = None):
        """One AR step with the whole trunk as one K2 call over the
        three-tier mega cache (int8 weights)."""
        h, cache = self.transformer.decode_mega(
            self._fuse_frames(xv), weights, cache, pos, flushed, a8=a8)
        return self._sample_next(h, generator, temperature,
                                 token_temperature, truncated_norm), cache

    @torch.no_grad()
    def encode(self, x: Masked, generator: Optional[torch.Generator],
               temperature: float = 1.0) -> Masked:
        """mel (+ token channel) -> [token, latent] frames."""
        tokens_id = None
        if self.use_tokens:
            tokens_id, x = x.split(1)
        out = self.encoder_head(self.encoder_net(x), generator,
                                temperature=temperature).sample
        if self.use_tokens:
            return tokens_id.cat(out.apply_mask())
        return out.apply_mask()

    def cond_frames(self, x: Masked) -> Masked:
        """The diffusion condition: token embedding + fused latent."""
        if not self.use_tokens:
            return x
        tokens_id, lat = x.split(1)
        tokens = self.token_embedding(
            Masked(tokens_id.value[..., 0], tokens_id.lengths, 1))
        return tokens + self.token_fuser(lat)

    @torch.no_grad()
    def decode(self, x: Masked, generator: Optional[torch.Generator],
               start: Optional[Masked] = None) -> Masked:
        """Diffusion-decode [token, latent] frames to mels.  ``start``
        replaces the drawn start noise (tests share one start)."""
        if start is None:
            out_len = int(x.value.shape[1] * (1.0 / self.sample_ratio))
            noise = torch.randn((x.value.shape[0], out_len, self.input_dim),
                                generator=generator, device=x.value.device)
            start = Masked.from_lengths(
                noise, resize_length(x.lengths, 1.0 / self.sample_ratio)
            ).apply_mask()
        out = self.decoder.sample(start, self.cond_frames(x).apply_mask(),
                                  generator)
        return dataclasses.replace(out, value=out.value * self.diff_scaling)
