"""LVTR, the VAE-GSLM model (port of
``vae_gslm_tpu/models/speech/lvtr.py``).

What the port runs: the training forward (``forward``, JAX's
``__call__``: posterior, teacher-forced trunk, prior head through the
flow, token CE, diffusion loss with the utterance embedding),
``encode`` (mel -> [token, latent] frames), ``encode_utterance``,
``step`` (the stacked prefill), ``step_hybrid`` (one AR step over the
hybrid int8 cache), ``step_mega`` (one AR step through K2 with int8
weights), ``decode`` (diffusion back to mels) and ``likelihood`` (the
per-utterance pseudo-likelihood of the scoring path).  The encoder is a
``ResNet`` (JAX's default), ``BottleNeckResNet`` or ``CNNStack``; the
denoiser a ``ConditionalUNet`` (JAX's default) or
``ConditionalBottleNeckUNet``.  A trunk with cross-attention layers
attends over a memory ``c`` (``memory_dim`` wide when the stack projects
it) in ``forward`` and ``likelihood`` and, projected once by the caller
(``transformer.project_memory``), in the per-layer ``step``.

Randomness comes from one ``torch.Generator`` that the caller passes
and that is consumed in call order: ``forward`` draws the posterior
noise, the initial state, the prior noise, (with ``diff_input`` that
input's posterior noise,) then the diffusion step ``t`` and noise;
``encode`` draws the posterior noise; ``step``/``step_hybrid``/
``step_mega`` draw the prior noise, then the Gumbel noise of the token
draw; ``decode`` draws the start noise, then one noise tensor per
diffusion step; ``likelihood`` at temperature 0 draws the initial state
only.  Token ids ride as floats in channel 0 of the frames.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.losses import masked_ce_loss
from ...core.masked import Masked, resize_length
from ...hparams.hp import Hparams
from ...nn.conv import BottleNeckResNet, CNNStack, ResNet
from ...nn.diffusion import GaussianDiffusion1D
from ...nn.flow import CouplingStack, TensorLogdet
from ...nn.linear import (Embedding, GaussianParameterize, Linear,
                          TimeAggregation)
from ...nn.transformer import TransformerLayerStack
from ...nn.unet import ConditionalBottleNeckUNet, ConditionalUNet

LOG_2PI = math.log(2.0 * math.pi)
ENCODERS = {"BottleNeckResNet": BottleNeckResNet, "ResNet": ResNet,
            "CNNStack": CNNStack}
DENOISERS = {"ConditionalBottleNeckUNet": ConditionalBottleNeckUNet,
             "ConditionalUNet": ConditionalUNet}


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
                 generator: Optional[torch.Generator] = None,
                 memory_dim: Optional[int] = None):
        super().__init__()
        dev = resolve_device(device)
        hp.check_arg_in_hparams("encoder", "decoder", "transformer",
                                "latent_dim")
        with torch.device(dev):
            self._build(hp, input_dim, memory_dim)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        init_parameters(self, generator)

    def _build(self, hp: Hparams, input_dim: Optional[int],
               memory_dim: Optional[int]) -> None:
        self.hp = hp
        self.input_dim = input_dim
        self.latent_dim = hp.latent_dim
        enc_id = hp.encoder.get("identifier", "ResNet")
        if enc_id not in ENCODERS:
            raise ValueError(f"{enc_id} not recognized.")
        self.encoder_net = ENCODERS[enc_id](hp.encoder, input_dim=input_dim,
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
        if hp.has("utterance_encoder"):
            diff_cond_dim += hp.utterance_encoder.embedding_dim
        dec_id = hp.decoder.diffusion.get("identifier", "ConditionalUNet")
        if dec_id not in DENOISERS:
            raise ValueError(f"{dec_id} not recognized.")
        hp.decoder.check_arg_in_hparams("cond_unet")
        self.decoder = GaussianDiffusion1D(
            DENOISERS[dec_id](diff_cond_dim, input_dim,
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
                       else hp.latent_dim), memory_dim=memory_dim)
        self.prior_head = GaussianParameterize(
            tr_dim, hp.latent_dim, std=hp.transformer.get("fix_std", None),
            std_range=hp.transformer.get("std_range", None),
            fix_mean=hp.transformer.get("fix_mean", None))
        if hp.has("utterance_encoder"):
            self.utterance_net = CNNStack(
                hp.utterance_encoder, input_dim=input_dim,
                output_dim=hp.utterance_encoder.embedding_dim)
            self.utterance_pool = TimeAggregation()
        else:
            self.utterance_net = None

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

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   stacked: bool = False):
        """The stacked cache (``stacked``; the port's is int8 only) or one
        per-layer cache per layer (``dtype`` None: the compute dtype)."""
        if stacked:
            return self.transformer.init_stacked_cache(batch, max_len, dtype)
        return self.transformer.init_cache(batch, max_len, dtype)

    def forward(self, x: Masked, generator: Optional[torch.Generator],
                c: Optional[Masked] = None,
                utterance: Optional[Masked] = None,
                diff_input: Optional[Masked] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """Training forward (JAX ``__call__``): the loss terms and
        statistics of [token, mel] frames ``x``, the trunk attending over
        the memory ``c`` where it has cross-attention layers.  ``draws``
        may replace any of the generator's draws with given tensors:
        ``posterior``, ``initial`` (B, 1, C) uniform(-1, 1), ``prior``,
        ``diff_posterior``, ``t`` and ``noise``."""
        draws = draws or {}
        tokens = token_ids = None
        if self.use_tokens:
            tokens_id, x = x.split(1)
            token_ids = Masked(tokens_id.value[..., 0].long(),
                               tokens_id.lengths, 1)
            tokens = self.token_embedding(token_ids)
        q_z = self.encoder_head(self.encoder_net(x), generator,
                                noise=draws.get("posterior"))
        sample_q = q_z.sample.apply_mask()
        log_q = Masked(-q_z.logstd.value - 0.5 - 0.5 * LOG_2PI,
                       q_z.logstd.lengths, 1)

        init = draws.get("initial")
        if init is None:
            init = self.initial_state(generator, x.value.shape[0])
        shifted = sample_q
        if self.use_tokens:
            shifted = tokens + self.token_fuser(shifted)
        shifted = shifted.shift_right(init.to(x.value.device)).apply_mask()

        trunk = self.transformer(shifted, c)
        q_split = self.q_spliter(trunk) if self.use_tokens else trunk
        z_given = self.prior_head(q_split, generator,
                                  noise=draws.get("prior"))
        mean, logstd = z_given.mean.value, z_given.logstd.value
        if self.transformer_flow is None:
            log_p = (-logstd - 0.5 * LOG_2PI - 0.5 * torch.exp(-2.0 * logstd)
                     * (sample_q.value.float() - mean).square())
        else:
            p_z = self.transformer_flow(TensorLogdet(sample_q, 0.0),
                                        c=q_split)
            log_p = p_z.logdet.sum(-1)[..., None] / self.latent_dim
            log_p = (log_p - logstd - 0.5 * LOG_2PI
                     - 0.5 * torch.exp(-2.0 * logstd)
                     * (p_z.tensor.value - mean).square())
        log_p = Masked(log_p, z_given.logstd.lengths, 1)

        ce_loss = None
        if self.use_tokens:
            pred_tokens = self.token_predictor(self.token_spliter(trunk))
            ce_loss = masked_ce_loss(pred_tokens, token_ids)

        if diff_input is None:
            diffusion_input, xi = sample_q, x
        else:
            diffusion_input = self.encoder_head(
                self.encoder_net(diff_input), generator,
                noise=draws.get("diff_posterior")).sample
            xi = diff_input
        if self.use_tokens:
            diffusion_input = tokens + self.token_fuser(diffusion_input)
        u_c = None
        if self.utterance_net is not None:
            u_c = self.utterance_pool(self.utterance_net(utterance))
            diffusion_input = diffusion_input.cat(u_c[:, None].expand(
                -1, diffusion_input.value.shape[1], -1))
        rec_loss = self.decoder(
            dataclasses.replace(xi, value=xi.value / self.diff_scaling),
            diffusion_input, generator, t=draws.get("t"),
            noise=draws.get("noise"))
        return {
            "log_p": log_p.apply_mask(),
            "log_q": log_q.apply_mask(),
            "rec_loss": rec_loss,
            "sample_q": sample_q,
            "transformer_latent": trunk,
            "logstd": z_given.logstd.mean(),
            "mean": z_given.mean.mean(),
            "q_logstd": q_z.logstd.mean(),
            "q_mean": q_z.mean.mean(),
            "q_mean_abs": q_z.mean.abs().mean(),
            "q_z": q_z,
            "u_c": u_c,
            "ce_loss": ce_loss,
        }

    def likelihood(self, x: Masked, generator: Optional[torch.Generator],
                   temperature: float = 0.0,
                   c: Optional[Masked] = None) -> torch.Tensor:
        """Per-utterance pseudo-likelihood (B,) of [token, mel] (or mel)
        frames ``x``: the token log-prob per frame with tokens, else the
        latent log-density per frame (flow-corrected with a flow).  The
        initial AR state is the one draw from ``generator``; at
        ``temperature`` 0 the posterior sample is its mean and no noise
        is drawn (the prior head's sample is never used).  ``c`` is the
        memory of a cross-attention trunk (JAX's ``likelihood`` takes
        none, so it runs trunks without cross-attention only)."""
        token_ids = None
        if self.use_tokens:
            tokens_id, x = x.split(1)
            token_ids = Masked(tokens_id.value[..., 0].long(),
                               tokens_id.lengths, 1)
            tokens = self.token_embedding(token_ids)
        zero = torch.zeros((), device=x.value.device)
        q = self.encoder_head(self.encoder_net(x), generator,
                              temperature=temperature,
                              noise=None if temperature else zero).sample
        shift_q = tokens + self.token_fuser(q) if self.use_tokens else q
        init = self.initial_state(generator, x.value.shape[0])
        shift_q = shift_q.shift_right(init.to(x.value.device)).apply_mask()
        trunk = self.transformer(shift_q, c)
        if self.use_tokens:
            # JAX computes the latent log-density here too and discards
            # it; the score is the token log-prob alone
            logits = self.token_predictor(self.token_spliter(trunk))
            logprobs = torch.log_softmax(logits.value.float(), dim=-1)
            lp = logprobs.gather(-1, token_ids.value[..., None])[..., 0]
            lp = torch.where(logits.mask(), lp, torch.zeros_like(lp))
            return lp.sum(-1) / logits.lengths
        z_given = self.prior_head(trunk, generator, noise=zero)
        mean, logstd = z_given.mean.value, z_given.logstd.value
        if self.transformer_flow is not None:
            p_z = self.transformer_flow(TensorLogdet(q, 0.0), c=trunk)
            log_p = p_z.logdet.sum(-1)[..., None] / self.latent_dim
            log_p = (log_p - logstd - 0.5 * LOG_2PI
                     - 0.5 * torch.exp(-2.0 * logstd)
                     * (p_z.tensor.value - mean).square())
            log_p = Masked(log_p, p_z.tensor.lengths, 1)
        else:
            log_p = Masked(-logstd - 0.5 * LOG_2PI
                           - 0.5 * torch.exp(-2.0 * logstd)
                           * (q.value.float() - mean).square(),
                           z_given.mean.lengths, 1)
        return log_p.apply_mask().value.mean(-1).sum(1) / log_p.lengths

    def encode_utterance(self, utterance: Masked) -> torch.Tensor:
        """The (B, embedding_dim) utterance embedding of [token, mel] or
        mel frames."""
        if self.use_tokens:
            _, utterance = utterance.split(1)
        return self.utterance_pool(self.utterance_net(utterance))

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
             push_init_state: bool = False, stacked: Optional[dict] = None,
             window: Optional[int] = None, return_attn: bool = False,
             flash_decode: bool = False, memory: Optional[Masked] = None):
        """Frames xv (B, S, C) at [pos, pos+S) over the stacked int8 cache
        (``stacked`` weights; the prefill) or the per-layer caches
        (``stacked`` None: a prefill, or one AR step attending over
        ``cache[:window]``, through K6 with ``flash_decode``; the
        cross-attention layers over ``memory``, already through
        ``transformer.project_memory``).  With ``push_init_state`` the
        initial state is prepended (S' = S + 1).  Returns next frames (B,
        S', C) and the cache, with ``return_attn`` (per-layer only) also
        the stacked maps (L, B, H, S', maxT)."""
        fused = self._fuse_frames(xv)
        if push_init_state:
            init = self.initial_state(generator, xv.shape[0])
            fused = torch.cat([init.to(fused.dtype), fused], dim=1)
        attn = None
        if stacked is not None:
            if return_attn:
                raise NotImplementedError(
                    "return_attn runs the per-layer step (stacked=None)")
            h, cache = self.transformer.decode_stacked(fused, stacked, cache,
                                                       pos)
        else:
            res = self.transformer.decode(fused, cache, pos, window=window,
                                          return_attn=return_attn,
                                          flash=flash_decode, memory=memory)
            h, cache = res[:2]
            if return_attn:
                attn = res[2]
        out = self._sample_next(h, generator, temperature, token_temperature,
                                truncated_norm)
        return (out, cache, attn) if return_attn else (out, cache)

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
               start: Optional[Masked] = None,
               u_c: Optional[torch.Tensor] = None) -> Masked:
        """Diffusion-decode [token, latent] frames to mels, conditioned
        on the utterance embedding ``u_c`` (B, E) where the model has an
        utterance encoder.  ``start`` replaces the drawn start noise
        (tests share one start)."""
        if start is None:
            out_len = int(x.value.shape[1] * (1.0 / self.sample_ratio))
            noise = torch.randn((x.value.shape[0], out_len, self.input_dim),
                                generator=generator, device=x.value.device)
            start = Masked.from_lengths(
                noise, resize_length(x.lengths, 1.0 / self.sample_ratio)
            ).apply_mask()
        cond = self.cond_frames(x)
        if u_c is not None:
            cond = cond.cat(u_c[:, None].expand(-1, cond.value.shape[1], -1))
        out = self.decoder.sample(start, cond.apply_mask(), generator)
        return dataclasses.replace(out, value=out.value * self.diff_scaling)
