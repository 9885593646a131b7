"""DiscreteAR, the autoregressive token LM baseline, with its inner RVQ
decoder ``ARCTransformer`` (port of
``vae_gslm_tpu/models/speech/discrete.py``).

Single-VQ: a token embedding (``codebook_size + 2`` rows; SOS is index
``codebook_size``), optionally with an f0 scalar channel, through a
causal ``TransformerLayerStack`` to vocabulary logits, plus an
``f0_dense`` head on the last layer's output.  Multi-VQ (RVQ): the sum of
per-quantizer embeddings through the trunk, then per frame the inner
``ARCTransformer`` over the codebooks with learned codebook positions.
The frozen codec (``HuBERTIO``) is attached by ``set_soundstream``.

Serving: ``step`` runs the stacked int8 prefill (``stacked`` weights) or
the per-layer caches (a prefill, or one AR step over ``cache[:window]``);
``step_hybrid`` one AR step over the hybrid cold/tail int8 cache, each
layer's attention through K1 on the card.  Token draws are Gumbel-max
draws (``jax.random.categorical``'s method) from an explicit
``torch.Generator``.  JAX's multi-VQ ``step`` looks its ids up with
``embedding.lookup``, which its ``RVQEmbedding`` does not have; the port
sums the per-quantizer tables there as the training forward does.

Attribute names are JAX's (``embedding``, ``transformer``,
``arc_transformer``, ``f0_dense``), so the compact checkpoint maps
through ``models/convert.py::to_flat``/``load_flat``; the reference's
state dict loads through ``load_reference_discrete_ar``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.masked import Masked
from ...hparams.hp import Hparams
from ...nn.linear import Dense, Embedding, RVQEmbedding
from ...nn.transformer import TransformerLayerStack
from .lvtr import categorical, init_parameters


class ARCTransformer(nn.Module):
    """The inner per-frame codebook AR transformer: position i of a frame
    reads the frame's trunk latent (i = 0) or code i - 1's embedding, plus
    a learned codebook position, and predicts code i."""

    def __init__(self, hp: Hparams, num_quantizers: int, codebook_size: int,
                 embedding_dim: int):
        super().__init__()
        if num_quantizers <= 1:
            raise ValueError("ARCTransformer takes more than one quantizer")
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.embedding_dim = embedding_dim
        self.pos_encoding = nn.Parameter(torch.empty(num_quantizers,
                                                     embedding_dim))
        self.transformer = TransformerLayerStack(
            hp, input_dim=embedding_dim, output_dim=codebook_size)
        self.embedding = Embedding((num_quantizers - 1) * codebook_size,
                                   embedding_dim)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.pos_encoding.normal_(generator=generator)

    def forward(self, x: Masked, x_label: Masked) -> Masked:
        """Frame latents x (B, T, C) and codes x_label (B, T, n) -> logits
        (B, T, n, codebook)."""
        b, t, _ = x.value.shape
        n = self.num_quantizers
        shift = torch.arange(n - 1, device=x.value.device) \
            * self.codebook_size
        labels = x_label.value[..., :-1].long() + shift
        emb = self.embedding.lookup(labels)
        inp = torch.cat([x.value[:, :, None].to(emb.dtype), emb], dim=2)
        inp = inp.reshape(b * t, n, self.embedding_dim)
        inp = inp + self.pos_encoding.to(inp.dtype)[None]
        out = self.transformer(Masked.full(inp)).value
        out = out.reshape(b, t, n, self.codebook_size)
        return Masked(out, x.lengths, 1).apply_mask()

    def step(self, frame: torch.Tensor,
             prev_codes: List[torch.Tensor]) -> torch.Tensor:
        """A frame latent (B, C) and the codes drawn so far, each (B,) ->
        the logits (B, codebook) of the next code."""
        parts = [frame[:, None]]
        if prev_codes:
            shift = torch.arange(len(prev_codes), device=frame.device) \
                * self.codebook_size
            labels = torch.stack(prev_codes, dim=-1).long() + shift
            parts.append(self.embedding.lookup(labels).to(frame.dtype))
        inp = torch.cat(parts, dim=1)
        inp = inp + self.pos_encoding.to(inp.dtype)[None, : inp.shape[1]]
        return self.transformer(Masked.full(inp)).value[:, -1]


class DiscreteAR(nn.Module):
    """``hp`` is the model config (``transformer``, ``arc_transformer``
    for RVQ, ``f0``), ``hp_vq`` the codec's (``num_quantizers``,
    ``codebook_size``, ``dim``).  ``device`` defaults to CUDA and raises
    without it; parameters are drawn from ``generator`` (seed 0 when
    omitted)."""

    def __init__(self, hp: Hparams, hp_vq: Hparams,
                 input_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        hp.check_arg_in_hparams("transformer")
        with torch.device(dev):
            self._build(hp, hp_vq, input_dim)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        init_parameters(self, generator)
        self.codec = None

    def _build(self, hp: Hparams, hp_vq: Hparams,
               input_dim: Optional[int]) -> None:
        self.hp = hp
        self.hp_vq = hp_vq
        self.input_dim = input_dim
        self.f0 = hp.get("f0", None)
        self.single_vq = hp_vq.num_quantizers == 1
        tr_dim = hp.transformer.layer.dim
        if not self.single_vq:
            hp.check_arg_in_hparams("arc_transformer")
            self.embedding = RVQEmbedding(hp_vq.num_quantizers,
                                          hp_vq.codebook_size + 2, hp_vq.dim)
            self.transformer = TransformerLayerStack(hp.transformer,
                                                     input_dim=hp_vq.dim)
            self.arc_transformer = ARCTransformer(
                hp.arc_transformer, hp_vq.num_quantizers,
                hp_vq.codebook_size, tr_dim)
        else:
            in_dim = hp_vq.dim + (1 if self.f0 is not None else 0)
            self.embedding = Embedding(hp_vq.codebook_size + 2, hp_vq.dim)
            self.transformer = TransformerLayerStack(
                hp.transformer, input_dim=in_dim,
                output_dim=hp_vq.codebook_size)
        self.f0_dense = (Dense(tr_dim, 1) if self.f0 is not None else None)

    def set_soundstream(self, codec) -> None:
        """Attach the frozen codec (a ``HuBERTIO``)."""
        self.codec = codec

    @property
    def sample_ratio(self) -> float:
        return self.codec.sample_ratio

    @property
    def device(self) -> torch.device:
        return self.transformer.layers[0].linear1.weight.device

    def initial_state(self, bsize: int) -> torch.Tensor:
        """SOS, the index ``codebook_size``: (B, 1) or (B, 1, n)."""
        shape = ((bsize, 1) if self.single_vq
                 else (bsize, 1, self.hp_vq.num_quantizers))
        return torch.full(shape, self.hp_vq.codebook_size, dtype=torch.long,
                          device=self.device)

    def _embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        if self.single_vq:
            return self.embedding.lookup(ids)
        return self.embedding(Masked.full(ids)).value

    def _embed_shifted(self, x: Masked, f0: Optional[Masked]
                       ) -> Tuple[Masked, Optional[Masked]]:
        """SOS-shifted ids embedded (teacher forcing), with the shifted f0
        channel appended where the model has one."""
        ids = Masked(x.value.long(), x.lengths, 1)
        init = self.initial_state(x.value.shape[0])
        shifted = ids.push(init).pop(1).apply_mask()
        emb = self.embedding(shifted)
        if self.f0 is not None and f0 is not None:
            zero = torch.zeros((f0.value.shape[0], 1), dtype=f0.value.dtype,
                               device=f0.value.device)
            f0s = f0.push(zero).pop(1).apply_mask()
            return emb.cat(f0s.value[..., None]), f0s
        return emb, None

    def forward(self, x: Masked, c: Optional[Masked] = None,
                f0: Optional[Masked] = None) -> Dict[str, Any]:
        """Teacher-forced forward of token ids x (B, T) (or codes (B, T,
        n)): ``logits``, ``labels`` and, with f0, the ``f0`` prediction."""
        emb, f0s = self._embed_shifted(x, f0)
        out = self.transformer.run(emb, c)
        hidden = out["output"]
        res: Dict[str, Any] = {}
        if self.f0 is not None:
            res["f0"] = Masked(self.f0_dense(out["layers"][-1].value),
                               f0s.lengths, 1)
        res["logits"] = (hidden if self.single_vq
                         else self.arc_transformer(hidden, x))
        res["labels"] = Masked(x.value.long(), x.lengths, 1)
        return res

    def likelihood(self, x: Masked,
                   f0: Optional[Masked] = None) -> torch.Tensor:
        """Per-utterance token log-prob per valid frame (B,); with RVQ a
        frame's log-prob is the sum over its codebooks (JAX's masks the
        (B, T, n) log-probs with a (B, T) mask, which does not broadcast,
        so its RVQ likelihood cannot run)."""
        out = self(x, f0=f0)
        logits, labels = out["logits"], out["labels"]
        logp = torch.log_softmax(logits.value.float(), dim=-1)
        lp = logp.gather(-1, labels.value[..., None])[..., 0]
        if lp.dim() == 3:
            lp = lp.sum(-1)
        lp = torch.where(logits.mask(), lp, torch.zeros_like(lp))
        return lp.sum(-1) / logits.lengths

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   stacked: bool = False):
        """The stacked int8 cache (``stacked``) or one per-layer cache per
        layer (``dtype`` None: the compute dtype)."""
        if stacked:
            return self.transformer.init_stacked_cache(batch, max_len, dtype)
        return self.transformer.init_cache(batch, max_len, dtype)

    def _embed_step(self, xv: torch.Tensor) -> torch.Tensor:
        if self.f0 is None:
            return self._embed_ids(xv.long())
        emb = self._embed_ids(xv[..., 0].long())
        return torch.cat([emb, xv[..., -1:].to(emb.dtype)], dim=-1)

    @torch.no_grad()
    def step(self, xv: torch.Tensor, caches, pos: int,
             generator: Optional[torch.Generator],
             temperature: float = 1.0, window: Optional[int] = None,
             return_attn: bool = False, stacked: Optional[dict] = None):
        """Tokens xv (B, S) (codes (B, S, n); with f0 (B, S, 2) [token,
        f0]) at [pos, pos + S) over the stacked int8 cache (``stacked``
        weights: the prefill) or the per-layer caches (a prefill, or one
        AR step over ``cache[:window]``).  Returns the next tokens (B, S)
        (with f0 (B, S, 2); RVQ (B, 1, n)) and the caches, with
        ``return_attn`` (per-layer) also the maps (L, B, H, S, maxT)."""
        emb = self._embed_step(xv)
        attn = None
        if stacked is not None:
            if return_attn:
                raise NotImplementedError(
                    "return_attn runs the per-layer step (stacked=None)")
            h, caches = self.transformer.decode_stacked(
                emb, stacked, caches, pos, project=False)
        else:
            res = self.transformer.decode(emb, caches, pos, window=window,
                                          return_attn=return_attn,
                                          project=False)
            h, caches = res[:2]
            if return_attn:
                attn = res[2]
        out = self._sample_from_hidden(h, generator, temperature)
        return (out, caches, attn) if return_attn else (out, caches)

    def _sample_from_hidden(self, h: torch.Tensor,
                            generator: Optional[torch.Generator],
                            temperature: float) -> torch.Tensor:
        """The next tokens (and f0) from the trunk's normed hidden ``h``
        (before its output layer): one Gumbel draw per row over the
        vocabulary logits, or the codebooks one by one through the inner
        transformer (last position only); the f0 head reads ``h``, as in
        training (JAX's reads the vocabulary logits, a width its f0 head
        does not take, so its f0 sampling cannot run)."""
        if self.single_vq:
            sample = categorical(self.transformer.out(h).float()
                                 / temperature, generator)
        else:
            frame = h[:, -1]
            codes: List[torch.Tensor] = []
            for _ in range(self.hp_vq.num_quantizers):
                logits = self.arc_transformer.step(frame, codes).float()
                codes.append(categorical(logits / temperature, generator))
            sample = torch.stack(codes, dim=-1)[:, None]
        if self.f0 is not None:
            f0_out = self.f0_dense(h).float()
            return torch.cat([sample[..., None].float(), f0_out], dim=-1)
        return sample

    @torch.no_grad()
    def step_hybrid(self, xv: torch.Tensor, stacked: dict, cache: dict,
                    pos: int, flushed: int,
                    generator: Optional[torch.Generator],
                    temperature: float = 1.0):
        """One AR step over the hybrid cold/tail int8 cache."""
        h, cache = self.transformer.decode_hybrid(
            self._embed_step(xv), stacked, cache, pos, flushed, project=False)
        return self._sample_from_hidden(h, generator, temperature), cache

    # ---------------------------------------------------------------- codec
    @torch.no_grad()
    def decode(self, x: Masked, generator: Optional[torch.Generator] = None,
               spkr: Optional[Masked] = None) -> Masked:
        """Tokens ([token, f0] with f0) -> waves through the frozen
        codec."""
        kwargs = {}
        if self.f0 is not None:
            kwargs["f0"] = Masked(x.value[..., -1], x.lengths, 1)
            x = Masked(x.value[..., 0].long(), x.lengths, 1)
        if spkr is not None:
            kwargs["spkr"] = spkr
        return self.codec.decode(x, generator, **kwargs).apply_mask()

    def encode(self, x: Masked, temperature: float = 1.0) -> Masked:
        return self.codec.encode_mel(x).apply_mask()
