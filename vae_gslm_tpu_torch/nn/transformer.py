"""Transformer trunk (port of ``TransformerLayer`` and
``TransformerLayerStack`` from ``vae_gslm_tpu/nn/transformer.py``).

Training: ``TransformerLayerStack.run`` / ``forward`` takes masked
frames through pre-LN or post-LN layers (self-attention through K3/K3b
on the card, cross-attention over a memory where the layers have it,
then the FFN), with optional per-layer rematerialization.  The stack
owns one position module (``rpe``: ALiBi, T5RPE, Rotary or SinCos)
shared by its layers; a T5 bias is computed once per call and reused by
every layer, as JAX reuses the first layer's.

Serving:
  * ``init_stacked_cache`` + ``decode_stacked`` prefill: the prompt runs
    through all layers at once and fills a stacked int8 cache
    ``(L, B, H, T, D)``; attention reads the dequantized bfloat16 cache,
    as the JAX prefill does;
  * ``hybrid_cache_from_prefill`` converts it to the cold/tail layout of
    ``ops/fused_decode.py``;
  * ``decode_hybrid`` runs one token through the layers with the K1
    kernel as each layer's attention; all layers' new K/V rows are
    written into the tail once, after the layer loop;
  * ``flush_hybrid`` moves a full tail into the next cold block;
  * with int8 weights (``quantize_weights_int8``) the stacked entries
    hold the int8 weight and its scales, and ``_matmul`` upconverts them,
    so an int8-weight model that the mega path cannot take serves
    through the hybrid path, as in JAX;
  * the mega path: ``build_mega_decode`` stacks the int8 weights for K2,
    ``mega_cache_from_prefill`` converts the prefill cache to the
    three-tier cold/tail/stage layout of ``ops/mega_step.py`` and
    ``decode_mega`` runs one token through the whole trunk as one K2
    call plus the stage append.
  * the per-layer path: ``init_cache`` gives one ``LayerKVCache`` per
    layer (int8 or float) and ``decode`` runs
    frames through ``TransformerLayer.decode`` layer by layer (pre-LN or
    post-LN): a prefill (S > 1) or one token through
    ``SelfAttention.decode_step``, optionally returning the stacked
    attention maps.
The cache tensors are updated in place (the JAX functions return new
arrays).  Every decode takes ``project=False`` to return the final
norm's output without the stack's output layer (the token LM reads it
for its f0 head and applies the output layer itself).
"""
from __future__ import annotations

from operator import attrgetter
from typing import List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.masked import Masked
from ..hparams.hp import Hparams
from ..ops import mega_step as mega
from ..ops.fused_decode import BLK, TAIL, fused_decode_attention
from .activations import gelu, get_activation
from .attention import (CrossAttention, LayerKVCache, SelfAttention, attend,
                        merge_heads, quantize_i8, split_heads)
from .linear import Dense
from .norms import RMSNorm, get_norm
from .positions import T5RPE, get_positional_encoding


@torch.no_grad()
def pack_mega_w4(w8: dict, group: int, head_dim: int) -> dict:
    """K2's int8 weights (``build_mega_decode``) requantized to int4 for
    K2-w4, as JAX's ``build_mega_decode_w4`` does it: per (group of
    ``group`` rows, column) the scale ``s4 = max(amax, 1e-8) / 7`` and
    ``round(q / s4)`` clipped to [-8, 7]; rows ``r`` and ``r + din/2``
    packed into the hi and lo nibble of one byte, so ``wq/wo/w1/w2``
    become (L, din/2, dout) int8; ``s4`` folded with the column scale into
    ``gq/go/g1/g2`` (L, din/group, dout) float32.  ``sq/so/s1/s2`` stay,
    as in JAX.  The divisions are by tensors and the packing runs in
    int32, so the bytes equal JAX's on any device.  Raises unless
    ``group`` is a multiple of ``head_dim`` (the out-projection applies
    one group scale per head) and divides each din / 2."""
    if group <= 0 or group % head_dim:
        raise ValueError(f"w4 group {group} must be a multiple of the head "
                         f"width {head_dim}")
    out = dict(w8)
    for name, sname, gname in (("wq", "sq", "gq"), ("wo", "so", "go"),
                               ("w1", "s1", "g1"), ("w2", "s2", "g2")):
        w = w8[name]                           # (L, din, dout) int8
        nl, din, dout = w.shape
        if din % (2 * group):
            raise ValueError(f"{name}: din {din} is not a multiple of 2 x "
                             f"group {group}")
        q = w.float().reshape(nl, din // group, group, dout)
        s4 = q.abs().amax(dim=2).clamp(min=1e-8) / torch.tensor(
            7.0, device=w.device)
        q4 = torch.round(q / s4[:, :, None, :]).clamp(-8, 7).reshape(
            nl, din, dout).to(torch.int32)
        hi, lo = q4[:, :din // 2], q4[:, din // 2:]
        out[name] = ((hi << 4) | (lo & 0xF)).to(torch.int8)
        out[gname] = s4 * w8[sname][:, None, :]
    return out


class TransformerLayer(nn.Module):
    def __init__(self, hp: Hparams):
        super().__init__()
        hp.check_arg_in_hparams("ffd_size", "norm", "activation", "dim",
                                "self_attn")
        self.preln = hp.get("preln", True)
        self.self_attn = SelfAttention(hp.dim, hp.self_attn)
        if hp.has("cross_attn"):
            self.cross_attn = CrossAttention(hp.dim, hp.cross_attn)
            self.norm2 = get_norm(hp.dim, hp.norm)
        else:
            self.cross_attn = None
        bias = hp.get("bias", True)
        self.linear1 = Dense(hp.dim, hp.ffd_size, bias=bias)
        self.linear2 = Dense(hp.ffd_size, hp.dim, bias=bias)
        self.norm1 = get_norm(hp.dim, hp.norm)
        self.norm3 = get_norm(hp.dim, hp.norm)
        self.activation = get_activation(hp.activation)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))

    def forward(self, tgt: Masked, memory: Optional[Masked] = None,
                rpe=None, bias: Optional[torch.Tensor] = None) -> Masked:
        """Pre-LN (default) or post-LN: self-attention (``rpe`` and
        ``bias`` as in ``SelfAttention.forward``), cross-attention over
        ``memory`` where the layer has it, then the FFN."""
        lengths = tgt.lengths
        if self.preln:
            n_tgt = Masked(self.norm1(tgt.value), lengths, 1).apply_mask()
        else:
            n_tgt = tgt
        x = tgt.value + self.self_attn(n_tgt, rpe, bias).value
        if not self.preln:
            x = self.norm1(x)
        if self.cross_attn is not None:
            if memory is None:
                raise ValueError("a cross-attention layer needs a memory")
            n_x = self.norm2(x) if self.preln else x
            x = x + self.cross_attn(Masked(n_x, lengths, 1).apply_mask(),
                                    memory).value
            if not self.preln:
                x = self.norm2(x)
        n_x = self.norm3(x) if self.preln else x
        x = x + self._ffn(n_x)
        if not self.preln:
            x = self.norm3(x)
        return Masked(x, lengths, 1).apply_mask()

    def decode(self, xv: torch.Tensor, cache: LayerKVCache, pos: int,
               rpe=None, window: Optional[int] = None,
               return_attn: bool = False, flash: bool = False,
               memory: Optional[Masked] = None):
        """Pre-LN or post-LN step of frames xv (B, S, C) at [pos, pos+S)
        over this layer's cache (no masking: decode positions are all
        valid); with ``memory`` a cross-attention layer attends over all
        of it (without, it is skipped, as in JAX).  Returns ``(x,
        cache)``, with ``return_attn`` also the self-attention weights
        (B, H, S, maxT)."""
        n_x = self.norm1(xv) if self.preln else xv
        res = self.self_attn.decode_step(n_x, cache, pos, rpe=rpe,
                                         window=window,
                                         return_attn=return_attn,
                                         flash=flash)
        h = res[0]
        cross = self.cross_attn is not None and memory is not None
        if self.preln:
            x = xv + h
            if cross:
                x = x + self.cross_attn(Masked.full(self.norm2(x)),
                                        memory).value
            x = x + self._ffn(self.norm3(x))
        else:
            x = self.norm1(xv + h)
            if cross:
                x = self.norm2(x + self.cross_attn(Masked.full(x),
                                                   memory).value)
            x = self.norm3(x + self._ffn(x))
        return (x,) + tuple(res[1:])


class TransformerLayerStack(nn.Module):
    def __init__(self, hp: Hparams, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None,
                 memory_dim: Optional[int] = None):
        super().__init__()
        hp.check_arg_in_hparams("num_layers", "layer")
        self.hp = hp
        self.layers = nn.ModuleList([TransformerLayer(hp.layer)
                                     for _ in range(hp.num_layers)])
        bias = hp.get("bias", True)
        dim = hp.layer.dim
        self.linear = (Dense(input_dim, dim, bias=bias)
                       if input_dim is not None else None)
        self.is_cross_attn = hp.layer.has("cross_attn")
        self.memory_linear = (Dense(memory_dim, dim, bias=bias)
                              if self.is_cross_attn
                              and memory_dim is not None else None)
        self.out = (Dense(dim, output_dim, bias=bias)
                    if output_dim is not None else None)
        self.final_norm = (get_norm(dim, hp.layer.norm)
                           if hp.get("final_ln", True) else None)
        self.first_norm = (get_norm(dim, hp.layer.norm)
                           if hp.get("first_ln", False) else None)
        self.rpe_id = hp.rpe.identifier if hp.get("rpe", False) else None
        self.rpe = (get_positional_encoding(self.rpe_id, hp.rpe, dim,
                                            hp.layer.self_attn.nheads)
                    if self.rpe_id is not None else None)
        self.remat = bool(hp.get("remat", False))

    @property
    def dim(self) -> int:
        return self.hp.layer.dim

    def set_uniform(self, std: float, generator=None) -> None:
        """Re-draw a learned T5 bias table uniform +-std, as JAX does;
        the other positions hold no table."""
        if isinstance(self.rpe, T5RPE):
            self.rpe.set_uniform(std, generator)

    def project_memory(self, memory: Optional[Masked]) -> Optional[Masked]:
        """The stack's memory projection (``memory_linear``), applied once
        per call."""
        if self.memory_linear is not None and memory is not None:
            memory = Masked(self.memory_linear(memory.value),
                            memory.lengths, 1).apply_mask()
        return memory

    # -- full-sequence (training) call -----------------------------------
    def run(self, tgt: Masked, memory: Optional[Masked] = None) -> dict:
        """All layers over (B, T, C) frames, cross-attention layers over
        ``memory`` (B, Tm, memory_dim or C): ``{"output": Masked,
        "layers": [per-layer outputs, then the final norm's]}``.  With
        ``remat: true`` each layer's activations are recomputed in the
        backward (``torch.utils.checkpoint``, as JAX's
        ``jax.checkpoint``)."""
        lengths = tgt.lengths
        out = tgt
        if self.linear is not None:
            out = Masked(self.linear(out.value), lengths, 1).apply_mask()
        if self.first_norm is not None:
            out = Masked(self.first_norm(out.value), lengths,
                         1).apply_mask()
        memory = self.project_memory(memory)
        bias = None
        if isinstance(self.rpe, T5RPE):
            bias = self.rpe(out.value.shape[1], out.value.shape[1])
        layers = []
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                value = torch.utils.checkpoint.checkpoint(
                    lambda v, la=layer: la(Masked(v, lengths, 1), memory,
                                           self.rpe, bias).value,
                    out.value, use_reentrant=False)
                out = Masked(value, lengths, 1)
            else:
                out = layer(out, memory, self.rpe, bias)
            layers.append(out)
        if self.final_norm is not None:
            out = Masked(self.final_norm(out.value), lengths, 1)
            layers.append(out)
        if self.out is not None:
            out = Masked(self.out(out.value), lengths, 1).apply_mask()
        return {"output": out, "layers": layers}

    def forward(self, tgt: Masked, memory: Optional[Masked] = None
                ) -> Masked:
        return self.run(tgt, memory)["output"]

    # -- shared pieces of the stacked paths -----------------------------
    def supports_stacked_decode(self) -> bool:
        """JAX's rule for its stacked paths: ALiBi or no positions, no
        cross-attention, pre-LN RMSNorm layers; other trunks take the
        per-layer ``decode``."""
        return self.rpe_id in (None, "ALiBi") and all(
            la.preln and la.cross_attn is None
            and isinstance(la.norm1, RMSNorm)
            and isinstance(la.norm3, RMSNorm) for la in self.layers)

    def build_stacked_decode(self) -> dict:
        """Per-layer weights stacked on a leading L axis, ``w`` as
        (L, in, out) in the compute dtype, ``x @ w`` like the JAX
        package; int8 weights stay int8 beside their ``scale`` (L, 1,
        out) in the compute dtype.  Build once per sampling call."""
        from ..core.precision import get_policy

        if not self.supports_stacked_decode():
            raise NotImplementedError(
                "the stacked decode needs pre-LN RMSNorm layers without "
                "cross-attention and ALiBi or no positions")
        dt = get_policy().compute_dtype

        def dense(getter):
            mods = [getter(la) for la in self.layers]
            w = torch.stack([m.weight.t() for m in mods])
            if w.dtype == torch.int8:
                entry = {"w": w, "scale": torch.stack(
                    [m.weight_scale.t() for m in mods]).to(dt)}
            else:
                entry = {"w": w.to(dt)}
            if mods[0].bias is not None:
                entry["b"] = torch.stack([m.bias for m in mods]).to(dt)
            return entry

        with torch.no_grad():
            return {
                "n1": torch.stack([la.norm1.scale for la in self.layers]),
                "n3": torch.stack([la.norm3.scale for la in self.layers]),
                "qkv": dense(lambda la: la.self_attn.in_proj),
                "out": dense(lambda la: la.self_attn.out_proj),
                "ffn1": dense(lambda la: la.linear1),
                "ffn2": dense(lambda la: la.linear2),
            }

    def _rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        eps = self.layers[0].norm1.eps
        return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)

    @staticmethod
    def _matmul(x: torch.Tensor, entry: dict, li: int) -> torch.Tensor:
        w = entry["w"][li]
        if w.dtype == torch.int8:
            w = w.to(x.dtype) * entry["scale"][li]
        y = x @ w
        if "b" in entry:
            y = y + entry["b"][li]
        return y

    def _ffn(self, x: torch.Tensor, stacked: dict, li: int) -> torch.Tensor:
        h2 = self._rms(x, stacked["n3"][li])
        act = self.layers[0].activation
        h = act(self._matmul(h2, stacked["ffn1"], li))
        return x + self._matmul(h, stacked["ffn2"], li)

    def _project_in(self, xv: torch.Tensor) -> torch.Tensor:
        if self.linear is not None:
            xv = self.linear(xv)
        if self.first_norm is not None:
            xv = self.first_norm(xv)
        return xv

    def _project_out(self, x: torch.Tensor, project: bool = True
                     ) -> torch.Tensor:
        """The final norm, then the output layer unless ``project`` is
        False (a caller that reads the normed hidden itself)."""
        if self.final_norm is not None:
            x = self.final_norm(x)
        if self.out is not None and project:
            x = self.out(x)
        return x

    def _slopes(self, device) -> torch.Tensor:
        if self.rpe_id == "ALiBi":
            return self.rpe.slopes
        return torch.zeros(self.layers[0].self_attn.nheads, device=device)

    # -- per-layer static-cache decode ------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=None) -> List[LayerKVCache]:
        """One cache per layer (``dtype`` None: the compute dtype)."""
        return [la.self_attn.init_cache(batch, max_len, dtype)
                for la in self.layers]

    @torch.no_grad()
    def decode(self, xv: torch.Tensor, caches: List[LayerKVCache], pos: int,
               window: Optional[int] = None, return_attn: bool = False,
               flash: bool = False, memory: Optional[Masked] = None,
               project: bool = True):
        """Frames xv (B, S, C) at [pos, pos+S) through every layer's
        ``decode`` over its cache: a prefill (S > 1) or one AR step
        (``window`` and ``flash`` as in ``SelfAttention.decode_step``);
        ``memory`` has been through ``project_memory`` once.  Returns the
        final hidden (B, S, C) and the caches, with ``return_attn`` also
        the per-layer weights stacked, (L, B, H, S, maxT)."""
        xv = self._project_in(xv)
        attns = []
        for layer, cache in zip(self.layers, caches):
            res = layer.decode(xv, cache, pos, rpe=self.rpe, window=window,
                               return_attn=return_attn, flash=flash,
                               memory=memory)
            xv = res[0]
            if return_attn:
                attns.append(res[2])
        xv = self._project_out(xv, project)
        if return_attn:
            return xv, caches, torch.stack(attns)
        return xv, caches

    # -- stacked int8 cache and prefill ----------------------------------
    def init_stacked_cache(self, batch: int, max_len: int,
                           dtype=torch.int8) -> LayerKVCache:
        """One int8 KV cache for the whole stack: ``(L, B, H, maxT, D)``."""
        if dtype != torch.int8:
            raise NotImplementedError(
                "the port's stacked cache is int8 only (ROADMAP.md)")
        la = self.layers[0].self_attn
        dev = la.in_proj.weight.device
        shape = (len(self.layers), batch, la.nheads, max_len, la.head_dim)
        return LayerKVCache(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], device=dev),
            torch.zeros(shape[:-1], device=dev))

    @torch.no_grad()
    def decode_stacked(self, xv: torch.Tensor, stacked: dict,
                       cache: LayerKVCache, pos: int, project: bool = True):
        """Prefill: frames ``xv`` (B, S, C) at positions [pos, pos+S)
        through all layers, writing their int8 K/V rows into ``cache``.
        Returns the final hidden (B, S, C) and the cache."""
        xv = self._project_in(xv)
        b, s, _ = xv.shape
        if s == 1:
            raise NotImplementedError(
                "single-token steps run through decode_hybrid, decode_mega "
                "or the per-layer decode; JAX's stacked single-token step "
                "is not ported (ROADMAP.md, Queue 1)")
        nheads = self.layers[0].self_attn.nheads
        win = cache.k.shape[-2]
        dev = xv.device
        k_pos = torch.arange(win, device=dev)
        q_pos = pos + torch.arange(s, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
        mask = mask.expand(b, 1, s, win)
        bias = self.rpe.bias(q_pos, k_pos) if self.rpe_id == "ALiBi" \
            else None
        x = xv
        for li in range(len(self.layers)):
            h = self._rms(x, stacked["n1"][li])
            q, k, v = self._matmul(h, stacked["qkv"], li).chunk(3, dim=-1)
            kh = split_heads(k, nheads).transpose(1, 2)    # (B, H, S, D)
            vh = split_heads(v, nheads).transpose(1, 2)
            for dst, sdst, new in ((cache.k, cache.k_scale, kh),
                                   (cache.v, cache.v_scale, vh)):
                q8, sc = quantize_i8(new)
                dst[li, :, :, pos:pos + s] = q8
                sdst[li, :, :, pos:pos + s] = sc
            # bfloat16 like LayerKVCache.dense_kv in the JAX package
            kd = (cache.k[li, :, :, :win].float()
                  * cache.k_scale[li, :, :, :win, None]).to(torch.bfloat16)
            vd = (cache.v[li, :, :, :win].float()
                  * cache.v_scale[li, :, :, :win, None]).to(torch.bfloat16)
            out = attend(split_heads(q, nheads), kd.transpose(1, 2),
                         vd.transpose(1, 2), bias, mask)
            x = x + self._matmul(merge_heads(out), stacked["out"], li)
            x = self._ffn(x, stacked, li)
        return self._project_out(x, project), cache

    # -- hybrid cold/tail cache ------------------------------------------
    @staticmethod
    def hybrid_cache_from_prefill(cache: LayerKVCache, prompt_len: int,
                                  total_len: int):
        """Convert the filled stacked prefill cache (positions
        [0, prompt_len)) into the cold/tail layout: the largest multiple
        of 256 positions goes cold, block-major and time-minor; the rest
        goes to the head-major 256-row tail.  Returns (cache, flushed)."""
        nl, b, h, _, dh = cache.k.shape
        dev = cache.k.device
        flushed = (prompt_len // TAIL) * TAIL
        nb = max((total_len // TAIL) * TAIL, BLK) // BLK
        nb_f = flushed // BLK
        n = prompt_len - flushed
        out = {}
        for name, src, scale in (("k", cache.k, cache.k_scale),
                                 ("v", cache.v, cache.v_scale)):
            cold = torch.zeros((nl, nb, b, h, dh, BLK), dtype=torch.int8,
                               device=dev)
            cold_s = torch.zeros((nl, nb, b, h, BLK), device=dev)
            if flushed:
                cold[:, :nb_f] = src[:, :, :, :flushed].reshape(
                    nl, b, h, nb_f, BLK, dh).permute(0, 3, 1, 2, 5, 4)
                cold_s[:, :nb_f] = scale[..., :flushed].reshape(
                    nl, b, h, nb_f, BLK).permute(0, 3, 1, 2, 4)
            tail = torch.zeros((nl, b, h, TAIL, dh), dtype=torch.int8,
                               device=dev)
            tail_s = torch.zeros((nl, b, h, TAIL), device=dev)
            tail[:, :, :, :n] = src[:, :, :, flushed:prompt_len]
            tail_s[..., :n] = scale[..., flushed:prompt_len]
            out[f"{name}_cold"], out[f"{name}c_scale"] = cold, cold_s
            out[f"{name}_tail"], out[f"{name}t_scale"] = tail, tail_s
        return out, flushed

    @staticmethod
    def flush_hybrid(cache: dict, flushed_prev: int) -> dict:
        """Move the full tail (one 256-position block) into cold block
        ``flushed_prev // 256``, in place."""
        nb = flushed_prev // BLK
        cache["k_cold"][:, nb] = cache["k_tail"].transpose(3, 4)
        cache["v_cold"][:, nb] = cache["v_tail"].transpose(3, 4)
        cache["kc_scale"][:, nb] = cache["kt_scale"]
        cache["vc_scale"][:, nb] = cache["vt_scale"]
        return cache

    @torch.no_grad()
    def decode_hybrid(self, xv: torch.Tensor, stacked: dict, cache: dict,
                      pos: int, flushed: int, project: bool = True):
        """One token (B, 1, C) at position ``pos`` through all layers,
        with ``fused_decode_attention`` as each layer's attention.  The
        layers' new K/V rows go into tail slot ``pos - flushed`` after
        the loop.  Returns the final hidden (B, 1, C) and the cache."""
        x = self._project_in(xv)
        b, s, d = x.shape
        if s != 1:
            raise ValueError("decode_hybrid takes one token per row")
        la0 = self.layers[0].self_attn
        nheads, dh = la0.nheads, la0.head_dim
        slopes = self._slopes(x.device)
        k_rows, v_rows = [], []
        for li in range(len(self.layers)):
            h = self._rms(x, stacked["n1"][li])
            qkv = self._matmul(h, stacked["qkv"], li)[:, 0]
            qh, kh, vh = qkv.view(b, 3, nheads, dh).unbind(1)
            out = fused_decode_attention(
                qh, cache["k_cold"], cache["v_cold"], cache["kc_scale"],
                cache["vc_scale"], cache["k_tail"], cache["v_tail"],
                cache["kt_scale"], cache["vt_scale"], pos, li, slopes,
                kh, vh, flushed)
            out = out.to(x.dtype).reshape(b, 1, d)
            x = x + self._matmul(out, stacked["out"], li)
            x = self._ffn(x, stacked, li)
            k_rows.append(kh)
            v_rows.append(vh)
        slot = pos - flushed
        for name, rows in (("k", k_rows), ("v", v_rows)):
            q8, sc = quantize_i8(torch.stack(rows))        # (L, B, H, D)
            cache[f"{name}_tail"][:, :, :, slot] = q8
            cache[f"{name}t_scale"][..., slot] = sc
        return self._project_out(x, project), cache

    # -- int8 weights and the mega path -----------------------------------
    def quantize_weights_int8(self) -> None:
        """Weight-only int8 (per output feature) for the stack's
        projections, its FFN and its input/output ``linear``s.
        Irreversible; inference only."""
        for la in self.layers:
            for m in (la.self_attn.in_proj, la.self_attn.out_proj,
                      la.linear1, la.linear2):
                m.quantize_int8()
        for m in (self.linear, self.out):
            if m is not None:
                m.quantize_int8()

    def supports_mega_decode(self) -> bool:
        """JAX's eligibility checks for K2, and no others: int8
        projections, no other norm than pre-LN RMSNorm with eps 1e-6,
        ALiBi, GELU, ffd = 4 dim, dim a multiple of 256.  Like JAX's, it
        asks nothing of the head width; the kernel is instantiated at
        widths 32, 64 and 128 (``ops/mega_step.HEAD_DIMS``) and raises at
        any other on a card, while the CPU's plain version takes any."""
        if not self.supports_stacked_decode():
            return False
        d = self.dim
        if self.rpe_id != "ALiBi" or d % 256:
            return False
        for la in self.layers:
            mods = (la.self_attn.in_proj, la.self_attn.out_proj, la.linear1,
                    la.linear2)
            if any(m.weight.dtype != torch.int8 for m in mods):
                return False
            if la.linear1.out_dim != 4 * d or la.norm1.eps != 1e-6:
                return False
            if la.activation is not gelu:
                return False
        return True

    @torch.no_grad()
    def build_mega_decode(self) -> Optional[dict]:
        """The stacked weights of K2 (``ops/mega_step.py``): int8 ``wq/wo/
        w1/w2`` in JAX's (L, din, dout) layout, float32 column scales
        ``sq/so/s1/s2``, RMSNorm scales ``n1/n3`` and biases ``bq/bo/b1/
        b2`` (zeros without biases).  None unless
        ``supports_mega_decode()``."""
        if not self.supports_mega_decode():
            return None
        d = self.dim
        dev = self.layers[0].linear1.weight.device

        def stack(get):
            return torch.stack([get(la).weight.t() for la in self.layers]
                               ).contiguous()

        def scales(get):
            return torch.stack([get(la).weight_scale.reshape(-1)
                                for la in self.layers]).float()

        def biases(get, n):
            return torch.stack([
                get(la).bias.float() if get(la).bias is not None
                else torch.zeros(n, device=dev) for la in self.layers])

        qkv, out, up, down = map(attrgetter, (
            "self_attn.in_proj", "self_attn.out_proj", "linear1", "linear2"))
        return {
            "wq": stack(qkv), "wo": stack(out), "w1": stack(up),
            "w2": stack(down),
            "sq": scales(qkv), "so": scales(out), "s1": scales(up),
            "s2": scales(down),
            "n1": torch.stack([la.norm1.scale for la in self.layers]
                              ).float(),
            "n3": torch.stack([la.norm3.scale for la in self.layers]
                              ).float(),
            "bq": biases(qkv, 3 * d), "bo": biases(out, d),
            "b1": biases(up, 4 * d), "b2": biases(down, d),
        }

    def build_mega_decode_w4(self, group: int = 128) -> Optional[dict]:
        """K2-w4's nibble-packed int4 weights (JAX's
        ``build_mega_decode_w4``): ``pack_mega_w4`` of
        ``build_mega_decode()``.  None unless ``supports_mega_decode()``."""
        w8 = self.build_mega_decode()
        if w8 is None:
            return None
        return pack_mega_w4(w8, group, self.layers[0].self_attn.head_dim)

    @staticmethod
    def mega_cache_from_prefill(cache: LayerKVCache, prompt_len: int,
                                total_len: int):
        """Convert the filled stacked prefill cache (positions
        [0, prompt_len)) into K2's three tiers: the largest multiple of
        128 positions goes to block-major, time-minor cold blocks
        (``total_len // 128 + 1`` of them), the largest multiple of 8
        after it to the head-major int8 tail, and the rest, dequantized,
        to the bfloat16 stage.  Returns (cache, flushed)."""
        nl, b, h, _, dh = cache.k.shape
        dev = cache.k.device
        blk, stage_n = mega.BLK, mega.STAGE
        flushed = (prompt_len // blk) * blk
        nb = max(total_len // blk + 1, 1)
        nb_f = flushed // blk
        n_tail = (prompt_len - flushed) // stage_n * stage_n
        mid = flushed + n_tail
        out = {}
        for name, src, scale in (("k", cache.k, cache.k_scale),
                                 ("v", cache.v, cache.v_scale)):
            cold = torch.zeros((nl, nb, h, b, dh, blk), dtype=torch.int8,
                               device=dev)
            cold_s = torch.zeros((nl, nb, h, b, blk), device=dev)
            if flushed:
                cold[:, :nb_f] = src[:, :, :, :flushed].reshape(
                    nl, b, h, nb_f, blk, dh).permute(0, 3, 2, 1, 5, 4)
                cold_s[:, :nb_f] = scale[..., :flushed].reshape(
                    nl, b, h, nb_f, blk).permute(0, 3, 2, 1, 4)
            tail = torch.zeros((nl, h, b, mega.TAIL, dh), dtype=torch.int8,
                               device=dev)
            tail_s = torch.zeros((nl, h, b, mega.TAIL), device=dev)
            tail[:, :, :, :n_tail] = src[:, :, :, flushed:mid].transpose(1, 2)
            tail_s[..., :n_tail] = scale[..., flushed:mid].transpose(1, 2)
            stage = torch.zeros((nl, stage_n, h, b, dh),
                                dtype=torch.bfloat16, device=dev)
            rows = (src[:, :, :, mid:prompt_len].float()
                    * scale[..., mid:prompt_len, None])
            stage[:, :prompt_len - mid] = rows.permute(0, 3, 2, 1, 4).to(
                torch.bfloat16)
            out[f"{name}_cold"], out[f"{name}c_scale"] = cold, cold_s
            out[f"{name}_tail"], out[f"{name}t_scale"] = tail, tail_s
            out[f"{name}_stage"] = stage
        return out, flushed

    @torch.no_grad()
    def decode_mega(self, xv: torch.Tensor, weights: dict, cache: dict,
                    pos: int, flushed: int, a8: Optional[bool] = None):
        """One token (B, 1, C) at position ``pos`` through the whole trunk
        as one K2 call (``ops/mega_step.fused_trunk_step``), then the
        step's bf16 K/V rows into stage slot ``(pos - flushed) % 8``.
        ``a8`` (s8 x s8 dense products) defaults to B <= 8, JAX's batch
        gate.  The caller owns the 8-step ``merge_stage`` and the 128-step
        ``flush_mega``.  Returns the final hidden (B, 1, C) and the
        cache."""
        xv = self._project_in(xv)
        b, s, _ = xv.shape
        if s != 1:
            raise ValueError("decode_mega takes one token per row")
        if a8 is None:
            a8 = b <= 8
        xo, k_new, v_new = mega.fused_trunk_step(
            xv[:, 0].float(), weights, cache, pos,
            self._slopes(xv.device).float(), flushed, a8=a8)
        mega.stage_append(cache, k_new, v_new, (pos - flushed) % mega.STAGE)
        return self._project_out(xo[:, None].to(xv.dtype)), cache
