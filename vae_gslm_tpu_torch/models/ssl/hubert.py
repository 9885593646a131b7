"""HuBERT speech encoder for semantic tokenization (port of
``vae_gslm_tpu/models/ssl/hubert.py``).

The conv feature extractor (strides 5, 2, 2, 2, 2, 2, 2: 50 Hz frames),
the feature projection, the grouped conv positional embedding and the
transformer encoder: pre-LN ("stable layer norm", hubert-large) or
post-LN (hubert-base).  Per-utterance input normalisation is the
caller's (``normalize_input``).  Attention is the dense product with a
-1e30 key mask: the JAX package computes it in plain XLA, so the port
runs plain torch ops and no kernel.  Matmul and convolution inputs take
the policy's compute dtype (``core/precision.py``); norms and the
softmax run in float32.

Layouts: dense weights ``w`` are (in, out) as in JAX (``x @ w + b``);
conv weights are torch's (out, in / groups, k), so ``conv1d`` on NCW
takes them as they are (JAX holds (k, in, out) for its NWC convs).
``convert_hf_state_dict`` folds the positional conv's weight norm at
load, as JAX does; ``from_hf_pretrained`` reads a local HF directory
(``config.json`` and ``pytorch_model.bin`` or ``model.safetensors``)
without ``transformers`` or ``safetensors``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.precision import get_policy


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Sequence[int] = (512,) * 7
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"   # 'layer' (large) | 'group' (base)
    do_stable_layer_norm: bool = True  # True for large
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def large(cls) -> "HubertConfig":
        return cls()

    @classmethod
    def base(cls) -> "HubertConfig":
        return cls(hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   conv_bias=False, feat_extract_norm="group",
                   do_stable_layer_norm=False)

    @classmethod
    def from_hf(cls, config: Union[Mapping, Any]) -> "HubertConfig":
        """From an HF config: a ``config.json`` dict or an object with
        the same attributes (``transformers.HubertConfig``)."""
        get = (config.__getitem__ if isinstance(config, Mapping)
               else lambda k: getattr(config, k))
        return cls(
            hidden_size=get("hidden_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            conv_dim=tuple(get("conv_dim")),
            conv_kernel=tuple(get("conv_kernel")),
            conv_stride=tuple(get("conv_stride")),
            conv_bias=get("conv_bias"),
            feat_extract_norm=get("feat_extract_norm"),
            do_stable_layer_norm=get("do_stable_layer_norm"),
            num_conv_pos_embeddings=get("num_conv_pos_embeddings"),
            num_conv_pos_embedding_groups=get(
                "num_conv_pos_embedding_groups"),
            layer_norm_eps=get("layer_norm_eps"))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class _LN(nn.Module):
    """LayerNorm over the last axis in float32, back to the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.w = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (self.w * y + self.b).to(x.dtype)


class _GroupNormAll(nn.Module):
    """GroupNorm(num_groups=C, C), HF's norm of conv layer 0 in the base
    variant: per (batch, channel) statistics over time, on NCW."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.w = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()                                   # (B, C, T)
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (self.w[:, None] * y + self.b[:, None]).to(x.dtype)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        return x.to(dt) @ self.w.to(dt) + self.b.to(dt)


class FeatureEncoder(nn.Module):
    """The strided conv stack over the raw waveform: (B, T) -> (B, T',
    C).  ``norms`` holds a norm for each layer that has one (all of them
    in the layer-norm variant, layer 0 in the group-norm one)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_w = nn.ParameterList()
        self.conv_b = nn.ParameterList()
        self.norms = nn.ModuleDict()
        in_ch = 1
        for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            self.conv_w.append(nn.Parameter(torch.zeros(dim, in_ch, k)))
            if cfg.conv_bias:
                self.conv_b.append(nn.Parameter(torch.zeros(dim)))
            if cfg.feat_extract_norm == "layer":
                self.norms[str(i)] = _LN(dim, cfg.layer_norm_eps)
            elif i == 0:
                self.norms[str(i)] = _GroupNormAll(dim, cfg.layer_norm_eps)
            in_ch = dim

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        dt = get_policy().compute_dtype
        x = wave[:, None].to(dt)                         # (B, 1, T)
        for i, s in enumerate(self.cfg.conv_stride):
            b = self.conv_b[i].to(dt) if self.cfg.conv_bias else None
            x = F.conv1d(x, self.conv_w[i].to(dt), b, stride=s)
            norm = self.norms[str(i)] if str(i) in self.norms else None
            if isinstance(norm, _LN):
                x = norm(x.transpose(1, 2)).transpose(1, 2)
            elif norm is not None:
                x = norm(x)
            x = _gelu(x)
        return x.transpose(1, 2)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.q = _Dense(d, d)
        self.k = _Dense(d, d)
        self.v = _Dense(d, d)
        self.o = _Dense(d, d)
        self.attn_ln = _LN(d, cfg.layer_norm_eps)
        self.ff1 = _Dense(d, cfg.intermediate_size)
        self.ff2 = _Dense(cfg.intermediate_size, d)
        self.final_ln = _LN(d, cfg.layer_norm_eps)
        self.nheads = cfg.num_attention_heads
        self.stable = cfg.do_stable_layer_norm

    def _attn(self, x: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        h = self.nheads
        hd = d // h
        q = self.q(x).reshape(b, t, h, hd).transpose(1, 2)
        k = self.k(x).reshape(b, t, h, hd).transpose(1, 2)
        v = self.v(x).reshape(b, t, h, hd).transpose(1, 2)
        # float32 products of the compute-dtype values (JAX's
        # preferred_element_type=float32)
        logits = (q.float() @ k.float().transpose(-1, -2)) / np.float32(
            math.sqrt(hd))
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = w.float() @ v.float()                      # (B, H, T, hd)
        return self.o(out.to(x.dtype).transpose(1, 2).reshape(b, t, d))

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff2(_gelu(self.ff1(x)))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.stable:
            x = x + self._attn(self.attn_ln(x), mask)
            return x + self._ff(self.final_ln(x))
        x = self.attn_ln(x + self._attn(x, mask))
        return self.final_ln(x + self._ff(x))


class HubertEncoder(nn.Module):
    """``device`` defaults to CUDA and raises without it."""

    def __init__(self, cfg: HubertConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        k = cfg.num_conv_pos_embeddings
        g = cfg.num_conv_pos_embedding_groups
        self.feature_encoder = FeatureEncoder(cfg)
        self.fp_ln = _LN(cfg.conv_dim[-1], cfg.layer_norm_eps)
        self.fp_proj = _Dense(cfg.conv_dim[-1], d)
        self.pos_conv_w = nn.Parameter(torch.zeros(d, d // g, k))
        self.pos_conv_b = nn.Parameter(torch.zeros(d))
        self.enc_ln = _LN(d, cfg.layer_norm_eps)
        self.layers = nn.ModuleList([EncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])
        self.to(resolve_device(device))

    def _pos_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The grouped positional conv over (B, T, d); an even kernel's
        extra last frame is dropped."""
        cfg = self.cfg
        k = cfg.num_conv_pos_embeddings
        y = F.conv1d(x.transpose(1, 2), self.pos_conv_w.to(x.dtype),
                     self.pos_conv_b.to(x.dtype), padding=k // 2,
                     groups=cfg.num_conv_pos_embedding_groups)
        if k % 2 == 0:
            y = y[..., :-1]
        return _gelu(y.transpose(1, 2))

    def frame_count(self, n_samples):
        """Output frames for an input length (the conv stack's
        arithmetic); an int or an integer tensor."""
        n = n_samples
        for k, s in zip(self.cfg.conv_kernel, self.cfg.conv_stride):
            n = (n - k) // s + 1
        return n

    def forward(self, wave: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wave: (B, T) normalised waveform -> (B, frames, d) float32.
        With ``lengths`` (samples) padded frames are zeroed and masked
        out of attention (HF's attention_mask), so a bucket-padded batch
        matches unpadded runs up to the positional conv's edge."""
        feats = self.feature_encoder(wave)
        mask = None
        if lengths is not None:
            n = self.frame_count(lengths.to(torch.int64))
            pos = torch.arange(feats.shape[1], device=feats.device)
            mask = pos[None, :] < n[:, None]
            feats = torch.where(mask[..., None], feats,
                                feats.new_zeros(()))
        x = self.fp_proj(self.fp_ln(feats))
        if mask is not None:
            x = torch.where(mask[..., None], x, x.new_zeros(()))
        x = x + self._pos_conv(x)
        if self.cfg.do_stable_layer_norm:
            x = self.enc_ln(self._run_layers(x, mask))
        else:
            x = self._run_layers(self.enc_ln(x), mask)
        return x.float()

    def _run_layers(self, x: torch.Tensor, mask) -> torch.Tensor:
        # JAX scans one compiled layer body L times to save XLA compile
        # time; eager torch needs nothing of the kind
        for layer in self.layers:
            x = layer(x, mask)
        return x


def normalize_input(wave: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor(do_normalize=True) semantics."""
    wave = np.asarray(wave, np.float32)
    mean = wave.mean(-1, keepdims=True)
    var = wave.var(-1, keepdims=True)
    return (wave - mean) / np.sqrt(var + 1e-7)


# ------------------------------------------------------------ conversion
def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


@torch.no_grad()
def convert_hf_state_dict(model: HubertEncoder, sd: Mapping) -> None:
    """Load an HF ``HubertModel`` state dict (torch tensors or numpy);
    the positional conv's weight norm (``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0/1``) is folded as JAX folds it:
    g * v / sqrt(sum over axes (0, 1) of v^2 + 1e-12), in numpy float32."""
    def g(key):
        return _np(sd[key])

    def put(param: torch.Tensor, arr: np.ndarray) -> None:
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"shape {arr.shape} does not fit "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr)))

    cfg, fe = model.cfg, model.feature_encoder
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        put(fe.conv_w[i], g(f"{pre}.conv.weight"))
        if cfg.conv_bias and f"{pre}.conv.bias" in sd:
            put(fe.conv_b[i], g(f"{pre}.conv.bias"))
        if f"{pre}.layer_norm.weight" in sd:
            put(fe.norms[str(i)].w, g(f"{pre}.layer_norm.weight"))
            put(fe.norms[str(i)].b, g(f"{pre}.layer_norm.bias"))
    put(model.fp_ln.w, g("feature_projection.layer_norm.weight"))
    put(model.fp_ln.b, g("feature_projection.layer_norm.bias"))
    put(model.fp_proj.w, g("feature_projection.projection.weight").T)
    put(model.fp_proj.b, g("feature_projection.projection.bias"))
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        wg, wv = g(f"{pc}.weight_g"), g(f"{pc}.weight_v")
    elif f"{pc}.parametrizations.weight.original0" in sd:
        wg = g(f"{pc}.parametrizations.weight.original0")
        wv = g(f"{pc}.parametrizations.weight.original1")
    else:
        wg, wv = None, g(f"{pc}.weight")
    if wg is not None:
        norm = np.sqrt((wv ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
        wv = wg * wv / norm          # (out, in/g, k), g is (1, 1, k)
    put(model.pos_conv_w, wv)
    put(model.pos_conv_b, g(f"{pc}.bias"))
    put(model.enc_ln.w, g("encoder.layer_norm.weight"))
    put(model.enc_ln.b, g("encoder.layer_norm.bias"))
    for i, layer in enumerate(model.layers):
        pre = f"encoder.layers.{i}"
        for ours, theirs in ((layer.q, "attention.q_proj"),
                             (layer.k, "attention.k_proj"),
                             (layer.v, "attention.v_proj"),
                             (layer.o, "attention.out_proj"),
                             (layer.ff1, "feed_forward.intermediate_dense"),
                             (layer.ff2, "feed_forward.output_dense")):
            put(ours.w, g(f"{pre}.{theirs}.weight").T)
            put(ours.b, g(f"{pre}.{theirs}.bias"))
        put(layer.attn_ln.w, g(f"{pre}.layer_norm.weight"))
        put(layer.attn_ln.b, g(f"{pre}.layer_norm.bias"))
        put(layer.final_ln.w, g(f"{pre}.final_layer_norm.weight"))
        put(layer.final_ln.b, g(f"{pre}.final_layer_norm.bias"))


_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32,
                       "F16": np.float16}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file of float tensors as numpy arrays (bfloat16
    widened to float32): an 8-byte little-endian header length, a JSON
    header of ``{name: {dtype, shape, data_offsets}}`` and the raw
    little-endian buffers after it."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        buf, dt = data[lo:hi], info["dtype"]
        if dt == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32)
                   << 16).view(np.float32)
        elif dt in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(buf, np.dtype(_SAFETENSORS_DTYPES[dt])
                                .newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name} has dtype {dt}")
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Float32 numpy arrays as a ``.safetensors`` file (the inverse of
    ``read_safetensors`` for float32)."""
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        b = np.ascontiguousarray(arr, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(arr)),
                        "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(np.uint64(len(head)).astype("<u8").tobytes())
        f.write(head)
        for b in blobs:
            f.write(b)


def from_hf_pretrained(path: str,
                       device: Union[str, torch.device] = "cuda"
                       ) -> HubertEncoder:
    """Build and load from a local HF checkpoint directory: its
    ``config.json`` and ``pytorch_model.bin`` (read with
    ``weights_only``) or ``model.safetensors``.  A name that is not a
    directory (a hub name) raises: nothing is downloaded."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"HuBERT weights are read from a local HF directory; "
            f"{path!r} is not one (wanted {os.path.abspath(path)}/"
            "config.json and pytorch_model.bin or model.safetensors)")
    with open(os.path.join(path, "config.json")) as f:
        cfg = HubertConfig.from_hf(json.load(f))
    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.exists(st_path):
        sd = read_safetensors(st_path)
    else:
        raise FileNotFoundError(f"{path} holds neither pytorch_model.bin "
                                "nor model.safetensors")
    # a model with a head (HubertForCTC) nests the encoder under "hubert."
    sd = {k[len("hubert."):] if k.startswith("hubert.") else k: v
          for k, v in sd.items()}
    model = HubertEncoder(cfg, device="cpu")
    convert_hf_state_dict(model, sd)
    return model.to(resolve_device(device))
