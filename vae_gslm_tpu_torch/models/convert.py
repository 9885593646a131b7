"""Weights carried into the port from the reference's state dicts.

The port's modules use the reference's state-dict names and torch
layouts, so loading is a rename of a few top-level prefixes plus a
strict ``load_state_dict``: every port parameter must be covered and
no key may be left over.  ``load_reference_lvtr`` takes exactly what
``vae_gslm_tpu/models/convert_torch.py::export_torch_lvtr`` returns (or
a reference checkpoint's state dict); ``load_reference_generator``
takes the reference HiFi-GAN generator's state dict in either
weight-norm form (``weight_g``/``weight_v`` or
``parametrizations.weight.original0/1``) or with weight norm removed
(``weight``: then v = weight and g = ||weight||, as JAX loads it), into
a weight-normed generator (``HiFiGAN.from_pretrained`` folds it after).
``load_reference_lvtts`` takes a reference LVTTS state dict: the LVTR's
keys plus the text encoder, the eos head, the speaker encoder and
``spkr_film``, renamed as JAX's ``load_torch_lvtts`` reads them.
``load_reference_hubert_decoder`` and ``load_reference_discrete_ar``
take the reference's token->mel decoder and token LM state dicts (JAX's
``export_torch_hubert_decoder`` and what ``load_torch_discrete_ar``
reads).  ``mega_weights_from_numpy`` carries the int8 K2 weights of a JAX
``build_mega_decode()`` dict across as they are, and
``layer_cache_from_numpy`` a JAX per-layer KV cache;
``load_hubert_flat`` carries the JAX tokenizer encoder's parameters.

``to_flat`` / ``load_flat`` map an LVTR, a DiscreteAR, a HuBERT decoder,
a SoundStream (its quantizer's codebooks; BestRQ's frozen projection and
codebooks, ``nnx.Variable`` buffers in JAX, buffers in the port) or a
HiFi-GAN generator to and from the JAX package's compact checkpoint contract: a flat dict of
numpy arrays keyed by the flax attribute paths joined by ``/``
(``nnx.to_pure_dict``, list indices included), in the JAX layouts
(dense kernels (in, out), conv kernels (k, in, out), transposed-conv
kernels (k, out, in), 2-D conv kernels (kh, kw, in, out), the HiFi-GAN
weight-norm ``g``/``v`` pairs with ``g`` flat).  ``load_hfgan_flat``
fills a HiFi-GAN generator and its discriminators from the JAX trainer's
two parameter sets (``mpd/discriminators/{i}/convs/{j}/v`` and so on).
The map is derived from the port's modules, as the JAX package's
``models/convert_torch.py::export_torch_lvtr`` derives the reference
names from its own, and is strict both ways: every port parameter is
covered, no key is left over, shapes must agree.  Variables that are not
parameters (ALiBi's ``slopes``, the SinCos ``p`` table, Rotary's
``freqs`` and xpos ``scale``, the diffusion ``schedule`` stack) are
written from the port's recomputed buffers and, on loading, checked
equal to them.  The JAX exporter drops a ``ConditionalUNet`` denoiser
(and names any encoder as a bottleneck's), so ``load_reference_lvtr``
refuses such a dict and points to ``load_flat``, which carries every
LVTR the port builds.  None of this imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..nn.attention import LayerKVCache
from ..nn.conv import Conv1d, ConvTranspose1d, LayerScale
from ..nn.diffusion import GaussianDiffusion1D
from ..nn.linear import Dense, Embedding, FiLM, GaussianParameterize, Linear
from ..nn.positions import ALiBi, Rotary, SinCos
from ..ops.mega_step import W4_KEYS, WEIGHT_KEYS
from .vocoder.hfgan import WN_CONVS, WNConv2d

# reference top-level prefix -> port attribute
_LVTR_PREFIXES = (("encoder.0.", "encoder_net."),
                  ("encoder.1.", "encoder_head."),
                  ("transformer.0.", "transformer."),
                  ("transformer.1.", "prior_head."),
                  ("utterance_encoder.0.", "utterance_net."))


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.tensor(np.asarray(v))


def load_reference_lvtr(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference-keyed LVTR state dict into the port;
    raises naming ``load_flat`` when the dict does not cover the model
    (a JAX ``export_torch_lvtr`` dict of a ``ConditionalUNet`` model)."""
    _load_renamed("LVTR", model, sd, _LVTR_PREFIXES,
                  "; the JAX exporter drops a ConditionalUNet denoiser: "
                  "carry the model through its compact checkpoint and "
                  "load_flat instead")


# the reference LVTTS's extra top-level prefixes (JAX's load_torch_lvtts)
_LVTTS_PREFIXES = _LVTR_PREFIXES + (
    ("text_encoder.0.", "text_embedding."),
    ("text_encoder.1.", "text_encoder."),
    ("spkr_encoder.0.", "spkr_encoder."))


def load_reference_lvtts(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference-keyed LVTTS state dict: the LVTR's
    renames, then the text embedding (``text_encoder.0``), the text stack
    (``text_encoder.1``) and the speaker encoder (``spkr_encoder.0``);
    ``eos_head`` and the time-first ``spkr_film`` keep their names."""
    _load_renamed("LVTTS", model, sd, _LVTTS_PREFIXES)


def _load_renamed(what: str, model: nn.Module, sd: Mapping, prefixes,
                  hint: str = "") -> None:
    """Strictly load ``sd`` into ``model`` after renaming the reference's
    top-level ``prefixes`` (old, new) pairs; a dict that does not cover
    the model raises a ``KeyError`` (ending with ``hint``)."""
    out = {}
    for k, v in sd.items():
        for old, new in prefixes:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = _tensor(v)
    try:
        model.load_state_dict(out, strict=True)
    except RuntimeError as e:
        raise KeyError(f"the state dict does not cover this {what} "
                       f"({e}){hint}") from None


def load_reference_hubert_decoder(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference-keyed HuBERT token->mel decoder state
    dict (the reference checkpoint's, or JAX's
    ``export_torch_hubert_decoder``): the speaker encoder's
    ``spkr_encoder.0.`` is the port's ``spkr_net.``, every other key the
    port's own."""
    _load_renamed("HuBERT decoder", model, sd,
                  (("spkr_encoder.0.", "spkr_net."),))


def load_reference_discrete_ar(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference DiscreteAR state dict (the reference's
    ``Sequential(embedding, stack)`` as ``transformer.0.``/
    ``transformer.1.``; a multi-VQ embedding's per-quantizer tables
    ``transformer.0.embeddings.{i}.weight`` stack into the port's
    ``embedding.tables``)."""
    sd = dict(sd)
    n = getattr(model.embedding, "num_quantizers", None)
    if n is not None:
        sd["embedding.tables"] = torch.stack(
            [_tensor(sd.pop(f"transformer.0.embeddings.{i}.weight"))
             for i in range(n)])
    _load_renamed("DiscreteAR", model, sd,
                  (("transformer.0.", "embedding."),
                   ("transformer.1.", "transformer.")))


def _wn_convs(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    return ((name, m) for name, m in model.named_modules()
            if isinstance(m, WN_CONVS))


def _set_wn(mod: nn.Module, g: torch.Tensor, v: torch.Tensor) -> None:
    """A torch-layout g/v pair into a weight-normed conv as it is."""
    mod.weight_g.copy_(g.reshape(mod.weight_g.shape))
    mod.weight_v.copy_(v)


def _check_shape(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{what}: shape {tuple(got.shape)}, the port's "
                         f"{tuple(want.shape)}")


@torch.no_grad()
def load_reference_generator(gen: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference HiFi-GAN generator state dict (any of
    the three weight forms) into the port's generator."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    for prefix, mod in _wn_convs(gen):
        if f"{prefix}.weight_g" in sd:
            g, v = sd.pop(f"{prefix}.weight_g"), sd.pop(f"{prefix}.weight_v")
        elif f"{prefix}.parametrizations.weight.original0" in sd:
            g = sd.pop(f"{prefix}.parametrizations.weight.original0")
            v = sd.pop(f"{prefix}.parametrizations.weight.original1")
        else:
            v = sd.pop(f"{prefix}.weight")
            g = torch.from_numpy(_g_norm(v.numpy()))
        _check_shape(f"{prefix} weight", v, mod.weight_v)
        _set_wn(mod, g, v)
        bias = sd.pop(f"{prefix}.bias")
        _check_shape(f"{prefix}.bias", bias, mod.bias)
        mod.bias.copy_(bias)
    if sd:
        raise KeyError(f"unexpected generator keys: {sorted(sd)}")


def mega_weights_from_numpy(d: Mapping,
                            device: Union[str, torch.device] = "cpu"
                            ) -> Dict[str, torch.Tensor]:
    """The port's K2 weights dict from the arrays of a JAX
    ``TransformerLayerStack.build_mega_decode()`` dict (numpy or array
    likes): the same (L, din, dout) int8 weights and float32 vectors,
    contiguous, with nothing requantized.  A ``build_mega_decode_w4()``
    dict (its packed (L, din/2, dout) ``wq/wo/w1/w2`` and its group scales
    ``gq/go/g1/g2``) carries across the same way."""
    keys = WEIGHT_KEYS + (W4_KEYS if "gq" in d else ())
    extra = sorted(set(d) - set(keys))
    if extra:
        raise KeyError(f"unexpected mega weight keys: {extra}")
    out = {}
    for key in keys:
        v = np.array(d[key])          # a writable, contiguous copy
        want = np.int8 if key.startswith("w") else np.float32
        if v.dtype != want:
            raise TypeError(f"{key}: dtype {v.dtype}, expected {want}")
        out[key] = torch.from_numpy(v).to(device)
    return out


def _array_tensor(a, device) -> torch.Tensor:
    """A contiguous copy of a numpy (or array-like) array, bfloat16
    included (numpy holds it as ml_dtypes' bfloat16, which torch does not
    read: its bits go across as int16)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def layer_cache_from_numpy(cache, device: Union[str, torch.device] = "cpu"
                           ) -> LayerKVCache:
    """The port's per-layer ``LayerKVCache`` from the arrays of a JAX
    per-layer ``LayerKVCache`` (``k``, ``v`` and, int8, ``k_scale``,
    ``v_scale``) in the base (B, H, T, D) layout, in the same dtype (int8
    with float32 scales, or a float dtype), copied."""
    if cache.k.ndim != 4:
        raise ValueError(f"k: rank {cache.k.ndim}; the port takes the base "
                         "(B, H, T, D) layout, not JAX's packed one")
    scales = ((None, None) if cache.k_scale is None else
              (_array_tensor(cache.k_scale, device),
               _array_tensor(cache.v_scale, device)))
    return LayerKVCache(_array_tensor(cache.k, device),
                        _array_tensor(cache.v, device), *scales)


# ------------------------------------------------- JAX compact contract
def _flat_name(model: nn.Module, name: str) -> Tuple[str, str]:
    """The flax path of a port parameter or buffer ``name`` and how its
    array maps: "t2" (a dense kernel, transposed), "t3" (a conv kernel,
    axes reversed), "film" (a 1x1 conv FiLM's kernel: JAX keeps it 2-D),
    "gamma" (a LayerScale, flat in JAX) or "same"."""
    segs = name.split(".")
    out, owner, parent = [], None, model
    for seg in segs[:-1]:
        child = parent[int(seg)] if seg.isdigit() else getattr(parent, seg)
        if isinstance(parent, GaussianParameterize) and seg in ("mean",
                                                                "logstd"):
            seg += "_head"
        elif isinstance(parent, Linear) and seg == "linear":
            seg = "dense"
        out.append(seg)
        owner, parent = parent, child
    leaf, kind = segs[-1], "same"
    if isinstance(parent, Embedding):
        leaf = "table"
    elif isinstance(parent, Dense) and leaf == "weight":
        leaf, kind = "kernel", "t2"
    elif isinstance(parent, (Conv1d, ConvTranspose1d)) and leaf == "weight":
        leaf = "kernel"
        kind = ("film" if isinstance(owner, FiLM) and not owner.time_first
                else "t3")
    elif isinstance(parent, LayerScale):
        kind = "gamma"
    path = "/".join(out + [leaf]).replace("shortcut/0/", "shortcut_conv/")
    return path, kind


def _to_jax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "t2":
        return a.T
    if kind == "t3":
        return a.transpose(2, 1, 0)
    if kind == "film":
        return a[:, :, 0].T
    if kind == "gamma":
        return a.reshape(-1)
    return a


def _from_jax(a: np.ndarray, kind: str, shape) -> np.ndarray:
    if kind == "t2":
        a = a.T
    elif kind == "t3":
        a = a.transpose(2, 1, 0)
    elif kind == "film":
        a = a.T[:, :, None]
    if kind == "gamma":
        a = a.reshape(shape)
    return a


def _lvtr_variables(model: nn.Module) -> Iterator[Tuple[str, np.ndarray]]:
    """The non-parameter variables of a JAX LVTR, from the port's
    recomputed buffers: ALiBi slopes, SinCos tables, Rotary frequencies
    (and xpos scales) and each diffusion decoder's sorted ``schedule``
    stack."""
    for name, mod in model.named_modules():
        prefix = name.replace(".", "/")
        if isinstance(mod, ALiBi):
            yield f"{prefix}/slopes", mod.slopes.cpu().numpy()
        elif isinstance(mod, SinCos):
            yield f"{prefix}/p", mod.p.cpu().numpy()
        elif isinstance(mod, Rotary):
            yield f"{prefix}/freqs", mod.freqs.cpu().numpy()
            if mod.scale is not None:
                yield f"{prefix}/scale", mod.scale.cpu().numpy()
        elif isinstance(mod, GaussianDiffusion1D):
            yield f"{prefix}/schedule", np.stack(
                [mod._host[k] for k in sorted(mod._host)])


def _g_norm(v: np.ndarray) -> np.ndarray:
    """The weight-norm magnitude of a folded torch-layout weight: its
    norm over every axis but the first."""
    return np.sqrt((v.astype(np.float64) ** 2).sum(
        axis=tuple(range(1, v.ndim)))).astype(np.float32)


def _wn_perm(mod: nn.Module, to_jax: bool) -> Tuple[int, ...]:
    """Torch layout -> JAX layout (or back) of a weight-normed conv's v:
    (out, in, k) <-> (k, in, out), (in, out, k) <-> (k, out, in), (out,
    in, kh, kw) <-> (kh, kw, in, out)."""
    if isinstance(mod, WNConv2d):
        return (2, 3, 1, 0) if to_jax else (3, 2, 0, 1)
    return (2, 1, 0)


def _wn_path(prefix: str) -> str:
    """The flax path prefix of a conv at torch module path ``prefix``
    (empty for a conv on its own)."""
    return prefix.replace(".", "/") + "/" if prefix else ""


def _wn_to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for prefix, mod in _wn_convs(model):
        path = _wn_path(prefix)
        perm = _wn_perm(mod, True)
        if mod.weight_norm:
            v = mod.weight_v.detach().float().cpu().numpy()
            g = mod.weight_g.detach().float().cpu().numpy().reshape(-1)
        else:       # folded: v = w, g = |w|, so g v/|v| = w
            v = mod.weight.detach().float().cpu().numpy()
            g = _g_norm(v)
        out[f"{path}v"] = np.ascontiguousarray(v.transpose(perm))
        out[f"{path}g"] = g
        out[f"{path}bias"] = mod.bias.detach().float().cpu().numpy()
    return out


@torch.no_grad()
def _wn_load_flat(what: str, model: nn.Module, flat: Dict[str, np.ndarray]
                  ) -> None:
    """Pop every weight-normed conv's ``v``, ``g`` and ``bias`` from
    ``flat`` into ``model``."""
    for prefix, mod in _wn_convs(model):
        path = _wn_path(prefix)
        try:
            v, g, bias = (torch.from_numpy(np.array(flat.pop(
                f"{path}{leaf}"), np.float32)) for leaf in ("v", "g", "bias"))
        except KeyError as e:
            raise KeyError(f"{what}: key missing {e}") from None
        v = v.permute(_wn_perm(mod, False)).contiguous()
        _check_shape(f"{path}v", v, mod.weight_v)
        if tuple(g.shape) != (v.shape[0],):
            raise ValueError(f"{path}g: shape {tuple(g.shape)}, the "
                             f"port's ({v.shape[0]},)")
        _check_shape(f"{path}bias", bias, mod.bias)
        _set_wn(mod, g, v)
        mod.bias.copy_(bias)


def _is_wn_model(model: nn.Module) -> bool:
    return any(True for _ in _wn_convs(model))


def load_hfgan_flat(generator: nn.Module, discriminators: nn.Module,
                    g_flat: Mapping, d_flat: Mapping) -> None:
    """Strictly fill a HiFi-GAN generator and its discriminators
    (``trainers/vocoder/hfgan.py::Discriminators``) from the JAX trainer's
    parameters as flat ``flax path -> array`` dicts (``g_params`` and
    ``d_params``)."""
    load_flat(generator, g_flat)
    d_flat = {k: np.asarray(v) for k, v in d_flat.items()}
    _wn_load_flat("discriminator parameters", discriminators, d_flat)
    _strict_keys("discriminator parameters", [], d_flat)


def to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """The JAX compact-checkpoint dict of an LVTR, a DiscreteAR, a HuBERT
    decoder, a SoundStream or a HiFi-GAN generator, weight-normed or
    folded (float32 numpy arrays keyed by flax paths)."""
    if _is_wn_model(model):
        return _wn_to_flat(model)
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    for key, w in sd.items():
        path, kind = _flat_name(model, key)
        out[path] = np.ascontiguousarray(_to_jax(w, kind))
    out.update(_lvtr_variables(model))
    return out


def _strict_keys(what: str, want, got) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: keys missing {missing}, unexpected {extra}")


def load_flat(model: nn.Module, flat: Mapping) -> None:
    """Strictly load a JAX compact-checkpoint dict (``to_flat``'s
    contract) into an LVTR, a DiscreteAR, a HuBERT decoder, a SoundStream
    or a HiFi-GAN generator; the non-parameter
    variables must equal the port's (to 1e-6)."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    if _is_wn_model(model):
        _wn_load_flat("generator checkpoint", model, flat)
        _strict_keys("generator checkpoint", [], flat)
        return
    sd = model.state_dict()
    names = {key: _flat_name(model, key) for key in sd}
    variables = dict(_lvtr_variables(model))
    _strict_keys(f"{type(model).__name__} checkpoint",
                 [p for p, _ in names.values()] + list(variables), flat)
    for path, want in variables.items():
        got = flat[path]
        if got.shape != want.shape or not np.allclose(got, want, rtol=1e-6,
                                                      atol=1e-6):
            raise ValueError(f"{path}: the checkpoint's variable differs "
                             "from the port's recomputed one")
    out = {}
    for key, (path, kind) in names.items():
        a = _from_jax(flat[path], kind, tuple(sd[key].shape))
        if a.shape != tuple(sd[key].shape):
            raise ValueError(f"{path}: checkpoint shape {a.shape}, the "
                             f"port's {tuple(sd[key].shape)}")
        out[key] = torch.from_numpy(np.array(a)).to(sd[key].dtype)
    model.load_state_dict(out, strict=True)


def _hubert_path(name: str) -> str:
    return name.replace(".", "/")


def _is_hubert_conv(name: str) -> bool:
    return name == "pos_conv_w" or name.startswith("feature_encoder.conv_w.")


def load_hubert_flat(model: nn.Module, flat: Mapping) -> None:
    """Strictly load the JAX ``HubertEncoder``'s parameters, a flat dict
    of numpy arrays keyed by the flax paths joined by ``/``
    (``feature_encoder/conv_w/0``, ``layers/3/q/w``, ...), into the
    port's ``models/ssl/hubert.py::HubertEncoder``: the names are the
    same, dense weights keep JAX's (in, out), and the conv kernels go
    from JAX's (k, in, out) to torch's (out, in, k)."""
    params = dict(model.named_parameters())
    want = {_hubert_path(n): n for n in params}
    _strict_keys("HuBERT encoder", list(want), flat)
    with torch.no_grad():
        for path, name in want.items():
            a = np.asarray(flat[path], np.float32)
            if _is_hubert_conv(name):
                a = a.transpose(2, 1, 0)
            p = params[name]
            if a.shape != tuple(p.shape):
                raise ValueError(f"{path}: shape {a.shape}, the port's "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)))
