"""Weights carried into the port from the reference's state dicts.

The port's modules use the reference's state-dict names and torch
layouts, so loading is a rename of a few top-level prefixes plus a
strict ``load_state_dict``: every port parameter must be covered and
no key may be left over.  ``load_reference_lvtr`` takes exactly what
``vae_gslm_tpu/models/convert_torch.py::export_torch_lvtr`` returns (or
a reference checkpoint's state dict); ``load_reference_generator``
takes the reference HiFi-GAN generator's state dict in either
weight-norm form (``weight_g``/``weight_v`` or
``parametrizations.weight.original0/1``) or with weight norm removed,
and folds it.  ``mega_weights_from_numpy`` carries the int8 K2 weights
of a JAX ``build_mega_decode()`` dict across as they are, and
``layer_cache_from_numpy`` a JAX per-layer KV cache.

``to_flat`` / ``load_flat`` map an LVTR or a HiFi-GAN generator to and
from the JAX package's compact checkpoint contract: a flat dict of
numpy arrays keyed by the flax attribute paths joined by ``/``
(``nnx.to_pure_dict``, list indices included), in the JAX layouts
(dense kernels (in, out), conv kernels (k, in, out), transposed-conv
kernels (k, out, in), the generator's weight-norm ``g``/``v`` pairs).
The map is derived from the port's modules, as the JAX package's
``models/convert_torch.py::export_torch_lvtr`` derives the reference
names from its own, and is strict both ways: every port parameter is
covered, no key is left over, shapes must agree.  Variables that are not
parameters (ALiBi's ``slopes``, the SinCos ``p`` table, the diffusion
``schedule`` stack) are written from the port's recomputed buffers and,
on loading, checked equal to them.  None of this imports the JAX
package.
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
from ..nn.positions import ALiBi, SinCos
from ..ops.mega_step import W4_KEYS, WEIGHT_KEYS
from .vocoder.hfgan import Generator

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


def _rename(key: str) -> str:
    for old, new in _LVTR_PREFIXES:
        if key.startswith(old):
            return new + key[len(old):]
    return key


def load_reference_lvtr(model: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference-keyed LVTR state dict into the port."""
    model.load_state_dict({_rename(k): _tensor(v) for k, v in sd.items()},
                          strict=True)


def _fold(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight norm (dim=0): w = g * v / ||v||, the norm over every
    axis but the first, with the JAX package's 1e-12 inside the root."""
    g, v = g.double(), v.double()
    norm = torch.sqrt(v.square().sum(dim=tuple(range(1, v.dim())),
                                     keepdim=True) + 1e-12)
    return (g.reshape((-1,) + (1,) * (v.dim() - 1)) * v / norm).float()


def load_reference_generator(gen: nn.Module, sd: Mapping) -> None:
    """Strictly load a reference HiFi-GAN generator state dict, folding
    weight norm into plain ``weight`` tensors."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for key in gen.state_dict():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "bias":
            out[key] = sd.pop(key)
        elif f"{prefix}.weight_g" in sd:
            out[key] = _fold(sd.pop(f"{prefix}.weight_g"),
                             sd.pop(f"{prefix}.weight_v"))
        elif f"{prefix}.parametrizations.weight.original0" in sd:
            out[key] = _fold(
                sd.pop(f"{prefix}.parametrizations.weight.original0"),
                sd.pop(f"{prefix}.parametrizations.weight.original1"))
        else:
            out[key] = sd.pop(key)
    if sd:
        raise KeyError(f"unexpected generator keys: {sorted(sd)}")
    gen.load_state_dict(out, strict=True)


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
    recomputed buffers: ALiBi slopes, SinCos tables and each diffusion
    decoder's sorted ``schedule`` stack."""
    for name, mod in model.named_modules():
        prefix = name.replace(".", "/")
        if isinstance(mod, ALiBi):
            yield f"{prefix}/slopes", mod.slopes.cpu().numpy()
        elif isinstance(mod, SinCos):
            yield f"{prefix}/p", mod.p.cpu().numpy()
        elif isinstance(mod, GaussianDiffusion1D):
            yield f"{prefix}/schedule", np.stack(
                [mod._host[k] for k in sorted(mod._host)])


def _g_norm(v: np.ndarray) -> np.ndarray:
    """The weight-norm magnitude of a folded torch-layout weight: its
    norm over every axis but the first."""
    return np.sqrt((v.astype(np.float64) ** 2).sum(axis=(1, 2))).astype(
        np.float32)


def to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """The JAX compact-checkpoint dict of an LVTR or a HiFi-GAN
    generator (float32 numpy arrays keyed by flax paths)."""
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    if isinstance(model, Generator):
        for key, w in sd.items():
            prefix, leaf = key.rsplit(".", 1)
            path = prefix.replace(".", "/")
            if leaf == "bias":
                out[f"{path}/bias"] = w
            else:       # a folded weight: v = w, g = |w|, so g v/|v| = w
                out[f"{path}/v"] = w.transpose(2, 1, 0)
                out[f"{path}/g"] = _g_norm(w)
        return out
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
    contract) into an LVTR or a HiFi-GAN generator; the non-parameter
    variables must equal the port's (to 1e-6)."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    if isinstance(model, Generator):
        ref = {}
        for key in model.state_dict():
            prefix, leaf = key.rsplit(".", 1)
            path = prefix.replace(".", "/")
            if leaf == "bias":
                ref[key] = flat.pop(f"{path}/bias")
            else:
                v = flat.pop(f"{path}/v")
                ref[f"{prefix}.weight_g"] = flat.pop(f"{path}/g")
                ref[f"{prefix}.weight_v"] = v.transpose(2, 1, 0)
        _strict_keys("generator checkpoint", [], flat)
        load_reference_generator(model, ref)
        return
    sd = model.state_dict()
    names = {key: _flat_name(model, key) for key in sd}
    variables = dict(_lvtr_variables(model))
    _strict_keys("LVTR checkpoint",
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
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
            sd[key].dtype)
    model.load_state_dict(out, strict=True)
