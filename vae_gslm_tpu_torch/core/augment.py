"""Feature-space utilities: MFCC, deltas, SpecAugment (port of
``vae_gslm_tpu/core/augment.py``; the reference's ``utils/helpers.py:
187-228``).

``compute_mfcc`` takes log-mels through a DCT-II basis, with optional
CMVN (per utterance, over ``lengths``, as JAX computes it: the sums run
over the whole padded time axis) and regression deltas; ``specaug``
zeroes random (b, t) frames, its uniform draws from an explicit
generator or given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .masked import Masked


def dct_matrix(n_mels: int, n_mfcc: int, norm: str = "ortho"
               ) -> np.ndarray:
    """DCT-II basis (n_mels, n_mfcc), torchaudio's ``create_dct``
    convention."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        dct[:, 0] *= 1.0 / np.sqrt(2)
        dct *= np.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return dct.astype(np.float32)


def compute_deltas(x: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Regression deltas over time of (B, T, C), the window's ends
    replicate-padded (torchaudio's semantics)."""
    n = (win_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3
    xp = torch.cat([x[:, :1].expand(-1, n, -1), x,
                    x[:, -1:].expand(-1, n, -1)], dim=1)
    out = torch.zeros_like(x)
    for i in range(-n, n + 1):
        out = out + i * xp[:, i + n: i + n + x.shape[1]]
    return out / denom


def compute_mfcc(mel: Masked, dct, delta: bool = False,
                 cmvn: bool = False) -> Masked:
    """log-mels (B, T, n_mels) -> MFCC (B, T, n_mfcc), float32; with
    ``cmvn`` normalised per utterance, with ``delta`` followed by its Δ
    and ΔΔ (3 n_mfcc channels)."""
    d = torch.as_tensor(dct, dtype=torch.float32, device=mel.value.device)
    mfcc = mel.value.float() @ d
    if cmvn:
        n = mel.lengths[:, None, None].float()
        mean = mfcc.sum(1, keepdim=True) / n
        var = (mfcc - mean).square().sum(1, keepdim=True) / n
        mfcc = (mfcc - mean) / torch.sqrt(var + 1e-6)
    if delta:
        d1 = compute_deltas(mfcc)
        mfcc = torch.cat([mfcc, d1, compute_deltas(d1)], dim=-1)
    return Masked(mfcc, mel.lengths, 1).apply_mask()


def specaug(x: Masked, generator: Optional[torch.Generator],
            feat_drop_rate: float, time_drop_rate: float,
            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Masked:
    """Random (b, t) frame dropout (the reference's ``helpers.py:211-
    228``): a frame is zeroed where its first uniform draw is below
    ``feat_drop_rate`` or its second below ``time_drop_rate``; as in
    JAX, neither applies unless ``feat_drop_rate`` > 0.  ``draws``
    replaces the two (B, T) uniform draws from ``generator``."""
    b, t, _ = x.value.shape
    keep = torch.ones((b, t), dtype=torch.bool, device=x.value.device)
    if feat_drop_rate > 0.0:
        if draws is None:
            draws = tuple(torch.rand((b, t), generator=generator,
                                     device=x.value.device)
                          for _ in range(2))
        keep = keep & ~(draws[0] < feat_drop_rate) \
            & ~(draws[1] < time_drop_rate)
    value = torch.where(keep[:, :, None], x.value,
                        torch.zeros((), dtype=x.value.dtype,
                                    device=x.value.device))
    return Masked(value, x.lengths, 1)
