"""K-means: Lloyd iterations and nearest-centroid assignment (port of
``vae_gslm_tpu/ops/kmeans.py``, which replaces the reference's faiss
``Kmeans(d, k=200, niter=20)``).

  * assignment: argmin over k of ||x||^2 + ||c||^2 - 2 x.c, one (N, D) @
    (D, K) product per chunk of rows, in float32;
  * update: a one-hot segment sum, (K, N) @ (N, D); empty clusters keep
    their centroid (faiss's behaviour).

The JAX package runs these as plain ``jax.jit`` programs, so the port
runs plain torch ops on the device (no kernel).  Every product runs
under the float32 policy (``core/precision.py::policy_scope``), which
turns TF32 off on the card: TF32 products would move distances by
about 1e-3 and flip tokens against the CPU at near-ties.  The
k-means++ seeding draws from ``np.random.RandomState(seed)`` in numpy,
so it picks the same rows as JAX's given the same input order.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import Policy, policy_scope

Device = Union[str, torch.device]


def _assign_chunk(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x = x.float()
    c = c.float()
    x2 = x.square().sum(-1, keepdim=True)
    c2 = c.square().sum(-1)
    return torch.argmin(x2 + c2 - 2.0 * (x @ c.T), dim=-1).to(torch.int32)


def assign(x, centroids, chunk: int = 65536,
           device: Device = "cuda") -> np.ndarray:
    """Nearest-centroid labels (int32) of (N, D) rows, ``chunk`` rows a
    product."""
    dev = resolve_device(device)
    out = []
    with policy_scope(Policy()):
        c = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
        for i in range(0, len(x), chunk):
            xi = torch.as_tensor(np.asarray(x[i: i + chunk], np.float32),
                                 device=dev)
            out.append(_assign_chunk(xi, c).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def _lloyd(x: torch.Tensor, init_centroids: torch.Tensor, k: int,
           niter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``niter`` Lloyd iterations from ``init_centroids``; the final
    centroids and their labels."""
    x = x.float()
    centroids = init_centroids.float()
    with policy_scope(Policy()):
        for _ in range(niter):
            labels = _assign_chunk(x, centroids)
            onehot = torch.nn.functional.one_hot(
                labels.long(), k).to(torch.float32)          # (N, K)
            counts = onehot.sum(0)                           # (K,)
            sums = onehot.T @ x                              # (K, D)
            new = sums / counts.clamp(min=1.0)[:, None]
            centroids = torch.where(counts[:, None] > 0, new, centroids)
        return centroids, _assign_chunk(x, centroids)


class KMeans:
    """``faiss.Kmeans(d, k, niter)``'s role: ``train`` then ``search``
    (labels through ``assign``); ``device`` as the port's other entry
    points (CUDA unless ``"cpu"``)."""

    def __init__(self, d: int, k: int, niter: int = 20, seed: int = 1234,
                 device: Device = "cuda"):
        self.d, self.k, self.niter, self.seed = d, k, niter, seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None

    def _kmeanspp_init(self, x: np.ndarray,
                       rng: np.random.RandomState) -> np.ndarray:
        """k-means++ seeding (distance-weighted), in numpy as in JAX."""
        n = len(x)
        centroids = [x[rng.randint(n)]]
        d2 = np.sum((x - centroids[0]) ** 2, axis=-1)
        for _ in range(1, self.k):
            probs = d2 / max(d2.sum(), 1e-12)
            idx = rng.choice(n, p=probs)
            centroids.append(x[idx])
            d2 = np.minimum(d2, np.sum((x - x[idx]) ** 2, axis=-1))
        return np.stack(centroids)

    def train(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        assert x.shape[1] == self.d
        rng = np.random.RandomState(self.seed)
        init = self._kmeanspp_init(x, rng)
        centroids, _ = _lloyd(torch.as_tensor(x, device=self.device),
                              torch.as_tensor(init, device=self.device),
                              self.k, self.niter)
        self.centroids = centroids.cpu().numpy()
        return self.centroids

    def search(self, x: np.ndarray) -> np.ndarray:
        assert self.centroids is not None, "train() or load first"
        return assign(x, self.centroids, device=self.device)

    def save(self, path: str) -> None:
        np.save(path, self.centroids)

    @classmethod
    def load(cls, path: str, niter: int = 20,
             device: Device = "cuda") -> "KMeans":
        centroids = np.load(path)
        km = cls(centroids.shape[1], centroids.shape[0], niter,
                 device=device)
        km.centroids = centroids.astype(np.float32)
        return km


def inertia(x: np.ndarray, centroids: np.ndarray,
            device: Device = "cuda") -> float:
    labels = assign(x, centroids, device=device)
    return float(np.sum((x - centroids[labels]) ** 2))
