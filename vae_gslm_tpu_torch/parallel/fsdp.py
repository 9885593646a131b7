"""ZeRO/FSDP-style parameter and optimizer-state sharding over the data
axis (port of ``vae_gslm_tpu/parallel/fsdp.py``).

``fsdp_spec`` is JAX's decision: ``data`` on the largest axis that is
still free in the base spec (the tensor-parallel one on a (data, model)
grid) and that the data ranks divide; tensors under ``min_size``
elements stay as the base has them.  JAX places the parameters with
that spec and lets XLA gather them before use and reduce-scatter their
gradients.  The port writes those collectives out (``FSDP``):

  * each rank keeps its slice of every sharded parameter (``p.data``)
    and AdamW's moments of that slice (the optimizer is built on the
    slices);
  * ``gather_params`` all-gathers the full weights over the data ranks
    before each micro-batch's forward, ``release_params`` returns to the
    slices after its backward (``collect_grads`` first moves the
    micro-batch's full-size gradients into the step's accumulators);
  * ``reduce_grads`` reduce-scatters the accumulated gradients over the
    data ranks, so each rank keeps the sum's slice for AdamW.

``torch.distributed.fsdp`` lays its shards out flat, which ``fsdp_spec``
cannot describe, so it is not used.  Checkpoints stay the compact
contract: the trainer gathers the full tensors for rank 0 and cuts them
again after a resume (``cut``/``gather``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import mesh

DEFAULT_MIN_SIZE = 4096


def fsdp_spec(shape: Sequence[int], n_data: int,
              base: Optional[Sequence] = None,
              min_size: int = DEFAULT_MIN_SIZE) -> Tuple[Optional[str], ...]:
    """JAX's ``fsdp_spec``: ``base`` (padded with None) with ``data`` on
    the largest axis that is None in ``base`` and divisible by ``n_data``
    (the first such on a tie); ``base`` unchanged below ``min_size``
    elements or without such an axis."""
    base_t = tuple(base) if base is not None else ()
    base_t = base_t + (None,) * (len(shape) - len(base_t))
    if n_data <= 1 or int(np.prod(shape, dtype=np.int64)) < min_size:
        return base_t
    best = None
    for i, d in enumerate(shape):
        if base_t[i] is None and d >= n_data and d % n_data == 0:
            if best is None or d > shape[best]:
                best = i
    if best is None:
        return base_t
    spec = list(base_t)
    spec[best] = "data"
    return tuple(spec)


def placed_fsdp_spec(model: torch.nn.Module, name: str, shape,
                     n_data: int, n_model: int = 1,
                     min_size: int = DEFAULT_MIN_SIZE
                     ) -> Tuple[Optional[str], ...]:
    """The FSDP spec of the port parameter ``name`` (full ``shape``), in
    the port's layout: ``fsdp_spec`` decided in JAX's layout on top of
    JAX's tensor-parallel spec (``fsdp.py::shard_params``), so that a
    square kernel's tie goes to the axis JAX picks."""
    from . import tp

    base, kind, jshape = tp.jax_placement(model, name, shape, n_model)
    spec = fsdp_spec(jshape, n_data, base, min_size)
    return tp.port_spec(spec, kind, len(tuple(shape)))


class FSDP:
    """The data-axis slices of ``params``: ``axes[i]`` is the axis that
    parameter i is cut along (None: whole on every data rank)."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 axes: Sequence[Optional[int]], grid: "mesh.Grid"):
        self.params = list(params)
        self.axes = list(axes)
        self.group = grid.group("data")
        self.n, self.index = grid.size("data"), grid.index("data")
        self._local: List[Optional[torch.Tensor]] = [None] * len(params)
        self._acc: List[Optional[torch.Tensor]] = [None] * len(params)

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.axes)

    def cut(self, t: torch.Tensor, i: int) -> torch.Tensor:
        a = self.axes[i]
        if a is None:
            return t
        return t.chunk(self.n, a)[self.index].contiguous()

    def gather(self, t: torch.Tensor, i: int) -> torch.Tensor:
        a = self.axes[i]
        return t if a is None else mesh.all_gather_dim(t, a, self.group)

    @torch.no_grad()
    def shard(self) -> None:
        """Cut every sharded parameter to this rank's slice."""
        for i, p in enumerate(self.params):
            p.data = self.cut(p.data, i)

    @torch.no_grad()
    def gather_params(self) -> None:
        for i, p in enumerate(self.params):
            if self.axes[i] is not None:
                self._local[i] = p.data
                p.data = self.gather(p.data, i)

    @torch.no_grad()
    def collect_grads(self) -> None:
        """Move this micro-batch's full-size gradients of the sharded
        parameters into the step's accumulators."""
        for i, p in enumerate(self.params):
            if self.axes[i] is None or p.grad is None:
                continue
            g = p.grad
            p.grad = None
            self._acc[i] = g if self._acc[i] is None else self._acc[i] + g

    @torch.no_grad()
    def release_params(self) -> None:
        for i, p in enumerate(self.params):
            if self._local[i] is not None:
                p.data = self._local[i]
                self._local[i] = None

    def step_grads(self, grads: List[Optional[torch.Tensor]]
                   ) -> List[Optional[torch.Tensor]]:
        """``grads`` with the sharded parameters' accumulated full-size
        gradients in place (zeros where a parameter got none); the
        accumulators are cleared."""
        out = list(grads)
        for i, p in enumerate(self.params):
            if self.axes[i] is None:
                continue
            acc = self._acc[i]
            if acc is None:
                shape = list(p.shape)
                shape[self.axes[i]] *= self.n
                acc = p.new_zeros(shape)
            out[i] = acc
            self._acc[i] = None
        return out

    def reduce_scatter(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each sharded parameter's gradient summed over the data ranks,
        this rank's slice of it."""
        return [g if self.axes[i] is None
                else mesh.reduce_scatter_dim(g, self.axes[i], self.group)
                for i, g in enumerate(grads)]
