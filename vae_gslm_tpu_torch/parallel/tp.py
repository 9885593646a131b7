"""The data axis of the flash-attention mesh (port of ``flash_mesh`` and
``active_flash_mesh`` in ``vae_gslm_tpu/parallel/tp.py``).

Under a JAX mesh of more than one device every self-attention layer
leaves the packed kernels (K3/K3b) for the (B, H, T, D) custom VJP
(K4/K4b, K5/K5b), which ``shard_map`` runs per device.  The port follows
that routing, so that it computes what JAX computes at each world size:
``flash_mesh(world_size)`` is active while a training step of a process
group of more than one rank runs, and ``SelfAttention`` reads
``active_flash_mesh()``.  Each rank already holds only its own rows, so
nothing is sharded here.  The model axis, sequence parallelism, pipeline
parallelism and FSDP are not ported (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_WORLD = contextvars.ContextVar("flash_mesh_world", default=1)


@contextlib.contextmanager
def flash_mesh(world_size: int) -> Iterator[None]:
    """Route attention as JAX does over a data mesh of ``world_size``
    devices (a no-op for one)."""
    token = _WORLD.set(int(world_size))
    try:
        yield
    finally:
        _WORLD.reset(token)


def active_flash_mesh() -> bool:
    """True inside ``flash_mesh`` of more than one rank."""
    return _WORLD.get() > 1
