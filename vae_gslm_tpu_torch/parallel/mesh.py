"""Process group and data-parallel helpers (port of the data axis of
``vae_gslm_tpu/parallel/mesh.py``).

The reference scales with DDP only: one process per device, gradients
all-reduced, per-rank batch samplers.  JAX builds a ``data`` mesh over
its processes; the port runs one ``torch.distributed`` process group of
``W`` ranks, one per device.  The launch contract is the JAX package's
own: ``VAE_GSLM_COORDINATOR`` (host:port of rank 0),
``VAE_GSLM_NUM_PROCESSES`` and ``VAE_GSLM_PROCESS_ID``.  The caller names
the backend: ``"nccl"`` when every rank has a card of its own,
``"gloo"`` for CPU ranks and for ranks that share one card (gloo
broadcasts and all-reduces CUDA tensors through the host).  Nothing
switches it silently.  JAX's ``VAE_GSLM_AUTO_DISTRIBUTED`` reads TPU pod
metadata and has no meaning here (ROADMAP.md).
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group named by the launch variables; False (and
    nothing done) when ``VAE_GSLM_COORDINATOR`` is not set."""
    if os.environ.get("VAE_GSLM_AUTO_DISTRIBUTED"):
        raise NotImplementedError(
            "VAE_GSLM_AUTO_DISTRIBUTED reads TPU pod metadata; launch the "
            "port's ranks with VAE_GSLM_COORDINATOR, VAE_GSLM_NUM_PROCESSES "
            "and VAE_GSLM_PROCESS_ID (ROADMAP.md)")
    coord = os.environ.get("VAE_GSLM_COORDINATOR")
    if not coord:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    world = int(os.environ["VAE_GSLM_NUM_PROCESSES"])
    rank = int(os.environ["VAE_GSLM_PROCESS_ID"])
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    if backend == "nccl":
        torch.cuda.set_device(rank_device(rank))
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank,
                            timeout=timeout or datetime.timedelta(minutes=10))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """The CUDA devices this process sees (0 without any)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def rank_device(rank: Optional[int] = None) -> torch.device:
    """The card of ``rank`` (this process's by default): rank modulo the
    cards this host has, so ranks that outnumber the cards share them."""
    n = local_device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for a rank; CPU ranks pass "
                           "device='cpu' to the trainer")
    return torch.device("cuda", (process_index() if rank is None
                                 else rank) % n)


def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite every tensor in place with rank 0's (a no-op in one
    process)."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0)


def all_reduce_sum(tensors: List[torch.Tensor]) -> None:
    """Sum the tensors (one dtype, one device) over the ranks in place,
    in one all-reduce of one flat buffer."""
    if process_count() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
