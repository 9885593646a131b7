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

JAX's 2-D meshes, (data, model) for tensor parallelism and (data, pipe)
for the pipeline, become a ``Grid`` of ranks, the inner axis innermost
(rank = data * n_inner + inner), with a process sub-group along each
axis.  The collectives along an axis (``all_gather_dim``,
``reduce_scatter_dim``, ``send``/``recv``, ``broadcast_from``) copy a
CUDA tensor through host memory themselves when the group's backend is
gloo (ranks that share one card): gloo's send, recv and reduce-scatter
take host tensors.  That copy is the call's one route on such a group,
not a fallback.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple

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


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> None:
    """Sum the tensors (one dtype, one device) over the ranks (of
    ``group``, every rank by default) in place, in one all-reduce of one
    flat buffer.  A ``group`` of None is every rank here (the axis
    collectives below take None as an axis of one rank)."""
    if process_count() == 1 or not tensors or (
            group is not None and _size(group) == 1):
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


# ----------------------------------------------------------------- grid
def _size(group) -> int:
    """The ranks of an axis group; None is an axis of one rank."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


@dataclasses.dataclass
class Grid:
    """The ranks as a (data, ``inner``) grid, ``inner`` innermost: rank =
    data * n_inner + inner.  ``groups[axis]`` is this rank's sub-group
    along ``axis`` (None where the axis has one rank); JAX's
    ``create_mesh_2d`` (inner "model") and ``create_mesh_pipe`` (inner
    "pipe") in one process per rank."""
    inner: str
    n_data: int
    n_inner: int
    data_index: int
    inner_index: int
    groups: Dict[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, self.inner: self.n_inner}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else (
            self.inner_index if axis == self.inner else 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def create_grid(inner: str, n_inner: int, n_data: Optional[int] = None
                ) -> Grid:
    """The grid of this process group; every rank must call it (the
    sub-groups are created collectively, in one order).  ``n_data``
    defaults to world // n_inner; their product must be the world."""
    world, rank = process_count(), process_index()
    if n_data is None:
        if world % n_inner:
            raise ValueError(f"{n_inner} {inner} ranks do not divide the "
                             f"process group's {world}")
        n_data = world // n_inner
    if n_data * n_inner != world:
        raise ValueError(f"a {n_data} x {n_inner} (data, {inner}) grid "
                         f"needs {n_data * n_inner} ranks; the process "
                         f"group has {world}")
    groups: Dict[str, Optional[object]] = {"data": None, inner: None}
    if world > 1 and n_inner == 1:                    # data only
        groups["data"] = dist.group.WORLD
    elif world > 1:
        for i in range(n_inner):                      # data groups
            ranks = [d * n_inner + i for d in range(n_data)]
            g = dist.new_group(ranks) if n_data > 1 else None
            if rank in ranks:
                groups["data"] = g
        for d in range(n_data):                       # inner groups
            ranks = [d * n_inner + i for i in range(n_inner)]
            g = dist.new_group(ranks) if n_inner > 1 else None
            if rank in ranks:
                groups[inner] = g
    return Grid(inner, n_data, n_inner, rank // n_inner, rank % n_inner,
                groups)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective on ``group`` copies ``t`` through the host:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors (one shape) concatenated along ``dim`` in rank
    order."""
    n = _size(group)
    if n == 1:
        return x
    src = x.detach().contiguous()
    host = _staged(group, src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if host else out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, cut in group-size chunks along
    ``dim``: this rank's chunk."""
    n = _size(group)
    if n == 1:
        return x
    src = x.detach()
    host = _staged(group, src)
    if host:
        src = src.cpu()
    chunks = [c.contiguous() for c in src.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device) if host else out


def all_reduce_in(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor)."""
    if _size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (a new
    tensor on the others; ``x`` supplies the shape and dtype)."""
    if _size(group) == 1:
        return x
    buf = x.detach().contiguous().clone()
    host = _staged(group, buf)
    if host:
        buf = buf.cpu()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(x.device) if host else buf


def broadcast_list(tensors: List[torch.Tensor], src: int, group) -> None:
    """Overwrite the tensors (one dtype, one device) in place with group
    rank ``src``'s, in one broadcast of one flat buffer."""
    if _size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = broadcast_from(flat, src, group)
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to group rank ``dst``."""
    buf = x.detach().contiguous()
    if _staged(group, buf):
        buf = buf.cpu()
    dist.send(buf, dist.get_global_rank(group, dst), group=group)


def recv(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device,
         src: int, group) -> torch.Tensor:
    """Receive a tensor of ``shape`` from group rank ``src``."""
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(device) if host else buf
