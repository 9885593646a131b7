"""Tensor and sequence parallelism for the transformer trunk (port of
``vae_gslm_tpu/parallel/tp.py``).

JAX annotates a (data, model) mesh and lets XLA's partitioner insert the
collectives.  The port runs one process per rank (``parallel/mesh.py::
Grid``), so the same modes are explicit collectives over the model
sub-group:

  * ``param_spec`` is JAX's rule by parameter path (qkv and FFN-up
    column-sharded with their bias, out and FFN-down row-sharded, the
    row bias replicated), read on the port's parameters through their
    flax paths and mapped to the port's layouts, with JAX's fallback to
    replication when an axis does not divide (``placed_spec``);
  * ``shard_layers`` keeps, on each model rank, its slice of every
    trunk layer's in/out projection and FFN: Megatron's pairs.  A rank
    holds its heads' rows of q, k and v (head-aligned, where JAX's
    contiguous third of the fused columns is resharded by XLA), so the
    pair needs nheads divisible by the model ranks as well;
  * ``_Copy`` (identity forward, all-reduce backward) enters a column-
    parallel product and ``_Reduce`` (all-reduce forward, identity
    backward) leaves a row-parallel one; each rank's self-attention runs
    its nheads / n_model heads through ``flash_attention_bhtd`` (K4/K4b
    on the card) with its own heads' ALiBi slopes, as ``shard_map_flash``
    does;
  * ``sequence_parallel``: between the sharded products the residual
    stream is split on T over the model ranks; it is all-gathered before
    a column-parallel product (``_Gather``: reduce-scatter backward) and
    reduce-scattered after a row-parallel one (``_Scatter``: all-gather
    backward).  The norms and row biases that then see a slice of T have
    their gradients summed over the model ranks (``_SumGrad``).  A stack
    whose T does not divide, or whose layers are not all sharded, or
    that cross-attends, runs whole, as JAX leaves such shapes
    unconstrained.

Other parameters that JAX's substring rule also shards (a flow
coupling's ``linear1``, an eos head's, a cross-attention's
``out_proj``) stay whole on every model rank here: XLA reshards them
itself in JAX; the port computes them replicated, the same function.
JAX's lane-packed cache sharding (``packed_cache_mesh``) serves its
TPU-only packed decode layout, which the port does not have.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import mesh

_WORLD = contextvars.ContextVar("flash_mesh", default=(1, 1))
_SEQ_PARALLEL = contextvars.ContextVar("sequence_parallel", default=False)
_SEQ = contextvars.ContextVar("seq_sharded", default=None)


# ------------------------------------------------------ flash routing
@contextlib.contextmanager
def flash_mesh(n_data: int, n_model: int = 1) -> Iterator[None]:
    """Route attention as JAX does over a (data, model) mesh of
    ``n_data`` x ``n_model`` devices (a no-op for one)."""
    token = _WORLD.set((int(n_data), int(n_model)))
    try:
        yield
    finally:
        _WORLD.reset(token)


def active_flash_mesh(nheads: Optional[int] = None) -> bool:
    """JAX's ``active_flash_mesh``: inside ``flash_mesh``, True when the
    data axis has more than one rank or the model axis has more than one
    and divides ``nheads`` (an indivisible axis is dropped, the other
    kept).  Each rank already holds its own rows, so the batch always
    divides."""
    n_data, n_model = _WORLD.get()
    model = n_model > 1 and (nheads is None or nheads % n_model == 0)
    return model or n_data > 1


# ------------------------------------------------------- specs
def param_spec(path: str) -> Tuple[Optional[str], ...]:
    """JAX's ``param_spec`` for a flax parameter path ("a/b/kernel"),
    in JAX's layout (dense kernels (in, out))."""
    if "in_proj" in path or "linear1" in path:
        if "kernel" in path:
            return (None, "model")
        if "bias" in path:
            return ("model",)
    if "out_proj" in path or "linear2" in path:
        if "kernel" in path:
            return ("model", None)
    return ()


def _jax_shape(shape, kind: str) -> Tuple[int, ...]:
    shape = tuple(shape)
    if kind in ("t2", "t3"):
        return shape[::-1]
    if kind == "film":
        return (shape[1], shape[0])
    if kind == "gamma":
        n = 1
        for d in shape:
            n *= d
        return (n,)
    return shape


def port_spec(spec, kind: str, ndim: int) -> Tuple[Optional[str], ...]:
    if kind in ("t2", "t3"):
        return tuple(spec[::-1])
    if kind == "film":
        return (spec[1], spec[0], None)
    if kind == "gamma":
        return (None,) * ndim
    return tuple(spec)


def jax_placement(model: torch.nn.Module, name: str, shape,
                  n_model: int):
    """(JAX's spec of the port parameter ``name`` of full ``shape`` on
    ``n_model`` model ranks, in JAX's layout; the parameter's layout
    kind; its shape in JAX's layout): ``param_spec`` on its flax path,
    replicated where an axis does not divide (JAX's ``shard_params``) or
    without a model axis."""
    from ..models.convert import _flat_name

    path, kind = _flat_name(model, name)
    jshape = _jax_shape(shape, kind)
    spec = param_spec(path)
    spec = tuple(spec) + (None,) * (len(jshape) - len(spec))
    if n_model <= 1 or any(a is not None and jshape[i] % n_model
                           for i, a in enumerate(spec)):
        spec = (None,) * len(jshape)
    return spec, kind, jshape


def placed_spec(model: torch.nn.Module, name: str, shape,
                n_model: int) -> Tuple[Optional[str], ...]:
    """``jax_placement``'s spec in the port's layout."""
    spec, kind, _ = jax_placement(model, name, shape, n_model)
    return port_spec(spec, kind, len(tuple(shape)))


# ------------------------------------------------------- sharding
@dataclasses.dataclass(frozen=True)
class TPShard:
    """A rank's place on the model axis: its sub-group, the axis size and
    its index."""
    group: object
    n: int
    index: int


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """How a parameter is cut over the model axis: ``kind`` "qkv" (the
    rows of each of q, k and v), "rows" (axis 0) or "cols" (axis 1)."""
    kind: str
    info: TPShard


def gather_full(t: torch.Tensor, ps: ParamShard) -> torch.Tensor:
    """The full tensor from every model rank's slice ``t``."""
    if ps.kind == "cols":
        return mesh.all_gather_dim(t, 1, ps.info.group)
    full = mesh.all_gather_dim(t, 0, ps.info.group)
    if ps.kind == "qkv":                # per rank [q_r; k_r; v_r]
        parts = [p.chunk(3, 0) for p in full.chunk(ps.info.n, 0)]
        full = torch.cat([torch.cat([p[j] for p in parts], 0)
                          for j in range(3)], 0)
    return full


def cut(t: torch.Tensor, ps: ParamShard) -> torch.Tensor:
    """This rank's slice of the full tensor ``t``."""
    n, r = ps.info.n, ps.info.index
    if ps.kind == "qkv":
        return torch.cat([c.chunk(n, 0)[r] for c in t.chunk(3, 0)], 0)
    return t.chunk(n, 0 if ps.kind == "rows" else 1)[r].contiguous()


def _rpe_ok(stack) -> bool:
    from ..nn.positions import Rotary, SinCos

    return not isinstance(stack.rpe, (Rotary, SinCos))


@torch.no_grad()
def shard_layers(model: torch.nn.Module, grid: "mesh.Grid"
                 ) -> Dict[torch.nn.Parameter, ParamShard]:
    """Cut every trunk layer's attention pair (in_proj, out_proj) and FFN
    pair (linear1, linear2) to this rank's slice where JAX's placement
    shards both members (and, for attention, the heads divide); marks
    the modules (``SelfAttention.tp_shard``,
    ``TransformerLayer.ffn_shard``) and returns each cut parameter's
    ``ParamShard``.  Rotary and SinCos
    positions act on q and k across the heads' columns and are refused
    on a model axis."""
    from ..nn.transformer import TransformerLayerStack

    n = grid.size("model")
    if n <= 1:
        return {}
    info = TPShard(grid.group("model"), n, grid.index("model"))
    names = {p: nm for nm, p in model.named_parameters()}
    out: Dict[torch.nn.Parameter, ParamShard] = {}

    def spec(p):
        return placed_spec(model, names[p], p.shape, n)

    def place(p, kind):
        ps = ParamShard(kind, info)
        p.data = cut(p.data, ps)
        out[p] = ps

    for stack in model.modules():
        if not isinstance(stack, TransformerLayerStack):
            continue
        for la in stack.layers:
            sa = la.self_attn
            ip, op = sa.in_proj, sa.out_proj
            if (spec(ip.weight) == ("model", None)
                    and spec(op.weight) == (None, "model")
                    and (ip.bias is None or spec(ip.bias) == ("model",))
                    and sa.nheads % n == 0):
                if not _rpe_ok(stack):
                    raise NotImplementedError(
                        "a model axis over Rotary or SinCos positions is "
                        "not ported (ROADMAP.md)")
                place(ip.weight, "qkv")
                if ip.bias is not None:
                    place(ip.bias, "qkv")
                place(op.weight, "cols")
                sa.tp_shard = info
            l1, l2 = la.linear1, la.linear2
            if (spec(l1.weight) == ("model", None)
                    and spec(l2.weight) == (None, "model")
                    and (l1.bias is None or spec(l1.bias) == ("model",))):
                place(l1.weight, "rows")
                if l1.bias is not None:
                    place(l1.bias, "rows")
                place(l2.weight, "cols")
                la.ffn_shard = info
    return out


# ------------------------------------------------- autograd pieces
class _Copy(torch.autograd.Function):
    """Into a column-parallel product: identity forward, the gradient
    summed over the model ranks backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_in(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Out of a row-parallel product: the partial sums added over the
    model ranks forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh.all_reduce_in(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The T slices all-gathered before a column-parallel product;
    backward, the partial gradients reduce-scattered to the slices."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mesh.all_gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return mesh.reduce_scatter_dim(g, 1, ctx.group), None


class _Scatter(torch.autograd.Function):
    """A row-parallel product's partial sums reduce-scattered to the T
    slices; backward, the slices' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mesh.reduce_scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_gather_dim(g, 1, ctx.group), None


class _Split(torch.autograd.Function):
    """Enter the sequence-parallel region: this rank's T slice of a
    tensor every model rank holds whole; backward, the slices' gradients
    all-gathered (the replicated computation upstream needs all of it)."""

    @staticmethod
    def forward(ctx, x, info):
        ctx.group = info.group
        return x.chunk(info.n, 1)[info.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return mesh.all_gather_dim(g, 1, ctx.group), None


class _Join(torch.autograd.Function):
    """Leave the region: the T slices all-gathered; backward, this
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, info):
        ctx.info = info
        return mesh.all_gather_dim(x, 1, info.group)

    @staticmethod
    def backward(ctx, g):
        i = ctx.info
        return g.chunk(i.n, 1)[i.index].contiguous(), None


class _SumGrad(torch.autograd.Function):
    """A replicated parameter used on a T slice: identity forward, its
    gradient summed over the model ranks backward."""

    @staticmethod
    def forward(ctx, p, group):
        ctx.group = group
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_in(g, ctx.group), None


def column_in(x: torch.Tensor, info: TPShard) -> torch.Tensor:
    if _SEQ.get() is not None:
        return _Gather.apply(x, info.group)
    return _Copy.apply(x, info.group)


def row_out(y: torch.Tensor, info: TPShard) -> torch.Tensor:
    if _SEQ.get() is not None:
        return _Scatter.apply(y, info.group)
    return _Reduce.apply(y, info.group)


def seq_param(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``p`` as a sequence-parallel layer uses it: its gradient summed
    over the model ranks inside the region, itself outside."""
    seq = _SEQ.get()
    if p is None or seq is None:
        return p
    return _SumGrad.apply(p, seq[1].group)


def seq_norm(norm: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)``; inside the sequence-parallel region with its
    parameters' gradients summed over the model ranks."""
    if _SEQ.get() is None:
        return norm(x)
    params = {k: seq_param(v) for k, v in norm.named_parameters()}
    return torch.func.functional_call(norm, params, (x,))


def full_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Inside the region the layers carry their slice's lengths; the
    attention reads the whole sequence's."""
    seq = _SEQ.get()
    return lengths if seq is None else seq[0]


def _row_bias(y: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    if bias is None:
        return y
    from ..core.precision import get_policy

    return y + seq_param(bias).to(get_policy().compute_dtype)


def row_product(x: torch.Tensor, dense, info: TPShard) -> torch.Tensor:
    """A row-parallel ``Dense``: this rank's input columns times its
    weight columns, summed over the model ranks, then the replicated
    bias (JAX adds it after the all-reduce)."""
    from ..core.precision import get_policy

    dt = get_policy().compute_dtype
    y = torch.nn.functional.linear(x.to(dt), dense.weight.to(dt))
    return _row_bias(row_out(y, info), dense.bias)


def ffn(layer, x: torch.Tensor) -> torch.Tensor:
    """A model-parallel FFN: column-parallel ``linear1`` (this rank's
    rows and bias), the activation, row-parallel ``linear2``."""
    info = layer.ffn_shard
    h = layer.activation(layer.linear1(column_in(x, info)))
    return row_product(h, layer.linear2, info)


# ------------------------------------------------- sequence parallel
@contextlib.contextmanager
def sequence_parallel(active: bool) -> Iterator[None]:
    """Make the stacks split their residual stream on T over the model
    ranks (``trainer.sequence_parallel``)."""
    token = _SEQ_PARALLEL.set(bool(active))
    try:
        yield
    finally:
        _SEQ_PARALLEL.reset(token)


def seq_info(stack, t: int) -> Optional[TPShard]:
    """The model axis to split ``stack``'s residual stream of length
    ``t`` over, or None: sequence parallelism is on, every layer has both
    pairs sharded, none cross-attends and the model ranks divide t."""
    if not _SEQ_PARALLEL.get():
        return None
    info = None
    for la in stack.layers:
        if (la.self_attn.tp_shard is None or la.ffn_shard is None
                or la.cross_attn is not None):
            return None
        info = la.ffn_shard
    if info is None or t % info.n:
        return None
    return info


@contextlib.contextmanager
def seq_sharded(lengths: torch.Tensor, info: TPShard) -> Iterator[None]:
    token = _SEQ.set((lengths, info))
    try:
        yield
    finally:
        _SEQ.reset(token)


def split_seq(x: torch.Tensor, lengths: torch.Tensor, info: TPShard):
    """(this rank's T slice of ``x``, its lengths)."""
    tl = x.shape[1] // info.n
    local = (lengths - info.index * tl).clamp(0, tl).to(lengths.dtype)
    return _Split.apply(x, info), local


def join_seq(x: torch.Tensor, info: TPShard) -> torch.Tensor:
    return _Join.apply(x, info)
