"""GPipe pipeline parallelism for the transformer trunk (port of
``vae_gslm_tpu/parallel/pp.py``).

The trunk's layers split into ``S`` contiguous stages over the pipe
ranks of a (data, pipe) grid (``parallel/mesh.py::Grid``, pipe
innermost) and each rank's rows into ``M`` microbatches.  Stage ``s``
takes microbatch ``m`` from stage ``s - 1`` (``recv``; stage 0 from the
trunk input), runs its layers (``_block``: JAX's pre-LN RMSNorm block on
the stacked weights of ``build_stacked_decode``, attention through
``flash_attention_bhtd``, K4/K4b on the card) and sends the (bm, T, D)
activations on: GPipe's M + S - 1 ticks, each rank's sends and receives
in microbatch order.  The last stage's output goes to every pipe rank
(JAX's ``psum`` of the masked outputs, :195-199).

The backward runs the ticks in reverse: the last stage takes its output
gradient, each stage sends its input gradient to the one before.  JAX's
note at :201-206 is about over-counting the cotangents upstream of the
trunk; here every pipe rank computes the layers around the trunk on the
same rows, so stage 0's input gradient is broadcast to every pipe rank
(the upstream gradients are then equal everywhere, once), and each
stage's parameter gradients wait in ``pending`` until the trainer sums
them over the pipe ranks, once per optimizer step (zeros for the layers
a rank does not run).  Eligibility is JAX's (``supports_stacked_decode``:
pre-LN, RMSNorm, ALiBi or no positions, no cross-attention).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import mesh

_ACTIVE = contextvars.ContextVar("pipeline", default=None)
# parameter -> this step's stage gradient, summed over the pipe ranks by
# the trainer (training/trainer.py::BaseTrainer.reduce_grads)
pending: Dict[torch.nn.Parameter, torch.Tensor] = {}


def create_mesh_pipe(n_pipe: int, n_data: Optional[int] = None
                     ) -> "mesh.Grid":
    """The (data, pipe) grid, pipe innermost."""
    return mesh.create_grid("pipe", n_pipe, n_data)


@contextlib.contextmanager
def pipeline(grid: Optional["mesh.Grid"], n_micro: int) -> Iterator[None]:
    """Pipeline the trunks over ``grid`` (a no-op unless it has more than
    one pipe rank)."""
    on = grid is not None and grid.size("pipe") > 1
    token = _ACTIVE.set((grid, int(n_micro)) if on else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_pipeline() -> Optional[Tuple["mesh.Grid", int]]:
    return _ACTIVE.get()


def eligible(stack, batch: int, memory, return_attn: bool) -> bool:
    """JAX's test (``nn/transformer.py:243-266``): a pipeline is active,
    no memory and no maps, the stages divide the layers, the
    microbatches divide this rank's rows (JAX: the global batch into
    microbatches each divisible over the data axis), and the stack takes
    the stacked weights."""
    ctx = active_pipeline()
    if ctx is None or memory is not None or return_attn:
        return False
    grid, n_micro = ctx
    return (stack.num_layers % grid.size("pipe") == 0
            and batch % n_micro == 0
            and stack.supports_stacked_decode())


def _mm(x: torch.Tensor, entry: dict, li: int) -> torch.Tensor:
    """``x @ w (+ b)`` in the promoted dtype, as JAX's ``x @ w``."""
    w = entry["w"][li]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if "b" in entry:
        y = y + entry["b"][li]
    return y


def _block(stack, w: dict, li: int, x: torch.Tensor, lengths: torch.Tensor,
           slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """One pre-LN block (JAX :87-112) from the stacked weights' layer
    ``li``: RMSNorm, qkv, causal attention over the (B, H, T, D) heads,
    out, RMSNorm, FFN.  Padded query rows carry what the kernel gives
    them; padded keys are masked by ``lengths``."""
    from ..ops.flash_attention import flash_attention_bhtd

    la0 = stack.layers[0]
    nheads = la0.self_attn.nheads
    b, t, d = x.shape
    h = stack._rms(x, w["n1"][li])
    q, k, v = _mm(h, w["qkv"], li).chunk(3, dim=-1)

    def heads(z):
        return z.reshape(b, t, nheads, d // nheads).transpose(1, 2)

    attn = flash_attention_bhtd(heads(q), heads(k), heads(v), lengths,
                                slopes, True)
    attn = attn.transpose(1, 2).reshape(b, t, d)
    x = x + _mm(attn, w["out"], li)
    h = stack._rms(x, w["n3"][li])
    return x + _mm(la0.activation(_mm(h, w["ffn1"], li)), w["ffn2"], li)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lengths, stack, grid, n_micro, need_grad, *params):
        # ``params`` (the trunk's) only make the output require grad when
        # they do; their gradients go to ``pending``
        group, S, s = grid.group("pipe"), grid.size("pipe"), grid.index(
            "pipe")
        per = stack.num_layers // S
        idx = list(range(s * per, (s + 1) * per))
        slopes = (stack.rpe.slopes.float() if stack.rpe_id == "ALiBi"
                  else None)
        x_mb = x.detach().chunk(n_micro, 0)
        len_mb = lengths.chunk(n_micro, 0)
        params = [p for i in idx for p in stack.layers[i].parameters()]
        saved, outs = [], []
        span = torch.enable_grad() if need_grad else torch.no_grad()
        with span:
            w = stack.build_stacked_decode(layers=idx, grad=need_grad)
            for m in range(n_micro):
                if s == 0:
                    xin = x_mb[m]
                else:
                    xin = mesh.recv(tuple(x_mb[m].shape), x.dtype, x.device,
                                    s - 1, group)
                xin = xin.detach().requires_grad_(need_grad)
                y = xin
                for li in range(per):
                    y = _block(stack, w, li, y, len_mb[m], slopes)
                if s < S - 1:
                    mesh.send(y, s + 1, group)
                else:
                    outs.append(y.detach())
                saved.append((xin, y))
        out = torch.cat(outs, 0) if s == S - 1 else torch.empty_like(x)
        ctx.saved, ctx.params, ctx.grid = saved, params, grid
        ctx.stack, ctx.n_micro = stack, n_micro
        return mesh.broadcast_from(out, S - 1, group)

    @staticmethod
    def backward(ctx, g):
        grid, stack, n_micro = ctx.grid, ctx.stack, ctx.n_micro
        group, S, s = grid.group("pipe"), grid.size("pipe"), grid.index(
            "pipe")
        g_mb = g.chunk(n_micro, 0)
        dx = [None] * n_micro
        acc = [torch.zeros_like(p) for p in ctx.params]
        for m in reversed(range(n_micro)):
            xin, y = ctx.saved[m]
            dy = (g_mb[m] if s == S - 1 else
                  mesh.recv(tuple(y.shape), y.dtype, y.device, s + 1, group))
            grads = torch.autograd.grad(y, [xin] + ctx.params, dy,
                                        retain_graph=m > 0,
                                        allow_unused=True)
            ctx.saved[m] = None
            if s > 0:
                mesh.send(grads[0], s - 1, group)
            else:
                dx[m] = grads[0]
            for a, gp in zip(acc, grads[1:]):
                if gp is not None:
                    a.add_(gp)
        own = dict(zip(ctx.params, acc))
        for p in stack.layers.parameters():
            gp = own.get(p)
            if gp is None:
                gp = torch.zeros_like(p)
            pending[p] = pending[p] + gp if p in pending else gp
        x_grad = (torch.cat(dx, 0) if s == 0
                  else torch.empty_like(g))
        return ((mesh.broadcast_from(x_grad, 0, group),)
                + (None,) * (5 + len(list(stack.layers.parameters()))))


def pipeline_apply(stack, value: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Run ``stack``'s layers over this rank's (B, T, D) ``value`` with
    the GPipe schedule of the active pipeline; returns the residual
    stream before the stack's final norm and output layer.  Raises JAX's
    errors for layers that the stages do not divide, rows that the
    microbatches do not divide and an ineligible stack."""
    grid, n_micro = active_pipeline()
    S = grid.size("pipe")
    if stack.num_layers % S:
        raise ValueError(f"{stack.num_layers} layers not divisible into "
                         f"{S} stages")
    b = value.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b * grid.size('data')} not divisible "
                         f"into {n_micro} microbatches")
    if not stack.supports_stacked_decode():
        raise ValueError("stack config not eligible for the stacked path "
                         "(needs pre-LN + RMSNorm + ALiBi/none)")
    return _Pipeline.apply(value, lengths, stack, grid, n_micro,
                           torch.is_grad_enabled(),
                           *stack.layers.parameters())


def take_pending():
    """This step's stage gradients (cleared)."""
    out = dict(pending)
    pending.clear()
    return out
