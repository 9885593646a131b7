"""Base trainer (port of ``vae_gslm_tpu/training/trainer.py``): the
reference weight init, micro-batch stacking for gradient accumulation,
and ``BaseTrainer``: data wiring, the ``fit`` loop, checkpoints, full
state and the SIGTERM flag.

JAX jits one step over a ``data`` mesh and lets XLA insert the gradient
all-reduce.  The port runs one process per rank (``parallel/mesh.py``):
each rank loads its own rows through the distributed sampler, runs the
step on its device, and the task trainer sums the gradients over the
ranks in one all-reduce per optimizer step.  The model axis, pipeline
and FSDP modes are not ported (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

import logging
import math
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..core.masked import Masked
from ..data.loader import DataLoader, get_dataloader
from ..hparams.hp import Hparams
from ..nn.attention import CrossAttention, SelfAttention
from ..nn.linear import Dense, Embedding, uniform_
from ..nn.transformer import TransformerLayerStack
from ..parallel import mesh, tp
from .logging import ExperimentLogger

log = logging.getLogger(__name__)

Batch = Dict[str, Masked]
RANK_SEED_STRIDE = 1_000_003      # rank r draws from seed + 1 + r * this


@torch.no_grad()
def init_weights(model: nn.Module, init_std: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> None:
    """Reference init (``training_lib/trainer.py:113-125``), the JAX
    package's rules drawn from ``generator``: zero every dense bias;
    self- and cross-attention projections uniform +-init_std/sqrt(dim/3);
    embeddings uniform +-1; the stacks' ``set_uniform`` (a T5 bias table
    uniform +-init_std/sqrt(dim/3); the other positions hold none)."""
    for m in model.modules():
        if isinstance(m, Dense) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, (SelfAttention, CrossAttention)):
            std = init_std / math.sqrt(m.dim / 3)
            projs = ((m.in_proj, m.out_proj) if isinstance(m, SelfAttention)
                     else (m.q_proj, m.kv_proj, m.out_proj))
            for proj in projs:
                uniform_(proj.weight, std, generator)
        if isinstance(m, Embedding):
            uniform_(m.weight, 1.0, generator)
        if isinstance(m, TransformerLayerStack):
            m.set_uniform(init_std / math.sqrt(m.dim / 3), generator)


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Micro-batches' ``Masked`` entries stacked on a new leading
    accumulation axis (the others, such as a text batch's written forms,
    reach no step and are dropped)."""
    return {k: Masked.stack([b[k] for b in batches]) for k, v in
            batches[0].items() if isinstance(v, Masked)}


def fuse_microbatches(stacked: Batch) -> Batch:
    """(accum, B, ...) -> (1, accum * B, ...): the summed gradients of
    the micro-batches are the gradient of one fused batch (the losses
    are masked sums), up to the per-micro-batch random draws."""
    def f(x: torch.Tensor) -> torch.Tensor:
        return x.reshape((1, x.shape[0] * x.shape[1]) + tuple(x.shape[2:]))

    return {k: Masked(f(v.value), f(v.lengths), v.time_axis)
            for k, v in stacked.items()}


def bucket_pad_batch(batch: Dict[str, Any], bucket: int = 256
                     ) -> Dict[str, Any]:
    """Every Masked entry's time axis zero-padded up to a multiple of
    ``bucket``, lengths unchanged (JAX :101-122, which bounds its
    compiled eval shapes; the port keeps it so that validation sees the
    same padded shapes)."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, Masked) and v.time_axis == 1:
            t = v.value.shape[1]
            target = -(-t // bucket) * bucket
            value = v.value
            if target != t:
                pad = [0, 0] * (value.dim() - 2) + [0, target - t]
                value = torch.nn.functional.pad(value, pad)
            out[k] = Masked(value, v.lengths, 1)
        else:
            out[k] = v
    return out


_UNPORTED_MODES = ("model_parallel", "pipeline_parallel", "fsdp",
                   "sequence_parallel")


class BaseTrainer:
    """Owns the rank's view of the process group, the data, the logger
    and the step loop.  Task trainers implement ``train_dataloader`` and
    ``run_step``; ``save_checkpoint``, ``resume``, ``_train_state`` and
    ``_apply_train_state`` unless theirs is one ``model`` (compact
    checkpoint) with one optimizer (``opt``, ``lr_schedule``) over
    ``params`` named ``names``; with more than one rank,
    ``run_step`` sums ``_preempted`` over the ranks in its all-reduce and
    stores whether any rank saw SIGTERM in ``_stop_agreed``
    (``all_reduce_metrics``).  ``step_micro_batches`` is such a step for
    a trainer whose metrics are the last micro-batch's."""

    def __init__(self, hp: Hparams):
        hp.check_arg_in_hparams("model", "data")
        self.hp = hp
        self.gradient_update_step = 1
        if hp.has("training") and hp.training.has("gradient_accumulation"):
            self.gradient_update_step = hp.training.gradient_accumulation
        hp_tr = hp.get("trainer", None)
        for mode in _UNPORTED_MODES:
            val = hp_tr.get(mode, None) if hp_tr is not None else None
            if val and not (isinstance(val, int) and not isinstance(
                    val, bool) and val <= 1):
                raise NotImplementedError(
                    f"trainer.{mode} is not ported; the port trains data "
                    "parallel only (ROADMAP.md, Queue 1 item 11)")
        self.world_size = mesh.process_count()
        self.rank = mesh.process_index()
        self.global_step = 0
        self.logger: Optional[ExperimentLogger] = None
        # rank 0 owns every artifact write (scalars, checkpoints)
        self._is_main = self.rank == 0
        self._preempted = False       # this rank saw SIGTERM
        self._stop_agreed = False     # some rank had, at the last all-reduce

    def parallel_context(self):
        """The ambient parallelism of a step: attention routed as JAX
        routes it under a data mesh of ``world_size`` devices."""
        return tp.flash_mesh(self.world_size)

    # ---------------------------------------------------------------- data
    def _world(self):
        if self.hp.trainer.get("distributed", False):
            return self.world_size, self.rank
        return None, None

    def get_dataloader(self, hp: Hparams, dataset) -> DataLoader:
        """JAX's sampler dispatch (:238-266), its ``standard`` branch: a
        configuration with ``distributed`` gets the rank's distributed
        sampler, a world of 1 in one process."""
        world_size, rank = self._world()
        return get_dataloader(hp, dataset,
                              bool(self.hp.trainer.get("distributed",
                                                       False)),
                              world_size, rank)

    # --------------------------------------------------------------- hooks
    def train_dataloader(self) -> DataLoader:
        raise NotImplementedError

    def val_dataloader(self) -> Optional[DataLoader]:
        return None

    def validation_run(self, step: int) -> None:
        pass

    def save_checkpoint(self, path: str) -> None:
        """``self.model``'s compact npz (JAX's contract) and ``hp.yaml``
        beside it and in the logger's checkpoint directory."""
        from .checkpoint import save_compact

        save_compact(self.model, path)
        if self.logger is not None:
            self.hp.save(os.path.join(self.logger.ckpt_path, "hp.yaml"))
        self.hp.save(os.path.join(os.path.dirname(path), "hp.yaml"))

    def run_step(self, stacked_batch) -> Dict[str, Any]:
        raise NotImplementedError

    # ---------------------------------------------------------------- step
    def to_device(self, batch: Dict[str, Any], keys) -> Batch:
        """The ``keys`` of a collated batch as ``Masked`` on the trainer's
        ``device``."""
        return {k: Masked(v.value.to(self.device),
                          v.lengths.to(self.device, torch.int32),
                          v.time_axis)
                for k, v in batch.items() if k in keys}

    def backward_micro_batches(self, stacked: Batch,
                               loss_fn: Callable) -> List[Dict[str, Any]]:
        """``loss_fn(mb, i)``'s gradients summed over the stacked
        micro-batches into ``params``' ``.grad`` (cleared first); each
        micro-batch's metrics."""
        for p in self.params:
            p.grad = None
        metrics = []
        for i in range(next(iter(stacked.values())).value.shape[0]):
            loss, m = loss_fn({k: v.micro(i) for k, v in stacked.items()}, i)
            loss.backward()
            metrics.append(m)
        return metrics

    def all_reduce_metrics(self, vals: torch.Tensor) -> torch.Tensor:
        """``vals`` summed over the ranks in one all-reduce that also
        sums the ranks' SIGTERM flags into ``_stop_agreed``."""
        both = torch.cat([vals, vals.new_tensor([float(self._preempted)])])
        mesh.all_reduce_sum([both])
        self._stop_agreed = bool(both[-1] > 0)
        return both[:-1]

    def step_micro_batches(self, stacked: Batch,
                           loss_fn: Callable) -> Dict[str, Any]:
        """One optimizer step (``opt``, ``lr_schedule``) over the stacked
        micro-batches: ``loss_fn(mb, i)``'s gradients summed over them
        and over the ranks (JAX's losses are sums over the global batch),
        the metrics those of the last micro-batch (JAX's ``m[-1]``),
        summed over the ranks."""
        metrics = dict(self.backward_micro_batches(stacked, loss_fn)[-1])
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.world_size > 1:
            mesh.all_reduce_sum(grads)
            keys = list(metrics)
            vals = self.all_reduce_metrics(
                torch.stack([metrics[k].float() for k in keys]))
            metrics.update(zip(keys, vals))
        metrics["lr"] = self.lr_schedule(self.global_step)
        self.opt.step(grads)
        return metrics

    def resume(self, path: str) -> None:
        """From a compact npz (``self.model``'s parameters; the optimizer
        starts afresh and the step is kept, as JAX's ``resume`` does) or
        from the port's full state (exact)."""
        from .checkpoint import load_compact
        from .optimizer import create_optimizer

        if path.endswith(".npz"):
            load_compact(self.model, path)
            self.opt, self.lr_schedule = create_optimizer(
                self.hp.training, self.hp.trainer.total_steps, self.params)
        else:
            self.restore_full_state(path)
        mesh.replicate(self.params)

    # ----------------------------------------------- full-state resume
    # the default full state is that of one optimizer (``self.opt``, an
    # ``AdamOptimizer``) over ``self.params`` named ``self.names``
    def _train_state(self) -> Dict[str, Any]:
        opt = self.opt
        return {"params": dict(zip(self.names, self.params)),
                "mu": dict(zip(self.names, opt.mu)),
                "nu": dict(zip(self.names, opt.nu)),
                "count": opt.count, "step": self.global_step}

    def _apply_train_state(self, state: Dict[str, Any]) -> None:
        """Load a full state strictly: the same parameter names and
        shapes, then moments, optimizer count and step."""
        names = list(self.names)
        for key in ("params", "mu", "nu"):
            got = state[key]
            if sorted(got) != sorted(names):
                raise ValueError(
                    f"full state's {key} names differ from the model's: "
                    f"missing {sorted(set(names) - set(got))[:5]}, extra "
                    f"{sorted(set(got) - set(names))[:5]}")
        with torch.no_grad():
            for i, name in enumerate(names):
                for dst, key in ((self.params[i], "params"),
                                 (self.opt.mu[i], "mu"),
                                 (self.opt.nu[i], "nu")):
                    src = state[key][name]
                    if src.shape != dst.shape:
                        raise ValueError(f"full state's {key}[{name}] has "
                                         f"shape {tuple(src.shape)}, the "
                                         f"model {tuple(dst.shape)}")
                    dst.copy_(src)
        self.opt.count = int(state["count"])
        self.global_step = int(state["step"])

    def save_full_state(self, path: str) -> None:
        """The full train state (parameters, optimizer moments, step) in
        the port's torch format; failures raise (JAX logs a warning)."""
        from .checkpoint import save_train_state

        save_train_state(path, self._train_state())

    def restore_full_state(self, path: str) -> None:
        from .checkpoint import restore_train_state

        self._apply_train_state(restore_train_state(path))

    # ------------------------------------------------------- preemption
    def _should_stop(self) -> bool:
        """Whether to checkpoint and leave ``fit`` after this step: this
        rank's flag in one process; across ranks the flags as the step's
        all-reduce summed them, so every rank stops after the same step
        (a rank that returned alone would leave the others waiting in the
        next step's all-reduce)."""
        return self._preempted if self.world_size == 1 else self._stop_agreed

    def _install_preemption_handler(self) -> Callable[[], None]:
        """SIGTERM sets a flag; ``fit`` checkpoints at the next optimizer
        step and returns, so that ``-r`` on the full state resumes
        exactly.  Returns a callable that restores the old handler."""
        self._preempted = self._stop_agreed = False

        def on_term(signum, frame):
            log.warning("SIGTERM received: checkpointing at the next step "
                        "boundary, then exiting")
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, on_term)
        except ValueError:          # not the main thread: no handler
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    # ---------------------------------------------------------------- loop
    def fit(self, logger: ExperimentLogger,
            max_steps: Optional[int] = None,
            val_check_interval: Optional[int] = None,
            log_every: int = 50,
            profile_dir: Optional[str] = None) -> None:
        """JAX's loop (:362-454): optimizer steps until ``total_steps``,
        micro-batches carried across epochs (a loader with fewer batches
        than the accumulation count still makes progress), scalars every
        ``log_every`` steps from rank 0, validation and a checkpoint
        every ``val_check_interval`` steps and at the end (validation
        only in a world of one rank).  With ``profile_dir`` steps 10-12
        are traced by torch.profiler into a Chrome trace there."""
        self.logger = logger
        hp_tr = self.hp.trainer
        total_steps = max_steps or hp_tr.total_steps
        val_interval = val_check_interval or hp_tr.get(
            "val_check_interval", None)
        loader = self.train_dataloader()
        accum = self.gradient_update_step
        restore_sig = self._install_preemption_handler()
        t0 = time.time()
        prof, profiled = None, False
        epoch = 0
        micro: list = []
        try:
            while self.global_step < total_steps:
                loader.sampler.set_epoch(epoch)
                epoch += 1
                yielded = False
                for batch in loader:
                    yielded = True
                    micro.append(batch)
                    if len(micro) < accum:
                        continue
                    stacked = stack_batches(micro)
                    micro = []
                    if profile_dir and not profiled \
                            and self.global_step == 10:
                        prof, profiled = self._start_profile(), True
                    with self.parallel_context():
                        metrics = self.run_step(stacked)
                    if prof is not None and self.global_step == 12:
                        self._stop_profile(prof, profile_dir)
                        prof = None
                    self.global_step += 1
                    if self.global_step % log_every == 0:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        metrics["steps_per_sec"] = log_every / (
                            time.time() - t0)
                        t0 = time.time()
                        if self._is_main:
                            logger.log_scalars(
                                {f"train/{k}": v
                                 for k, v in metrics.items()},
                                self.global_step)
                    if val_interval and \
                            self.global_step % val_interval == 0:
                        self._validate()
                        self.checkpoint()
                    if self._should_stop():
                        self.checkpoint()
                        log.warning("preemption checkpoint written at step "
                                    "%d; exiting fit", self.global_step)
                        return
                    if self.global_step >= total_steps:
                        break
                if not yielded:
                    raise RuntimeError(
                        "train dataloader yielded no batches: dataset "
                        "smaller than the (distributed) batch size?")
            self._validate()
            self.checkpoint()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            restore_sig()

    def _validate(self) -> None:
        if self.world_size == 1:
            with self.parallel_context():
                self.validation_run(self.global_step)
        else:
            # every rank would have to run validation in lockstep; as in
            # JAX, evaluate the compact checkpoint in one process instead
            log.warning("%d ranks: skipping validation at step %d",
                        self.world_size, self.global_step)

    @staticmethod
    def _start_profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, profile_dir: str) -> None:
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"trace_rank{self.rank}.json"))

    def checkpoint(self) -> None:
        """Rank 0 writes ``step=N-cpt.npz``, ``last-cpt.npz`` and the full
        state ``full_state.pt`` into the logger's checkpoint directory."""
        if self.logger is None or not self._is_main:
            return
        ckpt = self.logger.ckpt_path
        self.save_checkpoint(os.path.join(
            ckpt, f"step={self.global_step}-cpt.npz"))
        self.save_checkpoint(os.path.join(ckpt, "last-cpt.npz"))
        self.save_full_state(os.path.join(ckpt, FULL_STATE))


FULL_STATE = "full_state.pt"
