"""Mixed-precision policy (port of ``vae_gslm_tpu/core/precision.py``).

Parameters stay float32.  The default policy computes in float32;
``bf16_mixed`` (training's ``"16-mixed"``, serving's bf16 path) runs
matmul and convolution inputs in bfloat16, while norms, softmax and
distribution math stay float32 inside the modules that do them.
Modules read the active policy at call time.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32


_POLICY = Policy()


def set_policy(policy: Policy) -> None:
    global _POLICY
    _POLICY = policy


def get_policy() -> Policy:
    return _POLICY


def bf16_mixed() -> Policy:
    return Policy(compute_dtype=torch.bfloat16)


@contextlib.contextmanager
def policy_scope(policy: Policy):
    prev = get_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(prev)


def policy_for_precision(precision) -> Policy:
    """``trainer.precision`` -> policy, as ``scripts/train.py`` maps it:
    "16-mixed", "bf16-mixed" and "16" train with float32 parameters and
    bfloat16 compute; "32" in float32."""
    if str(precision) in ("16-mixed", "bf16-mixed", "16"):
        return bf16_mixed()
    if str(precision) == "32":
        return Policy()
    raise ValueError(f"unknown trainer.precision {precision!r}")
