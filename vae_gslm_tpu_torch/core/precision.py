"""Mixed-precision policy (port of ``vae_gslm_tpu/core/precision.py``).

Parameters stay float32.  The default policy computes in float32;
``bf16_mixed`` (training's ``"16-mixed"``, serving's bf16 path) runs
matmul and convolution inputs in bfloat16, while norms, softmax and
distribution math stay float32 inside the modules that do them.
Modules read the active policy at call time.

A float32 policy means IEEE float32 products: ``policy_scope`` turns
PyTorch's TF32 switches for matmuls and cuDNN convolutions off inside a
float32 scope (cuDNN's default would run "float32" convolutions in TF32
on the card) and puts both back on exit; a bf16 scope leaves them as
they are.
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


def tf32_flags() -> tuple:
    """(``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32``)."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_tf32(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def policy_scope(policy: Policy):
    prev, flags = get_policy(), tf32_flags()
    set_policy(policy)
    if policy.compute_dtype == torch.float32:
        _set_tf32(False, False)
    try:
        yield
    finally:
        set_policy(prev)
        _set_tf32(*flags)


def policy_for_precision(precision) -> Policy:
    """``trainer.precision`` -> policy, as ``scripts/train.py`` maps it:
    "16-mixed", "bf16-mixed" and "16" train with float32 parameters and
    bfloat16 compute; "32" in float32."""
    if str(precision) in ("16-mixed", "bf16-mixed", "16"):
        return bf16_mixed()
    if str(precision) == "32":
        return Policy()
    raise ValueError(f"unknown trainer.precision {precision!r}")
