"""Mixed-precision policy (port of ``vae_gslm_tpu/core/precision.py``).

The default policy computes in float32.  ``bf16_mixed`` runs matmul
and convolution inputs in bfloat16; norms, softmax and distribution
math stay float32 inside the modules that do them.  Modules read the
active policy at call time.
"""
from __future__ import annotations

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
