"""Time the flash attention kernels of several checkouts on one card, in
one call, so that two versions of ``csrc/flash_attention.cu`` can be
compared on the same card and clocks:

    python vae_gslm_tpu_torch/scripts/flash_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``vae_gslm_tpu_torch`` package (a
checkout, or ``git archive <commit> vae_gslm_tpu_torch`` unpacked).  The
roots are timed one after another, each in a process of its own that
imports and builds that root's package, in the order given: list them
as A B B A to see the drift of the card between runs.  Every process
times the same calls on the same inputs (seeded here, not by the
package): K3 (``flash_forward_packed``), K3b (``flash_backward_packed``)
and K4 (``flash_forward_full`` with lse) at the single-process training
call (B 8, T 640, 16 heads of 64, bfloat16, ALiBi, causal, lengths
640, 320, 300, 640, 1, 639, 0, 64), K4b (``flash_backward_full``) there
where the root has it, and K5 (``flash_forward_tiled``) and K5b
(``flash_backward_blockwise``, with a seeded dO) at the long-segment
call (B 2, T 1536, lengths 1536 and 1).  K3b, K4b and K5b take o (and
lse) from the plain forward on the card, so their outputs depend on the
backward kernels alone.  A time is the median over 5 torch.profiler
windows of 50 calls of the kernels' own device time per call; a window
counts as read only when it holds every launch (1 kernel per K3/K4/K5
call, 2 per K3b/K4b call, and per K5b call the root's
``K5B_BF16_KERNELS``, 3 where the root has none: its statistics
launch, dk/dv, dq).  Beside each time, a digest of the call's
outputs: equal across roots when their kernels compute the same bits.
Prints one JSON line per root and then the card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

B, T, H, D = 8, 640, 16, 64
LENGTHS = [640, 320, 300, 640, 1, 639, 0, 64]
B5, T5, LENGTHS5 = 2, 1536, [1536, 1]
CALLS, WINDOWS = 50, 5


def _window_ms(fn, prefix: str, per_call: int) -> float:
    """Device ms per call of the kernels whose names hold ``prefix`` over one
    profiler window of ``CALLS`` calls; raises unless the window holds
    ``per_call`` launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if prefix in e.key]
        if sum(e.count for e in evs) == CALLS * per_call:
            return sum(e.self_device_time_total for e in evs) / 1e3 / CALLS
    raise RuntimeError(f"no profiler window held every {prefix} launch")


def _digest(outs) -> str:
    """The first 16 hex digits of the sha256 of the outputs' bytes."""
    import torch

    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def time_root(root: str) -> dict:
    """The kernels' times and output digests of the package under
    ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * D), generator=g,
                      device=dev).to(torch.bfloat16)
    do = torch.randn((B, T, H * D), generator=g,
                     device=dev).to(torch.bfloat16)
    qkv5 = torch.randn((B5, T5, 3 * H * D), generator=g,
                       device=dev).to(torch.bfloat16)
    do5 = torch.randn((B5, T5, H * D), generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    lengths5 = torch.tensor(LENGTHS5, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    o, lse = fa.flash_forward_packed_plain(q, k, v, lengths, slopes, True, H)
    heads = [x.view(B, T, H, D).transpose(1, 2) for x in (q, k, v, do)]
    heads5 = [x.view(B5, T5, H, D).transpose(1, 2)
              for x in qkv5.chunk(3, dim=-1)]
    o4, lse4 = fa.flash_forward_full_plain(*heads[:3], lengths, slopes, True,
                                           with_stats=True)
    calls = {
        "K3": (lambda: fa.flash_forward_packed(q, k, v, lengths, slopes,
                                               True, H), "k3_fwd", 1),
        "K3b": (lambda: fa.flash_backward_packed(q, k, v, o, do, lse,
                                                 lengths, slopes, True, H),
                "k3b_", 2),
        "K4": (lambda: fa.flash_forward_full(*heads[:3], lengths, slopes,
                                             True, with_stats=True),
               "k4_fwd", 1),
    }
    if hasattr(fa, "flash_backward_full"):
        calls["K4b"] = (lambda: fa.flash_backward_full(
            *heads[:3], o4, heads[3], lse4, lengths, slopes, True), "k4b_", 2)
    calls["K5"] = (lambda: fa.flash_forward_tiled(*heads5, lengths5, slopes,
                                                  True), "k5_fwd", 1)
    o5 = fa.flash_forward_tiled_plain(*heads5, lengths5, slopes, True)
    g5 = do5.view(B5, T5, H, D).transpose(1, 2)
    calls["K5b"] = (lambda: fa.flash_backward_blockwise(
        *heads5, o5, g5, lengths5, slopes, True), "k5b_",
        getattr(fa, "K5B_BF16_KERNELS", 3))
    out = {"root": root, "source": fa.__file__}
    for name, (fn, prefix, per_call) in calls.items():
        digest = _digest(fn())
        torch.cuda.synchronize()
        out[name] = {"ms": statistics.median(
            _window_ms(fn, prefix, per_call) for _ in range(WINDOWS)),
            "digest": digest}
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        print(json.dumps(time_root(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
