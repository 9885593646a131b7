"""Time K1 (``fused_decode_attention``, the hybrid cold/tail decode
attention) of several checkouts on one card, in one call, so that two
versions of ``csrc/fused_decode.cu`` can be compared on the same card and
clocks:

    python vae_gslm_tpu_torch/scripts/decode_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``vae_gslm_tpu_torch`` package (a
checkout, or ``git archive <commit> vae_gslm_tpu_torch`` unpacked).  The
roots are timed one after another, each in a process of its own that
imports and builds that root's package, in the order given: list them
as A B B A to see the drift of the card between runs.  Every process
times the same calls on the same inputs, made here on the card from a
seed per position: the flagship trunk's cache (16 layers, 16 heads of
64, B = 8, capacity for the 150 -> 650 rollout) and bf16 q/k/v rows as
views of one fused projection, at every 50th position of the rollout
(151 .. 601; 0, 1 or 2 cold blocks), the layer index cycling over the
16 layers so that the cache (> L2) is read cold, as ``chip_smoke.py``'s
``phase_k1`` times it.  A time is the median over 5 torch.profiler
windows of 160 calls of the kernel's device time per call (a window
counts only when it holds every launch); beside each position's time, a
digest of the outputs of all 16 layers: equal across roots when their
kernels compute the same bits.  Prints one JSON line per root (the mean
over the positions, each position's time and digest) and then the
card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

L, H, D, B = 16, 16, 64, 8
PROMPT, LENGTH = 150, 500
POSITIONS = range(PROMPT + 1, PROMPT + 1 + LENGTH, 50)
CALLS, WINDOWS = 160, 5


def _inputs(pos: int, dev):
    """Random int8 hybrid cache and bf16 q/k/v rows from seed ``pos``."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(pos)
    nb = (PROMPT + 1 + LENGTH) // 256

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02

    cache = (i8(L, nb, B, H, D, 256), i8(L, nb, B, H, D, 256),
             sc(L, nb, B, H, 256), sc(L, nb, B, H, 256),
             i8(L, B, H, 256, D), i8(L, B, H, 256, D),
             sc(L, B, H, 256), sc(L, B, H, 256))
    qkv = torch.randn((B, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv.view(B, 3, H, D).unbind(1)
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return cache, q, k, v, slopes


def _window_ms(fn) -> float:
    """Device ms per call of the K1 kernel over one profiler window of
    ``CALLS`` calls; raises unless a window holds every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(CALLS):
                fn(i)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if "fused_decode_kernel" in e.key]
        if sum(e.count for e in evs) == CALLS:
            return sum(e.self_device_time_total for e in evs) / 1e3 / CALLS
    raise RuntimeError("no profiler window held every K1 launch")


def time_root(root: str) -> dict:
    """K1's times and output digests over the rollout for the package
    under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from vae_gslm_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda", 0)
    out = {"root": root, "source": fd.__file__, "positions": {}}
    for pos in POSITIONS:
        flushed = pos // 256 * 256
        cache, q, k, v, slopes = _inputs(pos, dev)

        def call(i):
            return fd.fused_decode_attention(q, *cache, pos, i % L, slopes,
                                             k, v, flushed)

        h = hashlib.sha256()
        for li in range(L):
            h.update(call(li).cpu().numpy().tobytes())
        ms = statistics.median(_window_ms(call) for _ in range(WINDOWS))
        out["positions"][pos] = {"us": round(ms * 1e3, 3),
                                 "digest": h.hexdigest()[:16]}
    out["mean_us"] = round(statistics.mean(
        p["us"] for p in out["positions"].values()), 3)
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
