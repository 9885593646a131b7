"""Time the whole-trunk step kernel (K2, and K2-w4 where a root has it) of
several checkouts on one card, in one call, so that two versions of
``csrc/mega_step.cu`` can be compared on the same card and clocks:

    python vae_gslm_tpu_torch/scripts/mega_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``vae_gslm_tpu_torch`` package (a
checkout, or ``git archive <commit> vae_gslm_tpu_torch`` unpacked).  The
roots are timed one after another, each in a process of its own that
imports and builds that root's package, in the order given: list them
as A B B A to see the drift of the card between runs.  Every process
times the same calls on the same inputs, made here from seed 0 on the
card: the flagship trunk (16 layers, 16 heads of 64, random int8
weights with column scales, a random three-tier cache at position 351,
256 rows flushed) through ``fused_trunk_step`` at B = 8 with s8 x s8
products (K2-a8, the serving default at B <= 8), at B = 32 and 17 with
bf16 products (K2-bf16: the CLI's B = 32 chunks, and the ragged last
chunk of a 49-utterance run), and, where the root has
``pack_mega_w4``, at B = 8 and B = 32 on those weights packed to int4 at
group 128 (K2-w4).  A time is the median over 5 torch.profiler windows
of 20 calls of the device time per call of every operation the call
launches; a window counts as read only when it holds every launch.
Beside each time: the device time per call by kernel name, and a digest
of the call's outputs (x, k_new, v_new), equal across roots when their
kernels compute the same bits.  Prints one JSON line per root and then
the card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import subprocess
import sys

L, H, DH = 16, 16, 64
POS, FLUSHED, NB = 351, 256, 6
CALLS, WINDOWS = 20, 5


def mega_inputs(b: int, dev, mega):
    """Int8 weights, a three-tier cache and x from seed 0 on ``dev``."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(0)
    d = H * DH
    blk, stage, tail = mega.BLK, mega.STAGE, mega.TAIL

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    weights = {}
    for w, s, din, dout in (("wq", "sq", d, 3 * d), ("wo", "so", d, d),
                            ("w1", "s1", d, 4 * d), ("w2", "s2", 4 * d, d)):
        weights[w] = i8(L, din, dout)
        weights[s] = u(L, dout, lo=0.5, hi=1.0) / (127 * math.sqrt(din))
    weights["n1"] = u(L, d, lo=0.8, hi=1.2)
    weights["n3"] = u(L, d, lo=0.8, hi=1.2)
    for name, n in (("bq", 3 * d), ("bo", d), ("b1", 4 * d), ("b2", d)):
        weights[name] = torch.zeros((L, n), device=dev)
    cache = {
        "k_cold": i8(L, NB, H, b, DH, blk),
        "v_cold": i8(L, NB, H, b, DH, blk),
        "kc_scale": u(L, NB, H, b, blk, hi=0.02),
        "vc_scale": u(L, NB, H, b, blk, hi=0.02),
        "k_tail": i8(L, H, b, tail, DH), "v_tail": i8(L, H, b, tail, DH),
        "kt_scale": u(L, H, b, tail, hi=0.02),
        "vt_scale": u(L, H, b, tail, hi=0.02),
        "k_stage": (torch.randn((L, stage, H, b, DH), generator=g,
                                device=dev) * 0.3).to(torch.bfloat16),
        "v_stage": (torch.randn((L, stage, H, b, DH), generator=g,
                                device=dev) * 0.3).to(torch.bfloat16),
    }
    x = torch.randn((b, d), generator=g, device=dev)
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return x, weights, cache, slopes


def _window(fn):
    """{kernel name: (device us, launches)} of ``CALLS`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "").strip()
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + e.self_device_time_total, n + e.count)
    return out


def _time(fn) -> dict:
    """Median device ms per call over ``WINDOWS`` full windows, and the
    per-call microseconds by kernel name of the last one."""
    import torch

    fn()
    torch.cuda.synchronize()
    # launches per window: the fuller of two (a window may lose some)
    with_all = max(sum(n for _, n in _window(fn).values()) for _ in range(2))
    totals, last = [], None
    for _ in range(10 * WINDOWS):
        w = _window(fn)
        if sum(n for _, n in w.values()) == with_all:
            totals.append(sum(us for us, _ in w.values()) / 1e3 / CALLS)
            last = w
            if len(totals) == WINDOWS:
                break
    if len(totals) < WINDOWS:
        raise RuntimeError("too few profiler windows held every launch")
    return {"ms": statistics.median(totals),
            "by_kernel_us": {k: round(us / CALLS, 1)
                             for k, (us, _) in sorted(last.items())}}


def _digest(outs) -> str:
    """The first 16 hex digits of the sha256 of the outputs' bytes."""
    import torch

    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def time_root(root: str) -> dict:
    """The step's times on the package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from vae_gslm_tpu_torch.ops import mega_step as mega

    dev = torch.device("cuda", 0)
    out = {"root": root, "source": mega.__file__}
    cases = [("K2-a8 B8", 8, True, 0), ("K2-bf16 B32", 32, False, 0),
             ("K2-bf16 B17", 17, False, 0)]
    try:
        from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4
    except ImportError:
        pack_mega_w4 = None
    if pack_mega_w4 is not None:
        cases += [("K2-w4 B8", 8, False, 128), ("K2-w4 B32", 32, False, 128)]
    for name, b, a8, group in cases:
        x, w, cache, slopes = mega_inputs(b, dev, mega)
        if group:
            w = pack_mega_w4(w, group, DH)

        def call():
            return mega.fused_trunk_step(x, w, cache, POS, slopes, FLUSHED,
                                         a8=a8)

        res = _time(call)
        res["digest"] = _digest(call())
        out[name] = res
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
