"""Slope timing on one NVIDIA GPU (port of the cases of
``tools/bench_slope.py`` that need no patched kernel):

    python -m vae_gslm_tpu_torch.scripts.bench_slope

The time per call is ``(T(384 calls) - T(128 calls)) / 256``, which
cancels the fixed cost of starting and ending a timed run; each T is the
least of three runs timed with CUDA events (the tool's ``slope``).
Cases:

  * K7, ``ops/stream.py::stream_sums`` (the tool's ``mk_stream``) on a
    seed-0 (16, 1024, 12288) int8 stack made on the card, 201.3 MB:
    microseconds per call and GB/s;
  * K2, the whole-trunk step ``ops/mega_step.py::fused_trunk_step`` at the
    flagship width (16 layers, 16 heads of 64), B = 8 with s8 x s8
    products, on ``scripts/mega_ab.py``'s random int8 weights and cache,
    at (flushed, pos) = (0, 88) and (512, 600): the tool's ``full, fl=0``
    and ``full, fl=512`` cases at the same tail fill (the port's K2 takes
    pos < flushed + 128).

Left out: the tool's ablation cases, which load a patched kernel copy
that the repository does not hold, and its ``full+DUS`` case (K2 with
its new rows written back into the cache by XLA; the port's stage
append is a kernel of its own).  Prints one JSON line, then the card's
name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

N1, N2 = 128, 384
L, R, C = 16, 1024, 12 * 1024


def slope(fn, runs: int = 3) -> float:
    """Seconds per call of ``fn``: (T(N2) - T(N1)) / (N2 - N1), each T the
    least of ``runs`` CUDA-event timings of that many calls in a row."""
    import torch

    def timed(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    fn()
    torch.cuda.synchronize()
    t1s, t2s = [], []
    for _ in range(runs):
        t1s.append(timed(N1))
        t2s.append(timed(N2))
    return (min(t2s) - min(t1s)) / (N2 - N1)


def run(dev) -> dict:
    """The three slopes on ``dev``; with the stream kernel's launches."""
    import torch

    from vae_gslm_tpu_torch.ops import mega_step as mega
    from vae_gslm_tpu_torch.ops.stream import stream_sums
    from vae_gslm_tpu_torch.scripts.mega_ab import mega_inputs

    g = torch.Generator(dev).manual_seed(0)
    w = torch.randint(-127, 128, (L, R, C), generator=g, device=dev,
                      dtype=torch.int8)
    before = stream_sums.launches
    t = slope(lambda: stream_sums(w))
    out = {"stream_bytes": w.numel(), "stream_us": t * 1e6,
           "stream_gb_s": w.numel() / t / 1e9,
           "stream_launches": stream_sums.launches - before}
    del w
    x, weights, cache, slopes = mega_inputs(8, dev, mega)
    for flushed, pos in ((0, 88), (512, 600)):
        t = slope(lambda: mega.fused_trunk_step(x, weights, cache, pos,
                                                slopes, flushed, a8=True))
        out[f"mega_us_flushed_{flushed}"] = t * 1e6
    return out


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_slope times kernels on a CUDA device and "
                           "none is available")
    res = run(torch.device("cuda", 0))
    print(json.dumps(res))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
