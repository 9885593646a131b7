"""Time the flash attention kernels of several checkouts on one card, in
one call, so that two versions of ``csrc/flash_attention.cu`` can be
compared on the same card and clocks:

    python vae_gslm_tpu_torch/scripts/flash_ab.py [--only K5f32,K3f32]
        ROOT [ROOT ...]

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
call (B 2, T 1536, lengths 1536 and 1), K5_1750 (K5 in bf16 at
``chip_smoke.py``'s K5 call: B 8, T 1750, lengths 1750, 1000, 1, 0,
1749, 64, 1700, 900); then the float32 backwards K4bf32 (K4b at the
training call), K3bf32 (K3b there, q, k and v views of one packed
projection) and K5bf32 (K5b at the long-segment call), from the plain
forward's o (and lse); then the float32 forwards of the scoring path: K5f32 at its long batch's call (B 64, T 1750, 16 heads of
64, the lengths of the scoring corpus's last batch) and K3f32 at its
short batch's (B 64, T 973), q, k and v views of one packed projection
(``chip_smoke.py``'s uniform scoring mix, seed 0), and K4f32 (with lse)
at the training call's shape in float32 (any root runs them: the calls
are the same on the two-pass body).  ``--only`` times just
the named calls.  K3b, K4b and K5b take o (and
lse) from the plain forward on the card, so their outputs depend on the
backward kernels alone.  A time is the median over 5 torch.profiler
windows of 50 calls of the kernels' own device time per call; a window
counts as read only when it holds every launch (1 kernel per K3/K4/K5
call, 2 per K3b/K4b call, and per K5b call the root's
``K5B_BF16_KERNELS`` or, in float32, ``K5B_F32_KERNELS``, 3 where the
root has none: its statistics launch, dk/dv, dq).  Beside each time, a
digest of the call's outputs: equal across roots when their kernels
compute the same bits.  Prints one JSON line per root and then the
card's name and power limit.

    python vae_gslm_tpu_torch/scripts/flash_ab.py --library

times, in this process and without any root's kernels, the library
calls beside them: SDPA's bf16 forward with a float mask at the K5_1750
call (on contiguous (B, H, T, D) tensors, and as ``K5_1750_views`` on
the strided views of one packed projection that the kernels' calls
get) and its float32 forward at the K4f32 call, and SDPA's float32
backward alone (one ``torch.autograd.grad`` on a retained graph, float
mask) at the K4bf32 and K5bf32 calls, each with the bound of the
kernels' work (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16 or 67
TFLOP/s float32, the larger; K4f32 writes lse too).  Beside each
profiler time, the median over 5 runs of CUDA events around 10 calls
(host gaps included) and the device kernels of the last profiled window
with their launch counts (which SDPA backend ran, and whether a window
lost launches).
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
B7, T7 = 8, 1750                   # chip_smoke.py's K5 call
LENGTHS7 = [1750, 1000, 1, 0, 1749, 64, 1700, 900]
CALLS, WINDOWS = 50, 5
F32_BWD_CALLS = 10                 # float32 backward calls per window
HBM, BF16, F32 = 3.35e12, 989e12, 67e12   # H100 SXM data sheet
SCORE_B, F32_CALLS = 64, 5         # the scoring batch; calls per window


def scoring_lengths():
    """The short and the last long batch of ``chip_smoke.py``'s synthetic
    scoring corpus (seed 0: 64 utterances of 250-1000 frames, then 128 of
    250-1750, each long batch holding one of 1750)."""
    import numpy as np

    rng = np.random.RandomState(0)
    frames = np.concatenate([rng.randint(250, 1001, SCORE_B),
                             rng.randint(250, 1751, 2 * SCORE_B)])
    frames[SCORE_B] = frames[2 * SCORE_B] = 1750
    frames = [int(f) for f in frames]
    return frames[:SCORE_B], frames[2 * SCORE_B:]


def _window_ms(fn, prefix: str, per_call: int, calls: int = CALLS
               ) -> float:
    """Device ms per call of the kernels whose names hold ``prefix`` over one
    profiler window of ``calls`` calls; raises unless the window holds
    ``per_call`` launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if prefix in e.key]
        if sum(e.count for e in evs) == calls * per_call:
            return sum(e.self_device_time_total for e in evs) / 1e3 / calls
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


def time_root(root: str, only=()) -> dict:
    """The kernels' times and output digests of the package under
    ``root`` (with ``only``, of the named calls alone)."""
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
    if not only or "K5_1750" in only:
        x7 = torch.randn((B7, T7, 3 * H * D), generator=g,
                         device=dev).to(torch.bfloat16)
        heads7 = [y.view(B7, T7, H, D).transpose(1, 2)
                  for y in x7.chunk(3, dim=-1)]
        lengths7 = torch.tensor(LENGTHS7, dtype=torch.int32, device=dev)
        calls["K5_1750"] = (lambda: fa.flash_forward_tiled(
            *heads7, lengths7, slopes, True), "k5_fwd", 1, 10)
    if not only or "K3bf32" in only:
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        o32, lse32 = fa.flash_forward_packed_plain(q32, k32, v32, lengths,
                                                   slopes, True, H)
        calls["K3bf32"] = (lambda: fa.flash_backward_packed(
            q32, k32, v32, o32, do32, lse32, lengths, slopes, True, H),
            "k3b_", 2, F32_BWD_CALLS)
    if not only or "K4bf32" in only or "K5bf32" in only:
        f4 = [x.float() for x in heads]
        o4f, lse4f = fa.flash_forward_full_plain(*f4[:3], lengths, slopes,
                                                 True, with_stats=True)
        calls["K4bf32"] = (lambda: fa.flash_backward_full(
            *f4[:3], o4f, f4[3], lse4f, lengths, slopes, True), "k4b_", 2,
            F32_BWD_CALLS)
        f5 = [x.float() for x in heads5] + [g5.float()]
        o5f = fa.flash_forward_tiled_plain(*f5[:3], lengths5, slopes, True)
        calls["K5bf32"] = (lambda: fa.flash_backward_blockwise(
            *f5[:3], o5f, f5[3], lengths5, slopes, True), "k5b_",
            getattr(fa, "K5B_F32_KERNELS", 3), F32_BWD_CALLS)
    if not only or "K4f32" in only:
        h32 = [x.float() for x in heads[:3]]
        calls["K4f32"] = (lambda: fa.flash_forward_full(
            *h32, lengths, slopes, True, with_stats=True), "k4_fwd", 1, 10)
    short, long_ = scoring_lengths()
    for name, lens, prefix in (("K5f32", long_, "k5_fwd"),
                               ("K3f32", short, "k3_fwd")):
        if only and name not in only:
            continue
        t = max(lens)
        x = torch.randn((SCORE_B, t, 3 * H * D), generator=g, device=dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        if name == "K5f32":
            hq, hk, hv = (y.view(SCORE_B, t, H, D).transpose(1, 2)
                          for y in x.chunk(3, dim=-1))
            fn = (lambda hq=hq, hk=hk, hv=hv, ln=ln: fa.flash_forward_tiled(
                hq, hk, hv, ln, slopes, True))
        else:
            pq, pk, pv = x.chunk(3, dim=-1)
            fn = (lambda pq=pq, pk=pk, pv=pv, ln=ln: fa.flash_forward_packed(
                pq, pk, pv, ln, slopes, True, H))
        calls[name] = (fn, prefix, 1, F32_CALLS)
    if only:
        calls = {k: v for k, v in calls.items() if k in only}
    out = {"root": root, "source": fa.__file__}
    for name, (fn, prefix, per_call, *n) in calls.items():
        digest = _digest(fn())
        torch.cuda.synchronize()
        out[name] = {"ms": statistics.median(
            _window_ms(fn, prefix, per_call, *n) for _ in range(WINDOWS)),
            "digest": digest}
    return out


def _pairs(b: int, tq: int, tk: int, lengths) -> int:
    """(query, key) pairs of nonzero probability per head: causal, keys
    below each length (every key for a row of length 0)."""
    return sum(sum(min(r + 1, ln) if ln >= 1 else tk for r in range(tq))
               for ln in lengths)


def library() -> dict:
    """SDPA's times at the K5_1750, K4f32, K4bf32 and K5bf32 calls and
    the bounds of the kernels' work there (module docstring)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    slopes = -torch.tensor(alibi_slopes(H), device=dev)

    def mask(lengths, t, dtype):
        pos = torch.arange(t, device=dev)
        bias = slopes[:, None, None] * (pos[None, :] - pos[:, None]).abs()
        ok = (pos[None, None, None, :] < lengths[:, None, None, None]) & \
            (pos[None, :] <= pos[:, None])[None, None]
        return torch.where(ok, bias[None], float("-inf")).to(dtype)

    def ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        best, kernels = [], {}
        for _ in range(WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            best.append(sum(e.self_device_time_total for e in evs)
                        / 1e3 / calls)
            kernels = {e.key[:80]: e.count for e in evs}
        events = []
        for _ in range(WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            events.append(start.elapsed_time(end) / calls)
        return statistics.median(best), statistics.median(events), kernels

    out = {}
    for name, b, t, lens, dtype in (
            ("K5_1750", B7, T7, LENGTHS7, torch.bfloat16),
            ("K5_1750_views", B7, T7, LENGTHS7, torch.bfloat16),
            ("K4f32", B, T, LENGTHS, torch.float32),
            ("K4bf32", B, T, LENGTHS, torch.float32),
            ("K5bf32", B5, T5, LENGTHS5, torch.float32)):
        q, k, v, do = (torch.randn((b, H, t, D), generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        if name.endswith("_views"):      # as the kernels' calls get them
            x = torch.randn((b, t, 3 * H * D), generator=g, device=dev
                            ).to(dtype)
            q, k, v = (y.view(b, t, H, D).transpose(1, 2)
                       for y in x.chunk(3, dim=-1))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        m = mask(ln, t, dtype)
        pairs = H * _pairs(b, t, t, lens)
        kv = sum(x if x >= 1 else t for x in lens) * H * D
        if name in ("K5_1750", "K5_1750_views", "K4f32"):
            with torch.no_grad():
                lib, lib_ev, kernels = ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=m), 10)
            item = 2 if name.startswith("K5_1750") else 4
            flops, rate = 4 * D * pairs, BF16 if item == 2 else F32
            nbytes = item * (2 * b * t * H * D + 2 * kv)
            if name == "K4f32":
                nbytes += 4 * b * H * t           # lse written
        else:
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m)
            lib, lib_ev, kernels = ms(
                lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                            retain_graph=True), 10)
            del o
            flops, rate = 10 * D * pairs, F32
            n_stats = 2 if name == "K4bf32" else 1
            nbytes = 4 * ((5 * b * t * H * D) + 2 * kv
                          + n_stats * b * H * t)
        t_b, t_o = nbytes / HBM, flops / rate
        out[name] = {"sdpa_ms": lib, "sdpa_event_ms": lib_ev,
                     "sdpa_kernels": kernels,
                     "bound_ms": max(t_b, t_o) * 1e3,
                     "bound_by": "bytes" if t_b > t_o else "operations",
                     "gflop": flops / 1e9, "mb": nbytes / 1e6}
        del q, k, v, do, m
    return out


def main(argv) -> int:
    if argv[:1] == ["--library"]:
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        print(json.dumps({"library": library()}), flush=True)
        argv = argv[1:]
        if not argv:
            return 0
    only = []
    if argv[:1] == ["--only"]:
        only, argv = argv[1].split(","), argv[2:]
    if argv[:1] == ["--one"]:
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        print(json.dumps(time_root(argv[1], only)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        sel = ["--only", ",".join(only)] if only else []
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               *sel, "--one", root], capture_output=True,
                              text=True, timeout=600)
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
