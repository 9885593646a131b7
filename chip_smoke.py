#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, no result):
  1. device: the card's name and power limit; TF32 switched off for
     float32 matmuls and convolutions (the comparisons below are float32;
     the pipelines themselves run bfloat16);
  2. build: every kernel of the port's serving, training and scoring
     paths and its measurement tool, from ``vae_gslm_tpu_torch/csrc`` with
     one nvcc per source, all started together (K1 ``fused_decode.cu``,
     K2 ``mega_step.cu``, K3/K3b/K4/K4b/K5/K5b ``flash_attention.cu``, K6
     ``flash_decode.cu``, K7 ``stream.cu``), with nvcc's register and
     spill lines, and beside them the g++ build of ``native/dataio.cc``;
  3. K1 against its plain PyTorch version at the flagship width (16
     layers, 16 heads, head_dim 64) at B = 8 and 32 over the cache
     states the 150 -> 650 rollout passes through; kernel and plain
     device times (torch.profiler), the time per call with the wrapper
     (CUDA events), the HBM-bytes bound;
  4. K2 (the whole 16-layer trunk step) against its plain version at the
     flagship width, B = 8 with s8 x s8 products and B = 32 with bf16
     products, over five (flushed, pos) cache states, at max |diff| <=
     2e-3 |want| + 2e-4; then its times at B = 8 as K1's;
  4b. K2-w4 (the same step on nibble-packed int4 weights) against its
     plain version over those cache states at B = 8 with group 128, at
     B = 32 with group 128 (the CLI's chunks under
     ``VAE_GSLM_MEGA_W4=1``) and at B = 32 with group 64 (its ``=64``
     setting), at K2's tolerance (the weights packed by the
     port's ``pack_mega_w4`` on the card from K2's int8 weights, bitwise
     equal to the same packing on the CPU); its times at B = 8 over the
     rollout and at B = 32 (group 128), and the device time of one w4
     and one a8 call by kernel name;
  5. K3 (packed ALiBi flash attention forward: o, lse) and K3b (its
     backward: dq, dk, dv) against their plain versions at the training
     shapes (B 8, T 640, 16 heads of 64, q/k/v views of one projection,
     lengths down to 1), float32 and bfloat16, with ALiBi and without,
     the bf16 outputs also element by element (2 ulps + a share of the
     rms) and in relative L2, and in bf16 at T 1000 and 1024 (the wgmma
     forward's largest resident K); K3 float32 at the scoring path's
     call (B 64, the short batch's padded length and lengths) and its
     time beside SDPA's (float32, float mask) and the bound; K3/K3b's
     bf16 times beside the plain versions', SDPA's with a float mask
     (K3: forward, and the kernel's ratio to it; K3b: backward alone,
     and forward+backward) and the bound;
  5b. K5 (the q-tiled forward) at B 8, 16 heads of 64, T 1750, lengths
     down to 0 and 1, and Tq 96 x Tk 256 non-causal, and K4 (the (B, H,
     T, D) full forward with lse) at B 8, T 640 with 15 heads (no packed
     head grouping), against their plain versions, float32 and bfloat16,
     with ALiBi and without, at K3's tolerances; K5 float32 at the
     scoring path's calls (B 64, T 1750, each long batch's lengths) and
     its time there beside the bound; its float32 time at B 8 beside the
     plain version's, SDPA's (float mask) and the bound;
  5c. K4 (with lse) and K4b (the (B, H, T, D) full backward from K4's
     lse) at the data-parallel training call (B 8, T 640, 16 heads,
     lengths down to 0 and 1; K4's o and lse at K3's forward
     tolerances) and K5b (the blockwise backward) at B 2, T 1536
     (lengths 1536 and 1) and Tq 96 x Tk 256 non-causal (lengths 256, 0,
     1), float32 and bfloat16, against their plain versions, K4b/K5b at
     K3b's tolerances (f32 1e-4 x max|ref|; bf16 2e-2 x max|ref|,
     element by element 2 bf16 ulps + 2e-2 rms(ref), relative L2 1e-3:
     dk and dv sum every query row's share in float32 in another order
     than the plain einsum, and a ds one ulp apart rounds to another
     bf16 value); K4 bf16 also at T 200, 1000 and 1024, with and
     without lse; the bf16 backward (K4b and K5b's ``bwd_wgmma``) also
     at K4b T 200, 1000 and 1024 and K5b T 1100 and 8192 (Tk at the
     envelope's edge), lengths 0 and 1 among them; their bf16 times (K4
     and K4b at the training call, K5b at B 2 x T 1536: 2 kernels per
     call, its row statistics inside the dq kernel) beside the plain
     versions', SDPA's with a float mask (forward for K4, with the
     ratio; backward alone, with the ratio, and forward+backward for
     K4b/K5b) and the bound;
  5d. K6 (single-query decode attention over an int8 per-layer cache,
     reading only the blocks up to ``pos``) against its plain version at
     the per-layer path's calls: B 128, 16 heads of 64, T 768 (the
     651-position rollout rounded up to 256), a bf16 q as a view of one
     qkv projection, at pos 151, 255, 256, 400, 511, 512 and 650, to
     1e-5 x max|ref| (float32, both summing in 256-key blocks); then
     over every 50th position of
     the rollout its device time, the time per call with the wrapper,
     the plain version's time, JAX's route as ported (``decode_attention``
     over the cache at the sampler's segment window: the A/B beside the
     kernel) and the bytes bound;
  5e. K7 (the weight-stream probe) on a seed-0 (16, 1024, 12288) int8
     stack: its per-layer sums and the TPU kernel's tile sum equal to the
     plain version's; the plain version's and one ``torch.sum``'s times;
     then ``scripts/bench_slope.py``'s slopes: K7's microseconds per call
     and GB/s (beside the 3.35 TB/s of the data sheet, which the bounds
     keep), K2's full step at flushed 0 and 512;
  6. agreement on a small input: a small LVTR (head_dim 64)
     continues a prompt by 300 frames on the card (through the kernels)
     and on the CPU (through the plain versions), float32, temperature 0,
     with bf16 weights through K1 across a 256-position flush, with
     int8 weights through K2 (dim 256) across 8-step merges and two
     128-position flushes, and with int4 weights (group 128) through
     K2-w4 (exactly 300 K2-w4 launches and no other K2 on the card); then
     the int8-weight model (dim 256) at B = 72, past the mega batches, on
     the per-layer route three times: an int8 cache through
     ``decode_attention``, the same through K6 (exactly 600 launches) and
     a float32 cache (``kv_dtype`` None), none launching K1 or K2: the
     token streams agree until at least step 150, the latents of the
     first 64 steps to 1e-2;
  7. one small training step (accumulation 2, utterance encoder) on the
     card through K3/K3b and on the CPU through the plain versions, same
     weights, batch and draws, float32: loss terms to 1e-4 relative,
     every gradient leaf to 1e-3 of its max |g|;
  7b. ``LVTR.likelihood`` of a small float32 LVTR with three heads of 64
     (no packed head grouping) on the card and on the CPU, pinned initial
     state: at T = 300 through K4 and at T = 1100 through K5, scores to
     1e-4 relative;
  7c. two ranks of the small training step on the card: two processes
     of this script (worker mode, ``--dp-worker``) join a gloo process
     group through JAX's launch variables and share the one card; each
     takes its half of a global batch with pinned draws through K4/K4b
     (the data-mesh route); against the single-process step over the
     whole batch on the card (K3/K3b): metrics to 1e-4 relative, the
     summed gradients to 1e-3 x max|g|, the ranks' parameters bitwise
     equal, 4 K4 and 4 K4b launches per rank and no K3/K3b;
  8. the serving paths: a 3 s -> 10 s continuation at B = 8 at the full
     width of ``configs/train/speech/vae-gslm.yaml`` (weights from seed
     0; without the utterance encoder, which the serving path does not
     run), int8 KV cache,
     temperature 0.85, DDIM-100 at eta 0.5, then the HiFi-GAN of
     ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml``; each run
     once, with the kernels' counts set to 0 just before a run and read
     just after:
       - bf16 weights (the hybrid path): exactly 16 x 500 K1 launches and
         no K2 launch per run;
       - int8 weights quantized from the float32 weights, the rest cast
         to bf16 (the shipped ``weight_dtype: int8`` path): exactly 500
         K2 launches and no K1 launch per run (B = 64 runs in phase 11);
     then, for each path, a profile of 64 AR steps: the device busy
     share and the kernels that take it;
  8b. the per-layer paths at that width and B = 128 (past the mega
     batches), same prompts, stages and checks: int8 weights and an
     int8 cache through JAX's route (``decode_attention``; no K1, K2 or
     K6 launch), then with ``flash_decode=True`` (exactly 16 x 500 K6
     launches, no K1 or K2), the two routes' token agreement and latent
     difference reported, each with its real-time factor, stage times,
     ms per AR step and peak memory, and a profile of 32 AR steps of
     each; then bf16 weights with a bf16 cache (``kv_dtype`` None; no
     kernel launch on the AR loop);
  9. the training path: ``LVTRTrainer`` on that config at full width with
     its utterance encoder (16-mixed, AdamW, accumulation 2), synthetic
     B = 8 x 640 batches from seed 0: one warm-up and five timed
     ``run_step`` calls, each with exactly 32 K3 and 32 K3b launches
     (counts set to 0 just before each step), the plain attention
     versions refused; ms per step, tokens/s, peak memory, then one
     profiled step;
  9b. the data-parallel training path: two ranks sharing the card (gloo)
     run ``scripts/train.py`` -> ``LVTRTrainer.fit`` on the shipped
     config, its data paths pointed at a synthetic corpus written from
     seed 0 (96 WAVs of 13-20 s, their token ids, and the mels that
     ``scripts/preprocess_mels.py`` writes from them on the card):
     8 rows per rank x accumulation 2 x 640 frames, 16-mixed, three
     optimizer steps, each with its counts set to 0 just before and read
     just after (exactly 32 K4 and 32 K4b launches per rank and no other
     attention kernel; the plain versions refused), the ranks'
     parameters bitwise equal and their logged metrics equal, rank 0's
     ``last-cpt.npz`` read back strictly and equal to them; ms per step,
     tokens/s per rank, the all-reduce's share and peak memory per rank
     (two ranks on one card: no scaling claim); then one step past 1024
     frames (``token_segment_size`` 1536 and its post-padding, the only
     changes, 2 rows per rank, accumulation 1, 4 WAVs of 31-35 s):
     exactly 16 K5 and 16 K5b launches per rank;
  10. the scoring path: ``LikelihoodEstimator`` at the full width of that
     config with its utterance encoder (weights from seed 0 written once
     by ``save_compact`` beside a seed-1 vocoder directory and shared
     with phase 11, read back strictly), float32, over 192 synthetic
     WAVs from seed 0 with the
     infer config's data settings (batch 64) and a uniform length mix
     made to run both routes: 64 utterances of 5-20 s (one batch <= 1024
     frames: 16 K3 launches) and 128 of 5-35 s (two batches padded to
     1750 frames: 16 K5 launches each), no K4 launch and no plain
     version, each batch's lengths those phases 5 and 5b held K3 and K5
     at; utterances/s, seconds of audio scored per wall second, model
     and data time, peak memory, one profiled batch, and the device time
     of one loader pass alone;
  11. the speech-continuation CLI, three times: ``scripts/infer.py``'s
     ``main`` in this process on the shipped
     ``configs/infer/speech/vae-gslm.yaml``
     with only ``ckpt_path`` (phase 10's checkpoint), ``vocoder.path``,
     ``data.path``, ``data.wavdir`` and ``output_dir`` pointed at a
     temporary directory holding 64 synthetic WAVs of 5-13 s from seed 0
     and their tokens file: one batch of 64 (two sequential B = 32 chunks
     of 500 AR steps, 16-mixed, int8 KV cache, int8 weights, DDIM-100 at
     eta 0.5 with the utterance embedding, HiFi-GAN, the energy-VAD trim),
     the kernels' counts set to 0 just before ``main`` and read just
     after: exactly 1000 K2 launches and no K2-w4 or K1 launch; then with
     ``VAE_GSLM_MEGA_W4=1``, exactly 1000 K2-w4 launches and no K2 or K1
     launch; then one batch of 128 over 128 such WAVs (``data.batch_size``
     128, the per-layer int8 route: no K1, K2, K2-w4 or K6 launch).  Each
     run writes exactly one finite 16 kHz WAV per input, none longer than
     the 3 s prompt + 10 s; the real-time factor over the whole ``main``
     call (n x 10 s over its wall time: model build, data, sampling,
     vocoder and WAV writing included), the stage times and the peak
     memory.
Output: one line per measurement, then the ``{"kernels": [...]}`` line,
the nvidia-smi name/power line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
L, H, D = 16, 16, 64              # flagship trunk: 16 layers, 16 x 64
PROMPT, LENGTH = 150, 500         # 3 s -> 10 s at 50 frames/s
HBM_BYTES_PER_S = 3.35e12         # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS = 0.989e15


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``n`` calls (CUDA
    events), after one warm-up loop."""
    import torch

    fn(0)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _profiled(fn, n: int, only=()):
    """(name, device microseconds, launches) of each device operation
    that torch.profiler's CUDA activity records over ``n`` calls of
    ``fn``: with ``only``, just the kernels whose names contain one of
    its strings.  The runtime calls that the activity also records
    (launches, synchronizes) are host events and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (not only or any(s in e.key for s in only))]


def _kernel_name(key: str) -> str:
    """A profiler key without its namespace and argument list."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


def device_ms(fn, n: int, only=(), per_call: int = 0, tries: int = 4
              ) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler's CUDA activity (their own durations: host gaps
    between launches are left out), after one warm-up call.  With
    ``only``, just the kernels whose names contain one of its strings.
    On the H100 a window has recorded as few as 6 of 10 launches of one
    kernel, so a window's total over ``n`` can read low.  With
    ``per_call`` (the port's kernels: that many kernels per call, each
    launched once under a name of its own) the time per call is the sum
    of each name's mean recorded duration, and a window must record
    every name, else it is profiled again, up to ``tries`` windows; then
    the run fails.  Without it (plain versions, library calls and K2:
    many launches of few names, of which windows have lost a few in
    thousands or, once, 5 %), the fuller of two windows' total over
    ``n``."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    if not per_call:
        evs = max((_profiled(fn, n, only) for _ in range(2)),
                  key=lambda w: sum(c for _, _, c in w))
        if not evs:
            raise AssertionError("the profiler recorded no device operation")
        return sum(us for _, us, _ in evs) / 1e3 / n
    seen = []
    for _ in range(tries):
        evs = _profiled(fn, n, only)
        seen.append([c for _, _, c in evs])
        if len(evs) == per_call:
            got = sum(c for _, _, c in evs)
            if got != n * per_call or len(seen) > 1:
                log(f"  (profiler windows recorded {seen} launches per "
                    f"kernel name of {n} calls; the time is the mean of "
                    "the recorded launches)")
            return sum(us / c for _, us, c in evs) / 1e3
    raise AssertionError(f"the profiler windows recorded {seen} launches per "
                         f"kernel name, {per_call} names expected")


# ------------------------------------------------------------------ K1
def k1_inputs(b: int, dev, seed: int = 0):
    """Random int8 hybrid cache (capacity for the 651-position rollout)
    and bfloat16 q/k/v rows as views of one fused qkv projection, as
    ``decode_hybrid`` hands them to the kernel."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    nb = max((PROMPT + 1 + LENGTH) // 256 * 256, 256) // 256

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02

    cache = (i8(L, nb, b, H, D, 256), i8(L, nb, b, H, D, 256),
             sc(L, nb, b, H, 256), sc(L, nb, b, H, 256),
             i8(L, b, H, 256, D), i8(L, b, H, 256, D),
             sc(L, b, H, 256), sc(L, b, H, 256))
    qkv = torch.randn((b, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv.view(b, 3, H, D).unbind(1)
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return cache, q, k, v, slopes


def k1_bytes_ops(b: int, pos: int):
    """Bytes the call must move (each input read once, the output written
    once) and its int8 operations, for this call's valid rows."""
    rows = pos                       # cold + tail rows below pos
    cache_bytes = b * H * rows * (2 * D + 2 * 4)
    io_bytes = 3 * b * H * D * 2 + b * H * D * 4 + H * 4
    ops = 2 * 2 * b * H * rows * D   # QK and PV multiply-adds
    return cache_bytes + io_bytes, ops


def phase_k1(dev):
    import torch

    from vae_gslm_tpu_torch.ops.fused_decode import (
        fused_decode_attention as k1, fused_decode_attention_plain as plain)

    worst = 0.0
    for b in (8, 32):
        for flushed, pos in ((0, 151), (0, 255), (256, 256), (256, 511),
                             (512, 650)):
            cache, q, k, v, slopes = k1_inputs(b, dev)
            for li in (0, L - 1):
                got = k1(q, *cache, pos, li, slopes, k, v, flushed)
                want = plain(q, *cache, pos, li, slopes, k, v, flushed)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = (1e-4 + 1e-3 * want.abs()).sub(
                    (got - want).abs()).min().item()
                log(f"K1 check B={b} flushed={flushed} pos={pos} li={li}: "
                    f"max_abs_err={err:.3e}")
                if tol < 0 or not math.isfinite(err):
                    raise AssertionError(
                        f"K1 disagrees with its plain version beyond "
                        f"rtol 1e-3 / atol 1e-4 (B={b}, pos={pos})")
                worst = max(worst, err)
    # Times over the main path's cache states at B = 8: every 50th
    # position of the 151 -> 650 rollout; the layer index cycles so the
    # 16-layer cache (> L2) is read cold, as in the pipeline.  The
    # kernel's and the plain version's device times come from the
    # profiler; the time per call with the wrapper's host work (checks,
    # pointers, launch) from CUDA events around back-to-back calls.
    ks, calls, ps, bs = [], [], [], []
    for pos in range(PROMPT + 1, PROMPT + 1 + LENGTH, 50):
        flushed = pos // 256 * 256
        cache, q, k, v, slopes = k1_inputs(8, dev, seed=pos)

        def kernel(i):
            return k1(q, *cache, pos, i % L, slopes, k, v, flushed)

        ks.append(device_ms(kernel, n=200, only=("fused_decode_kernel",),
                            per_call=1))
        calls.append(cuda_ms(kernel, n=200))
        ps.append(device_ms(lambda i: plain(q, *cache, pos, i % L, slopes, k,
                                            v, flushed), n=10))
        nbytes, ops = k1_bytes_ops(8, pos)
        bs.append(max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3)
        log(f"K1 time B=8 pos={pos}: kernel {ks[-1] * 1e3:.2f} us, "
            f"{calls[-1] * 1e3:.2f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.2f} us, bound {bs[-1] * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
    log(f"K1 mean over the rollout: kernel {statistics.mean(ks) * 1e3:.2f} "
        f"us, {statistics.mean(calls) * 1e3:.2f} us per call with the "
        f"wrapper, plain {statistics.mean(ps) * 1e3:.2f} us, bound "
        f"{statistics.mean(bs) * 1e3:.2f} us")
    log("K1 library_ms: null (no single PyTorch call computes this "
        "int8-requantized attention over the cold/tail cache)")
    return {"name": "fused_decode_attention", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/fused_decode.cu",
            "replaces": "vae_gslm_tpu/ops/fused_decode.py:229",
            "launches": None, "max_abs_err": worst,
            "ms": statistics.mean(ks), "plain_ms": statistics.mean(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------------ K2
K2_CASES = ((128, 151), (128, 255), (256, 256), (384, 500), (640, 650))


def k2_inputs(b: int, dev, seed: int = 0):
    """Random int8 weights of the flagship trunk (column scales of a
    uniform(+-1/sqrt(din)) init), a random three-tier cache with room for
    the 651-position rollout, and a residual row x."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops.mega_step import BLK, STAGE, TAIL

    g = torch.Generator(dev).manual_seed(seed)
    d = H * D
    nb = (PROMPT + 1 + LENGTH) // BLK + 1

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
        "k_cold": i8(L, nb, H, b, D, BLK), "v_cold": i8(L, nb, H, b, D, BLK),
        "kc_scale": u(L, nb, H, b, BLK, hi=0.02),
        "vc_scale": u(L, nb, H, b, BLK, hi=0.02),
        "k_tail": i8(L, H, b, TAIL, D), "v_tail": i8(L, H, b, TAIL, D),
        "kt_scale": u(L, H, b, TAIL, hi=0.02),
        "vt_scale": u(L, H, b, TAIL, hi=0.02),
        "k_stage": (torch.randn((L, STAGE, H, b, D), generator=g, device=dev)
                    * 0.3).to(torch.bfloat16),
        "v_stage": (torch.randn((L, STAGE, H, b, D), generator=g, device=dev)
                    * 0.3).to(torch.bfloat16),
    }
    x = torch.randn((b, d), generator=g, device=dev)
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return x, weights, cache, slopes


def k2_bytes_ops(b: int, pos: int, flushed: int, a8: bool, group: int = 0):
    """Bytes one call must move (int8 weights and their float32 vectors,
    the valid cache rows of every layer, x in and out, the new K/V rows)
    and its operations (dense multiply-adds; QK and PV over the valid
    rows), and the card's peak rate for their type.  With ``group``
    (K2-w4): nibble-packed weights and their float32 group scales in
    place of the int8 weights and column scales; s8 x s8 products."""
    d = H * D
    stage_base = pos - (pos - flushed) % 8
    weight_bytes = L * (12 * d * d + 4 * (2 * 9 * d + 2 * d))
    if group:
        weight_bytes = L * (6 * d * d + 4 * 12 * d * d // group
                            + 4 * (9 * d + 2 * d))
    rows_i8 = stage_base                      # cold + merged tail rows
    rows_bf16 = pos - stage_base              # stage rows
    cache_bytes = L * b * H * (rows_i8 * 2 * (D + 4) + rows_bf16 * 4 * D)
    io_bytes = 2 * b * d * 4 + 2 * L * H * b * D * 2 + H * 4
    ops = 2 * b * L * 12 * d * d + L * b * H * 4 * D * (pos + 1)
    peak = INT8_OPS_PER_S if a8 or group else BF16_FLOPS
    return weight_bytes + cache_bytes + io_bytes, ops, peak


def phase_k2(dev):
    """K2 against its plain version at the flagship width (B = 8 with the
    s8 x s8 products, B = 32 with bf16 products) over the rollout's cache
    states, then its times at B = 8 over the rollout's positions."""
    import torch

    from vae_gslm_tpu_torch.ops.mega_step import (
        fused_trunk_step as k2, fused_trunk_step_plain as plain)

    worst = 0.0
    for b, a8 in ((8, True), (32, False)):
        x, weights, cache, slopes = k2_inputs(b, dev, seed=b)
        for flushed, pos in K2_CASES:
            got = k2(x, weights, cache, pos, slopes, flushed, a8=a8)
            want = plain(x, weights, cache, pos, slopes, flushed, a8=a8)
            torch.cuda.synchronize()
            errs = []
            for name, gt, wt in zip(("x", "k_new", "v_new"), got, want):
                gt, wt = gt.float(), wt.float()
                diff = (gt - wt).abs()
                errs.append(diff.max().item())
                slack = (2e-4 + 2e-3 * wt.abs() - diff).min().item()
                if slack < 0 or not math.isfinite(errs[-1]):
                    raise AssertionError(
                        f"K2 {name} disagrees with its plain version beyond "
                        f"rtol 2e-3 / atol 2e-4 (B={b}, a8={a8}, "
                        f"flushed={flushed}, pos={pos}): max abs "
                        f"{errs[-1]:.3e}")
            log(f"K2 check B={b} a8={a8} flushed={flushed} pos={pos}: "
                f"max_abs_err x {errs[0]:.3e}, k_new {errs[1]:.3e}, "
                f"v_new {errs[2]:.3e}")
            worst = max(worst, *errs)
    # Times over the main path's positions at B = 8 (a8), as K1's.
    ks, calls, ps, bs = [], [], [], []
    x, weights, cache, slopes = k2_inputs(8, dev, seed=1)
    for pos in range(PROMPT + 1, PROMPT + 1 + LENGTH, 100):
        flushed = pos // 128 * 128

        def kernel(i):
            return k2(x, weights, cache, pos, slopes, flushed, a8=True)

        ks.append(device_ms(kernel, n=50))
        calls.append(cuda_ms(kernel, n=50))
        ps.append(device_ms(lambda i: plain(x, weights, cache, pos, slopes,
                                            flushed, a8=True), n=3))
        nbytes, ops, peak = k2_bytes_ops(8, pos, flushed, True)
        bs.append(max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3)
        log(f"K2 time B=8 a8 pos={pos}: kernel {ks[-1] * 1e3:.1f} us, "
            f"{calls[-1] * 1e3:.1f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.1f} us, bound {bs[-1] * 1e3:.1f} us "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G int8 ops)")
    log(f"K2 mean over the rollout: kernel {statistics.mean(ks) * 1e3:.1f} "
        f"us, {statistics.mean(calls) * 1e3:.1f} us per call with the "
        f"wrapper, plain {statistics.mean(ps) * 1e3:.1f} us, bound "
        f"{statistics.mean(bs) * 1e3:.1f} us")
    log("K2 library_ms: null (no single PyTorch call computes a whole "
        "int8-weight trunk step)")
    return {"name": "fused_trunk_step", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
            "replaces": "vae_gslm_tpu/ops/mega_step.py:427",
            "launches": None, "max_abs_err": worst,
            "ms": statistics.mean(ks), "plain_ms": statistics.mean(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


def phase_k2_w4(dev):
    """K2-w4 (the nibble-packed int4 branch of the trunk step) against its
    plain version at the flagship width over ``K2_CASES``: at B = 8 with
    group 128, and at B = 32 with group 128 and with group 64 (the CLI's
    chunks under ``VAE_GSLM_MEGA_W4=1`` and ``=64``), at K2's tolerance; the w4
    weights are built by the port's ``pack_mega_w4`` on the card from
    ``k2_inputs``' int8 weights and held bitwise equal to the same build
    on the CPU.  Then its times at B = 8 over the rollout's positions and
    at B = 32, group 128 (the CLI's chunks under ``VAE_GSLM_MEGA_W4=1``)."""
    import torch

    from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4
    from vae_gslm_tpu_torch.ops.mega_step import (
        fused_trunk_step as k2, fused_trunk_step_plain as plain)

    def w4_weights(weights, group):
        w4 = pack_mega_w4(weights, group, D)
        cpu = pack_mega_w4({k: v.cpu() for k, v in weights.items()}, group,
                           D)
        for k in cpu:
            a, b = w4[k].cpu(), cpu[k]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"the card's w4 build of {k} (group "
                                     f"{group}) differs from the CPU's")
        return w4

    worst = 0.0
    for b, group in ((8, 128), (32, 128), (32, 64)):
        x, weights, cache, slopes = k2_inputs(b, dev, seed=b)
        w4 = w4_weights(weights, group)
        mb = sum(v.numel() * v.element_size() for k, v in w4.items()
                 if k[0] in "wg") / 1e6
        log(f"K2-w4 build B={b} group={group}: card and CPU bitwise equal "
            f"({mb:.1f} MB of packed weights and group scales)")
        for flushed, pos in K2_CASES:
            before = k2.launches_w4
            got = k2(x, w4, cache, pos, slopes, flushed)
            want = plain(x, w4, cache, pos, slopes, flushed)
            torch.cuda.synchronize()
            if k2.launches_w4 != before + 1:
                raise AssertionError("the w4 call did not count as K2-w4")
            errs = []
            for name, gt, wt in zip(("x", "k_new", "v_new"), got, want):
                gt, wt = gt.float(), wt.float()
                diff = (gt - wt).abs()
                errs.append(diff.max().item())
                slack = (2e-4 + 2e-3 * wt.abs() - diff).min().item()
                if slack < 0 or not math.isfinite(errs[-1]):
                    raise AssertionError(
                        f"K2-w4 {name} disagrees with its plain version "
                        f"beyond rtol 2e-3 / atol 2e-4 (B={b}, group="
                        f"{group}, flushed={flushed}, pos={pos}): max abs "
                        f"{errs[-1]:.3e}")
            log(f"K2-w4 check B={b} group={group} flushed={flushed} "
                f"pos={pos}: max_abs_err x {errs[0]:.3e}, k_new "
                f"{errs[1]:.3e}, v_new {errs[2]:.3e}")
            worst = max(worst, *errs)
    ks, calls, ps, bs = [], [], [], []
    x, weights, cache, slopes = k2_inputs(8, dev, seed=1)
    w4 = pack_mega_w4(weights, 128, D)
    for pos in range(PROMPT + 1, PROMPT + 1 + LENGTH, 100):
        flushed = pos // 128 * 128

        def kernel(i):
            return k2(x, w4, cache, pos, slopes, flushed)

        ks.append(device_ms(kernel, n=50))
        calls.append(cuda_ms(kernel, n=50))
        ps.append(device_ms(lambda i: plain(x, w4, cache, pos, slopes,
                                            flushed), n=3))
        nbytes, ops, peak = k2_bytes_ops(8, pos, flushed, False, 128)
        bs.append(max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3)
        log(f"K2-w4 time B=8 group=128 pos={pos}: kernel "
            f"{ks[-1] * 1e3:.1f} us, {calls[-1] * 1e3:.1f} us per call with "
            f"the wrapper, plain {ps[-1] * 1e3:.1f} us, bound "
            f"{bs[-1] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} G int8 ops)")
    # where a step's device time goes, K2-w4 against K2-a8 on the same
    # int8 weights, by kernel name (per call)
    pos = PROMPT + 1 + 200
    flushed = pos // 128 * 128
    for what, w, kw in (("K2-w4", w4, {}), ("K2-a8", weights, {"a8": True})):
        evs = _profiled(lambda i: k2(x, w, cache, pos, slopes, flushed, **kw),
                        20)
        total = sum(us for _, us, _ in evs) / 20
        log(f"{what} B=8 pos={pos} by kernel: " + "; ".join(
            f"{_kernel_name(name)} {us / 20:.1f} us ({cnt / 20:.0f}x)"
            for name, us, cnt in sorted(evs, key=lambda e: -e[1]))
            + f"; total {total:.1f} us")
    log(f"K2-w4 mean over the rollout (B=8, group 128): kernel "
        f"{statistics.mean(ks) * 1e3:.1f} us, "
        f"{statistics.mean(calls) * 1e3:.1f} us per call with the wrapper, "
        f"plain {statistics.mean(ps) * 1e3:.1f} us, bound "
        f"{statistics.mean(bs) * 1e3:.1f} us")
    x, weights, cache, slopes = k2_inputs(32, dev, seed=32)
    w4 = pack_mega_w4(weights, 128, D)
    pos = PROMPT + 1 + LENGTH // 2
    flushed = pos // 128 * 128
    k32 = device_ms(lambda i: k2(x, w4, cache, pos, slopes, flushed), n=20)
    p32 = device_ms(lambda i: plain(x, w4, cache, pos, slopes, flushed), n=2)
    nbytes, ops, peak = k2_bytes_ops(32, pos, flushed, False, 128)
    b32 = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
    log(f"K2-w4 time B=32 group=128 pos={pos}: kernel {k32 * 1e3:.1f} us, "
        f"plain {p32 * 1e3:.1f} us, bound {b32 * 1e3:.1f} us "
        f"({nbytes / 1e6:.1f} MB)")
    log("K2-w4 library_ms: null (no single PyTorch call computes a whole "
        "int4-weight trunk step)")
    return {"name": "fused_trunk_step_w4", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
            "replaces": "vae_gslm_tpu/ops/mega_step.py:143",
            "launches": None, "max_abs_err": worst,
            "ms": statistics.mean(ks), "plain_ms": statistics.mean(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


# -------------------------------------------------------------- K3/K3b
K3_B, K3_T = 8, 640               # the training micro-batch
K3_KERNELS = ("k3_fwd", "k3b_dkv", "k3b_dq")   # kernel name prefixes
K3_LENGTHS = [640, 320, 300, 640, 1, 639, 512, 64]
# bf16 K3/K4 checks at the largest resident key sets (16 tiles at 1024)
K3_LONG = ((4, 1000, 4, [1000, 0, 1, 611]), (4, 1024, 4, [1024, 1, 0, 700]))


def k3_inputs(dtype, dev, seed: int = 0, b: int = K3_B, t: int = K3_T,
              h: int = H, lengths=K3_LENGTHS):
    """q/k/v as views of one (B, T, 3 H D) projection, dO, lengths and
    the port's ALiBi slopes."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * D), generator=g, device=dev).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    do = torch.randn((b, t, h * D), generator=g, device=dev).to(dtype)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    return q, k, v, do, lengths, slopes


def k3_bytes_ops(itemsize: int, b: int = K3_B, t: int = K3_T,
                 lengths=K3_LENGTHS):
    """Bytes and FLOPs of one K3 call and of K3b's two kernels (the
    timed part: ``delta`` comes in computed) on the inputs of
    ``k3_inputs``.  Bytes: each input read once, each output written
    once, key and value rows only below each batch row's length (a row
    of length 0 reads all T): K3 reads q, k, v and writes o, lse; K3b
    reads q, k, v, dO, lse, delta and writes dq, dk, dv.  FLOPs: the
    (query, key) pairs this run's causal and length masks leave, 2 D per
    pair and product: 2 products forward (QK, PV), 5 backward (QK, dO V,
    dS K, dS^T Q, P^T dO)."""
    row = H * D * itemsize
    n = b * t * row                          # one full (B, T, H D) tensor
    n_kv = sum(ln if ln >= 1 else t for ln in lengths) * row
    stats = b * H * t * 4                    # lse or delta, float32
    small = b * 4 + H * 4
    rows = sum(sum(min(r + 1, ln) if ln >= 1 else t
                   for r in range(t)) for ln in lengths)
    pairs = H * rows
    return ((2 * n + 2 * n_kv + stats + small, 2 * 2 * pairs * D),
            (5 * n + 2 * n_kv + 2 * stats + small, 5 * 2 * pairs * D))


def sdpa_mask(lengths, slopes, dtype, dev, tq: int = K3_T, tk: int = K3_T,
              causal: bool = True):
    """The explicit float mask (ALiBi + length, causal or not) that makes
    ``scaled_dot_product_attention`` compute the flash kernels'
    function."""
    import torch

    q_pos = torch.arange(tq, device=dev)
    k_pos = torch.arange(tk, device=dev)
    bias = slopes[:, None, None] * (k_pos[None, :]
                                    - q_pos[:, None]).abs()[None]
    valid = k_pos[None, None, None, :] < lengths[:, None, None, None]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return torch.where(valid, bias[None], float("-inf")).to(dtype)


def sdpa_bwd_ms(q, k, v, do, mask) -> float:
    """Device ms of SDPA's backward alone (float mask): one
    ``torch.autograd.grad`` call on a retained forward graph, the
    library call that computes a backward kernel's function."""
    import torch
    import torch.nn.functional as F

    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    ms = device_ms(lambda i: torch.autograd.grad(out, (q, k, v), do,
                                                 retain_graph=True), n=10)
    del out
    return ms


def ulp_bf16(x):
    """One bfloat16 unit in the last place of each |x| (0 where x is 0)."""
    import torch

    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def hold(where: str, name: str, got, want, tol: float, floor: float,
         bf16: bool):
    """Fails unless max |diff| <= tol x max(floor, max|ref|) and, for a
    bf16 output other than lse, |diff| <= 2 bf16 ulps of |ref| + tol x
    rms(ref) element by element and ||diff|| <= 1e-3 ||ref||: a length-1
    row makes one dv row the sum of all T dO rows, whose max |ref| alone
    would let a wrong entry elsewhere through.  Returns the max |diff|
    and its log text."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    ref = max(floor, want.abs().max().item())
    text = f"{name} {err:.3e}"
    if not err <= tol * ref:
        raise AssertionError(f"{name} disagrees with its plain version: max "
                             f"abs {err:.3e} > {tol} x {ref:.3e} ({where})")
    if bf16 and name != "lse":
        rms = want.pow(2).mean().sqrt().item()
        excess = (diff - 2 * ulp_bf16(want)).clamp_min(0).max().item() / rms
        rel = (diff.norm() / want.norm()).item()
        text += f" ({excess:.1e} rms past 2 ulp, L2 {rel:.1e})"
        if not (excess <= tol and rel <= 1e-3):
            raise AssertionError(
                f"{name} disagrees with its plain version: {excess:.3e} x "
                f"rms(ref) past 2 bf16 ulps (limit {tol}), relative L2 "
                f"{rel:.3e} (limit 1e-3) ({where})")
    return err, text


def in_chunks(fn, b: int, step: int):
    """``fn(rows)`` over slices of ``step`` batch rows, the outputs joined
    along the batch (tuples element by element): the plain versions'
    (B, H, T, T) logits at the scoring batch of 64 would take tens of
    GB at once."""
    import torch

    outs = [fn(slice(i, i + step)) for i in range(0, b, step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def phase_k3(dev):
    """K3 (o, lse) and K3b (dq, dk, dv) against their plain versions at
    the training shapes (B 8, T 640, 16 heads of 64) and at T 200 (a
    partial last tile), float32 and bfloat16, and in bfloat16 at T 1000
    and 1024 (lengths 0 and 1 among them: the bf16 forward's largest
    resident key sets), with ALiBi and without; K3 float32 at the
    scoring path's shape (B 64, the short batch's padded length and
    lengths) and its time there beside SDPA's (float32, float mask) and
    the bound; then K3/K3b's bf16 times beside the plain versions',
    SDPA's (K3: its forward and the ratio; K3b: its backward alone, and
    forward+backward) and the bound.  Every output is held by ``hold`` at tol x max|ref| (tol 1e-5
    on f32 o and lse, 1e-4 on f32 gradients, bf16: 1e-2 on o, 1e-5 on
    lse, 2e-2 on gradients), a bf16 o, dq, dk or dv also element by
    element and in relative L2."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.ops.flash_attention import (
        flash_backward_packed as k3b, flash_backward_packed_plain as k3b_plain,
        flash_forward_packed as k3, flash_forward_packed_plain as k3_plain)

    worst_f, worst_b = 0.0, 0.0
    shapes = ((K3_B, K3_T, H, K3_LENGTHS), (4, 200, 2, [200, 77, 1, 130]))
    cases = list(itertools.product(shapes, (torch.float32, torch.bfloat16)))
    # the bf16 forward's largest resident K: T 1000 and 1024
    cases += [(shape, torch.bfloat16) for shape in K3_LONG]
    for (b, t, h, lengths), dtype in cases:
        bf16 = dtype == torch.bfloat16
        q, k, v, do, lengths, slopes = k3_inputs(dtype, dev, 0, b, t, h,
                                                 lengths)
        for sl in (slopes, None):
            o, lse = k3(q, k, v, lengths, sl, True, h)
            o_ref, lse_ref = k3_plain(q, k, v, lengths, sl, True, h)
            grads = k3b(q, k, v, o, do, lse, lengths, sl, True, h)
            refs = k3b_plain(q, k, v, o, do, lse, lengths, sl, True, h)
            torch.cuda.synchronize()
            checks = [("o", o, o_ref, 1e-2 if bf16 else 1e-5,
                       0.0 if bf16 else 1.0), ("lse", lse, lse_ref, 1e-5, 1.0)]
            checks += [(n, g_, r_, 2e-2 if bf16 else 1e-4, 0.0)
                       for n, g_, r_ in zip(("dq", "dk", "dv"), grads, refs)]
            errs = []
            for name, got, want, tol, floor in checks:
                where = f"K3/K3b, {dtype}, T={t}, alibi={sl is not None}"
                err, text = hold(where, name, got, want, tol, floor, bf16)
                errs.append(text)
                if name in ("o", "lse"):
                    worst_f = max(worst_f, err)
                else:
                    worst_b = max(worst_b, err)
            log(f"K3/K3b check B={b} T={t} H={h} {str(dtype)[6:]} "
                f"alibi={sl is not None}: max_abs_err " + ", ".join(errs))

    # The scoring path's K3 call: float32, B 64, the short batch's padded
    # length and lengths; the plain version in chunks of 16 rows.
    lens = scoring_batches()[0]
    ts = max(lens)
    q, k, v, _, lengths, slopes = k3_inputs(torch.float32, dev, 2,
                                            SCORE_BATCH, ts, H, lens)

    def plain_s(i):
        return in_chunks(lambda s: k3_plain(q[s], k[s], v[s], lengths[s],
                                            slopes, True, H), SCORE_BATCH, 16)

    o, lse = k3(q, k, v, lengths, slopes, True, H)
    o_ref, lse_ref = plain_s(0)
    torch.cuda.synchronize()
    where = f"K3 at the scoring shape, float32, B={SCORE_BATCH}, T={ts}"
    errs = []
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref)):
        err, text = hold(where, name, got, want, 1e-5, 1.0, False)
        worst_f = max(worst_f, err)
        errs.append(text)
    log(f"K3 check B={SCORE_BATCH} T={ts} H={H} float32 alibi=True (the "
        f"scoring corpus's short batch, lengths {min(lens)}-{max(lens)}): "
        f"max_abs_err " + ", ".join(errs))
    del o, lse, o_ref, lse_ref
    ks = device_ms(lambda i: k3(q, k, v, lengths, slopes, True, H), n=10,
                   only=K3_KERNELS[:1], per_call=1)
    cs = cuda_ms(lambda i: k3(q, k, v, lengths, slopes, True, H), n=10)
    ps = device_ms(plain_s, n=2)
    mask = sdpa_mask(lengths, slopes, torch.float32, dev, ts, ts)
    q4, k4, v4 = (x.view(SCORE_BATCH, ts, H, D).transpose(1, 2)
                  for x in (q, k, v))

    def sdpa_s(i):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    ls = device_ms(sdpa_s, n=3)
    del mask
    (sb, so), _ = k3_bytes_ops(4, SCORE_BATCH, ts, lens)
    bound_s = max(sb / HBM_BYTES_PER_S, so / F32_FLOPS) * 1e3
    by_s = "bytes" if sb / HBM_BYTES_PER_S > so / F32_FLOPS else "operations"
    log(f"K3 time B={SCORE_BATCH} T={ts} float32 (the scoring path's call): "
        f"kernel {ks:.4f} ms, {cs:.4f} ms per call with the wrapper, plain "
        f"{ps:.4f} ms (16-row chunks), SDPA (float32, float mask) forward "
        f"{ls:.4f} ms, bound {bound_s:.4f} ms ({by_s}; {sb / 1e6:.1f} MB, "
        f"{so / 1e9:.2f} GFLOP at the float32 FMA rate)")
    del q, k, v, q4, k4, v4

    # Times at the training path's type (bf16, ALiBi).
    q, k, v, do, lengths, slopes = k3_inputs(torch.bfloat16, dev, seed=1)
    o, lse = k3(q, k, v, lengths, slopes, True, H)

    def fwd(i):
        return k3(q, k, v, lengths, slopes, True, H)

    def bwd(i):
        return k3b(q, k, v, o, do, lse, lengths, slopes, True, H)

    kf = device_ms(fwd, n=20, only=K3_KERNELS[:1], per_call=1)
    kb = device_ms(bwd, n=20, only=K3_KERNELS[1:], per_call=2)
    cf, cb = cuda_ms(fwd, n=20), cuda_ms(bwd, n=20)
    pf = device_ms(lambda i: k3_plain(q, k, v, lengths, slopes, True, H), n=3)
    pb = device_ms(lambda i: k3b_plain(q, k, v, o, do, lse, lengths, slopes,
                                       True, H), n=3)
    mask = sdpa_mask(lengths, slopes, torch.bfloat16, dev)
    q4, k4, v4 = (x.view(K3_B, K3_T, H, D).transpose(1, 2).detach()
                  .requires_grad_() for x in (q, k, v))
    do4 = do.view(K3_B, K3_T, H, D).transpose(1, 2)

    def sdpa_fwd(i):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def sdpa_fwd_bwd(i):
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask).backward(
            do4)

    lf = device_ms(sdpa_fwd, n=20)
    lfb = device_ms(sdpa_fwd_bwd, n=10)
    lb = sdpa_bwd_ms(q4, k4, v4, do4, mask)
    (fb, fo), (bb, bo) = k3_bytes_ops(2)
    bound_f = max(fb / HBM_BYTES_PER_S, fo / BF16_FLOPS) * 1e3
    bound_b = max(bb / HBM_BYTES_PER_S, bo / BF16_FLOPS) * 1e3
    by_f = "bytes" if fb / HBM_BYTES_PER_S > fo / BF16_FLOPS else "operations"
    by_b = "bytes" if bb / HBM_BYTES_PER_S > bo / BF16_FLOPS else "operations"
    log(f"K3 time B={K3_B} T={K3_T} bf16: kernel {kf:.4f} ms, {cf:.4f} ms "
        f"per call with the wrapper, plain {pf:.4f} ms, SDPA (float mask) "
        f"forward {lf:.4f} ms (kernel / SDPA {kf / lf:.3f}), bound "
        f"{bound_f:.4f} ms ({by_f}; {fb / 1e6:.1f} MB, {fo / 1e9:.2f} "
        f"GFLOP)")
    log(f"K3b time B={K3_B} T={K3_T} bf16: kernels {kb:.4f} ms, {cb:.4f} ms "
        f"per call with the wrapper (delta included), plain {pb:.4f} ms, "
        f"SDPA (float mask) backward alone {lb:.4f} ms (kernels / SDPA "
        f"backward {kb / lb:.3f}), forward+backward {lfb:.4f} ms, bound of "
        f"the kernels {bound_b:.4f} ms ({by_b}; {bb / 1e6:.1f} MB, "
        f"{bo / 1e9:.2f} GFLOP)")
    return (
        {"name": "flash_forward_packed", "route": "cuda",
         "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vae_gslm_tpu/ops/flash_attention.py:230",
         "launches": None, "max_abs_err": worst_f, "ms": kf, "plain_ms": pf,
         "bound_ms": bound_f, "bound_by": by_f, "library_ms": lf},
        {"name": "flash_backward_packed", "route": "cuda",
         "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vae_gslm_tpu/ops/flash_attention.py:359",
         "launches": None, "max_abs_err": worst_b, "ms": kb, "plain_ms": pb,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": lb})


# --------------------------------------------------------------- K4/K5
K5_B, K5_T = 8, 1750              # a scoring batch padded to 35 s
K5_LENGTHS = [1750, 1000, 1, 0, 1749, 64, 1700, 900]
K4_B, K4_T, K4_H = 8, 640, 15     # 15 heads: no packed head grouping
K4_LENGTHS = [640, 320, 300, 640, 1, 639, 0, 64]
F32_FLOPS = 67e12                 # H100 SXM float32 FMA units (data sheet)


def bhtd_inputs(dtype, dev, b: int, tq: int, tk: int, h: int, seed: int):
    """q (B, H, Tq, D) and k, v (B, H, Tk, D) as strided views of packed
    (B, T, H D) projections, as the scoring path hands them over."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    xq = torch.randn((b, tq, h * D), generator=g, device=dev).to(dtype)
    xkv = torch.randn((b, tk, 2 * h * D), generator=g, device=dev).to(dtype)
    q = xq.view(b, tq, h, D).transpose(1, 2)
    k, v = (x.view(b, tk, h, D).transpose(1, 2)
            for x in xkv.chunk(2, dim=-1))
    return q, k, v


def bhtd_bytes_ops(b: int, tq: int, tk: int, h: int, lengths, causal: bool,
                   itemsize: int):
    """Bytes and FLOPs of one K4/K5 forward on these inputs: q read and o
    written once, key and value rows only below each length (a row of
    length 0 reads all Tk), no lse; the (query, key) pairs the causal and
    length masks leave (all Tk for a row of length 0), 2 products of 2 D
    FLOPs each."""
    row = h * D * itemsize
    kv_rows = sum(ln if ln >= 1 else tk for ln in lengths)
    nbytes = 2 * b * tq * row + 2 * kv_rows * row + b * 4 + h * 4

    def keys(r, ln):
        if ln < 1:
            return tk
        return min(r + 1, ln) if causal else min(ln, tk)

    pairs = h * sum(sum(keys(r, ln) for r in range(tq)) for ln in lengths)
    return nbytes, 2 * 2 * D * pairs


def phase_k45(dev):
    """K5 (the q-tiled forward) at the scoring shapes (B 8, 16 heads of
    64, Tq = Tk = 1750, lengths down to 0 and 1; and Tq 96 x Tk 256,
    non-causal) and K4 (the (B, H, T, D) full forward with lse) at B 8,
    T 640 with 15 heads (the odd-head case; phase_k45b holds it at the
    training call), against their plain versions, float32 and bfloat16,
    with ALiBi and without, at K3's tolerances (f32 1e-5 x max(1,
    max|ref|); bf16 o 1e-2 x max|ref| and element by element 2 ulps +
    1e-2 x rms, relative L2 1e-3; lse 1e-5 x max(1, max|ref|)); K5
    float32 at the scoring path's shape (B 64, T 1750, each long batch's
    lengths) and its time there beside the bound.  Then K5's float32
    time (the scoring path's type) at B 8 beside the plain version's,
    SDPA's with a float mask (forward) and the bound.  Returns K4's
    worst error and K5's entry."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    worst = {"K4": 0.0, "K5": 0.0}
    cases = (("K5", K5_B, K5_T, K5_T, H, K5_LENGTHS, True),
             ("K5", 3, 96, 256, H, [256, 0, 131], False),
             ("K4", K4_B, K4_T, K4_T, K4_H, K4_LENGTHS, True))
    for (name, b, tq, tk, h, lens, causal), dtype in itertools.product(
            cases, (torch.float32, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tk, h, seed=tq)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        slopes = -torch.tensor(alibi_slopes(h), device=dev)
        for sl in (slopes, None):
            where = (f"{name} B={b} Tq={tq} Tk={tk} H={h} {str(dtype)[6:]} "
                     f"causal={causal} alibi={sl is not None}")
            errs = []
            if name == "K5":
                got = fa.flash_forward_tiled(q, k, v, lengths, sl, causal)
                want = fa.flash_forward_tiled_plain(q, k, v, lengths, sl,
                                                    causal)
                pairs = [("o", got, want)]
            else:
                got, lse = fa.flash_forward_full(q, k, v, lengths, sl, causal,
                                                 with_stats=True)
                want, lse_ref = fa.flash_forward_full_plain(
                    q, k, v, lengths, sl, causal, with_stats=True)
                pairs = [("o", got, want), ("lse", lse, lse_ref)]
            torch.cuda.synchronize()
            for n, g_, r_ in pairs:
                tol = 1e-2 if bf16 and n == "o" else 1e-5
                floor = 0.0 if bf16 and n == "o" else 1.0
                err, text = hold(where, n, g_, r_, tol, floor, bf16)
                errs.append(text)
                if n == "o":
                    worst[name] = max(worst[name], err)
            log(f"{name} check {where}: max_abs_err " + ", ".join(errs))

    # The scoring path's K5 calls: float32, B 64, each long batch's padded
    # length and lengths, q/k/v the (B, H, T, D) views of one packed
    # projection that flash_attention_packed hands over; the plain
    # version in chunks of 8 rows.  The last batch's call is timed.
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    for bi, lens in enumerate(scoring_batches()[1:], 1):
        ts = max(lens)
        qp, kp, vp, _, lengths, _ = k3_inputs(torch.float32, dev, 10 + bi,
                                              SCORE_BATCH, ts, H, lens)
        q, k, v = (fa._heads(x, H) for x in (qp, kp, vp))

        def plain_s(i):
            return in_chunks(lambda s: fa.flash_forward_tiled_plain(
                q[s], k[s], v[s], lengths[s], slopes, True), SCORE_BATCH, 8)

        got = fa.flash_forward_tiled(q, k, v, lengths, slopes, True)
        want = plain_s(0)
        torch.cuda.synchronize()
        where = (f"K5 at the scoring shape, float32, batch {bi}, "
                 f"B={SCORE_BATCH}, T={ts}")
        err, text = hold(where, "o", got, want, 1e-5, 1.0, False)
        worst["K5"] = max(worst["K5"], err)
        log(f"K5 check B={SCORE_BATCH} Tq=Tk={ts} H={H} float32 causal=True "
            f"alibi=True (the scoring corpus's batch {bi}, lengths "
            f"{min(lens)}-{max(lens)}): max_abs_err {text}")
        del got, want
    ks = device_ms(lambda i: fa.flash_forward_tiled(q, k, v, lengths, slopes,
                                                    True), n=5,
                   only=("k5_fwd",), per_call=1)
    cs = cuda_ms(lambda i: fa.flash_forward_tiled(q, k, v, lengths, slopes,
                                                  True), n=5)
    ps = device_ms(plain_s, n=1)
    nbytes, flops = bhtd_bytes_ops(SCORE_BATCH, ts, ts, H, lens, True, 4)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS \
        else "operations"
    log(f"K5 time B={SCORE_BATCH} T={ts} H={H} float32 (the scoring path's "
        f"call, batch {bi}): kernel {ks:.4f} ms, {cs:.4f} ms per call with "
        f"the wrapper, plain {ps:.4f} ms (8-row chunks), bound {bound:.4f} "
        f"ms ({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the "
        f"float32 FMA rate)")
    del q, k, v, qp, kp, vp

    b, tq, h, lens = K5_B, K5_T, H, K5_LENGTHS
    fn, plain = fa.flash_forward_tiled, fa.flash_forward_tiled_plain
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):   # float32 last: the
        # plain version and SDPA below take its q, k, v
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tq, h, seed=1)
        times[dtype] = (
            device_ms(lambda i: fn(q, k, v, lengths, slopes, True), n=10,
                      only=("k5_fwd",), per_call=1),
            cuda_ms(lambda i: fn(q, k, v, lengths, slopes, True), n=10))
    kf, cf = times[torch.float32]
    pf = device_ms(lambda i: plain(q, k, v, lengths, slopes, True), n=2)
    mask = sdpa_mask(lengths, slopes, torch.float32, dev, tq, tq, True)

    def sdpa(i):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lf = device_ms(sdpa, n=5)
    del mask
    nbytes, flops = bhtd_bytes_ops(b, tq, tq, h, lens, True, 4)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = ("bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS
          else "operations")
    log(f"K5 time B={b} T={tq} H={h} float32: kernel {kf:.4f} ms, "
        f"{cf:.4f} ms per call with the wrapper, plain {pf:.4f} ms, SDPA "
        f"(float mask) forward {lf:.4f} ms, bound {bound:.4f} ms ({by}; "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the float32 "
        f"FMA rate); bf16 kernel {times[torch.bfloat16][0]:.4f} ms, "
        f"{times[torch.bfloat16][1]:.4f} ms with the wrapper")
    return worst["K4"], {
        "name": "flash_forward_tiled", "route": "cuda",
        "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vae_gslm_tpu/ops/flash_attention.py:443",
        "launches": None, "max_abs_err": worst["K5"], "ms": kf,
        "plain_ms": pf, "bound_ms": bound, "bound_by": by,
        "library_ms": lf}


# ----------------------------------------------------- small agreement
SMALL_YAML = """
tokens: {embedding_dim: 32, vocab_size: 50}
latent_dim: 4
encoder:
    identifier: BottleNeckResNet
    num_layers: 1
    init_channel: 32
    out_channels: [32]
    hidden_channels: [64]
    resample_rates: [1]
    resample_ksize: [1]
    final_norm: true
    layer:
        kernel_size: 7
        causal_padding: true
        norm: {identifier: InstanceNorm, eps: 1.0e-6}
        activation: {identifier: ReLU}
transformer:
    num_layers: 2
    bias: false
    rpe: {identifier: ALiBi, maxpos: 1024}
    layer:
        dim: 128
        ffd_size: 512
        norm: {identifier: RMSNorm, eps: 1.0e-6}
        activation: {identifier: GELU}
        self_attn: {nheads: 2, causal: true}
    flow:
        num_layers: 2
        conditional: true
        layer:
            hidden_dim: 16
            mean_only: false
            scale_range: [0.5, 2.0]
            activation: {identifier: GELU}
            norm: {identifier: LayerNorm, eps: 1.0e-6}
decoder:
    diffusion:
        identifier: ConditionalBottleNeckUNet
        timesteps: 50
        beta_schedule: {identifier: cosine}
        objective: pred_noise
        input_scale: 5.0
        clamp_range: [-3.0, 1.2]
        sampling_timesteps: 5
        ddim_sampling_eta: 0.0
    cond_unet:
        unet:
            condition_dim: 16
            num_layers: 2
            init_channel: 32
            out_channels: [32, 32]
            hidden_channels: [64, 64]
            resample_rates: [1, 1]
            resample_ksize: [1, 1]
            conditional: [false, true]
            skip_connection: [null, 0]
            connection_type: concat
            final_norm: true
            layer:
                kernel_size: 7
                causal_padding: true
                condition_type: concat
                norm: {identifier: InstanceNorm, eps: 1.0e-6}
                activation: {identifier: SiLU}
        time_embedding:
            dim: 32
            maxpos: 50
            activation: {identifier: SiLU}
"""


def small_hparams(mega: bool):
    """SMALL_YAML; for the mega path widened to K2's smallest width (dim
    256, 4 heads of 64, ffd 1024)."""
    from vae_gslm_tpu_torch.hparams.hp import Hparams

    d = Hparams.from_yaml(SMALL_YAML).to_dict()
    if mega:
        d["transformer"]["layer"].update(dim=256, ffd_size=1024)
        d["transformer"]["layer"]["self_attn"]["nheads"] = 4
    return Hparams.from_dict(d)


def phase_small(dev, quantize: bool, w4: int = 0, per_layer: str = ""):
    """A small LVTR continues a prompt by 300 frames on the card (through
    the kernels) and on the CPU (through the plain versions), float32,
    temperature 0: bf16 weights through K1, or int8 weights through K2
    (a8 at B = 2) across eight-step merges and two tail -> cold flushes,
    or with ``w4`` nibble-packed int4 weights of that scale group through
    K2-w4 (exactly 300 K2-w4 launches and no other K2 on the card).  With
    ``per_layer`` the int8-weight model (dim 256) at B = 72, past the mega
    batches, on the per-layer route: "int8" (an int8 cache through
    ``decode_attention``, no kernel), "k6" (the same through K6: exactly
    600 launches on the card) or "float" (``kv_dtype`` None: a float32
    cache, no kernel); no K1 or K2 launch."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step

    quantize = quantize or bool(per_layer)
    rng = np.random.RandomState(1)
    b, tp, length = (72 if per_layer else 2), 20, 300
    prompt = np.concatenate([rng.randint(0, 50, (b, tp, 1)),
                             rng.randn(b, tp, 80)], -1).astype(np.float32)
    # the CPU and the card draw different streams from one seed, so the
    # uniform initial AR state is pinned on both, as the tests pin it
    init = torch.from_numpy(rng.rand(b, 1, 32).astype(np.float32) * 2 - 1)
    route = ("per_layer" if per_layer else "mega" if quantize
             else "hybrid")
    runs = {}
    for where in ("cpu", dev):
        model = LVTR(small_hparams(quantize), input_dim=80, device=where,
                     generator=torch.Generator("cpu").manual_seed(3)
                     if where == "cpu" else None)
        model.initial_state = (
            lambda generator, bsize, nfeat=None, where=where: init.to(where))
        if where == "cpu":      # float weights; each side quantizes its own
            runs["cpu_state"] = {k: v.clone()
                                 for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(runs["cpu_state"])
        sampler = ARTRSampler(
            model, kv_dtype=None if per_layer == "float" else torch.int8,
            quantize_weights=quantize, device=where, mega_w4=w4,
            flash_decode=per_layer == "k6")
        if sampler.route(b) != route:
            raise AssertionError(f"the small model took the "
                                 f"{sampler.route(b)} route, not {route}")
        x = torch.from_numpy(prompt).to(where)
        fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
        fused_decode_attention.launches = flash_decode_int8.launches = 0
        out = sampler(length, Masked.from_lengths(x, [tp] * b),
                      torch.Generator(where).manual_seed(0),
                      temperature=0.0, token_temperature=1e-6,
                      encoder_temperature=0.0)
        counts = (fused_decode_attention.launches, fused_trunk_step.launches,
                  fused_trunk_step.launches_w4, flash_decode_int8.launches)
        want = None
        if w4:
            want = (0, 0, length, 0)
        elif per_layer:
            want = (0, 0, 0, 2 * length if per_layer == "k6" else 0)
        if want and str(where) != "cpu" and counts != want:
            raise AssertionError(f"K1 / K2 / K2-w4 / K6 launches {counts}, "
                                 f"expected {want}")
        runs[str(where)] = out["frames"].value.float().cpu().numpy()
    cpu, gpu = runs["cpu"][:, tp:], runs[str(dev)][:, tp:]
    neq = (cpu[..., 0] != gpu[..., 0]).any(0)
    first = int(neq.argmax()) if neq.any() else length
    lat_err = float(np.abs(cpu[:, :64, 1:] - gpu[:, :64, 1:]).max())
    what = (f"int4 weights (group {w4}) through K2-w4" if w4
            else {"int8": "per-layer int8 cache through decode_attention",
                  "k6": "per-layer int8 cache through K6",
                  "float": "per-layer float32 cache"}[per_layer]
            if per_layer else "int8 weights through K2" if quantize
            else "bf16 through K1")
    log(f"small-input agreement (card {what} vs CPU plain, B={b}, {length} "
        f"steps): tokens equal for the first {first} steps, first-64-step "
        f"latent max error {lat_err:.2e}")
    if first < 150 or not lat_err < 1e-2:
        raise AssertionError("the card and the CPU disagree on a small "
                             "input")


# ------------------------------------------------------------ training
VOCODER_YAML = os.path.join(ROOT, "configs", "train", "vocoder",
                            "hfgan_16k_50hz_librispeech.yaml")
TRAIN_YAML = os.path.join(ROOT, "configs", "train", "speech",
                          "vae-gslm.yaml")
TRAIN_T, TRAIN_B, TRAIN_ACCUM = 640, 8, 2
TRAIN_LENGTHS = [640] * 6 + [400, 520]


def vocoder_dir(tmp: str) -> str:
    """A vocoder directory holding the 80-bin vocoder config as
    ``hp.yaml``: the trainer reads the model's mel width from it."""
    import shutil

    shutil.copy(VOCODER_YAML, os.path.join(tmp, "hp.yaml"))
    return tmp


def train_batches(rng, b: int, t: int, lengths, t_utt: int, vocab: int):
    """Two synthetic micro-batches stacked on the accumulation axis:
    [token, 80-bin mel] frames of the given lengths and utterance mel
    crops of 50 %-100 % of ``t_utt`` frames (numpy draws)."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.training.trainer import stack_batches

    mbs = []
    for _ in range(TRAIN_ACCUM):
        ln = torch.tensor(lengths, dtype=torch.int32)
        utt = torch.from_numpy(rng.randint(t_utt // 2, t_utt + 1, b)
                               .astype(np.int32))
        mbs.append({
            "mel": Masked(torch.from_numpy(
                rng.randn(b, t, 80).astype(np.float32)), ln),
            "tokens": Masked(torch.from_numpy(
                rng.randint(0, vocab, (b, t)).astype(np.int32)), ln),
            "cropped_mel_utt": Masked(torch.from_numpy(
                rng.randn(b, t_utt, 80).astype(np.float32)), utt)})
    return stack_batches(mbs)


def train_draws(rng, b: int, t: int, latent: int, nfeat: int, steps: int):
    """One micro-batch's random draws of ``LVTR.forward`` (numpy), so that
    the card and the CPU take the same ones."""
    import numpy as np
    import torch

    f = (lambda a: torch.from_numpy(a.astype(np.float32)))
    return {"posterior": f(rng.randn(b, t, latent)),
            "initial": f(rng.uniform(-1, 1, (b, 1, nfeat))),
            "prior": f(rng.randn(b, t, latent)),
            "t": torch.from_numpy(rng.randint(0, steps, b)),
            "noise": f(rng.randn(b, t, 80))}


def small_train_hparams(vdir: str):
    """SMALL_YAML's LVTR (dim 128, two heads of 64: the kernels' head_dim)
    with a two-layer strided utterance encoder, under the flagship's
    training block with float32 compute, clipping and accumulation 2."""
    import yaml

    from vae_gslm_tpu_torch.hparams.hp import Hparams

    with open(TRAIN_YAML) as f:
        cfg = yaml.safe_load(f)
    model = yaml.safe_load(SMALL_YAML)
    model["utterance_encoder"] = {
        "embedding_dim": 16, "num_layers": 2, "init_channel": 16,
        "out_channels": [16, 32], "resample_rates": [-2, -2],
        "resample_ksize": [4, 4],
        "layer": cfg["model"]["utterance_encoder"]["layer"]}
    cfg["model"] = model
    cfg["vocoder"]["path"] = vdir
    cfg["trainer"]["precision"] = "32"
    cfg["training"]["gradient_clip_val"] = 1.0
    return Hparams.from_dict(cfg)


def phase_train_small(dev):
    """One optimizer step (accumulation 2) of a small LVTR on the card
    (K3/K3b) and on the CPU (plain versions) from the same weights,
    batch and draws, float32: loss terms within 1e-4 relative, every
    gradient leaf within 1e-3 x its max |g|."""
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.ops.flash_attention import (
        flash_backward_packed, flash_forward_packed)
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    b, t = 3, 100
    with tempfile.TemporaryDirectory() as tmp:
        hp = small_train_hparams(vocoder_dir(tmp))
        cpu = LVTRTrainer(hp, seed=3, device="cpu")
        gpu = LVTRTrainer(small_train_hparams(tmp), seed=3, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.RandomState(2)
    batch = train_batches(rng, b, t, [100, 61, 1], 40, 50)
    draws = [train_draws(rng, b, t, 4, 32, cpu.model.decoder.num_timesteps)
             for _ in range(TRAIN_ACCUM)]
    cpu.global_step = gpu.global_step = 40000    # past the KLD warm-up
    want = cpu.run_step(batch, draws=draws)
    flash_forward_packed.launches = flash_backward_packed.launches = 0
    got = gpu.run_step(batch, draws=draws)
    torch.cuda.synchronize()
    launches = (flash_forward_packed.launches, flash_backward_packed.launches)
    n_layers = len(gpu.model.transformer.layers)
    if launches != (n_layers * TRAIN_ACCUM,) * 2:
        raise AssertionError(f"small step: K3/K3b launches {launches}")
    worst_m = 0.0
    for k in ("rec_loss", "kld", "token_kld", "log_p", "log_q"):
        g, w = float(got[k]), float(want[k])
        worst_m = max(worst_m, abs(g - w) / max(abs(w), 1e-12))
    worst_g = 0.0
    for name, pg, pc in zip(gpu.names, gpu.params, cpu.params):
        gg, gc = pg.grad.double().cpu(), pc.grad.double()
        err = (gg - gc).abs().max().item()
        scale = gc.abs().max().item()
        if not err <= 1e-3 * scale + 1e-30:
            raise AssertionError(f"small step: gradient of {name} differs "
                                 f"by {err:.3e} (max |g| {scale:.3e})")
        worst_g = max(worst_g, err / max(scale, 1e-30))
    log(f"small train step (card K3/K3b vs CPU plain, accumulation 2, "
        f"float32): loss terms max rel err {worst_m:.2e}, gradients max "
        f"err {worst_g:.2e} x max|g| over {len(gpu.params)} leaves; "
        f"K3/K3b launches {launches}")
    if not worst_m <= 1e-4:
        raise AssertionError("small step: the card's loss differs from "
                             "the CPU's")


def phase_train(dev, gpu: str, seed: int = 0):
    """The full-width LVTR training step of ``configs/train/speech/
    vae-gslm.yaml`` (16-mixed, AdamW, accumulation 2, utterance encoder):
    one warm-up and five timed ``run_step`` calls on synthetic B = 8 x 640
    batches, each with the kernels' counts set to 0 just before and read
    just after (exactly 32 K3 and 32 K3b launches; the plain attention
    versions and the dense ``attend`` raise if reached); then one
    profiled step.  Returns the K3 and K3b counts of the last step."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    with tempfile.TemporaryDirectory() as tmp:
        hp = Hparams.from_yamlfile(TRAIN_YAML)
        hp.vocoder.path = vocoder_dir(tmp)
        t0 = time.perf_counter()
        trainer = LVTRTrainer(hp, seed=seed, device=dev)
    nparams = sum(p.numel() for p in trainer.params)
    torch.cuda.synchronize()
    log(f"train: LVTR {nparams / 1e6:.1f} M parameters (float32, bf16 "
        f"compute, utterance encoder on) and AdamW state built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    batch = trainer.prepare_batch(train_batches(
        rng, TRAIN_B, TRAIN_T, TRAIN_LENGTHS, 200,
        hp.model.tokens.vocab_size))
    tokens = TRAIN_B * TRAIN_ACCUM * TRAIN_T
    want = 16 * TRAIN_ACCUM

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"the training path reached {what} on "
                                 "the card")
        return fn

    saved = (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
             attn_mod.attend)
    fa.flash_forward_packed_plain = refuse("the plain K3")
    fa.flash_backward_packed_plain = refuse("the plain K3b")
    attn_mod.attend = refuse("the dense attention")
    opt_step, opt_s = trainer.opt.step, []

    def timed_opt_step(grads):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_step(grads)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t1)

    trainer.opt.step = timed_opt_step
    watch = {n: p for n, p in zip(trainer.names, trainer.params)
             if n in ("transformer.layers.0.self_attn.in_proj.weight",
                      "transformer.layers.15.linear2.weight",
                      "encoder_net.layers.0.conv1.weight",
                      "utterance_net.layers.0.conv.weight",
                      "decoder.model.unet.layers.5.conv2.weight")}
    before = {n: p.detach().clone() for n, p in watch.items()}
    steps, counts = [], None
    try:
        torch.cuda.reset_peak_memory_stats()
        for i in range(6):
            fa.flash_forward_packed.launches = 0
            fa.flash_backward_packed.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = trainer.run_step(batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            counts = (fa.flash_forward_packed.launches,
                      fa.flash_backward_packed.launches)
            trainer.global_step += 1
            loss_terms = {k: float(metrics[k]) for k in
                          ("rec_loss", "kld", "token_kld", "grad_norm")}
            log(f"train step {i}{' (warm-up)' if i == 0 else ''}: "
                f"{sec * 1e3:.1f} ms, optimizer {opt_s[-1] * 1e3:.1f} ms; "
                f"K3 {counts[0]}, K3b {counts[1]} launches; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in loss_terms.items()))
            if counts != (want, want):
                raise AssertionError(f"K3/K3b launches {counts} per step, "
                                     f"expected ({want}, {want})")
            if not all(math.isfinite(v) for v in loss_terms.values()):
                raise AssertionError(f"non-finite training metrics "
                                     f"{loss_terms}")
            if i:
                steps.append(sec)
        peak = torch.cuda.max_memory_allocated()
        moved = {n: (watch[n].detach() - before[n]).abs().max().item()
                 for n in watch}
        if len(watch) != 5 or not all(v > 0 for v in moved.values()):
            raise AssertionError(f"parameters did not move: {moved}")
        s = sorted(steps)
        med = statistics.median(s)
        opt_med = statistics.median(opt_s[1:])
        log(f"train step B={TRAIN_B} x accumulation {TRAIN_ACCUM} x "
            f"T={TRAIN_T} (16-mixed): median {med * 1e3:.1f} ms, range "
            f"{s[0] * 1e3:.1f}-{s[-1] * 1e3:.1f} ms over {len(s)} steps; "
            f"{tokens / med:.0f} tokens/s; forward+backward "
            f"{(med - opt_med) * 1e3:.1f} ms, optimizer {opt_med * 1e3:.1f} "
            f"ms; peak memory {peak / 2 ** 30:.2f} GiB ({gpu})")
        # model FLOPs: 6 per parameter per frame for the weights the
        # frames pass through (the utterance encoder's strided crops
        # counted as full frames: an overestimate of <1 %), plus causal
        # attention's 3 x 2 products of 2 D FLOPs per (query, key) pair
        # of every layer and head
        pairs = sum(sum(min(r + 1, ln) for r in range(TRAIN_T))
                    for ln in TRAIN_LENGTHS) * TRAIN_ACCUM * L * H
        flops = 6 * nparams * tokens + 3 * 2 * 2 * D * pairs
        rate = flops / med
        log(f"train model FLOPs per step ~{flops / 1e12:.1f} TFLOP: "
            f"{rate / 1e12:.1f} TFLOP/s, MFU {rate / BF16_FLOPS:.1%} of the "
            f"bf16 dense peak ({gpu})")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.run_step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        trainer.global_step += 1
    finally:
        (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
         attn_mod.attend) = saved
        trainer.opt.step = opt_step
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    if not kernels:
        log("train step profile: device time not measured (the profiler "
            "recorded no kernel)")
        return counts
    busy = sum(k[0] for k in kernels)
    attn = sum(k[0] for k in kernels if any(s in k[2] for s in K3_KERNELS))
    h2d = sum(k[1] for k in kernels if "HtoD" in k[2])
    log(f"train step profile (profiler on): wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({busy / wall_ms:.1%}), K3+K3b {attn:.1f} ms "
        f"({attn / busy:.1%} of busy), {sum(k[1] for k in kernels)} device "
        f"ops of which {h2d} host-to-device copies ({gpu})")
    for ms, n, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:.3f} ms, {n}x: {name[:90]}")
    return counts


# --------------------------------------------------------- main paths
def build_pipeline(dev, quantize: bool, kv_dtype="int8"):
    """The full-width LVTR of ``configs/train/speech/vae-gslm.yaml``
    (weights from seed 0, the utterance encoder left out), its sampler
    with an int8 KV cache (``kv_dtype`` None: a cache in the compute
    dtype, bf16), and the HiFi-GAN.  With ``quantize`` the trunk is
    quantized to int8 from the float32 weights; the remaining float
    parameters are then cast to bf16."""
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator

    precision.set_policy(precision.bf16_mixed())
    hp = Hparams.from_yamlfile(os.path.join(
        ROOT, "configs", "train", "speech", "vae-gslm.yaml"))
    del hp.model.__dict__["utterance_encoder"]
    voc_hp = Hparams.from_yamlfile(os.path.join(
        ROOT, "configs", "train", "vocoder",
        "hfgan_16k_50hz_librispeech.yaml"))
    t0 = time.perf_counter()
    model = LVTR(hp.model, input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(0))
    model.decoder.override_sampling(sampling_timesteps=100,
                                    ddim_sampling_eta=0.5)
    sampler = ARTRSampler(model, kv_dtype=kv_dtype and torch.int8,
                          quantize_weights=quantize, device=dev)
    if sampler.use_mega != (quantize and kv_dtype == "int8"):
        raise AssertionError("the int8-weight trunk missed the mega path")
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    vocoder = Generator(voc_hp.model.generator, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"pipeline: LVTR {nparams / 1e6:.1f} M parameters "
        f"({'int8 trunk, ' if quantize else ''}bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    return sampler, vocoder


def make_prior(batch: int, dev):
    """Synthetic 150-frame prompts ([token, mel] frames), as bench.py
    makes them."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked

    rng = np.random.RandomState(0)
    toks = rng.randint(0, 200, (batch, PROMPT, 1)).astype(np.float32)
    mel = (rng.randn(batch, PROMPT, 80) * 0.5 - 1.0).astype(np.float32)
    return Masked.from_lengths(
        torch.from_numpy(np.concatenate([toks, mel], -1)).to(dev),
        [PROMPT] * batch)


def run_once(sampler, vocoder, prior, dev, seed: int, kw: dict):
    """One continuation and its vocoding with the decode kernels' counts
    set to 0 just before and read just after.  Returns (stage seconds,
    (K1, K2, K6) launches, the sampler's outputs)."""
    import torch

    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step

    batch = prior.value.shape[0]
    fused_decode_attention.launches = 0
    fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
    flash_decode_int8.launches = 0
    timings = {}
    out = sampler(LENGTH, prior, torch.Generator(dev).manual_seed(seed),
                  timings=timings, **kw)
    t0 = time.perf_counter()
    wave = vocoder(out["output"])
    torch.cuda.synchronize()
    timings["vocoder"] = time.perf_counter() - t0
    counts = (fused_decode_attention.launches,
              fused_trunk_step.launches + fused_trunk_step.launches_w4,
              flash_decode_int8.launches)
    check_outputs(out, wave, batch)
    return timings, counts, out


def phase_pipeline(dev, gpu: str, quantize: bool):
    """The 3 s -> 10 s continuation at B = 8, once: bf16 weights through
    K1 (16 x 500 launches, no K2) or int8 weights through K2 (500
    launches, a8, no K1).  Then a profile of 64 AR steps.  Returns the
    path's kernel count."""
    import torch

    path = "int8 weights, K2" if quantize else "bf16 weights, K1"
    sampler, vocoder = build_pipeline(dev, quantize)
    prior = make_prior(8, dev)
    kw = dict(temperature=0.85, token_temperature=0.85)
    want = (0, LENGTH, 0) if quantize else (L * LENGTH, 0, 0)

    # warm-up (allocator, cuBLAS/cuDNN handles, lazily loaded kernels) on
    # a short continuation and its vocoding
    vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                    **kw)["output"])
    torch.cuda.synchronize()
    timings, counts, _ = run_once(sampler, vocoder, prior, dev, 1, kw)
    if counts != want:
        raise AssertionError(f"launches (K1, K2, K6) = {counts}, expected "
                             f"{want}")
    audio_s = 8 * LENGTH / 50.0
    log(f"pipeline B=8 ({path}): K1 launches {counts[0]}, K2 launches "
        f"{counts[1]}; " + ", ".join(
            f"{name} {sec * 1e3:.1f} ms" for name, sec in timings.items())
        + f"; {audio_s:.0f} s of audio, real-time factor "
        f"{audio_s / sum(timings.values()):.2f}x ({gpu})")
    profile_ar_loop(sampler, prior, dev, gpu, kw, path)
    return counts[1] if quantize else counts[0]


PL_B = 128                          # past the mega batches: per layer


def phase_per_layer(dev, gpu: str) -> int:
    """The per-layer serving paths at full width, B = 128 synthetic
    150-frame prompts, 500 AR steps, DDIM-100, HiFi-GAN, each run with
    the decode kernels' counts set to 0 just before and read just after:
    int8 weights and an int8 cache through JAX's route
    (``decode_attention``; no K1, K2 or K6 launch), then the same prompts
    and seed with ``flash_decode=True`` (exactly 16 x 500 K6 launches and
    no K1 or K2); the two routes' token agreement and latent difference
    (reported, not gated); then bf16 weights with a bf16 cache
    (``kv_dtype`` None; no kernel launch on the AR loop).  Real-time
    factor, stage times, peak memory and ms per AR step of each, and a
    profile of 32 AR steps of the two int8 routes.  Returns the K6
    launches."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler

    kw = dict(temperature=0.85, token_temperature=0.85)
    prior = make_prior(PL_B, dev)
    audio_s = PL_B * LENGTH / 50.0

    def run(name, sampler, vocoder, want):
        if sampler.route(PL_B) != "per_layer":
            raise AssertionError(f"{name}: route {sampler.route(PL_B)}")
        vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                        **kw)["output"])                # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timings, counts, out = run_once(sampler, vocoder, prior, dev, 1, kw)
        peak = torch.cuda.max_memory_allocated()
        if counts != want:
            raise AssertionError(f"{name}: launches (K1, K2, K6) = {counts}"
                                 f", expected {want}")
        log(f"per-layer B={PL_B} ({name}): K1 {counts[0]}, K2 {counts[1]}, "
            f"K6 {counts[2]} launches; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; {timings['ar_loop'] / LENGTH * 1e3:.2f} ms per AR step; "
            f"real-time factor {audio_s / sum(timings.values()):.2f}x; peak "
            f"memory {peak / 2 ** 30:.2f} GiB ({gpu})")
        return out["frames"].value[:, PROMPT:].float().cpu().numpy(), counts

    sampler, vocoder = build_pipeline(dev, quantize=True)
    k6_sampler = ARTRSampler(sampler.model, kv_dtype=torch.int8,
                             flash_decode=True, device=dev)
    ref, _ = run("int8 weights, int8 cache, JAX's route", sampler, vocoder,
                 (0, 0, 0))
    got, counts = run("int8 weights, int8 cache, K6", k6_sampler, vocoder,
                      (0, 0, L * LENGTH))
    same = float((ref[..., 0] == got[..., 0]).mean())
    log(f"per-layer B={PL_B}: K6 route against JAX's route, same prompts and "
        f"seed: tokens equal at {same:.1%} of the steps, latent max |diff| "
        f"{float(np.abs(ref[..., 1:] - got[..., 1:]).max()):.3e} (reported, "
        f"not gated: K6 does not quantize q)")
    for s, path in ((sampler, "per-layer int8, JAX's route"),
                    (k6_sampler, "per-layer int8, K6")):
        profile_ar_loop(s, prior, dev, gpu, kw, path, steps=32)
    del sampler, k6_sampler, vocoder
    gc.collect()
    sampler, vocoder = build_pipeline(dev, quantize=False, kv_dtype=None)
    run("bf16 weights, bf16 cache", sampler, vocoder, (0, 0, 0))
    del sampler, vocoder
    gc.collect()
    return counts[2]


def check_outputs(out, wave, batch: int) -> None:
    """Shapes, finiteness and token ids of one continuation."""
    import torch

    frames = out["frames"].value
    mel_out = out["output"].value
    w = wave.value
    if tuple(w.shape) != (batch, (PROMPT + LENGTH) * 320):
        raise AssertionError(f"wave shape {tuple(w.shape)}")
    if tuple(mel_out.shape) != (batch, PROMPT + LENGTH, 80):
        raise AssertionError(f"mel shape {tuple(mel_out.shape)}")
    toks_out = frames[:, PROMPT:, 0]
    if not (bool(torch.isfinite(w).all()) and bool(torch.isfinite(
            mel_out).all()) and bool(torch.isfinite(frames).all())):
        raise AssertionError("non-finite output")
    if not bool(((toks_out >= 0) & (toks_out < 200)
                 & (toks_out == toks_out.round())).all()):
        raise AssertionError("generated token ids outside the vocabulary")


def profile_ar_loop(sampler, prior, dev, gpu: str, kw: dict, path: str,
                    steps: int = 64) -> None:
    """Where the AR loop's time goes: the device busy share over
    ``steps`` steps and the kernels that take it (torch.profiler's CUDA
    activity; host clock around the loop, the profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.inference.speech.sampler import (
        hybrid_scan_segments, mega_scan_segments)

    model = sampler.model
    batch = prior.value.shape[0]
    route = sampler.route(batch)
    g = torch.Generator(dev).manual_seed(2)
    with torch.no_grad():
        enc = model.encode(prior, g)
        pos0 = enc.value.shape[1] + 1
        if route == "per_layer":
            frame, caches = sampler.prefill_per_layer(enc, steps, g, **kw)

            def run():
                sampler.per_layer_scan(frame, caches, pos0, steps, g, **kw)
        else:
            stacked = model.transformer.build_stacked_decode()
            frame, cache, flushed = sampler.prefill(
                enc, steps, stacked, g, mega=route == "mega", **kw)
        if route == "mega":
            weights = model.transformer.build_mega_decode()

            def run():
                mega_scan_segments(frame, cache, flushed, pos0, steps,
                                   lambda fr, c, p, f: model.step_mega(
                                       fr, weights, c, p, f, g, **kw))
        elif route == "hybrid":
            def run():
                hybrid_scan_segments(model, frame, cache, flushed, pos0,
                                     steps, lambda fr, c, p, f:
                                     model.step_hybrid(fr, stacked, c, p, f,
                                                       g, **kw))

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [(e.self_device_time_total / 1e3 / steps, e.count / steps,
                e.key) for e in prof.key_averages()
               if e.self_device_time_total > 0]
    if not kernels:
        log(f"AR loop profile ({path}): device time not measured (the "
            "profiler recorded no kernel)")
        return
    busy_ms = sum(k[0] for k in kernels)
    log(f"AR loop profile ({path}), {steps} steps at B={batch} (profiler "
        f"on): "
        f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({busy_ms / wall_ms:.1%}), {sum(k[1] for k in kernels):.0f} "
        f"device ops/step ({gpu})")
    for ms, n, name in sorted(kernels, reverse=True)[:8]:
        log(f"  {ms:.4f} ms/step, {n:.0f}/step: {name[:90]}")


# ------------------------------------------------------------- scoring
def phase_likelihood_small(dev) -> int:
    """``LVTR.likelihood`` of a small float32 LVTR with an unpackable head
    layout (dim 192, three heads of 64, 2 layers, tokens + flow) on the
    card (through the kernels) and on the CPU (through the plain
    versions), same weights, batch and pinned initial state: at T = 300
    (K4 in both layers, no K3/K5) and T = 1100 (K5), scores to 1e-4
    relative.  Returns the K4 launches of the T = 300 run."""
    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    d = yaml.safe_load(SMALL_YAML)
    d["transformer"]["layer"].update(dim=192, ffd_size=768)
    d["transformer"]["layer"]["self_attn"]["nheads"] = 3
    d["transformer"]["rpe"]["maxpos"] = 2048
    hp = Hparams.from_dict(d)
    rng = np.random.RandomState(4)
    k4_launches = None
    with precision.policy_scope(precision.Policy()):
        cpu = LVTR(hp, input_dim=80, device="cpu",
                   generator=torch.Generator("cpu").manual_seed(5))
        gpu = LVTR(hp, input_dim=80, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        for t, lens, want in ((300, [300, 1, 211], (0, 2, 0)),
                              (1100, [1100, 1030, 2], (0, 0, 2))):
            b = len(lens)
            x = np.concatenate([rng.randint(0, 50, (b, t, 1)),
                                rng.randn(b, t, 80)], -1).astype(np.float32)
            init = torch.from_numpy(
                (rng.rand(b, 1, 32) * 2 - 1).astype(np.float32))
            scores = []
            for model, where in ((cpu, "cpu"), (gpu, dev)):
                model.initial_state = (lambda generator, bsize, nfeat=None,
                                       where=where: init.to(where))
                xm = Masked.from_lengths(torch.from_numpy(x).to(where), lens)
                fa.flash_forward_packed.launches = 0
                fa.flash_forward_full.launches = 0
                fa.flash_forward_tiled.launches = 0
                with torch.no_grad():
                    scores.append(model.likelihood(xm, None).cpu().double())
                counts = (fa.flash_forward_packed.launches,
                          fa.flash_forward_full.launches,
                          fa.flash_forward_tiled.launches)
            torch.cuda.synchronize()
            rel = ((scores[1] - scores[0]).abs()
                   / scores[0].abs().clamp_min(1e-12)).max().item()
            log(f"small likelihood (dim 192, 3 heads, card vs CPU plain, "
                f"float32) T={t}: scores {scores[1].tolist()}, max rel err "
                f"{rel:.2e}; card launches (K3, K4, K5) {counts}")
            if counts != want:
                raise AssertionError(f"small likelihood T={t}: launches "
                                     f"(K3, K4, K5) {counts}, expected "
                                     f"{want}")
            if not rel <= 1e-4 or not bool(torch.isfinite(scores[1]).all()):
                raise AssertionError(f"small likelihood T={t}: the card and "
                                     "the CPU disagree")
            if t == 300:
                k4_launches = counts[1]
    return k4_launches


SCORE_SHORT, SCORE_LONG = 64, 128   # utterances of 5-20 s, then 5-35 s
SCORE_BATCH = 64                    # the infer config's batch_size


def scoring_frames(rng):
    """The synthetic corpus's lengths in 50 Hz frames, drawn uniformly
    (a length mix made to run both attention routes, not a measured
    corpus's): 64 of 250-1000 (5-20 s), then 128 of 250-1750 (5-35 s),
    each long batch holding one of exactly 1750."""
    import numpy as np

    frames = np.concatenate([rng.randint(250, 1001, SCORE_SHORT),
                             rng.randint(250, 1751, SCORE_LONG)])
    frames[SCORE_SHORT] = frames[SCORE_SHORT + SCORE_BATCH] = 1750
    return frames


def scoring_batches(seed: int = 0):
    """The frame lengths of each batch the scoring path reads from the
    corpus of ``seed`` (sequential sampler, no utterance filtered out)."""
    import numpy as np

    frames = [int(f) for f in scoring_frames(np.random.RandomState(seed))]
    return [frames[i:i + SCORE_BATCH]
            for i in range(0, len(frames), SCORE_BATCH)]


def write_scoring_corpus(root: str, seed: int = 0) -> float:
    """192 WAVs (16 kHz, 16-bit) from ``seed`` and a ``tokens.txt`` of
    random token ids at 50 Hz, of the lengths ``scoring_frames`` draws.
    Every duration is a whole number of 20 ms frames, so an utterance's
    mel frames equal its tokens.  Returns the seconds of audio."""
    import numpy as np

    from vae_gslm_tpu_torch.data import audio

    rng = np.random.RandomState(seed)
    frames = scoring_frames(rng)
    lines = []
    for i, nf in enumerate(frames):
        n = int(nf) * 320
        t = np.arange(n, dtype=np.float32) / 16000.0
        f0 = rng.uniform(90, 250)
        wave = sum(rng.uniform(0.02, 0.1) / h
                   * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3))
                   for h in range(1, 6))
        wave = (wave * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
                + 0.01 * rng.randn(n)).astype(np.float32)
        name = f"utt{i:03d}.wav"
        audio.save_wav(os.path.join(root, name), wave, 16000)
        lines.append(f"{name}|{' '.join(map(str, rng.randint(0, 200, nf)))}")
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return float(frames.sum()) / 50.0


SCORE_INFER_YAML = """
identifier: "inference.speech.likelihood.LikelihoodEstimator"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.lvtr.LVTR"}}
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 64
    num_workers: 8
    min_audio_length: 5.0
    bits_per_second: 32000
    pad: {{multiple_of: 320, mode: "constant"}}
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
"""


def write_flagship(root: str, dev, seed: int = 0):
    """The checkpoint directory of the full-width LVTR of
    ``configs/train/speech/vae-gslm.yaml`` with its utterance encoder
    (weights from ``seed``, float32, saved by the port's ``save_compact``
    with the train config as ``hp.yaml``) and a HiFi-GAN directory of
    the 80-bin vocoder config (weights from seed 1, ``save_pretrained``),
    written once under ``root`` for the scoring and the CLI phases.
    Returns (checkpoint directory, vocoder directory)."""
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.training.checkpoint import save_compact

    ckpt, voc = os.path.join(root, "ckpt"), os.path.join(root, "voc")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
            generator=torch.Generator(dev).manual_seed(1)
            ).save_pretrained(voc)
    hp = Hparams.from_yamlfile(TRAIN_YAML)
    hp.vocoder.path = voc
    model = LVTR(hp.model, input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(seed))
    nparams = sum(p.numel() for p in model.parameters())
    save_compact(model, os.path.join(ckpt, "last-cpt.npz"))
    hp.save(os.path.join(ckpt, "hp.yaml"))
    del model
    log(f"flagship: LVTR {nparams / 1e6:.1f} M parameters (with the "
        f"utterance encoder) saved with save_compact, and the vocoder, in "
        f"{time.perf_counter() - t0:.1f} s")
    return ckpt, voc


def phase_score(dev, gpu: str, ckpt: str, seed: int = 0) -> int:
    """The scoring path at full width: ``LikelihoodEstimator`` on the
    flagship checkpoint directory (``write_flagship``: the LVTR of
    ``configs/train/speech/vae-gslm.yaml``, weights from seed 0, and the
    80-bin vocoder directory), over a synthetic
    corpus of 192 WAVs with the infer config's data settings (batch 64,
    ``min_audio_length`` 5.0, padding to a multiple of 320 samples;
    ``bits_per_second`` 32000, the rate of 16-bit 16 kHz WAV), float32
    with TF32 off.  One warm-up batch, then the whole corpus with the
    kernels' counts set to 0 just before each batch and read just after:
    exactly 16 K3 launches per batch padded to <= 1024 frames, exactly
    16 K5 launches per batch past it, no K4 launch and no plain version
    (both refused); finite scores, all <= 0.  Then one profiled batch
    past 1024 frames.  Returns the K5 launches of the scored corpus."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.likelihood import \
        LikelihoodEstimator
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    tmp = tempfile.mkdtemp(prefix="score_")
    saved = (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
             fa.flash_forward_full_plain, fa.flash_forward_full,
             fa.attention_reference, attn_mod.attend)

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"the scoring path reached {what} on the "
                                 "card")
        return fn

    try:
        with precision.policy_scope(precision.Policy()):
            corpus = os.path.join(tmp, "corpus")
            os.makedirs(corpus)
            t0 = time.perf_counter()
            audio_s = write_scoring_corpus(corpus, seed)
            t2 = time.perf_counter()
            est = LikelihoodEstimator(Hparams.from_yaml(SCORE_INFER_YAML.format(
                ckpt=ckpt, corpus=corpus)), device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            log(f"score: corpus of {SCORE_SHORT + SCORE_LONG} WAVs "
                f"({audio_s:.1f} s of audio) written in {t2 - t0:.1f} s; "
                f"LikelihoodEstimator (checkpoint and vocoder loaded "
                f"strictly) built in {t3 - t2:.1f} s")
            (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
             fa.flash_forward_full_plain, fa.flash_forward_full,
             fa.attention_reference, attn_mod.attend) = (
                refuse("the plain K3"), refuse("the plain K5"),
                refuse("the plain K4"), refuse("K4"),
                refuse("the dense attention reference"),
                refuse("the dense attention"))
            step, per_batch = est.test_step, []

            def counted(batch, generator):
                fa.flash_forward_packed.launches = 0
                fa.flash_forward_tiled.launches = 0
                out = step(batch, generator)
                per_batch.append((int(batch["tokens"].value.shape[1]),
                                  fa.flash_forward_packed.launches,
                                  fa.flash_forward_tiled.launches,
                                  batch["tokens"].lengths.tolist()))
                return out

            est.test_step = counted
            est.run(seed=seed, max_batches=1)          # warm-up
            per_batch.clear()
            # reference cycles of earlier phases can still hold device
            # tensors here; collect them so that the peak is this path's
            before = torch.cuda.memory_allocated()
            gc.collect()
            resident = torch.cuda.memory_allocated()
            log(f"score: {resident / 2 ** 30:.2f} GiB allocated before the "
                f"timed run, {(before - resident) / 2 ** 30:.2f} GiB more "
                "before collecting earlier phases' garbage")
            torch.cuda.reset_peak_memory_stats()
            timings = {}
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            scores = est.run(seed=seed, timings=timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t4
            peak = torch.cuda.max_memory_allocated()
            for i, (t, k3n, k5n, _) in enumerate(per_batch):
                log(f"score batch {i}: padded to {t} frames, K3 launches "
                    f"{k3n}, K5 launches {k5n}")
                want = (16, 0) if t <= 1024 else (0, 16)
                if (k3n, k5n) != want:
                    raise AssertionError(f"batch {i} ({t} frames): (K3, K5) "
                                         f"launches {(k3n, k5n)}, expected "
                                         f"{want}")
            batches = scoring_batches(seed)
            if [(t, lens) for t, _, _, lens in per_batch] != [
                    (max(lens), lens) for lens in batches] \
                    or not any(max(lens) > 1024 for lens in batches):
                raise AssertionError(
                    f"batches padded to {[b[0] for b in per_batch]} frames: "
                    "expected the padded lengths and lengths that phases 5 "
                    f"and 5b hold K3 and K5 at ({[max(x) for x in batches]}"
                    "), one past 1024 frames or more")
            n = SCORE_SHORT + SCORE_LONG
            if scores.shape != (n,) or not np.isfinite(scores).all() \
                    or not (scores <= 0).all():
                raise AssertionError(f"scores: shape {scores.shape}, finite "
                                     f"{np.isfinite(scores).all()}, max "
                                     f"{scores.max()}")
            log(f"score: {n} utterances ({audio_s:.1f} s of audio) in "
                f"{wall:.3f} s: {n / wall:.2f} utterances/s, "
                f"{audio_s / wall:.1f} s of audio scored per wall second; "
                f"model {timings['model']:.3f} s, data (waiting for the "
                f"loader) {timings['data']:.3f} s; peak memory "
                f"{peak / 2 ** 30:.2f} GiB ({gpu}); scores mean "
                f"{scores.mean():.4f}, range {scores.min():.4f} to "
                f"{scores.max():.4f}")
            k5_launches = sum(b[2] for b in per_batch)

            batches = iter(est.test_dataloader())
            next(batches)
            long_batch = next(batches)
            batches.close()
            g = torch.Generator(dev).manual_seed(seed)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t5 = time.perf_counter()
                step(long_batch, g)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t5) * 1e3
            # The loader's threads issue the mel kernels on the stream the
            # model uses, so kernels of prefetched batches fall inside the
            # model time; one loader pass alone says how much they are.
            with profile(activities=[ProfilerActivity.CUDA]) as dprof:
                t6 = time.perf_counter()
                for _ in est.test_dataloader():
                    pass
                torch.cuda.synchronize()
                data_wall = time.perf_counter() - t6
    finally:
        (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
         fa.flash_forward_full_plain, fa.flash_forward_full,
         fa.attention_reference, attn_mod.attend) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    data_busy = sum(e.self_device_time_total
                    for e in dprof.key_averages()) / 1e3
    log(f"score data path alone (one loader pass over the corpus, no model, "
        f"profiler on): wall {data_wall:.3f} s, device busy {data_busy:.1f} "
        f"ms, the most of the model time above that is mel work of "
        f"prefetched batches ({gpu})")
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    if not kernels:
        log("score batch profile: device time not measured (the profiler "
            "recorded no kernel)")
        return k5_launches
    busy = sum(k[0] for k in kernels)
    k5 = sum(k[0] for k in kernels if "k5_fwd" in k[2])
    log(f"score batch profile (B=64, {long_batch['tokens'].value.shape[1]} "
        f"frames, profiler on): wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), K5 {k5:.1f} ms "
        f"({k5 / busy:.1%} of busy), {sum(k[1] for k in kernels)} device "
        f"ops ({gpu})")
    for ms, cnt, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:.3f} ms, {cnt}x: {name[:90]}")
    return k5_launches


# ------------------------------------------------------------------ CLI
INFER_YAML = os.path.join(ROOT, "configs", "infer", "speech",
                          "vae-gslm.yaml")
CLI_UTTERANCES = 64                 # the infer config's batch_size


def write_cli_corpus(root: str, n: int = CLI_UTTERANCES,
                     seed: int = 0) -> str:
    """``n`` WAVs of 5-13 s and their tokens file from ``seed`` (the
    training corpus writer, without mels), and the shipped infer config
    with only ``ckpt_path``, ``vocoder.path``, ``data.path``,
    ``data.wavdir`` and ``output_dir`` pointed under ``root`` (the corpus
    in ``corpus{n}``), and ``data.batch_size`` set to ``n`` where it is
    not the config's.  Returns the config's path."""
    import yaml

    corpus = os.path.join(root, f"corpus{n}")
    os.makedirs(corpus)
    write_train_corpus(corpus, None, n, 5.0, 13.0, seed)
    with open(INFER_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["ckpt_path"] = os.path.join(root, "ckpt")
    cfg["vocoder"]["path"] = os.path.join(root, "voc")
    cfg["data"].update(path=os.path.join(corpus, "tokens.txt"),
                       wavdir=corpus, batch_size=n)
    cfg["output_dir"] = os.path.join(root, f"samples{n}")
    path = os.path.join(root, f"infer{n}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_cli(dev, gpu: str, config: str, w4: bool = False,
              n_wavs: int = CLI_UTTERANCES) -> int:
    """The speech-continuation CLI at full width: ``scripts/infer.py``'s
    ``main`` in this process on the shipped infer config (``write_cli_
    corpus``), one batch of ``n_wavs`` (500 AR steps, DDIM-100 at eta 0.5
    with the utterance embedding, HiFi-GAN, the energy-VAD trim), the
    bf16-mixed policy, int8 KV cache and int8 weights; with ``w4`` under
    ``VAE_GSLM_MEGA_W4=1``.  The decode kernels' counts are set to 0 just
    before ``main`` and read just after: at 64 (two sequential B = 32
    chunks) exactly 1000 launches of K2 (int8) or of K2-w4 (w4), none of
    the other and no K1 or K6; at 128 (the per-layer int8 route, JAX's
    ``decode_attention``) no K1, K2, K2-w4 or K6 launch.  Checks
    ``n_wavs`` finite 16 kHz WAVs, none longer than the prompt + 10 s.
    Reports the real-time factor over the whole ``main`` call (model
    build, data, sampling, vocoder, WAV writing: ``n_wavs`` x 10 s over
    its wall time), the stage times and the peak memory.  Returns the K2
    or K2-w4 launches."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step
    from vae_gslm_tpu_torch.scripts import infer as infer_cli

    with open(config) as f:
        out_dir = yaml.safe_load(f)["output_dir"]
    shutil.rmtree(out_dir, ignore_errors=True)
    chunked = n_wavs <= 64
    path = ("int4 weights, K2-w4" if w4 else "int8 weights, K2" if chunked
            else "int8 weights, per-layer int8 cache")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    old = os.environ.pop("VAE_GSLM_MEGA_W4", None)
    if w4:
        os.environ["VAE_GSLM_MEGA_W4"] = "1"
    try:
        fused_decode_attention.launches = flash_decode_int8.launches = 0
        fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = infer_cli.main(["-c", config, "--max_batches", "1", "--seed",
                            "0"], timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fused_decode_attention.launches, fused_trunk_step.launches,
                  fused_trunk_step.launches_w4, flash_decode_int8.launches)
    finally:
        os.environ.pop("VAE_GSLM_MEGA_W4", None)
        if old is not None:
            os.environ["VAE_GSLM_MEGA_W4"] = old
    peak = torch.cuda.max_memory_allocated()
    k2 = n_wavs // 32 * LENGTH if chunked else 0
    want = (0, 0, k2, 0) if w4 else (0, k2, 0, 0)
    if counts != want:
        raise AssertionError(f"CLI ({path}): launches (K1, K2, K2-w4, K6) = "
                             f"{counts}, expected {want}")
    names = sorted(os.listdir(out_dir), key=lambda n: int(n.split(".")[0]))
    if n != n_wavs or names != [f"{i}.wav" for i in range(1, n_wavs + 1)]:
        raise AssertionError(f"CLI ({path}): {n} outputs, files {names[:4]}"
                             f"... ({len(names)})")
    lens = []
    for name in names:
        wave, sr = audio.load_audio(os.path.join(out_dir, name))
        lens.append(len(wave))
        if sr != 16000 or not 0 < len(wave) <= (PROMPT + LENGTH) * 320 \
                or not np.isfinite(wave).all():
            raise AssertionError(f"CLI ({path}) {name}: {len(wave)} samples "
                                 f"at {sr} Hz")
    trimmed = sum(x < (PROMPT + LENGTH) * 320 for x in lens)
    audio_s = n_wavs * LENGTH / 50.0
    how = "as two B=32 chunks" if chunked else "per layer"
    log(f"CLI ({path}), B={n_wavs} {how}: K1 {counts[0]}, K2 {counts[1]}, "
        f"K2-w4 {counts[2]}, K6 {counts[3]} launches; {n} "
        f"WAVs of {min(lens) / 16000:.2f}-{max(lens) / 16000:.2f} s ({trimmed}"
        f" shortened by the VAD trim); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; main wall {wall:.3f} s, real-time factor "
        f"{audio_s / wall:.2f}x with model build, data and WAV writing "
        f"({audio_s / sum(timings.values()):.2f}x over the timed stages); "
        f"peak memory {peak / 2 ** 30:.2f} GiB ({gpu})")
    return counts[2] if w4 else counts[1]


# --------------------------------------------------------------- K4b/K5b
K4B_LENGTHS = [640, 320, 300, 640, 1, 639, 0, 64]
K5B_T, K5B_LENGTHS = 1536, [1536, 1]
# the bf16 backward (bwd_wgmma) held at more shapes: (name, B, T, H,
# lengths), causal, Tq = Tk; partial last tiles, K4b's largest T, and
# K5b at the envelope's edge, Tk 8192
BWD_BF16_MORE = (("K4b", 4, 200, 2, [200, 77, 1, 0]),
                 ("K4b", 4, 1000, 4, [1000, 0, 1, 611]),
                 ("K4b", 4, 1024, 4, [1024, 1, 0, 700]),
                 ("K5b", 3, 1100, 3, [1100, 1, 0]),
                 ("K5b", 3, 8192, 2, [8192, 1, 0]))


def bhtd_grad(dtype, dev, b: int, tq: int, h: int, seed: int):
    """dO (B, H, Tq, D) as a strided view of a packed (B, Tq, H D) tensor,
    as the backward of the packed output hands it over."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, tq, h * D), generator=g, device=dev).to(dtype)
    return x.view(b, tq, h, D).transpose(1, 2)


def bwd_bytes_ops(b: int, tq: int, tk: int, h: int, lengths, causal: bool,
                  itemsize: int, n_stats: int):
    """Bytes and FLOPs of one K4b/K5b call's kernels on these inputs
    (``delta`` comes in computed, as K3b's): q and dO read and dq
    written (B x Tq rows), k and v read below each length (all Tk for a
    row of length 0), dk and dv written (B x Tk rows), ``n_stats``
    float32 (B, H, Tq) rows read (delta, and K4b's lse); the 5 products
    (QK, dO V, dS K, dS^T Q, P^T dO) of 2 D FLOPs over the (query, key)
    pairs the causal and length masks leave."""
    row = h * D * itemsize
    kv = sum(ln if ln >= 1 else tk for ln in lengths) * row
    nbytes = (3 * b * tq + 2 * b * tk) * row + 2 * kv \
        + n_stats * b * h * tq * 4 + b * 4 + h * 4

    def keys(r, ln):
        if ln < 1:
            return tk
        return min(r + 1, ln) if causal else min(ln, tk)

    pairs = h * sum(sum(keys(r, ln) for r in range(tq)) for ln in lengths)
    return nbytes, 5 * 2 * D * pairs


def phase_k45b(dev, k4_worst: float):
    """K4 (the (B, H, T, D) full forward with lse) and K4b (its backward
    from that lse) at the data-parallel training call (B 8, 16 heads of
    64, T 640, causal, lengths down to 0 and 1), and K5b (the blockwise
    backward) at the long-segment call (B 2, T 1536, lengths 1536 and 1)
    and at Tq 96 x Tk 256 (non-causal, lengths 256, 0, 1), float32 and
    bfloat16, ALiBi, from strided views of packed projections with o
    from K4/K5, against their plain versions: K4's o and lse at
    phase_k45's tolerances; K4b and K5b at K3b's, float32 1e-4 x
    max|ref|, bf16 2e-2 x max|ref| and element by element 2 bf16 ulps +
    2e-2 rms(ref), relative L2 1e-3 (dk and dv sum every query row's
    share in float32 in another order than the plain einsum, and a ds
    one ulp apart rounds to another bf16 value).  Then their bf16 times
    (the 16-mixed path's type), K4 and K4b at the training call, K5b at
    the long-segment one: kernels (profiler, every launch of the window
    counted), per call with the wrapper (CUDA events; K4b/K5b's delta
    included), plain, SDPA with a float mask (forward for K4, with the
    ratio; for K4b/K5b its backward alone, the library time, and
    forward+backward, with the kernels' ratio to the backward alone),
    and the bound.  K4 bf16 is also held at T 200, 1000 and 1024
    (lengths 0 and 1 among them), with lse and without, and the bf16
    backward (``bwd_wgmma``) at ``BWD_BF16_MORE``: K4b at T 200, 1000 and
    1024 and K5b at T 1100 and 8192 (Tk at the envelope's edge; its
    plain version one batch row at a time), at the same tolerances.
    Returns the K4, K4b and K5b entries (K4's error also covers
    phase_k45's odd-head case, ``k4_worst``)."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    worst = {"K4": k4_worst, "K4b": 0.0, "K5b": 0.0}
    cases = (("K4b", K3_B, K3_T, K3_T, K4B_LENGTHS, True),
             ("K5b", 2, K5B_T, K5B_T, K5B_LENGTHS, True),
             ("K5b", 3, 96, 256, [256, 0, 1], False))
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    for (name, b, tq, tk, lens, causal), dtype in \
            itertools.product(cases, (torch.float32, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tk, H, seed=tq + 1)
        do = bhtd_grad(dtype, dev, b, tq, H, seed=tq + 2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if name == "K4b":
            o, lse = fa.flash_forward_full(q, k, v, lengths, slopes, causal,
                                           with_stats=True)
            o_ref, lse_ref = fa.flash_forward_full_plain(
                q, k, v, lengths, slopes, causal, with_stats=True)
            torch.cuda.synchronize()
            where = (f"K4 B={b} T={tq} H={H} {str(dtype)[6:]} "
                     f"causal={causal} alibi=True (the training call)")
            errs = []
            for n, g_, r_ in (("o", o, o_ref), ("lse", lse, lse_ref)):
                tol = 1e-2 if bf16 and n == "o" else 1e-5
                err, text = hold(where, n, g_, r_, tol,
                                 0.0 if bf16 and n == "o" else 1.0, bf16)
                errs.append(text)
                if n == "o":
                    worst["K4"] = max(worst["K4"], err)
            log(f"K4 check {where}: max_abs_err " + ", ".join(errs))
            del o_ref, lse_ref
            extra = (lse,)
            fn, plain = fa.flash_backward_full, fa.flash_backward_full_plain
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
            extra = ()
            fn, plain = (fa.flash_backward_blockwise,
                         fa.flash_backward_blockwise_plain)
        got = fn(q, k, v, o, do, *extra, lengths, slopes, causal)
        want = plain(q, k, v, o, do, *extra, lengths, slopes, causal)
        torch.cuda.synchronize()
        where = (f"{name} B={b} Tq={tq} Tk={tk} H={H} {str(dtype)[6:]} "
                 f"causal={causal}")
        errs = []
        for n, g_, r_ in zip(("dq", "dk", "dv"), got, want):
            if g_.dtype != dtype or g_.shape != r_.shape:
                raise AssertionError(f"{where}: {n} is {g_.dtype} "
                                     f"{tuple(g_.shape)}")
            err, text = hold(where, n, g_, r_, 2e-2 if bf16 else 1e-4, 0.0,
                             bf16)
            worst[name] = max(worst[name], err)
            errs.append(text)
        log(f"{name} check {where}: max_abs_err " + ", ".join(errs))
        del got, want

    # the bf16 K4 forward at a partial last tile and at its largest
    # resident key sets, with lse and without (the scoring route's call)
    for b, t, h, lens in ((4, 200, 2, [200, 77, 1, 0]),) + K3_LONG:
        q, k, v = bhtd_inputs(torch.bfloat16, dev, b, t, t, h, seed=t + 3)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sl = -torch.tensor(alibi_slopes(h), device=dev)
        o, lse = fa.flash_forward_full(q, k, v, lengths, sl, True,
                                       with_stats=True)
        o_only = fa.flash_forward_full(q, k, v, lengths, sl, True)
        o_ref, lse_ref = fa.flash_forward_full_plain(q, k, v, lengths, sl,
                                                     True, with_stats=True)
        torch.cuda.synchronize()
        where = f"K4 B={b} T={t} H={h} bfloat16 causal=True alibi=True"
        errs = []
        for n, g_, r_ in (("o", o, o_ref), ("lse", lse, lse_ref),
                          ("o without lse", o_only, o_ref)):
            err, text = hold(where, n, g_, r_, 1e-5 if n == "lse" else 1e-2,
                             1.0 if n == "lse" else 0.0, True)
            errs.append(text)
            if n != "lse":
                worst["K4"] = max(worst["K4"], err)
        log(f"K4 check {where}: max_abs_err " + ", ".join(errs))
        del q, k, v, o, lse, o_only, o_ref, lse_ref

    # the bf16 backward at partial last tiles, K4b's largest T and K5b's
    # largest Tk (its plain version one batch row at a time)
    for name, b, t, h, lens in BWD_BF16_MORE:
        q, k, v = bhtd_inputs(torch.bfloat16, dev, b, t, t, h, seed=t + 5)
        do = bhtd_grad(torch.bfloat16, dev, b, t, h, seed=t + 6)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sl = -torch.tensor(alibi_slopes(h), device=dev)
        if name == "K4b":
            o, lse = fa.flash_forward_full(q, k, v, lengths, sl, True,
                                           with_stats=True)
            got = fa.flash_backward_full(q, k, v, o, do, lse, lengths, sl,
                                         True)
            want = in_chunks(lambda r: fa.flash_backward_full_plain(
                q[r], k[r], v[r], o[r], do[r], lse[r], lengths[r], sl,
                True), b, 1)
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, sl, True)
            got = fa.flash_backward_blockwise(q, k, v, o, do, lengths, sl,
                                              True)
            want = in_chunks(lambda r: fa.flash_backward_blockwise_plain(
                q[r], k[r], v[r], o[r], do[r], lengths[r], sl, True), b, 1)
        torch.cuda.synchronize()
        where = f"{name} B={b} T={t} H={h} bfloat16 causal=True alibi=True"
        errs = []
        for n, g_, r_ in zip(("dq", "dk", "dv"), got, want):
            err, text = hold(where, n, g_, r_, 2e-2, 0.0, True)
            worst[name] = max(worst[name], err)
            errs.append(text)
        log(f"{name} check {where}: max_abs_err " + ", ".join(errs))
        del q, k, v, do, o, got, want

    def entry(name, fn_name, line, ms, plain_ms, bound, by, lib):
        return {"name": fn_name, "route": "cuda",
                "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"vae_gslm_tpu/ops/flash_attention.py:{line}",
                "launches": None, "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib}

    def bound_of(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"

    out = {}
    dtype = torch.bfloat16
    for name, b, t, lens in (("K4b", K3_B, K3_T, K4B_LENGTHS),
                             ("K5b", 2, K5B_T, K5B_LENGTHS)):
        q, k, v = bhtd_inputs(dtype, dev, b, t, t, H, seed=1)
        do = bhtd_grad(dtype, dev, b, t, H, seed=2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = sdpa_mask(lengths, slopes, dtype, dev, t, t, True)
        if name == "K4b":
            def fwd(i):
                return fa.flash_forward_full(q, k, v, lengths, slopes, True,
                                             with_stats=True)

            def fwd_plain(i):
                return fa.flash_forward_full_plain(q, k, v, lengths, slopes,
                                                   True, with_stats=True)

            def sdpa_fwd(i):
                with torch.no_grad():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)

            kf = device_ms(fwd, n=20, only=("k4_fwd",), per_call=1)
            cf = cuda_ms(fwd, n=20)
            pf = device_ms(fwd_plain, n=3)
            lf = device_ms(sdpa_fwd, n=20)
            nbytes, flops = bhtd_bytes_ops(b, t, t, H, lens, True, 2)
            nbytes += b * H * t * 4                    # lse written
            bound, by = bound_of(nbytes, flops)
            log(f"K4 time B={b} T={t} H={H} bf16 with lse (the training "
                f"call): kernel {kf:.4f} ms, {cf:.4f} ms per call with the "
                f"wrapper, plain {pf:.4f} ms, SDPA (float mask) forward "
                f"{lf:.4f} ms (kernel / SDPA {kf / lf:.3f}), bound "
                f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP)")
            out["K4"] = entry("K4", "flash_forward_full", 406, kf, pf, bound,
                              by, lf)
            o, lse = fwd(0)

            def call(i):
                return fa.flash_backward_full(q, k, v, o, do, lse, lengths,
                                              slopes, True)

            def plain(i):
                return fa.flash_backward_full_plain(q, k, v, o, do, lse,
                                                    lengths, slopes, True)
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, slopes, True)

            def call(i):
                return fa.flash_backward_blockwise(q, k, v, o, do, lengths,
                                                   slopes, True)

            def plain(i):
                return fa.flash_backward_blockwise_plain(
                    q, k, v, o, do, lengths, slopes, True)
        # the dq and dk/dv kernels (K5b's row statistics inside dq)
        kt = device_ms(call, n=20, only=(name.lower() + "_",),
                       per_call=2 if name == "K4b" else fa.K5B_BF16_KERNELS)
        ct = cuda_ms(call, n=20)
        pt = device_ms(plain, n=3)
        q4, k4, v4 = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd(i):
            F.scaled_dot_product_attention(q4, k4, v4,
                                           attn_mask=mask).backward(do)

        lt = device_ms(sdpa_fwd_bwd, n=10)
        lb = sdpa_bwd_ms(q, k, v, do, mask)
        del mask
        nbytes, flops = bwd_bytes_ops(b, t, t, H, lens, True, 2,
                                      2 if name == "K4b" else 1)
        bound, by = bound_of(nbytes, flops)
        log(f"{name} time B={b} T={t} H={H} bf16: kernels {kt:.4f} ms, "
            f"{ct:.4f} ms per call with the wrapper (delta included), plain "
            f"{pt:.4f} ms, SDPA (float mask) backward alone {lb:.4f} ms "
            f"(kernels / SDPA backward {kt / lb:.3f}), "
            f"forward+backward {lt:.4f} ms, bound of the kernels "
            f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        out[name] = entry(name, "flash_backward_full" if name == "K4b"
                          else "flash_backward_blockwise",
                          735 if name == "K4b" else 682, kt, pt, bound, by,
                          lb)
        del q, k, v, do, o
    return out["K4"], out["K4b"], out["K5b"]


# ------------------------------------------------------------------ K6
K6_B, K6_T = 128, 768               # the per-layer path's batch; 651 -> 768
K6_CASES = (151, 255, 256, 400, 511, 512, 650)


def k6_inputs(dev, seed: int = 0):
    """An int8 per-layer cache (B 128, 16 heads, T 768) quantized from
    normal rows by the port's ``quantize_i8``, a bfloat16 q as a view of one fused qkv projection (as the per-layer
    step hands it over) and the ALiBi slopes."""
    import torch

    from vae_gslm_tpu_torch.nn.attention import quantize_i8
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(seed)
    k8, ks = quantize_i8(torch.randn((K6_B, H, K6_T, D), generator=g,
                                     device=dev))
    v8, vs = quantize_i8(torch.randn((K6_B, H, K6_T, D), generator=g,
                                     device=dev))
    qkv = torch.randn((K6_B, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    q = qkv.view(K6_B, 3, H, D)[:, 0]
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return q, k8, v8, ks, vs, slopes


def k6_bytes(pos: int, q_itemsize: int = 2) -> int:
    """Bytes one call must move: the valid rows' int8 K and V and their
    two float32 scales, q in, the float32 output, the slopes."""
    return (K6_B * H * ((pos + 1) * (2 * D + 8) + D * (q_itemsize + 4))
            + H * 4)


def phase_k6(dev):
    """K6 against its plain version at the per-layer path's calls (B 128,
    16 heads of 64, T 768) at the rollout's cache states ``K6_CASES``,
    to ``1e-5 * max|ref|`` (float32, both
    summing in 256-key blocks); then, over every 50th position of the
    151 -> 650 rollout, its device time, the time per call with the
    wrapper, the plain version's time, JAX's route as ported
    (``decode_attention`` over the int8 cache at the sampler's segment
    window, the A/B beside the kernel) and the bytes bound."""
    import torch

    from vae_gslm_tpu_torch.inference.speech.sampler import (
        n_segments, segment_windows)
    from vae_gslm_tpu_torch.ops.decode_attention import decode_attention
    from vae_gslm_tpu_torch.ops.flash_decode import (
        flash_decode_int8 as k6, flash_decode_int8_plain as plain)

    q, k8, v8, ks, vs, slopes = k6_inputs(dev)
    worst = 0.0
    for pos in K6_CASES:
        want = plain(q, k8, v8, ks, vs, pos, slopes)
        got = k6(q, k8, v8, ks, vs, pos, slopes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        log(f"K6 check B={K6_B} T={K6_T} pos={pos}: "
            f"max_abs_err={err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"pos {pos}")
        worst = max(worst, err)
    pos0 = PROMPT + 1
    segments = segment_windows(pos0, LENGTH, n_segments(LENGTH),
                               pos0 + LENGTH)
    ks_, calls, ps, js, bs = [], [], [], [], []
    for pos in range(pos0, pos0 + LENGTH, 50):
        window = next(w for a, e, w in segments if a <= pos - pos0 < e)

        def kernel(i):
            return k6(q, k8, v8, ks, vs, pos, slopes)

        ks_.append(device_ms(kernel, n=100, only=("flash_decode_kernel",),
                             per_call=1))
        calls.append(cuda_ms(kernel, n=100))
        ps.append(device_ms(lambda i: plain(q, k8, v8, ks, vs, pos, slopes),
                            n=5))
        js.append(device_ms(lambda i: decode_attention(
            q, k8, v8, pos, slopes, window=window, k_scale=ks, v_scale=vs),
            n=10))
        bs.append(k6_bytes(pos) / HBM_BYTES_PER_S * 1e3)
        log(f"K6 time B={K6_B} pos={pos}: kernel {ks_[-1] * 1e3:.2f} us, "
            f"{calls[-1] * 1e3:.2f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.1f} us, JAX's route (decode_attention, window "
            f"{window}) {js[-1] * 1e3:.1f} us, bound {bs[-1] * 1e3:.2f} us "
            f"({k6_bytes(pos) / 1e6:.1f} MB)")
    log(f"K6 mean over the rollout: kernel {statistics.mean(ks_) * 1e3:.2f} "
        f"us, {statistics.mean(calls) * 1e3:.2f} us per call with the "
        f"wrapper, plain {statistics.mean(ps) * 1e3:.1f} us, JAX's route "
        f"{statistics.mean(js) * 1e3:.1f} us, bound "
        f"{statistics.mean(bs) * 1e3:.2f} us")
    log("K6 library_ms: null (no single PyTorch call computes this "
        "int8-dequantizing decode attention)")
    return {"name": "flash_decode_int8", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/flash_decode.cu",
            "replaces": "vae_gslm_tpu/ops/flash_decode.py:131",
            "launches": None, "max_abs_err": worst,
            "ms": statistics.mean(ks_), "plain_ms": statistics.mean(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------------ K7
def phase_k7(dev, gpu: str):
    """K7's per-layer and tile sums against its plain version on the
    seed-0 (16, 1024, 12288) int8 stack, exactly; its plain version's and
    one ``torch.sum`` call's device times; then
    ``scripts/bench_slope.py``'s slopes (K7's microseconds per call and
    GB/s, K2's full step at flushed 0 and 512) with K7's count set to 0
    just before and read just after."""
    import torch

    from vae_gslm_tpu_torch.ops.stream import stream_sums, stream_sums_plain
    from vae_gslm_tpu_torch.scripts import bench_slope

    g = torch.Generator(dev).manual_seed(0)
    w = torch.randint(-127, 128, (bench_slope.L, bench_slope.R,
                                  bench_slope.C), generator=g, device=dev,
                      dtype=torch.int8)
    got, want = stream_sums(w), stream_sums_plain(w)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K7's sums differ from its plain version's")
    log(f"K7 check: per-layer sums and k_block's tile sum "
        f"({int(got[1])}) equal to the plain version's")
    plain_ms = device_ms(lambda i: stream_sums_plain(w), n=5)
    library_ms = device_ms(lambda i: w.sum(dim=(1, 2)), n=5)
    nbytes = w.numel()
    del w, got, want
    stream_sums.launches = 0
    res = bench_slope.run(dev)
    launches = stream_sums.launches
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    share = res["stream_gb_s"] * 1e9 / HBM_BYTES_PER_S
    log(f"bench_slope: K7 {res['stream_us']:.2f} us per call, "
        f"{res['stream_gb_s']:.1f} GB/s ({share:.1%} of the data sheet's "
        f"3.35 TB/s), bound {bound * 1e3:.2f} us "
        f"({nbytes / 1e6:.1f} MB), {launches} launches; plain "
        f"{plain_ms * 1e3:.1f} us, torch.sum {library_ms * 1e3:.1f} us; K2 "
        f"full step B=8 a8: {res['mega_us_flushed_0']:.1f} us at flushed 0, "
        f"{res['mega_us_flushed_512']:.1f} us at flushed 512 ({gpu})")
    return {"name": "stream_sums", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/stream.cu",
            "replaces": "tools/bench_slope.py:56",
            "launches": launches, "max_abs_err": 0.0,
            "ms": res["stream_us"] / 1e3, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms}


# ------------------------------------------------------ data parallel
DP_WORLD = 2
DP_STEPS = 3                        # optimizer steps of the two-rank fit
DP_FLASH = ("flash_forward_packed", "flash_backward_packed",
            "flash_forward_full", "flash_backward_full",
            "flash_forward_tiled", "flash_backward_blockwise")


def run_ranks(args: dict, work: str, timeout: float):
    """``DP_WORLD`` ranks of this script in worker mode (``--dp-worker``)
    on the card, over gloo: JAX's launch variables, one log file each.
    Every rank is killed if the ranks are not done in ``timeout``
    seconds.  Returns each rank's result dict."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.path.join(work, "args.json")
    with open(path, "w") as f:
        json.dump(args, f)
    procs, logs = [], []
    try:
        for r in range(DP_WORLD):
            env = dict(os.environ, VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                       VAE_GSLM_NUM_PROCESSES=str(DP_WORLD),
                       VAE_GSLM_PROCESS_ID=str(r), PYTHONPATH=ROOT)
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 path], cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                log(f"rank {r} failed (exit {procs[r].returncode}):\n"
                    + f.read()[-4000:])
        raise AssertionError(f"ranks {bad} of the {args['mode']} phase "
                             "failed")
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _refuse_plain(where: str):
    """Make every plain attention version raise (the kernels must run);
    returns a callable that undoes it."""
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    names = ("flash_forward_packed_plain", "flash_backward_packed_plain",
             "flash_forward_full_plain", "flash_forward_tiled_plain",
             "flash_backward_full_plain", "flash_backward_blockwise_plain",
             "attention_reference")
    saved = {n: getattr(fa, n) for n in names}
    saved_attend = attn_mod.attend

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"{where} reached {what} on the card")
        return fn

    for n in names:
        setattr(fa, n, refuse(n))
    attn_mod.attend = refuse("the dense attention")

    def undo():
        for n, f in saved.items():
            setattr(fa, n, f)
        attn_mod.attend = saved_attend

    return undo


def _param_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_small_rank(args: dict, rank: int) -> dict:
    """One rank of ``phase_dp_small``: the step on this rank's rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.parallel import mesh
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    mesh.init_distributed("gloo")
    try:
        dev = mesh.rank_device()
        work, b = args["work"], args["rows"]
        tr = LVTRTrainer(small_train_hparams(args["vocoder"]), seed=3,
                         device=dev)
        tr.model.load_state_dict(torch.load(
            os.path.join(work, "model.pt"), map_location=dev))
        tr.global_step = args["step"]
        data = torch.load(os.path.join(work, "batch.pt"))
        lo, hi = rank * b, (rank + 1) * b
        batch = {k: Masked(data[k][:, lo:hi], data[k + ".len"][:, lo:hi], 1)
                 for k in ("mel", "tokens", "cropped_mel_utt")}
        draws = [{k[len(f"draw{i}."):]: v[lo:hi] for k, v in data.items()
                  if k.startswith(f"draw{i}.")}
                 for i in range(TRAIN_ACCUM)]
        undo = _refuse_plain("the two-rank small step")
        for n in DP_FLASH:
            getattr(fa, n).launches = 0
        with tr.parallel_context():
            metrics = tr.run_step(batch, draws=draws)
        torch.cuda.synchronize()
        counts = {n: getattr(fa, n).launches for n in DP_FLASH}
        undo()
        np.savez(os.path.join(work, f"grads{rank}.npz"),
                 **{n: p.grad.cpu().numpy() for n, p in zip(tr.names,
                                                             tr.params)})
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "counts": counts, "digest": _param_digest(tr.params)}
    finally:
        dist.destroy_process_group()


def _dp_fit_rank(args: dict, rank: int) -> dict:
    """One rank of ``phase_dp_fit``: ``scripts/train.py`` (gloo), each
    optimizer step timed and its kernel counts set to 0 just before and
    read just after, the all-reduces timed, the plain versions refused."""
    import torch

    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.parallel import mesh
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    steps, reduce_s, holder = [], [], {}
    run_step, all_reduce = LVTRTrainer.run_step, mesh.all_reduce_sum

    def counted(self, stacked, draws=None):
        holder["trainer"] = self
        for n in DP_FLASH:
            getattr(fa, n).launches = 0
        torch.cuda.synchronize()
        t0, r0 = time.perf_counter(), sum(reduce_s)
        metrics = run_step(self, stacked, draws)
        torch.cuda.synchronize()
        tok = stacked["tokens"]
        steps.append({
            "sec": time.perf_counter() - t0,
            "reduce_sec": sum(reduce_s) - r0,
            "counts": {n: getattr(fa, n).launches for n in DP_FLASH},
            "shape": list(tok.value.shape),
            "tokens": int(tok.lengths.sum()),
            "metrics": {k: float(v) for k, v in metrics.items()}})
        return metrics

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(tensors)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    LVTRTrainer.run_step = counted
    mesh.all_reduce_sum = timed_reduce
    undo = _refuse_plain("the two-rank fit")
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)       # the allocator exists before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    train_cli.main(["-c", args["config"], "--backend", "gloo",
                    "--max_steps", str(args["steps"]), "-n", "dp",
                    "-log", "WARNING"])
    wall = time.perf_counter() - t0
    undo()
    tr = holder["trainer"]
    return {"steps": steps, "wall": wall, "device": str(tr.device),
            "world": tr.world_size,
            "peak": torch.cuda.max_memory_allocated(dev),
            "nparams": sum(p.numel() for p in tr.params),
            "digest": _param_digest(tr.params)}


def dp_worker(args_path: str) -> int:
    """Worker mode: one rank of a two-rank phase (launched by
    ``run_ranks`` with the launch variables set)."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args_path) as f:
        args = json.load(f)
    rank = int(os.environ["VAE_GSLM_PROCESS_ID"])
    out = (_dp_small_rank(args, rank) if args["mode"] == "small"
           else _dp_fit_rank(args, rank))
    with open(os.path.join(args["work"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_dp_small(dev):
    """Two ranks on the card (gloo, one process each) take one float32
    step of the small LVTR (accumulation 2, utterance encoder) on their
    halves of a global batch with pinned draws, through K4/K4b (the
    data-mesh route); the single-process step over the whole batch on
    the card (K3/K3b) is the reference: metrics to 1e-4 relative (token
    sums and grad_norm), the summed gradients to 1e-3 x max|g| per leaf
    (1e-3: two kernels summing in other orders, then the cross-rank sum);
    the ranks' parameters bitwise equal.  Exactly 2 x accumulation K4
    and K4b launches per rank, no K3/K3b."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    b_rank, t = 2, 100
    work = tempfile.mkdtemp(prefix="dp_small_")
    try:
        with precision.policy_scope(precision.Policy()):
            vdir = vocoder_dir(work)
            single = LVTRTrainer(small_train_hparams(vdir), seed=3,
                                 device=dev)
            torch.save(single.model.state_dict(),
                       os.path.join(work, "model.pt"))
            rng = np.random.RandomState(4)
            batch = train_batches(rng, DP_WORLD * b_rank, t,
                                  [100, 61, 1, 77], 40, 50)
            draws = [train_draws(rng, DP_WORLD * b_rank, t, 4, 32,
                                 single.model.decoder.num_timesteps)
                     for _ in range(TRAIN_ACCUM)]
            data = {}
            for k, v in batch.items():
                data[k], data[k + ".len"] = v.value, v.lengths
            for i, d in enumerate(draws):
                data.update({f"draw{i}.{k}": x for k, x in d.items()})
            torch.save(data, os.path.join(work, "batch.pt"))
            step = 40000                           # past the KLD warm-up
            single.global_step = step
            want = single.run_step(batch, draws=draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks = run_ranks({"mode": "small", "work": work,
                               "vocoder": vdir, "rows": b_rank,
                               "step": step}, work, timeout=300)
            sec = time.perf_counter() - t0
            grads = []
            for r in range(DP_WORLD):
                with np.load(os.path.join(work, f"grads{r}.npz")) as z:
                    grads.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_layers = len(single.model.transformer.layers)
    wantc = n_layers * TRAIN_ACCUM
    worst_m, worst_g = 0.0, 0.0
    for r, res in enumerate(ranks):
        c = res["counts"]
        if (c["flash_forward_full"], c["flash_backward_full"],
                c["flash_forward_packed"], c["flash_backward_packed"]) != \
                (wantc, wantc, 0, 0):
            raise AssertionError(f"rank {r}: launches {c}, expected "
                                 f"{wantc} K4 and K4b and no K3/K3b")
        for k in ("rec_loss", "kld", "token_kld", "log_p", "log_q",
                  "grad_norm"):
            g, w = res["metrics"][k], float(want[k])
            worst_m = max(worst_m, abs(g - w) / max(abs(w), 1e-12))
        for name, p in zip(single.names, single.params):
            ref = p.grad.double().cpu().numpy()
            scale = np.abs(ref).max()
            err = np.abs(grads[r][name] - ref).max()
            if not err <= 1e-3 * scale + 1e-30:
                raise AssertionError(f"rank {r}: summed gradient of {name} "
                                     f"differs by {err:.3e} (max |g| "
                                     f"{scale:.3e})")
            worst_g = max(worst_g, err / max(scale, 1e-30))
    if not worst_m <= 1e-4:
        raise AssertionError(f"two-rank metrics differ from the single "
                             f"process by {worst_m:.3e} relative")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the ranks' parameters differ after the step")
    log(f"two-rank small step on the card (gloo, K4/K4b, float32) vs the "
        f"single-process step (K3/K3b): metrics max rel err {worst_m:.2e}, "
        f"summed gradients max err {worst_g:.2e} x max|g| over "
        f"{len(single.params)} leaves; parameters bitwise equal across "
        f"ranks; launches per rank {ranks[0]['counts']}; {sec:.1f} s with "
        "the ranks' start")


def write_train_corpus(root: str, mels, n: int, lo_s: float,
                       hi_s: float, seed: int = 0) -> float:
    """``n`` WAVs (16 kHz, 16-bit) of ``lo_s``-``hi_s`` s from ``seed``
    and a ``tokens.txt`` of random token ids at 50 Hz; unless ``mels`` is
    None, ``scripts/preprocess_mels.py`` then writes each WAV's 80-bin
    log-mel (the vocoder config's frontend, on the card) as ``.npy``
    under ``mels``, the tree the training data reads.  Every duration is
    a whole number of 20 ms frames.  Returns the seconds of audio."""
    import logging

    import numpy as np
    import yaml

    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.scripts import preprocess_mels

    rng = np.random.RandomState(seed)
    frames = rng.randint(int(lo_s * 50), int(hi_s * 50) + 1, n)
    lines = []
    for i, nf in enumerate(frames):
        m = int(nf) * 320
        t = np.arange(m, dtype=np.float32) / 16000.0
        f0 = rng.uniform(90, 250)
        wave = sum(rng.uniform(0.02, 0.1) / h
                   * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3))
                   for h in range(1, 6))
        wave = (wave * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
                + 0.01 * rng.randn(m)).astype(np.float32)
        name = f"utt{i:03d}"
        audio.save_wav(os.path.join(root, name + ".wav"), wave, 16000)
        lines.append(f"{name}.wav|"
                     f"{' '.join(map(str, rng.randint(0, 200, nf)))}")
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("\n".join(lines) + "\n")
    if mels is not None:
        with open(VOCODER_YAML) as f:
            cfg = yaml.safe_load(f)
        cfg["data"] = {"path": tokens, "wavdir": root, "sample_rate": 16000,
                       "with_text": False, "with_tokens": True}
        path = os.path.join(os.path.dirname(os.path.abspath(mels)),
                            "preprocess_mels.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        level = logging.getLogger().level     # the CLI logs at INFO
        wrote = preprocess_mels.main(["-c", path, "-o", mels,
                                      "--device", "cuda"])
        logging.getLogger().setLevel(level)
        if wrote != n:
            raise AssertionError(f"preprocess_mels wrote {wrote} mels of "
                                 f"{n} WAVs")
    return float(frames.sum()) / 50.0


def phase_dp_fit(dev, gpu: str, long: bool = False):
    """Two ranks on the card (gloo) train the full-width LVTR of
    ``configs/train/speech/vae-gslm.yaml`` through ``scripts/train.py``
    -> ``LVTRTrainer.fit``, its data paths pointed at a synthetic corpus
    written from seed 0 (WAVs, tokens and mels from ``scripts/
    preprocess_mels.py``; a uniform
    length mix, not a measured corpus's).  The shipped settings: 8 rows
    per rank x accumulation 2 x 640-frame segments, 16-mixed, AdamW,
    ``DP_STEPS`` optimizer steps over 96 utterances of 13-20 s (one
    epoch); exactly 32 K4 and 32 K4b launches per rank per step and no
    K3/K3b; the ranks' parameters bitwise equal at the end; rank 0's
    ``last-cpt.npz`` read back strictly and equal to them.  With
    ``long``: one step past 1024 frames (``token_segment_size`` 1536 and
    its post-padding, 2 rows per rank, accumulation 1) over 4 utterances
    of 31-35 s: exactly 16 K5 and 16 K5b launches per rank.  Both ranks
    share the one card: their times say nothing about scaling.  Returns
    rank 0's launches of the kernels over the run."""
    import shutil
    import tempfile

    import yaml

    tmp = tempfile.mkdtemp(prefix="dp_fit_")
    try:
        corpus, mels = os.path.join(tmp, "corpus"), os.path.join(tmp, "mels")
        os.makedirs(corpus)
        steps = 1 if long else DP_STEPS
        n_utt = 4 if long else DP_WORLD * TRAIN_B * TRAIN_ACCUM * steps
        t0 = time.perf_counter()
        audio_s = write_train_corpus(corpus, mels, n_utt,
                                     31.0 if long else 13.0,
                                     35.0 if long else 20.0)
        with open(TRAIN_YAML) as f:
            cfg = yaml.safe_load(f)
        cfg["vocoder"]["path"] = vocoder_dir(tmp)
        cfg["logging"]["log_dir"] = os.path.join(tmp, "logs")
        data = cfg["data"]["train"]
        data.update(path=os.path.join(corpus, "tokens.txt"), wavdir=corpus,
                    preprocess_mels=mels)
        if long:
            data.update(token_segment_size=K5B_T, batch_size=2,
                        post_pad={"tokens": {"num_tokens": K5B_T},
                                  "mel": {"length": K5B_T / 50.0}})
            cfg["training"]["gradient_accumulation"] = 1
        path = os.path.join(tmp, "train.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        log(f"dp{' long' if long else ''}: corpus of {n_utt} WAVs "
            f"({audio_s:.1f} s of audio) with mels written in "
            f"{time.perf_counter() - t0:.1f} s")
        ranks = run_ranks({"mode": "fit", "work": tmp, "config": path,
                           "steps": steps}, tmp, timeout=600)
        ckpt = os.path.join(tmp, "logs", "dp", "ckpt", "version_0")
        names = sorted(os.listdir(ckpt))
        want_names = sorted([f"step={steps}-cpt.npz", "last-cpt.npz",
                             "hp.yaml", "full_state.pt"])
        if names != want_names:
            raise AssertionError(f"rank 0 wrote {names}, expected "
                                 f"{want_names}")
        if not long:
            read_back(os.path.join(ckpt, "last-cpt.npz"), cfg, dev,
                      ranks[0]["digest"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seg = K5B_T if long else TRAIN_T
    rows = 2 if long else TRAIN_B
    accum = 1 if long else TRAIN_ACCUM
    want = L * accum
    kernels = (("flash_forward_tiled", "flash_backward_blockwise") if long
               else ("flash_forward_full", "flash_backward_full"))
    for r, res in enumerate(ranks):
        if res["world"] != DP_WORLD or len(res["steps"]) != steps:
            raise AssertionError(f"rank {r}: world {res['world']}, "
                                 f"{len(res['steps'])} steps")
        for i, st in enumerate(res["steps"]):
            c = st["counts"]
            others = {n: v for n, v in c.items() if n not in kernels and v}
            if (c[kernels[0]], c[kernels[1]]) != (want, want) or others:
                raise AssertionError(
                    f"rank {r} step {i}: launches {c}, expected {want} of "
                    f"{kernels[0]} and {kernels[1]} and no other")
            if st["shape"] != [accum, rows, seg]:
                raise AssertionError(f"rank {r} step {i}: batch "
                                     f"{st['shape']}, expected "
                                     f"{[accum, rows, seg]}")
            terms = [st["metrics"][k] for k in ("rec_loss", "kld",
                                                "token_kld", "grad_norm")]
            if not all(math.isfinite(x) for x in terms):
                raise AssertionError(f"rank {r} step {i}: metrics "
                                     f"{st['metrics']}")
        log(f"dp{' long' if long else ''} rank {r} on {res['device']}: "
            + "; ".join(
                f"step {i} {st['sec'] * 1e3:.1f} ms (all-reduce "
                f"{st['reduce_sec'] * 1e3:.1f} ms), {st['tokens']} tokens, "
                f"{kernels[0]} {st['counts'][kernels[0]]}, {kernels[1]} "
                f"{st['counts'][kernels[1]]}, rec_loss "
                f"{st['metrics']['rec_loss']:.4f}, grad_norm "
                f"{st['metrics']['grad_norm']:.4f}"
                for i, st in enumerate(res["steps"]))
            + f"; peak memory {res['peak'] / 2 ** 30:.2f} GiB; fit wall "
              f"{res['wall']:.1f} s")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the ranks' parameters differ after fit")
    for i in range(steps):
        a, b = (res["steps"][i]["metrics"] for res in ranks)
        if a != b:
            raise AssertionError(f"step {i}: the ranks logged {a} and {b}")
    timed = [res["steps"][1:] or res["steps"] for res in ranks]
    sec = statistics.median(st["sec"] for st in timed[0])
    red = statistics.median(st["reduce_sec"] for st in timed[0])
    tokens = statistics.median(st["tokens"] for st in timed[0])
    log(f"dp{' long' if long else ''} summary ({DP_WORLD} ranks sharing one "
        f"card over gloo: no scaling claim; {ranks[0]['nparams'] / 1e6:.1f} "
        f"M parameters): median step {sec * 1e3:.1f} ms over "
        f"{len(timed[0])} step(s) of rank 0 ({rows} rows x accumulation "
        f"{accum} x {seg} frames per rank), {tokens / sec:.0f} tokens/s per "
        f"rank, all-reduce {red / sec:.1%} of the step, peak memory per "
        f"rank {', '.join(f'{r_['peak'] / 2 ** 30:.2f}' for r_ in ranks)} "
        f"GiB; parameters and logged metrics equal across ranks ({gpu})")
    return {n: sum(st["counts"][n] for st in ranks[0]["steps"])
            for n in kernels}


def read_back(path: str, cfg: dict, dev, digest: str) -> None:
    """Strictly load rank 0's compact checkpoint into a fresh LVTR of the
    config; its parameters must equal rank 0's at the end of fit."""
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.training.checkpoint import load_compact

    model = LVTR(Hparams.from_dict(cfg["model"]), input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(9))
    load_compact(model, path)
    got = _param_digest(p for _, p in model.named_parameters())
    if got != digest:
        raise AssertionError("last-cpt.npz read back differs from rank 0's "
                             "parameters")
    log("dp: rank 0's last-cpt.npz read back strictly, equal to the ranks' "
        "parameters")
    del model


def main() -> int:
    # keep CUPTI set up between profiler windows (torch's own workaround
    # for its re-initialisation, which has left windows with no kernel)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2])
    sys.path.insert(0, ROOT)
    import vae_gslm_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    gpu = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"device: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for float32 matmul and cuDNN")

    from concurrent.futures import ThreadPoolExecutor

    from vae_gslm_tpu_torch.data import native
    from vae_gslm_tpu_torch.ops import build
    names = ("fused_decode", "mega_step", "flash_attention", "flash_decode",
             "stream")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:   # one nvcc per source
        jobs = [pool.submit(build.load, n) for n in names]
        jobs.append(pool.submit(native.get_lib))   # g++ of native/dataio.cc
        for job in jobs:
            job.result()
    log(f"build: {', '.join(n + '.cu' for n in names)} (K1, K2, "
        f"K3/K3b/K4/K4b/K5/K5b, K6, K7) and native/dataio.cc in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in build.BUILD_LOG.items():
        log(f"nvcc {name} ({sec:.1f} s): "
            + " | ".join(x.strip() for x in text.splitlines()
                         if "registers" in x or "spill" in x))

    spent = []

    def timed(name, fn, *args, **kw):
        """``fn``'s result; its wall seconds go to the closing log line."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        spent.append(f"{name} {time.perf_counter() - t:.1f}")
        return out

    k1 = timed("k1", phase_k1, dev)
    k2 = timed("k2", phase_k2, dev)
    k2w4 = timed("k2_w4", phase_k2_w4, dev)
    k3, k3b = timed("k3", phase_k3, dev)
    k4_worst, k5 = timed("k45", phase_k45, dev)
    k4, k4b, k5b = timed("k45b", phase_k45b, dev, k4_worst)
    k6 = timed("k6", phase_k6, dev)
    k7 = timed("k7", phase_k7, dev, gpu)
    timed("small_k1", phase_small, dev, quantize=False)
    timed("small_k2", phase_small, dev, quantize=True)
    timed("small_w4", phase_small, dev, quantize=True, w4=128)
    for per_layer in ("int8", "k6", "float"):
        timed(f"small_{per_layer}", phase_small, dev, quantize=True,
              per_layer=per_layer)
    timed("train_small", phase_train_small, dev)
    timed("likelihood_small", phase_likelihood_small, dev)
    timed("dp_small", phase_dp_small, dev)
    k1["launches"] = timed("pipeline_k1", phase_pipeline, dev, gpu,
                           quantize=False)
    timed("pipeline_k2", phase_pipeline, dev, gpu, quantize=True)
    k6["launches"] = timed("per_layer", phase_per_layer, dev, gpu)
    k3["launches"], k3b["launches"] = timed("train", phase_train, dev, gpu)
    dp = timed("dp_fit", phase_dp_fit, dev, gpu)
    k4["launches"] = dp["flash_forward_full"]
    k4b["launches"] = dp["flash_backward_full"]
    k5b["launches"] = timed("dp_fit_long", phase_dp_fit, dev, gpu,
                            long=True)["flash_backward_blockwise"]
    import shutil
    import tempfile

    flagship = tempfile.mkdtemp(prefix="flagship_")
    try:
        ckpt, _ = timed("flagship", write_flagship, flagship, dev)
        k5["launches"] = timed("score", phase_score, dev, gpu, ckpt)
        config = write_cli_corpus(flagship)
        k2["launches"] = timed("cli_k2", phase_cli, dev, gpu, config,
                               w4=False)
        k2w4["launches"] = timed("cli_w4", phase_cli, dev, gpu, config,
                                 w4=True)
        timed("cli_per_layer", phase_cli, dev, gpu,
              write_cli_corpus(flagship, n=PL_B), n_wavs=PL_B)
    finally:
        shutil.rmtree(flagship, ignore_errors=True)
    log("phase seconds: " + ", ".join(spent))
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k2w4, k3, k3b, k4, k4b, k5,
                                  k5b, k6, k7]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
