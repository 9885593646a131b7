#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, no result):
  1. device: the card's name and power limit; TF32 switched off for
     float32 matmuls and convolutions (the comparisons below are float32;
     the pipelines themselves run bfloat16);
  2. build: every kernel of the port's speech-continuation paths, from
     ``vae_gslm_tpu_torch/csrc`` with one nvcc per source, all started
     together (K1 ``fused_decode.cu``, K2 ``mega_step.cu``), with nvcc's
     register and spill lines;
  3. K1 against its plain PyTorch version at the flagship width (16
     layers, 16 heads, head_dim 64) at B = 8 and 32 over the cache
     states the 150 -> 650 rollout passes through; kernel and plain
     device times (torch.profiler), the time per call with the wrapper
     (CUDA events), the HBM-bytes bound;
  4. K2 (the whole 16-layer trunk step) against its plain version at the
     flagship width, B = 8 with s8 x s8 products and B = 32 with bf16
     products, over five (flushed, pos) cache states, at max |diff| <=
     2e-3 |want| + 2e-4; then its times at B = 8 as K1's;
  5. agreement on a small input, twice: a small LVTR (head_dim 64)
     continues a prompt by 300 frames on the card (through the kernels)
     and on the CPU (through the plain versions), float32, temperature 0,
     with bf16 weights through K1 across a 256-position flush, and with
     int8 weights through K2 (dim 256) across 8-step merges and two
     128-position flushes: the token streams agree until at least step
     150, the latents of the first 64 steps to 1e-2;
  6. the main paths: a 3 s -> 10 s continuation at B = 8 at the full
     width of ``configs/train/speech/vae-gslm.yaml`` (weights from seed
     0; the utterance encoder, not ported yet, left out), int8 KV cache,
     temperature 0.85, DDIM-100 at eta 0.5, then the HiFi-GAN of
     ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml``; each run
     three times (stage times: median and range) with the kernels'
     counts set to 0 just before a run and read just after:
       - bf16 weights (the hybrid path): exactly 16 x 500 K1 launches and
         no K2 launch per run;
       - int8 weights quantized from the float32 weights, the rest cast
         to bf16 (the shipped ``weight_dtype: int8`` path): exactly 500
         K2 launches and no K1 launch per run; then one B = 64 run, two
         sequential B = 32 chunks with bf16 products, 1000 K2 launches;
     then, for each path, a profile of 64 AR steps: the device busy
     share and the kernels that take it.
Output: one line per measurement, then the ``{"kernels": [...]}`` line,
the nvidia-smi name/power line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

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


def device_ms(fn, n: int) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler's CUDA activity (their own durations: host gaps
    between launches are left out), after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / n


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

        ks.append(device_ms(kernel, n=200))
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


def k2_bytes_ops(b: int, pos: int, flushed: int, a8: bool):
    """Bytes one call must move (int8 weights and their float32 vectors,
    the valid cache rows of every layer, x in and out, the new K/V rows)
    and its operations (dense multiply-adds; QK and PV over the valid
    rows), and the card's peak rate for their type."""
    d = H * D
    stage_base = pos - (pos - flushed) % 8
    weight_bytes = L * (12 * d * d + 4 * (2 * 9 * d + 2 * d))
    rows_i8 = stage_base                      # cold + merged tail rows
    rows_bf16 = pos - stage_base              # stage rows
    cache_bytes = L * b * H * (rows_i8 * 2 * (D + 4) + rows_bf16 * 4 * D)
    io_bytes = 2 * b * d * 4 + 2 * L * H * b * D * 2 + H * 4
    ops = 2 * b * L * 12 * d * d + L * b * H * 4 * D * (pos + 1)
    peak = INT8_OPS_PER_S if a8 else BF16_FLOPS
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


def phase_small(dev, quantize: bool):
    """A small LVTR continues a prompt by 300 frames on the card (through
    the kernels) and on the CPU (through the plain versions), float32,
    temperature 0: bf16 weights through K1, or int8 weights through K2
    (a8 at B = 2) across eight-step merges and two tail -> cold flushes."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR

    rng = np.random.RandomState(1)
    b, tp, length = 2, 20, 300
    prompt = np.concatenate([rng.randint(0, 50, (b, tp, 1)),
                             rng.randn(b, tp, 80)], -1).astype(np.float32)
    # the CPU and the card draw different streams from one seed, so the
    # uniform initial AR state is pinned on both, as the tests pin it
    init = torch.from_numpy(rng.rand(b, 1, 32).astype(np.float32) * 2 - 1)
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
        sampler = ARTRSampler(model, quantize_weights=quantize, device=where)
        if sampler.use_mega != quantize:
            raise AssertionError("the small int8 model missed the mega path")
        x = torch.from_numpy(prompt).to(where)
        out = sampler(length, Masked.from_lengths(x, [tp] * b),
                      torch.Generator(where).manual_seed(0),
                      temperature=0.0, token_temperature=1e-6,
                      encoder_temperature=0.0)
        runs[str(where)] = out["frames"].value.float().cpu().numpy()
    cpu, gpu = runs["cpu"][:, tp:], runs[str(dev)][:, tp:]
    neq = (cpu[..., 0] != gpu[..., 0]).any(0)
    first = int(neq.argmax()) if neq.any() else length
    lat_err = float(np.abs(cpu[:, :64, 1:] - gpu[:, :64, 1:]).max())
    what = "int8 weights through K2" if quantize else "bf16 through K1"
    log(f"small-input agreement (card {what} vs CPU plain, {length} steps "
        f"across flushes): tokens equal for the first {first} steps, "
        f"first-64-step latent max error {lat_err:.2e}")
    if first < 150 or not lat_err < 1e-2:
        raise AssertionError("the card and the CPU disagree on a small "
                             "input")


# --------------------------------------------------------- main paths
def build_pipeline(dev, quantize: bool):
    """The full-width LVTR of ``configs/train/speech/vae-gslm.yaml``
    (weights from seed 0, the utterance encoder left out), its sampler
    with an int8 KV cache, and the HiFi-GAN.  With ``quantize`` the trunk
    is quantized to int8 from the float32 weights; the remaining float
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
    sampler = ARTRSampler(model, kv_dtype=torch.int8,
                          quantize_weights=quantize, device=dev)
    if sampler.use_mega != quantize:
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
    """One continuation and its vocoding with both kernels' counts set to
    0 just before and read just after.  Returns (stage seconds, K1
    launches, K2 launches)."""
    import torch

    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step

    batch = prior.value.shape[0]
    fused_decode_attention.launches = 0
    fused_trunk_step.launches = 0
    timings = {}
    out = sampler(LENGTH, prior, torch.Generator(dev).manual_seed(seed),
                  timings=timings, **kw)
    t0 = time.perf_counter()
    wave = vocoder(out["output"])
    torch.cuda.synchronize()
    timings["vocoder"] = time.perf_counter() - t0
    counts = fused_decode_attention.launches, fused_trunk_step.launches
    check_outputs(out, wave, batch)
    return timings, counts


def phase_pipeline(dev, gpu: str, quantize: bool):
    """The 3 s -> 10 s continuation at B = 8, three times: bf16 weights
    through K1 (16 x 500 launches, no K2) or int8 weights through K2 (500
    launches, a8, no K1); with int8 weights also one B = 64 run (two
    sequential B = 32 chunks, bf16 products, 1000 K2 launches).  Then a
    profile of 64 AR steps.  Returns the path's kernel count of its last
    B = 8 run."""
    import torch

    path = "int8 weights, K2" if quantize else "bf16 weights, K1"
    sampler, vocoder = build_pipeline(dev, quantize)
    prior = make_prior(8, dev)
    kw = dict(temperature=0.85, token_temperature=0.85)
    want = (0, LENGTH) if quantize else (L * LENGTH, 0)

    # warm-up (allocator, cuBLAS/cuDNN handles, lazily loaded kernels) on
    # a short continuation and its vocoding
    vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                    **kw)["output"])
    torch.cuda.synchronize()

    # Three runs: the stage times vary from run to run with the host (the
    # AR loop is host-bound), so their median and range are reported.
    runs = []
    for rep in range(3):
        timings, counts = run_once(sampler, vocoder, prior, dev, 1 + rep, kw)
        log(f"run {rep} ({path}): K1 launches {counts[0]}, K2 launches "
            f"{counts[1]}; " + ", ".join(
                f"{name} {sec * 1e3:.1f} ms" for name, sec in timings.items()))
        if counts != want:
            raise AssertionError(f"launches (K1, K2) = {counts}, expected "
                                 f"{want}")
        runs.append(timings)
    launches = counts[1] if quantize else counts[0]
    audio_s = 8 * LENGTH / 50.0
    for name in runs[0]:
        secs = sorted(r[name] for r in runs)
        log(f"stage {name} ({path}): median {secs[1] * 1e3:.1f} ms, range "
            f"{secs[0] * 1e3:.1f}-{secs[-1] * 1e3:.1f} ms ({gpu})")
    rtf = sorted(audio_s / sum(r.values()) for r in runs)
    log(f"pipeline B=8 ({path}): {audio_s:.0f} s of audio, real-time "
        f"factor median {rtf[1]:.2f}x, range {rtf[0]:.2f}-{rtf[-1]:.2f}x "
        f"over {len(runs)} runs ({gpu})")
    if quantize:
        prior64 = make_prior(64, dev)
        timings, counts = run_once(sampler, vocoder, prior64, dev, 7, kw)
        rtf64 = 64 * LENGTH / 50.0 / sum(timings.values())
        log(f"run B=64 ({path}, two B=32 chunks): K1 launches {counts[0]}, "
            f"K2 launches {counts[1]}; " + ", ".join(
                f"{name} {sec * 1e3:.1f} ms" for name, sec in timings.items())
            + f"; real-time factor {rtf64:.2f}x ({gpu})")
        if counts != (0, 2 * LENGTH):
            raise AssertionError(f"B=64: launches (K1, K2) = {counts}, "
                                 f"expected (0, {2 * LENGTH})")
    profile_ar_loop(sampler, prior, dev, gpu, kw, path)
    return launches


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
    mega = sampler.use_mega
    g = torch.Generator(dev).manual_seed(2)
    with torch.no_grad():
        enc = model.encode(prior, g)
        stacked = model.transformer.build_stacked_decode()
        frame, cache, flushed = sampler.prefill(enc, steps, stacked, g,
                                                mega=mega, **kw)
        pos0 = enc.value.shape[1] + 1
        if mega:
            weights = model.transformer.build_mega_decode()

            def run():
                mega_scan_segments(frame, cache, flushed, pos0, steps,
                                   lambda fr, c, p, f: model.step_mega(
                                       fr, weights, c, p, f, g, **kw))
        else:
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
    log(f"AR loop profile ({path}), {steps} steps at B=8 (profiler on): "
        f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({busy_ms / wall_ms:.1%}), {sum(k[1] for k in kernels):.0f} "
        f"device ops/step ({gpu})")
    for ms, n, name in sorted(kernels, reverse=True)[:8]:
        log(f"  {ms:.4f} ms/step, {n:.0f}/step: {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
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

    from vae_gslm_tpu_torch.ops import build
    names = ("fused_decode", "mega_step")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(build.load, names))
    log(f"build: {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in build.BUILD_LOG.items():
        log(f"nvcc {name} ({sec:.1f} s): "
            + " | ".join(x.strip() for x in text.splitlines()
                         if "registers" in x or "spill" in x))

    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_small(dev, quantize=False)
    phase_small(dev, quantize=True)
    k1["launches"] = phase_pipeline(dev, gpu, quantize=False)
    k2["launches"] = phase_pipeline(dev, gpu, quantize=True)
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
