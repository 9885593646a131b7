"""Time the end-to-end paths of several checkouts on one card, in one
call, so that a change's effect on them can be told from the card's and
the host's drift between calls:

    python vae_gslm_tpu_torch/scripts/phase_ab.py [--only vocoder,train]
        ROOT [ROOT ...]

Each ROOT is a directory holding ``chip_smoke.py``, ``configs`` and the
``vae_gslm_tpu_torch`` package (a checkout, or ``git archive <commit>
chip_smoke.py configs vae_gslm_tpu_torch native`` unpacked; ``vocoder``
alone needs only the package).  The roots run one after another, each in
a process of its own that imports that root's code and builds its
kernels, in the order given: list them as A B B A.  The entries, all of
them unless ``--only`` names some:

- ``vocoder``: the generator of this checkout's
  ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml`` as the
  serving and CLI paths run it.  A directory with that config as
  ``hp.yaml`` and a reference-form state dict (``weight_g``,
  ``weight_v``, ``bias`` drawn from numpy seed 1) as ``last-cpt.ckpt``
  goes through the root's ``HiFiGAN.from_pretrained`` on the card, which
  decodes seeded mels of 650 frames (a 3 s prompt plus 10 s) under the
  bf16-mixed policy at batch 8 (the serving path) and 32 and 64 (the
  CLI's chunks and batch).  A time is the median over 5 runs of the
  mean of 3 ``decode`` calls by CUDA events, after one warm-up call.
- ``train``: the root's ``chip_smoke.py::phase_train`` (six full-width
  LVTR training steps through K3/K3b).
- ``pipeline``: the root's ``chip_smoke.py::phase_pipeline`` on the bf16
  (K1) and the int8 (K2) weights (the B = 8 continuation and its stage
  times, the vocoder's among them).

The ``chip_smoke.py`` entries run with both TF32 flags off, as that
script's ``main`` sets them.  Each root's lines are printed under its
name (``vocoder`` as one JSON line); then the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

ENTRIES = ("vocoder", "train", "pipeline")
FRAMES, BATCHES, CALLS, RUNS = 650, (8, 32, 64), 3, 5
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "train", "vocoder",
    "hfgan_16k_50hz_librispeech.yaml")


def _reference_state(names_shapes, seed: int = 1) -> dict:
    """A weight-normed state dict in the reference's names for every conv
    weight of ``names_shapes`` ((name, shape) of a generator's
    ``weight``/``weight_v`` and ``bias`` entries, sorted): v normal 0.01,
    g = ||v|| x U(0.8, 1.2), bias uniform +-1/sqrt(fan in)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    shapes = dict(names_shapes)
    out = {}
    for name, shape in names_shapes:
        prefix, leaf = name.rsplit(".", 1)
        if leaf not in ("weight", "weight_v"):
            continue
        v = rng.randn(*shape) * 0.01
        g = np.sqrt((v ** 2).sum(axis=(1, 2))) * rng.uniform(0.8, 1.2,
                                                              shape[0])
        fan = shape[1] * shape[2]
        out[f"{prefix}.weight_v"] = torch.from_numpy(v.astype(np.float32))
        out[f"{prefix}.weight_g"] = torch.from_numpy(
            g.astype(np.float32).reshape(-1, 1, 1))
        out[f"{prefix}.bias"] = torch.from_numpy(rng.uniform(
            -1, 1, shapes[f"{prefix}.bias"]).astype(np.float32)
            / np.sqrt(fan))
    return out


def time_vocoder(root: str, dev="cuda") -> dict:
    import shutil

    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN

    dev = torch.device(dev)
    hp = Hparams.from_yamlfile(CONFIG)
    sd = HiFiGAN(hp, device="cpu").model.state_dict()
    state = _reference_state(sorted((k, tuple(v.shape))
                                    for k, v in sd.items()))
    tmp = tempfile.mkdtemp(prefix="vocoder_ab_")
    try:
        shutil.copy(CONFIG, os.path.join(tmp, "hp.yaml"))
        torch.save(state, os.path.join(tmp, "last-cpt.ckpt"))
        voc = HiFiGAN.from_pretrained(tmp, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    voc.model.requires_grad_(False)
    precision.set_policy(precision.bf16_mixed())
    out = {"root": root, "source": sys.modules[HiFiGAN.__module__].__file__}
    for b in BATCHES:
        g = torch.Generator(dev).manual_seed(b)
        mel = Masked.from_lengths(torch.randn(
            (b, FRAMES, hp.model.generator.in_channels), generator=g,
            device=dev) * 2 - 5, [FRAMES] * b)
        wave = voc.decode(mel).value
        times = []
        for _ in range(RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                voc.decode(mel)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        out[f"B{b}"] = {"ms": round(statistics.median(times), 4),
                        "mean_abs": float(wave.float().abs().mean())}
    precision.set_policy(precision.Policy())
    return out


def run_root(root: str, only) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    if "vocoder" in only:
        print(json.dumps({"vocoder": time_vocoder(root)}), flush=True)
    if not {"train", "pipeline"} & set(only):
        return 0
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from vae_gslm_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    with ThreadPoolExecutor(3) as pool:      # one nvcc per source
        for job in [pool.submit(build.load, name) for name in
                    ("fused_decode", "mega_step", "flash_attention")]:
            job.result()
    cs.log(f"root {root}: chip_smoke {cs.__file__}")
    if "train" in only:
        cs.phase_train(dev, gpu)
    if "pipeline" in only:
        cs.phase_pipeline(dev, gpu, quantize=False)
        cs.phase_pipeline(dev, gpu, quantize=True)
    return 0


def main(argv) -> int:
    only = list(ENTRIES)
    if argv[:1] == ["--only"]:
        only, argv = argv[1].split(","), argv[2:]
        unknown = sorted(set(only) - set(ENTRIES))
        if unknown:
            print(f"unknown entries {unknown}; known: {ENTRIES}",
                  file=sys.stderr)
            return 2
    if argv[:1] == ["--one"]:
        return run_root(argv[1], only)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--only", ",".join(only), "--one", root],
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            print(f"[{root}] {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
