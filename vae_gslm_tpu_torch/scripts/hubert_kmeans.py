"""HuBERT + k-means semantic tokenization CLI (port of
``vae_gslm_tpu/scripts/hubert_kmeans.py``).

    python -m vae_gslm_tpu_torch.scripts.hubert_kmeans -i METADATA
        -w WAVDIR -o OUTPUT -m HF_DIR [-c CENTROIDS] [-d DELIM] [-v 200]
        [-p 0.1] [-s 60] [-b 8] [--bf16] [--device cuda|cpu]

Without ``-c`` (mode A) it encodes a random ``--percentage`` of the
files, trains k-means (``--vocab`` clusters, 20 iterations) and saves
the centroids as ``kmeans_v{vocab}.npy`` beside ``OUTPUT``; then (either
mode) it writes ``line|tok tok ...`` for every file, in metadata order.
Clips of ``size_max`` s or more are skipped; the audio must be 16 kHz.
Files are encoded in fixed batches of ``--batch_size`` within 1 s length
buckets, 512 files at a time, with the audio decoded by 8 threads.
``-m`` is a local HF HuBERT directory (``models/ssl/hubert.py::
from_hf_pretrained``); ``--bf16`` runs the encoder under the bf16-mixed
policy.  The encoder and k-means run on the card unless ``--device cpu``.
Mode A's subset is drawn by an unseeded ``random.sample``, as in the
JAX CLI, so its centroids differ from run to run; mode B is
deterministic.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BUCKET = 16000          # 1 s length buckets
SLAB = 512              # files resident in memory at once


def load_metadata(metadata: str):
    lines, fns = [], []
    with open(metadata, "r", errors="ignore") as f:
        for line in f:
            if not line.strip():
                continue
            lines.append(line.strip())
            fns.append(line.strip().split("|")[0])
    return lines, fns


def main(argv: Optional[List[str]] = None,
         timings: Optional[Dict[str, float]] = None) -> int:
    """Run the CLI on ``argv``; returns the number of lines written.
    With ``timings`` the encoder's seconds (``encode_s``, device
    synchronised), the seconds of audio it encoded (``audio_s``) and
    k-means training's seconds (``kmeans_s``) are added to it."""
    parser = argparse.ArgumentParser(
        prog="Run HuBERT tokenization on a parsed metadata")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-w", "--wavdir", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-m", "--model",
                        default="facebook/hubert-large-ll60k")
    parser.add_argument("-c", "--centroids", default=None)
    parser.add_argument("-d", "--delimiter", default=" ")
    parser.add_argument("-v", "--vocab", type=int, default=200)
    parser.add_argument("-p", "--percentage", type=float, default=0.1)
    parser.add_argument("-s", "--size_max", type=float, default=60)
    parser.add_argument("-b", "--batch_size", type=int, default=8)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute for the encoder")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from ..core.device import resolve_device
    from ..core.precision import Policy, bf16_mixed, policy_scope
    from ..data import audio as audio_lib
    from ..models.ssl.hubert import from_hf_pretrained, normalize_input
    from ..ops.kmeans import KMeans

    dev = resolve_device(args.device)
    policy = bf16_mixed() if args.bf16 else Policy()
    model = from_hf_pretrained(args.model, device=dev).eval()
    times = {"encode_s": 0.0, "audio_s": 0.0, "kmeans_s": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def load_one(fn: str) -> Optional[np.ndarray]:
        wave, sr = audio_lib.load_audio(os.path.join(args.wavdir, fn))
        assert sr == 16000
        wave = audio_lib.to_mono(wave)
        if len(wave) / float(sr) >= args.size_max:
            return None
        return normalize_input(wave)

    bsz = args.batch_size

    @torch.no_grad()
    def encode_many(waves: List[Optional[np.ndarray]]
                    ) -> List[Optional[np.ndarray]]:
        """Batched, bucket-padded encoding; feats[i] aligns with waves[i]
        (None for a skipped file)."""
        feats: List[Optional[np.ndarray]] = [None] * len(waves)
        buckets = defaultdict(list)
        for i, w in enumerate(waves):
            if w is not None and len(w) > 0:
                padded = int(np.ceil(len(w) / BUCKET)) * BUCKET
                buckets[padded].append(i)
        for padded in sorted(buckets):
            idxs = buckets[padded]
            for start in range(0, len(idxs), bsz):
                chunk = idxs[start: start + bsz]
                # fixed batch: empty rows pad it, as in JAX
                batch = np.zeros((bsz, padded), np.float32)
                lengths = np.zeros((bsz,), np.int32)
                for j, gi in enumerate(chunk):
                    w = waves[gi]
                    batch[j, : len(w)] = w
                    lengths[j] = len(w)
                sync()
                t0 = time.perf_counter()
                with policy_scope(policy):
                    out = model(torch.from_numpy(batch).to(dev),
                                torch.from_numpy(np.maximum(lengths, 1))
                                .to(dev)).cpu().numpy()
                times["encode_s"] += time.perf_counter() - t0
                times["audio_s"] += float(lengths.sum()) / 16000.0
                for j, gi in enumerate(chunk):
                    nf = model.frame_count(int(lengths[j]))
                    feats[gi] = out[j][:nf]
        return feats

    def slabs(items):
        for i in range(0, len(items), SLAB):
            yield items[i: i + SLAB]

    dataset = list(zip(*load_metadata(args.input)))
    written = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        if args.centroids is None:
            subset = random.sample(dataset,
                                   int(len(dataset) * args.percentage))
            kmvs = []
            for slab in slabs(subset):
                waves = list(pool.map(load_one, [fn for _, fn in slab]))
                kmvs.extend(f for f in encode_many(waves) if f is not None)
            kmvs = np.concatenate(kmvs, 0)
            logging.info("Training Kmeans on %s features...", kmvs.shape)
            kmeans = KMeans(kmvs.shape[-1], args.vocab, niter=20,
                            device=dev)
            t0 = time.perf_counter()
            kmeans.train(kmvs)
            times["kmeans_s"] += time.perf_counter() - t0
            index_fn = (Path(args.output).parents[0]
                        / f"kmeans_v{args.vocab}.npy")
            kmeans.save(str(index_fn))
            logging.info("Saved centroids to %s", index_fn)
        else:
            kmeans = KMeans.load(args.centroids, device=dev)

        with open(args.output, "w") as f:
            for slab in slabs(dataset):
                waves = list(pool.map(load_one, [fn for _, fn in slab]))
                feats = encode_many(waves)
                for (line, _fn), ft in zip(slab, feats):
                    if ft is None:
                        continue
                    toks = kmeans.search(ft)
                    f.write(f"{line}|"
                            f"{args.delimiter.join(map(str, toks))}\n")
                    written += 1
    logging.info("Wrote tokens to %s", args.output)
    if timings is not None:
        for k, v in times.items():
            timings[k] = timings.get(k, 0.0) + v
    return written


if __name__ == "__main__":
    main()
