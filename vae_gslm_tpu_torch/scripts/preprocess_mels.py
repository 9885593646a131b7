"""Precompute log-mel ``.npy`` files for a dataset (port of
``vae_gslm_tpu/scripts/preprocess_mels.py``).

    python -m vae_gslm_tpu_torch.scripts.preprocess_mels -c CONFIG
        -o OUTPUT_DIR [--split train|val] [--device cuda|cpu]

Iterates the config's mel dataset (``data.<split>``, or ``data``; the
frontend from ``mel`` or ``feature``) and saves each utterance's
float32 log-mel (T, n_mels) as ``.npy`` under ``OUTPUT_DIR``, mirroring
the WAV tree below ``wavdir``: the layout that ``preprocess_mels`` with
``preprocess_mels_recursive_dir`` reads.  The mels are computed on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv``; returns the number of mels written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-o", "--output_dir", required=True)
    parser.add_argument("--split", default="train", choices=["train", "val"])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..data.dataset import MelSpecDataset
    from ..hparams.hp import Hparams

    hp = Hparams.from_yamlfile(args.config)
    hp_data = hp.data.get(args.split, None) or hp.data
    hp_mel = hp.get("mel", None) or hp.get("feature", None)
    if hp_mel is None:
        raise ValueError("the config needs a mel: or feature: block")
    ds = MelSpecDataset(hp_data, hp_mel, name="preprocess",
                        device=args.device)
    wavdir = Path(hp_data.wavdir).resolve()
    for i in range(len(ds)):
        item = ds[i]
        rel = Path(ds.audios[i]).resolve()
        rel = str(rel.parent / (rel.stem + ".npy"))[len(str(wavdir)) + 1:]
        out = Path(args.output_dir) / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(str(out), item["mel"].float().cpu().numpy())
        if (i + 1) % 100 == 0:
            logging.info("saved %d/%d", i + 1, len(ds))
    logging.info("done: %d mels -> %s", len(ds), args.output_dir)
    return len(ds)


if __name__ == "__main__":
    main()
