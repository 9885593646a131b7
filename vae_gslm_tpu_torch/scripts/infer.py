"""Inference CLI (port of ``vae_gslm_tpu/scripts/infer.py``).

    python -m vae_gslm_tpu_torch.scripts.infer -c CONFIG [-v VERSION]
        [--max_batches N] [--seed S] [--device cuda|cpu]

Reads an infer config, resolves its ``identifier`` inside this package
(``scripts/registry.py``) and runs the inferer.  ``-v VERSION`` copies
the newest compact checkpoint of ``{exp_dir}/ckpt/version_VERSION``,
its ``hp.yaml`` (or the log directory's) and ``symbols.json`` into a
temporary checkpoint directory, removed afterwards.  ``precision``
"16-mixed", "bf16-mixed" or "16" runs under the bf16-mixed policy, as
JAX's script sets it; the policy is restored on return.  The inferer
runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None,
         timings: Optional[Dict[str, float]] = None) -> int:
    """Run the CLI on ``argv``; returns the number of outputs.  With
    ``timings`` (in-process callers), the inferer's stage seconds are
    added to it."""
    parser = argparse.ArgumentParser(
        prog="Infer a model with a given config")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-v", "--version", default=None)
    parser.add_argument("-log", "--loglevel", default="WARNING")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.loglevel.upper())

    from ..core import precision
    from ..hparams.hp import Hparams
    from ..training.checkpoint import get_last_ckpt
    from .registry import resolve

    hp = Hparams.from_yamlfile(args.config)
    if hp.has("output_dir"):
        Path(hp.output_dir).mkdir(parents=True, exist_ok=True)

    tmp_dir = None
    try:
        if args.version is not None:
            hp.check_arg_in_hparams("exp_dir")
            tmp_dir = tempfile.mkdtemp(
                prefix=f"tmp_ckpt_infer_{args.version}_")
            exp_path = os.path.join(hp.exp_dir, "ckpt",
                                    f"version_{args.version}")
            last_ckpt = get_last_ckpt(exp_path)
            hp_path = os.path.join(exp_path, "hp.yaml")
            if not os.path.exists(hp_path):
                hp_path = os.path.join(hp.exp_dir, "log",
                                       f"version_{args.version}", "hp.yaml")
            ext = Path(last_ckpt).suffix
            shutil.copy(last_ckpt, os.path.join(tmp_dir, f"last-cpt{ext}"))
            shutil.copy(hp_path, os.path.join(tmp_dir, "hp.yaml"))
            sym = os.path.join(exp_path, "symbols.json")
            if os.path.exists(sym):
                shutil.copy(sym, os.path.join(tmp_dir, "symbols.json"))
            hp.ckpt_path = tmp_dir

        mixed = str(hp.get("precision", "32")) in ("16-mixed", "bf16-mixed",
                                                   "16")
        policy = precision.bf16_mixed() if mixed else precision.get_policy()
        with precision.policy_scope(policy):
            inferer = resolve(hp.identifier)(hp, device=args.device)
            n = inferer.run(seed=args.seed, max_batches=args.max_batches,
                            timings=timings)
        logging.info("produced %s outputs", n)
        return n
    finally:
        if tmp_dir is not None:
            shutil.rmtree(tmp_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
