"""Training CLI (port of ``vae_gslm_tpu/scripts/train.py``).

    python -m vae_gslm_tpu_torch.scripts.train -c CONFIG [-n NAME]
        [-r CHECKPOINT] [--max_steps N] [--device cpu]

The JAX script's flags: ``-c/--config``, ``-n/--name``, ``-p/--profile``
(torch.profiler trace of steps 10-12 under the run's log directory),
``-s/--sanity`` (a validation pass before training),
``-d/--detect_anomaly`` (autograd anomaly detection),
``-r/--resume_checkpoint`` (a compact ``.npz`` or the port's full state
``full_state.pt``), ``-v/--version``, ``-log/--log_level`` and
``--max_steps``.  The trainer is resolved from the config's
``trainer.identifier`` inside this package.

Data-parallel ranks are launched as JAX's are, one process per rank
with ``VAE_GSLM_COORDINATOR`` (host:port of rank 0),
``VAE_GSLM_NUM_PROCESSES`` and ``VAE_GSLM_PROCESS_ID`` set, plus
``--backend nccl`` (a card per rank) or ``--backend gloo`` (CPU ranks,
or ranks that share a card).  Each rank runs on its card
(``parallel/mesh.py::rank_device``) unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-n", "--name", default=None)
    parser.add_argument("-p", "--profile", action="store_true")
    parser.add_argument("-s", "--sanity", action="store_true",
                        help="run a val pass before training")
    parser.add_argument("-d", "--detect_anomaly", action="store_true")
    parser.add_argument("-r", "--resume_checkpoint", default=None)
    parser.add_argument("-v", "--version", type=int, default=None)
    parser.add_argument("-log", "--log_level", default="INFO")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override trainer.total_steps (smoke runs)")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        default=None,
                        help="process-group backend of a data-parallel "
                             "launch (VAE_GSLM_COORDINATOR set)")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    import torch
    import torch.distributed as dist

    from ..hparams.hp import Hparams
    from ..parallel import mesh
    from ..training.logging import ExperimentLogger, next_version
    from .registry import resolve

    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if os.environ.get("VAE_GSLM_COORDINATOR") and args.backend is None:
        raise SystemExit("a data-parallel launch (VAE_GSLM_COORDINATOR "
                         "set) needs --backend nccl or --backend gloo")
    distributed = mesh.init_distributed(args.backend) \
        if args.backend else False
    try:
        hp = Hparams.from_yamlfile(args.config)
        hp.check_arg_in_hparams("trainer", "logging")
        hp.trainer.check_arg_in_hparams("identifier", "total_steps")
        device = (mesh.rank_device() if distributed
                  and args.device == "cuda" else args.device)
        trainer = resolve(hp.trainer.identifier)(hp, device=device)

        version = args.version
        if version is None and distributed:
            # one version directory for every rank: rank 0 picks it
            base = os.path.join(hp.logging.log_dir, args.name or "")
            box = [next_version(os.path.join(base, "log"))
                   if mesh.process_index() == 0 else None]
            dist.broadcast_object_list(box, 0)
            version = box[0]
        logger = ExperimentLogger(hp.logging.log_dir, name=args.name,
                                  version=version)
        if mesh.process_index() == 0:
            hp.save(os.path.join(logger.ckpt_path, "hp.yaml"))
        if args.resume_checkpoint:
            trainer.resume(args.resume_checkpoint)
        if args.sanity:
            trainer.logger = logger
            trainer.validation_run(step=0)
        profile_dir = (os.path.join(logger.log_path, "profile")
                       if args.profile else None)
        trainer.fit(logger, max_steps=args.max_steps,
                    profile_dir=profile_dir)
        logger.close()
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
