"""Experiment logging with versioned run directories (port of
``vae_gslm_tpu/training/logging.py``).

The layout is the JAX package's (the reference's TensorBoard layout):
``{log_dir}[/{name}]/log/version_N`` for the logs and
``{log_dir}[/{name}]/ckpt/version_N`` for checkpoints.  Scalars and text
go to ``metrics.jsonl`` in the log directory, one JSON object per line,
as the JAX logger writes them without tensorboardX; audio goes to
``audio/{tag}_step{N}.wav`` beside it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


def next_version(root: str) -> int:
    os.makedirs(root, exist_ok=True)
    versions = []
    for name in os.listdir(root):
        if name.startswith("version_"):
            try:
                versions.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                pass
    return max(versions) + 1 if versions else 0


class ExperimentLogger:
    def __init__(self, log_dir: str, name: Optional[str] = None,
                 version: Optional[int] = None):
        base = os.path.join(log_dir, name) if name else log_dir
        if version is None:
            version = next_version(os.path.join(base, "log"))
        self.version = version
        self.log_path = os.path.join(base, "log", f"version_{version}")
        self.ckpt_path = os.path.join(base, "ckpt", f"version_{version}")
        os.makedirs(self.log_path, exist_ok=True)
        os.makedirs(self.ckpt_path, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_path, "metrics.jsonl"),
                           "a")

    def _write(self, record: dict) -> None:
        record["time"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")

    def log_scalar(self, tag: str, value, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": step})

    def log_scalars(self, scalars: dict, step: int) -> None:
        for k, v in scalars.items():
            self.log_scalar(k, v, step)
        self._jsonl.flush()

    def log_audio(self, tag: str, wave, step: int,
                  sample_rate: int) -> None:
        from ..data.audio import save_wav

        out = os.path.join(self.log_path, "audio",
                           f"{tag.replace('/', '_')}_step{step}.wav")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_wav(out, np.asarray(wave, np.float32), sample_rate)

    def log_text(self, tag: str, text: str, step: int) -> None:
        self._write({"tag": tag, "text": text, "step": step})
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
