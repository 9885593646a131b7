"""ctypes binding of the native data-IO library (port of
``vae_gslm_tpu/data/native.py``): WAV and FLAC decoding to mono float32
and windowed-sinc resampling, from the repository's ``native/dataio.cc``.

The port builds its own copy with ``g++`` at first use into
``vae_gslm_tpu_torch/_build/`` (listed in ``.gitignore``), never into
``native/``: under a lock file, through a temporary file and
``os.replace``, so concurrent processes (pytest-xdist workers, loader
processes) never load a half-written library.  The library file name
carries a hash of the source.  There is no fallback: a failed build
raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "dataio.cc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(build_dir: str = BUILD_DIR) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(build_dir, f"libdataio_{digest}.so")


def build_library(build_dir: str = BUILD_DIR) -> str:
    """Compile ``native/dataio.cc`` into ``build_dir`` unless it is
    there; returns the library path.  Builders serialize on a lock file
    and publish the library with an atomic rename."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libdataio.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):       # another builder may have won
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE,
                     "-o", tmp], capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed for native/dataio.cc:\n{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return path


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library with its argument types, built if needed."""
    if build_dir not in _LIBS:
        lib = ctypes.CDLL(build_library(build_dir))
        read_args = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                     ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                     ctypes.POINTER(ctypes.c_int64)]
        for fn in (lib.wav_read, lib.flac_read):
            fn.restype = ctypes.c_int
            fn.argtypes = read_args
        lib.resample_sinc.restype = ctypes.c_int64
        lib.resample_sinc.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _LIBS[build_dir] = lib
    return _LIBS[build_dir]


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _read(fn, path: str) -> Tuple[np.ndarray, int]:
    """A query call for the sample count, then the decode."""
    sr, n = ctypes.c_int32(0), ctypes.c_int64(0)
    if fn(path.encode(), None, 0, ctypes.byref(sr), ctypes.byref(n)) != 0:
        raise ValueError(f"cannot decode {path}")
    out = np.empty(max(n.value, 1), np.float32)
    if fn(path.encode(), _fptr(out), out.shape[0], ctypes.byref(sr),
          ctypes.byref(n)) != 0:
        raise ValueError(f"cannot decode {path}")
    return out[:n.value], int(sr.value)


def wav_read(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 samples and the sample rate of a WAV file."""
    return _read(get_lib().wav_read, path)


def flac_read(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 samples and the sample rate of a FLAC file."""
    return _read(get_lib().flac_read, path)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase kaiser-windowed-sinc resampling of a float32 signal."""
    x = np.ascontiguousarray(x, np.float32)
    max_out = int(len(x) * sr_out / sr_in) + 16
    out = np.empty(max_out, np.float32)
    n = get_lib().resample_sinc(_fptr(x), len(x), sr_in, sr_out, _fptr(out),
                                max_out)
    if n < 0:
        raise ValueError(f"resampling {sr_in} -> {sr_out} Hz failed")
    return out[:n]
