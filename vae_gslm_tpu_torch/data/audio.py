"""Host-side audio IO and signal utilities (port of
``vae_gslm_tpu/data/audio.py``, numpy).

WAV and FLAC decode through the port's build of ``native/dataio.cc``
(``data/native.py``); resampling uses its windowed-sinc resampler.  The
JAX package falls back to scipy where its library is missing; the port
raises instead.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import native

SAMPLE_RATE_POOL = [16000, 44100, 48000, 24000]


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV or FLAC file to (mono float32 samples, sample rate)."""
    lower = path.lower()
    if lower.endswith(".flac"):
        return native.flac_read(path)
    if lower.endswith(".wav"):
        return native.wav_read(path)
    raise ValueError(f"Only WAV/FLAC decoding is available in this build: "
                     f"{path}. Convert other codecs to WAV first.")


def save_wav(path: str, wave: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM WAV of a float signal clipped to [-1, 1]."""
    from scipy.io import wavfile

    wave = np.clip(np.asarray(wave, np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (wave * 32767.0).astype(np.int16))


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(0)
    return audio


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    if orig_sr == new_sr:
        return audio
    return native.resample(audio, orig_sr, new_sr)


def dither(audio: np.ndarray, rng: np.random.RandomState,
           scale: float = 1.0 / 32768.0) -> np.ndarray:
    """TPDF dither (the reference uses torchaudio.functional.dither)."""
    noise = (rng.rand(*audio.shape) - rng.rand(*audio.shape)) * scale
    return (audio + noise).astype(np.float32)


def random_crop_1d(signal, sample_rate: float, min_crop_length_sec: float,
                   rng: np.random.RandomState,
                   return_start_end: bool = False):
    """Crop along the first dimension (``utils/helpers.py:35-51``)."""
    min_crop = int(min_crop_length_sec * sample_rate)
    if min_crop >= len(signal):
        if return_start_end:
            return signal, 0, len(signal)
        return signal
    start = int(rng.randint(0, len(signal) - min_crop + 1))
    out = signal[start: start + min_crop]
    if return_start_end:
        return out, start, start + min_crop
    return out


def pad_1d(signal: np.ndarray, sample_rate: float, length_sec: float,
           padding_mode: str = "constant") -> np.ndarray:
    """Pad the first dimension to ``length_sec`` (``utils/helpers.py:
    54-67``)."""
    length = int(length_sec * sample_rate)
    if len(signal) >= length:
        return signal
    pad = [(0, length - len(signal))] + [(0, 0)] * (signal.ndim - 1)
    return np.pad(signal, pad, mode=padding_mode)


def truncate_1d(signal: np.ndarray, sample_rate: float,
                length_sec: float) -> np.ndarray:
    length = int(length_sec * sample_rate)
    if len(signal) < length:
        return signal
    return signal[:length]

