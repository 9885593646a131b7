"""Log-mel spectrogram frontend (port of ``vae_gslm_tpu/data/features.py``).

The reference's ``torchaudio.transforms.MelSpectrogram`` settings:
power-1 magnitude STFT with centre reflect padding and a periodic Hann
window, an HTK mel filterbank without norm, then ``log(clamp(x, 1e-6))``.
As in the JAX package the STFT is a windowed-DFT matmul: the frames
times a ``(n_fft, 2 * bins)`` basis with the window folded in, built in
float64 and stored float32.  It runs on the processor's device (the
estimator's); float32 products are exact float32 there only with TF32
off (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.masked import Masked, resize_length
from ..hparams.hp import Hparams


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, matching ``torch.hann_window``."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(
        np.float32)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int) -> np.ndarray:
    """HTK triangular filterbank (n_freqs, n_mels), torchaudio's
    ``melscale_fbanks(norm=None, mel_scale='htk')``."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis (n_fft, 2 * (n_fft // 2 + 1)): [cos | -sin],
    the window centred in n_fft as ``torch.stft`` pads it."""
    n_bins = n_fft // 2 + 1
    window = np.zeros(n_fft, np.float64)
    left = (n_fft - win_length) // 2
    window[left: left + win_length] = hann_window(win_length)
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (basis * window[:, None]).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) with reflect centre padding."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(1, n_fft, hop)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int,
                   win_length: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft // 2 + 1) magnitude spectrogram."""
    n_bins = n_fft // 2 + 1
    frames = frame_signal(x.float(), n_fft, hop)
    basis = torch.from_numpy(dft_basis(n_fft, win_length)).to(x.device)
    proj = torch.matmul(frames, basis)
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    return torch.sqrt(re * re + im * im + 1e-12)


class MelSpecFeatureProcessor:
    """Waveform -> log-mel with the reference wrapper's API
    (``data/features.py:45-106``): ``sample_rate`` (frames/s),
    ``sample_ratio`` (1/hop), ``encode_single`` and masked ``encode``.
    ``device`` defaults to CUDA and raises without it."""

    def __init__(self, hp: Hparams,
                 device: Union[str, torch.device] = "cuda"):
        hp.check_arg_in_hparams("sample_rate", "n_fft", "hop_length",
                                "n_mels", "power")
        self.hp = hp
        self.device = resolve_device(device)
        self._sample_rate = hp.sample_rate
        self._hop = hp.hop_length
        self.n_fft = hp.n_fft
        self.win_length = hp.get("win_length", None) or hp.n_fft
        self.n_mels = hp.n_mels
        self.power = hp.power
        self.log_scale = hp.get("log_scale", True)
        f_min = hp.get("f_min", 0.0)
        f_max = hp.get("f_max", None) or float(hp.sample_rate // 2)
        self.fb = torch.from_numpy(melscale_fbanks(
            self.n_fft // 2 + 1, f_min, f_max, hp.n_mels,
            hp.sample_rate)).to(self.device)

    @property
    def sample_rate(self) -> float:
        return float(self._sample_rate) / float(self._hop)

    @property
    def sample_ratio(self) -> float:
        return 1.0 / float(self._hop)

    def _encode_value(self, wave: torch.Tensor) -> torch.Tensor:
        mag = stft_magnitude(wave.to(self.device), self.n_fft, self._hop,
                             self.win_length)
        if self.power != 1.0:
            mag = mag ** self.power
        mel = torch.matmul(mag, self.fb)
        if self.log_scale:
            mel = torch.log(torch.clamp(mel, min=1e-6))
        return mel

    def encode_single(self, wave) -> torch.Tensor:
        """(T,) samples (numpy or torch) -> (frames, n_mels) on the
        processor's device."""
        return self._encode_value(torch.as_tensor(wave)[None])[0]

    def encode(self, signal: Masked) -> Masked:
        mel = self._encode_value(signal.value)
        lengths = resize_length(signal.lengths.to(self.device),
                                self.sample_ratio)
        return Masked.from_lengths(mel, lengths)
