"""Evaluation utilities: f0 tracking, MCD, WER/CER (the port's own copy
of ``vae_gslm_tpu/inference/eval_utils.py``, plain numpy).

The reference computes f0 with torchcrepe (periodicity-gated), MCD with
pysptk's mel-cepstra and WER/CER with jiwer.  Each stays an optional
import; without it the same metric is computed natively: f0 by
autocorrelation (NCCF) with a voicing threshold standing in for crepe's
periodicity, mel-cepstra by a Newton solve of SPTK's UELS criterion,
WER/CER by Levenshtein distance with jiwer's normalisation steps.
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------------- f0
def f0_autocorr(wave: np.ndarray, sr: int, hop: int = 320,
                fmin: float = 50.0, fmax: float = 550.0,
                frame: int = 1024,
                voicing_threshold: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-wise f0 + voicing confidence via normalised
    cross-correlation."""
    lag_min = int(sr / fmax)
    lag_max = int(sr / fmin)
    n_frames = max(0, (len(wave) - frame) // hop + 1)
    f0 = np.zeros(n_frames, np.float32)
    conf = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        seg = wave[i * hop: i * hop + frame].astype(np.float64)
        seg = seg - seg.mean()
        ac = np.correlate(seg, seg, mode="full")[len(seg) - 1:]
        if lag_max >= len(ac):
            continue
        window = ac[lag_min:lag_max] / (ac[0] + 1e-9)
        best = int(np.argmax(window))
        best_lag = float(lag_min + best)
        # parabolic interpolation around the peak: sub-sample lag
        # (integer lags quantize f0 by ~f0^2/sr, e.g. 3 Hz at 330 Hz)
        li, ri = lag_min + best - 1, lag_min + best + 1
        if 0 < li and ri < len(ac):
            y0, y1, y2 = ac[li], ac[lag_min + best], ac[ri]
            denom = y0 - 2 * y1 + y2
            if abs(denom) > 1e-12:
                delta = 0.5 * (y0 - y2) / denom
                best_lag += float(np.clip(delta, -0.5, 0.5))
        if best_lag > 0:
            f0[i] = sr / best_lag
            conf[i] = float(np.clip(window[best], 0.0, 1.0))
    return f0, conf


def crepe_f0(wave: np.ndarray, sr: int, hop: int = 320,
             fmin: float = 50.0, fmax: float = 550.0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(f0, periodicity) via torchcrepe when installed (the reference's
    predictor: ``utils/crepe.py`` with the 'tiny'
    model, ``reconstruction.py:18-19``); falls back to the native NCCF
    tracker otherwise."""
    try:
        import torch
        import torchcrepe
    except ImportError:
        return f0_autocorr(wave, sr, hop, fmin, fmax)
    audio = torch.tensor(np.asarray(wave, np.float32))[None]
    pitch, periodicity = torchcrepe.predict(
        audio, sr, hop_length=hop, fmin=fmin, fmax=fmax,
        model="tiny", device="cpu", return_periodicity=True)
    return (np.asarray(pitch[0]), np.asarray(periodicity[0]))


def f0_mse(gold: np.ndarray, rec: np.ndarray, sr: int,
           hop: int = 320, threshold: float = 0.5) -> float:
    """Periodicity-gated log-f0 MSE
    (``inference/speech/reconstruction.py:99-113`` semantics)."""
    n = min(len(gold), len(rec))
    g_f0, g_c = crepe_f0(gold[:n], sr, hop)
    r_f0, r_c = crepe_f0(rec[:n], sr, hop)
    m = min(len(g_f0), len(r_f0))
    voiced = (g_c[:m] > threshold) & (r_c[:m] > threshold)
    if voiced.sum() == 0:
        return float("nan")
    g = np.log2(np.maximum(g_f0[:m][voiced], 1e-5))
    r = np.log2(np.maximum(r_f0[:m][voiced], 1e-5))
    return float(np.mean((g - r) ** 2))


# ------------------------------------------------------------------ mcd
def _mel_warp(omega: np.ndarray, alpha: float) -> np.ndarray:
    """First-order all-pass frequency warp
    ``beta(w) = w + 2*atan(a*sin w / (1 - a*cos w))`` (the phase of
    ``(z^-1 - a)/(1 - a z^-1)`` — SPTK's mel scale)."""
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))


def mcep(frames: np.ndarray, order: int = 23, alpha: float = 0.42,
         eps: float = 1e-8, itr_max: int = 30, dd: float = 1e-5
         ) -> np.ndarray:
    """Native mel-cepstral analysis equivalent to
    ``pysptk.sptk.mcep(xw, order, alpha, eps=1e-8, etype=1)``
    (the reference's call, ``utils/mcd.py:10-16``).

    Solves the UELS spectral criterion (Fukada et al. 1992)

        E(mc) = mean_w[ exp(R) - R - 1 ],
        R(w)  = log(|FFT(xw)|^2 + eps) - 2 * sum_k mc_k cos(k*beta(w))

    by Newton iteration on the same ``len(xw)``-point FFT grid SPTK
    integrates over.  E is strictly convex in ``mc`` (R is affine in
    ``mc`` and exp is strictly convex), so the minimiser is unique —
    SPTK's Newton/theq iteration and this one converge to the SAME
    coefficients, to tolerance ``dd`` (SPTK default 1e-5).

    frames: (F, n_fft) pre-windowed frames (or (n_fft,)).
    Returns (F, order+1) mel-cepstra (or (order+1,)).
    """
    x = np.atleast_2d(np.asarray(frames, np.float64))
    f, n_fft = x.shape
    # Periodogram on the FFT grid, one-sided with mirror weights.
    spec = np.abs(np.fft.rfft(x, n_fft, axis=-1)) ** 2 + eps
    nbin = n_fft // 2 + 1
    w = np.full(nbin, 2.0 / n_fft)
    w[0] = w[-1] = 1.0 / n_fft
    omega = 2.0 * np.pi * np.arange(nbin) / n_fft
    beta = _mel_warp(omega, alpha)
    psi = np.cos(np.outer(beta, np.arange(order + 1)))   # (nbin, K)
    log_i = np.log(spec)

    # Init: weighted LS projection of log I / 2 onto the warped basis
    # (the exact-log solution — already close to the UELS optimum).
    a_ls = psi.T * w                                      # (K, nbin)
    mc = np.linalg.solve(a_ls @ psi, (a_ls @ (log_i.T / 2.0))).T

    def crit(mc_):
        r = log_i - 2.0 * (mc_ @ psi.T)
        er = np.exp(r)
        return r, er, ((er - r - 1.0) * w).sum(axis=-1)

    r, er, e_val = crit(mc)
    for _ in range(itr_max):
        # grad_k = 2 * sum_w w*(1 - e^R)*psi_k ; H = 4 psi' diag(w e^R) psi
        g = 2.0 * ((1.0 - er) * w) @ psi                  # (F, K)
        hess = 4.0 * np.einsum("fn,nk,nl->fkl", er * w, psi, psi)
        step = np.linalg.solve(hess, g[..., None])[..., 0]
        mc_new = mc - step
        r2, er2, e2 = crit(mc_new)
        # damped Newton (convex criterion: halving always recovers)
        bad = e2 > e_val
        t = 1.0
        while bad.any() and t > 1e-4:
            t *= 0.5
            mc_try = mc - t * step
            r2b, er2b, e2b = crit(mc_try)
            mc_new = np.where(bad[:, None], mc_try, mc_new)
            r2 = np.where(bad[:, None], r2b, r2)
            er2 = np.where(bad[:, None], er2b, er2)
            e2 = np.where(bad, e2b, e2)
            bad = e2 > e_val
        done = np.abs(e_val - e2) <= dd * np.abs(e2)
        mc, r, er, e_val = mc_new, r2, er2, e2
        if done.all():
            break
    return mc[0] if np.asarray(frames).ndim == 1 else mc


def wav2mcep(x: np.ndarray, mcep_dim: int = 23,
             mcep_alpha: float = 0.42, n_fft: int = 1024,
             n_shift: int = 256) -> np.ndarray:
    """The reference's framing (``utils/mcd.py:5-19``): hamming
    window, hop ``n_shift``, ``mcep`` per frame — computed natively
    (all frames in one vectorised Newton solve)."""
    x = np.asarray(x, np.float64)
    win = np.hamming(n_fft)     # SPTK hamming: .54 - .46 cos
    n_frame = (len(x) - n_fft) // n_shift + 1
    if n_frame <= 0:
        return np.zeros((0, mcep_dim + 1))
    idx = (np.arange(n_fft)[None, :]
           + n_shift * np.arange(n_frame)[:, None])
    return mcep(x[idx] * win, mcep_dim, mcep_alpha)


def mel_cepstrum(log_mel: np.ndarray, order: int = 13) -> np.ndarray:
    """DCT-II cepstra of log-mel frames: (T, n_mels) → (T, order)."""
    t, n = log_mel.shape
    k = np.arange(order)[None, :, None]
    m = np.arange(n)[None, None, :]
    basis = np.cos(np.pi * k * (2 * m + 1) / (2 * n))[0]  # (order, n)
    return log_mel @ basis.T * np.sqrt(2.0 / n)


def mcd_wav(gold_wave: np.ndarray, rec_wave: np.ndarray,
            mcep_dim: int = 23, mcep_alpha: float = 0.42,
            n_fft: int = 1024, n_shift: int = 256) -> float:
    """Waveform MCD via mel-cepstra — the EXACT reference pipeline
    (``utils/mcd.py:5-24``: hamming window,
    ``pysptk.sptk.mcep(..., eps=1e-8, etype=1)``, mean of
    ``10/ln10 * sqrt(2*sum(diff^2))``).  Uses pysptk when installed;
    otherwise the native :func:`mcep` solver of the same UELS
    criterion (same optimum — see its docstring)."""
    try:
        import pysptk

        def frames_mcep(x):
            win = pysptk.sptk.hamming(n_fft)
            n_frame = (len(x) - n_fft) // n_shift + 1
            return np.stack([
                pysptk.sptk.mcep(
                    x[n_shift * i: n_shift * i + n_fft] * win,
                    mcep_dim, mcep_alpha, eps=1e-8, etype=1)
                for i in range(n_frame)])
    except ImportError:
        def frames_mcep(x):
            return wav2mcep(x, mcep_dim, mcep_alpha, n_fft, n_shift)

    a, b = frames_mcep(np.asarray(gold_wave)), frames_mcep(
        np.asarray(rec_wave))
    n = min(len(a), len(b))
    diff2sum = np.sum((a[:n] - b[:n]) ** 2, 1)
    return float(np.mean(10.0 / np.log(10.0) * np.sqrt(2 * diff2sum)))


def mcd(gold_logmel: np.ndarray, rec_logmel: np.ndarray,
        order: int = 13) -> float:
    """Mel-cepstral distortion in dB (c1.. excluded c0), matching the
    standard 10*sqrt(2)/ln10 scaling used by ``utils/mcd.py``."""
    n = min(len(gold_logmel), len(rec_logmel))
    g = mel_cepstrum(gold_logmel[:n], order)[:, 1:]
    r = mel_cepstrum(rec_logmel[:n], order)[:, 1:]
    diff = np.sqrt(np.sum((g - r) ** 2, axis=-1))
    return float(10.0 * np.sqrt(2.0) / np.log(10.0) * diff.mean())


# ------------------------------------------------------------ wer / cer
_CONTRACTIONS = [
    (r"won't", "will not"), (r"can't", "can not"), (r"n't", " not"),
    (r"'re", " are"), (r"'ve", " have"), (r"'ll", " will"),
    (r"'d", " would"), (r"'m", " am"), (r"it's", "it is"),
]


def normalize_text(text: str) -> str:
    """jiwer-equivalent normalisation: lowercase, expand contractions,
    strip punctuation, collapse whitespace."""
    text = text.lower()
    for pat, rep in _CONTRACTIONS:
        text = re.sub(pat, rep, text)
    text = re.sub(r"[^\w\s]", "", text)
    return re.sub(r"\s+", " ", text).strip()


def edit_distance(a: Sequence, b: Sequence) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer(references: List[str], hypotheses: List[str]) -> float:
    errs, total = 0, 0
    for ref, hyp in zip(references, hypotheses):
        r = normalize_text(ref).split()
        h = normalize_text(hyp).split()
        errs += edit_distance(r, h)
        total += len(r)
    return errs / max(total, 1)


def cer(references: List[str], hypotheses: List[str]) -> float:
    errs, total = 0, 0
    for ref, hyp in zip(references, hypotheses):
        r = list(normalize_text(ref).replace(" ", ""))
        h = list(normalize_text(hyp).replace(" ", ""))
        errs += edit_distance(r, h)
        total += len(r)
    return errs / max(total, 1)


def asr_error_rate(references: List[str],
                   hypotheses: List[str]) -> float:
    """The reference's published 'wer' metric — which is actually a
    jiwer CHARACTER error rate over normalized text INCLUDING spaces
    (``jiwer.cer`` + ReduceToListOfListOfChars,
    ``inference/speech/reconstruction.py:55-75``).
    Prefers real jiwer with the reference's exact Compose pipeline;
    the native fallback replicates it (lowercase, whitespace->space,
    collapse, expand contractions, strip punctuation, strip, chars)."""
    try:
        import jiwer
    except ImportError:
        errs, total = 0, 0
        for ref, hyp in zip(references, hypotheses):
            r = list(normalize_text(ref))
            h = list(normalize_text(hyp))
            errs += edit_distance(r, h)
            total += len(r)
        return errs / max(total, 1)
    transformation = jiwer.Compose([
        jiwer.ToLowerCase(),
        jiwer.RemoveWhiteSpace(replace_by_space=True),
        jiwer.RemoveMultipleSpaces(),
        jiwer.ExpandCommonEnglishContractions(),
        jiwer.RemovePunctuation(),
        jiwer.Strip(),
        jiwer.ReduceToListOfListOfChars(),
    ])
    return jiwer.cer(references, hypotheses,
                     reference_transform=transformation,
                     hypothesis_transform=transformation)
