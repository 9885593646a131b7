"""Datasets and collation (port of ``vae_gslm_tpu/data/dataset.py``).

  * ``load_dataset``: ``name|text|tokens`` metadata lines, audio-length
    filtering estimated from file size / ``bits_per_second``, int16
    token parsing.
  * ``StandardDataset``: load -> mono -> optional dither -> resample ->
    optional segment crop / pad (``length`` or ``multiple_of``) /
    truncate -> text.
  * ``MelSpecDataset``: the log-mel of each utterance, computed on the
    dataset's device (``data/features.py``), or a precomputed ``.npy``;
    optional f0, mel rescale and ``random_crop_mel[_utt]`` crops.
  * ``DiscreteTokenDataset``: HuBERT tokens aligned to the mel frames,
    optional synchronized ``token_segment_size`` crops and
    ``unique_consecutive`` dedup with counts.
  * ``pad_to_max_length``: pad to the batch max (or a fixed
    ``post_pad``) into ``Masked`` batches of torch tensors, on the
    device each field was made on (host for audio and tokens, the
    feature device for mels).

No crop is applied unless the config asks for one.  The random crops
draw from a ``numpy.random.RandomState(seed)``, as the JAX datasets do.
"""
from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..core.masked import Masked
from ..hparams.hp import Hparams
from . import audio as audio_lib
from .features import MelSpecFeatureProcessor
from .symbols import Symbols

log = logging.getLogger(__name__)


def load_dataset(metadata: str,
                 with_text: bool,
                 delimiter: str = " ",
                 min_audio_length: Optional[float] = None,
                 max_audio_length: Optional[float] = None,
                 bits_per_second: Optional[int] = None,
                 wavdir: str = "",
                 max_text_tokens: int = 2 ** 62,
                 min_text_tokens: int = 0,
                 with_tokens: bool = False,
                 max_token_length: int = 2 ** 62,
                 min_token_length: int = 0,
                 ) -> Tuple[List[str], List[List[str]], Set, List[float],
                            List[np.ndarray]]:
    """Parse a ``name|text|tokens`` metadata file (``data/README.md``,
    ``data/dataset.py:20-104``)."""
    filenames: List[str] = []
    texts: List[List[str]] = []
    lengths: List[float] = []
    tokens: List[np.ndarray] = []
    symbols: Set[str] = set()
    if (min_audio_length is not None or max_audio_length is not None) \
            and bits_per_second is None:
        raise ValueError("audio-length filters need bits_per_second")
    with open(metadata, "r", errors="ignore") as f:
        for line in f:
            fn = line.strip()
            if not fn:
                continue
            if with_text:
                parts = fn.split("|")
                if len(parts) != 3:
                    raise ValueError(
                        f"expected 3 '|' fields, got {len(parts)}")
            else:
                parts = fn.split("|", 1)
            added_length = False
            if bits_per_second is not None:
                size = os.path.getsize(os.path.join(wavdir, parts[0]))
                audio_length = size / float(bits_per_second)
                if (min_audio_length is not None
                        and audio_length < min_audio_length):
                    continue
                if (max_audio_length is not None
                        and audio_length > max_audio_length):
                    continue
                lengths.append(audio_length)
                added_length = True
            filenames.append(parts[0])
            if with_text:
                sentence = parts[2].split(delimiter)
                if not (min_text_tokens <= len(sentence)
                        <= max_text_tokens):
                    filenames.pop()
                    if added_length:
                        lengths.pop()
                    continue
                texts.append(sentence)
                symbols |= set(sentence)
            if with_tokens:
                tok = np.asarray(
                    [int(t) for t in parts[-1].split()], np.int16)
                if not (min_token_length <= len(tok) <= max_token_length):
                    filenames.pop()
                    if added_length:
                        lengths.pop()
                    if with_text:
                        texts.pop()
                    continue
                tokens.append(tok)
    log.info("Loaded %d examples from %s", len(filenames), metadata)
    return filenames, texts, symbols, lengths, tokens


def _is_seq(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1


def _pad_rows(x, n: int):
    """Zero-pad the first axis of a numpy array or torch tensor to ``n``
    rows (no-op when it has as many)."""
    if len(x) >= n:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, n - len(x))] + [(0, 0)] * (x.ndim - 1))
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, n - len(x)])


def pad_to_max_length(batch: Iterable[Mapping[str, Any]],
                      max_lengths: Optional[Mapping[str, int]] = None,
                      ) -> Dict[str, Any]:
    """Collate a list of dicts (``utils/helpers.py:80-135``): each
    sequence field padded to the batch max or to ``max_lengths[key]``
    (truncating longer entries) into a ``Masked`` with int32 lengths;
    0-d arrays stacked; other values gathered in lists."""
    max_lengths = max_lengths or {}
    batch = list(batch)
    mlb: Dict[str, int] = {}
    for element in batch:
        for k, v in element.items():
            if _is_seq(v):
                mlb[k] = (max_lengths[k] if k in max_lengths
                          else max(mlb.get(k, 0), len(v)))
    out: Dict[str, Any] = {}
    for k in mlb:
        values, lens = [], []
        for element in batch:
            v = element[k][: mlb[k]]
            lens.append(len(v))
            v = _pad_rows(v, mlb[k])
            values.append(torch.from_numpy(np.ascontiguousarray(v))
                          if isinstance(v, np.ndarray) else v)
        value = torch.stack(values)
        out[k] = Masked(value, torch.tensor(lens, dtype=torch.int32,
                                            device=value.device), 1)
    scalars: Dict[str, list] = {}
    for element in batch:
        for k, v in element.items():
            if isinstance(v, np.ndarray) and v.ndim == 0:
                scalars.setdefault(k, []).append(v)
            elif not isinstance(v, (np.ndarray, torch.Tensor)):
                out.setdefault(k, [])
                if isinstance(out[k], list):
                    out[k].append(v)
    for k, v in scalars.items():
        out[k] = torch.from_numpy(np.stack(v))
    return out


class StandardDataset:
    """Audio (+ text) dataset (``data/dataset.py:107-247``)."""

    def __init__(self, hp: Hparams, name: Optional[str] = None,
                 seed: int = 0):
        hp.check_arg_in_hparams("with_text", "path", "sample_rate",
                                "wavdir")
        self.hp = hp
        self.name = name or "dataset"
        self.rng = np.random.RandomState(seed)
        # the bucket and concat samplers batch by length (JAX keeps the
        # lengths for "bucket" only, so its concat branch cannot run)
        store_length = hp.has("sampler") and hp.sampler.type in ("bucket",
                                                                 "concat")
        if hp.with_text:
            hp.check_arg_in_hparams("delimiter")
        if hp.get("min_audio_length", False):
            hp.check_arg_in_hparams("bits_per_second")
        self.audios: List[str] = []
        self.texts: List[List[str]] = []
        self.symbols: Any = set()
        self.tokens: List[np.ndarray] = []
        paths, wavdirs = hp.path, hp.wavdir
        bps = hp.get("bits_per_second", None)
        if isinstance(paths, str):
            paths, wavdirs = [paths], [wavdirs]
        if not isinstance(bps, list):
            bps = [bps] * len(paths)
        lengths: List[float] = []
        for _path, _wavdir, _bps in zip(paths, wavdirs, bps):
            a, t, s, ln, tk = load_dataset(
                _path, hp.with_text, hp.get("delimiter", " "),
                hp.get("min_audio_length", None),
                hp.get("max_audio_length", None), _bps, _wavdir,
                hp.get("max_text_tokens", 1000000),
                hp.get("min_text_tokens", 0), hp.get("with_tokens", False),
                hp.get("max_token_length", 1000000),
                hp.get("min_token_length", 0))
            self.audios += [os.path.join(_wavdir, f) for f in a]
            self.texts += t
            self.symbols |= s
            self.tokens += tk
            lengths += ln
        if hp.with_text:
            self.symbols = Symbols(self.symbols, hp.delimiter)
        if store_length:
            hp.check_arg_in_hparams("bits_per_second")
            self.lengths = lengths
            if hp.has("truncate"):
                self.lengths = [min(x, hp.truncate) for x in self.lengths]
        log.info("%s: total %d examples", self.name, len(self.audios))

    def __len__(self) -> int:
        return len(self.audios)

    def _load_audio(self, i: int) -> np.ndarray:
        wave, sr = audio_lib.load_audio(self.audios[i])
        wave = audio_lib.to_mono(wave)
        if self.hp.get("dither", False):
            wave = audio_lib.dither(wave, self.rng)
        if sr != self.hp.sample_rate:
            if sr not in audio_lib.SAMPLE_RATE_POOL:
                raise ValueError(f"Sample rate {sr} not supported.")
            wave = audio_lib.resample(wave, sr, self.hp.sample_rate)
        return wave.astype(np.float32)

    def _pad_truncate(self, wave: np.ndarray) -> np.ndarray:
        hp = self.hp
        if hp.has("segment_size"):
            wave = audio_lib.random_crop_1d(wave, hp.sample_rate,
                                            hp.segment_size, self.rng)
        if hp.has("pad"):
            if hp.pad.has("length") == hp.pad.has("multiple_of"):
                raise ValueError("pad takes one of length and multiple_of")
            mode = hp.pad.get("padding_mode", "constant")
            if hp.pad.has("length"):
                pad_len = hp.pad.length
            else:
                mult = math.ceil(float(len(wave))
                                 / float(hp.pad.multiple_of))
                pad_len = mult * hp.pad.multiple_of / float(hp.sample_rate)
            wave = audio_lib.pad_1d(wave, hp.sample_rate, pad_len, mode)
        if hp.has("truncate"):
            wave = audio_lib.truncate_1d(wave, hp.sample_rate, hp.truncate)
        return wave

    def _text_fields(self, i: int, ret: Dict[str, Any]) -> None:
        if not self.hp.with_text:
            return
        encoded = self.symbols.encode(self.texts[i])
        if self.hp.has("pad_text"):
            encoded = encoded + [self.symbols.pad_idx] * max(
                0, self.hp.pad_text.length - len(encoded))
        ret["text"] = np.asarray(encoded, np.int64)
        ret["text_written_form"] = self.symbols.decode(encoded)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        wave = self._pad_truncate(self._load_audio(i))
        ret: Dict[str, Any] = {"audio": wave}
        self._text_fields(i, ret)
        return ret

    def get_post_pad_dict(self) -> Optional[Dict[str, int]]:
        hp = self.hp
        if not hp.has("post_pad"):
            return None
        out: Dict[str, int] = {}
        if hp.post_pad.has("text"):
            out["text"] = hp.post_pad.text.length
        if hp.post_pad.has("audio"):
            out["audio"] = int(hp.post_pad.audio.length * hp.sample_rate)
        return out or None

    def seq_collate(self, batch: Iterable[Mapping[str, Any]]
                    ) -> Dict[str, Any]:
        return pad_to_max_length(batch, self.get_post_pad_dict())


class MelSpecDataset(StandardDataset):
    """Adds the log-mel (on ``device``, or a precomputed ``.npy``), f0
    and mel crops (``data/dataset.py:250-368``)."""

    def __init__(self, hp: Hparams, hp_mel: Hparams,
                 hp_rescale: Optional[Hparams] = None,
                 name: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(hp, name=name, seed=seed)
        self.melspec = MelSpecFeatureProcessor(hp_mel, device=device)
        if hp.has("random_crop_mel"):
            hp.random_crop_mel.check_arg_in_hparams("min_seg_sec",
                                                    "max_seg_sec")
        self.hp_rescale = hp_rescale
        self.preprocess_mels = hp.get("preprocess_mels", None)
        self.preprocess_mels_recursive_dir = hp.get(
            "preprocess_mels_recursive_dir", False)
        self.preprocess_f0 = hp.get("preprocess_f0", None)

    def _npy_path(self, base_dir: str, i: int) -> str:
        p = Path(self.audios[i])
        if self.preprocess_mels_recursive_dir:
            rel = str((p.parent / (p.stem + ".npy")).resolve())
            rel = rel[len(str(Path(self.hp.wavdir).resolve())) + 1:]
            return os.path.join(base_dir, rel)
        return os.path.join(base_dir, p.stem + ".npy")

    def _random_seg(self, lo: float, hi: float) -> float:
        return float(self.rng.rand()) * (hi - lo) + lo

    def __getitem__(self, i: int) -> Dict[str, Any]:
        if self.preprocess_mels is None:
            ret = super().__getitem__(i)
            mel = self.melspec.encode_single(ret["audio"])
        else:
            ret = {}
            self._text_fields(i, ret)
            mel = torch.from_numpy(np.load(self._npy_path(
                self.preprocess_mels, i)).astype(np.float32)).to(
                    self.melspec.device)
        f0 = None
        if self.preprocess_f0 is not None:
            f0 = np.load(self._npy_path(self.preprocess_f0.path,
                                        i)).astype(np.float32)
            if self.preprocess_f0.get("log", True):
                f0 = np.log1p(f0)
            if self.preprocess_f0.get("normalize", True):
                voiced = f0 != 0
                mean = f0[voiced].mean() if voiced.any() else 0.0
                f0 = np.where(~voiced, 0.0, f0 - mean).astype(np.float32)
            f0 = f0[: len(mel)]
        if self.hp.has("segment_size"):
            mel, s, e = audio_lib.random_crop_1d(
                mel, self.melspec.sample_rate, self.hp.segment_size,
                self.rng, return_start_end=True)
            if f0 is not None:
                f0 = f0[s:e]
        if self.hp_rescale is not None:
            mel = (mel - self.hp_rescale.mean) / self.hp_rescale.std
        ret["mel"] = mel
        if f0 is not None:
            ret["f0"] = f0
        if self.hp.has("random_crop_mel"):
            seg = self._random_seg(self.hp.random_crop_mel.min_seg_sec,
                                   self.hp.random_crop_mel.max_seg_sec)
            ret["cropped_mel"] = audio_lib.random_crop_1d(
                mel, self.melspec.sample_rate, seg, self.rng)
        if self.hp.has("random_crop_mel_utt"):
            seg = self._random_seg(
                self.hp.random_crop_mel_utt.min_seg_sec,
                self.hp.random_crop_mel_utt.max_seg_sec)
            ret["cropped_mel_utt"] = audio_lib.random_crop_1d(
                mel, self.melspec.sample_rate, seg, self.rng)
        return ret

    def get_post_pad_dict(self) -> Optional[Dict[str, int]]:
        hp = self.hp
        out: Dict[str, int] = {}
        # crops pad to their longest crop, as the JAX package does
        if hp.has("random_crop_mel"):
            out["cropped_mel"] = int(np.ceil(
                hp.random_crop_mel.max_seg_sec * self.melspec.sample_rate))
        if hp.has("random_crop_mel_utt"):
            out["cropped_mel_utt"] = int(np.ceil(
                hp.random_crop_mel_utt.max_seg_sec
                * self.melspec.sample_rate))
        if not hp.has("post_pad"):
            return out or None
        if hp.post_pad.has("text"):
            out["text"] = hp.post_pad.text.length
        if hp.post_pad.has("mel"):
            out["mel"] = int(hp.post_pad.mel.length
                             * self.melspec.sample_rate)
            if self.preprocess_f0 is not None:
                out["f0"] = out["mel"]
        for key in ("cropped_mel", "cropped_mel_utt"):
            if hp.post_pad.has(key):
                if not hp.has(f"random_crop_{key[8:]}"):
                    raise ValueError(f"post_pad.{key} needs "
                                     f"random_crop_{key[8:]}")
                out[key] = int(hp.post_pad.get(key).length
                               * self.melspec.sample_rate)
        return out or None


class DiscreteTokenDataset(MelSpecDataset):
    """Adds mel-aligned HuBERT tokens (``data/dataset.py:371-444``)."""

    def __init__(self, hp: Hparams, hp_mel: Hparams, hp_hubert: Hparams,
                 hp_rescale: Optional[Hparams] = None,
                 name: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        if not hp.get("with_tokens", False) or hp.has("segment_size") \
                or hp.has("truncate"):
            raise ValueError("DiscreteTokenDataset needs with_tokens and "
                             "takes no segment_size or truncate")
        super().__init__(hp, hp_mel, hp_rescale, name, seed=seed,
                         device=device)
        self.deduplicate = hp_hubert.get("deduplicate", False)
        self.token_sample_rate = hp_hubert.sample_rate

    def __getitem__(self, i: int) -> Dict[str, Any]:
        ret = super().__getitem__(i)
        tokens = self.tokens[i].astype(np.int64)
        if len(tokens) < len(ret["mel"]):
            ret["mel"] = ret["mel"][: len(tokens)]
        if self.hp.has("token_segment_size"):
            crop = self.hp.token_segment_size
            if crop <= len(tokens):
                start = int(self.rng.randint(0, len(tokens) - crop + 1))
                tokens = tokens[start: start + crop]
                mel_rate = self.melspec.sample_rate
                ms = int(float(start) / self.token_sample_rate * mel_rate)
                mc = int(float(crop) / self.token_sample_rate * mel_rate)
                ret["mel"] = _pad_rows(ret["mel"], ms + mc)[ms: ms + mc]
                if "f0" in ret:
                    ret["f0"] = _pad_rows(ret["f0"], ms + mc)[ms: ms + mc]
        ret["tokens"] = tokens
        if self.deduplicate:
            change = np.concatenate([[True], tokens[1:] != tokens[:-1]])
            dedup = tokens[change]
            inverse = np.cumsum(change) - 1
            counts = np.diff(np.concatenate(
                [np.flatnonzero(change), [len(tokens)]]))
            ret["dedup_tokens"] = dedup
            ret["inverse_indices"] = inverse.astype(np.int64)
            ret["counts"] = counts.astype(np.int64)
        return ret

    def get_post_pad_dict(self) -> Optional[Dict[str, int]]:
        out = super().get_post_pad_dict() or {}
        hp = self.hp
        if hp.has("post_pad") and hp.post_pad.has("tokens"):
            key = "dedup_tokens" if self.deduplicate else "tokens"
            out[key] = hp.post_pad.tokens.num_tokens
        return out or None
