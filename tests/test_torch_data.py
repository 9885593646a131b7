"""The port's input pipeline against the JAX package's.

  * log-mels of ``MelSpecFeatureProcessor`` (the windowed-DFT STFT, HTK
    filterbank, log) to 1e-3 absolute in log-mel, the bar of
    ``tests/test_features.py``, with equal frame counts;
  * WAV, and FLAC written by ``tests/flac_helper.py``, decoded equal to
    JAX's ``load_audio`` (16-bit PCM scaled by 2^-15 on both sides);
  * ``pad_to_max_length`` batches, sampler orders, the metadata parser
    and whole ``DiscreteTokenDataset`` batches equal to JAX's (tokens
    and lengths exactly, mels to 1e-3);
  * the port's native build: two processes that build and load it at
    once both load a whole library.
All on the CPU."""
import multiprocessing
import os

import numpy as np
import pytest
import torch

from tests.flac_helper import write_flac
from tests.test_e2e_lvtr import VOCODER_HP
from vae_gslm_tpu.data import audio as jaudio
from vae_gslm_tpu.data import dataset as jdataset
from vae_gslm_tpu.data import native as jnative
from vae_gslm_tpu.data import sampler as jsampler
from vae_gslm_tpu.data.features import \
    MelSpecFeatureProcessor as JMelSpec
from vae_gslm_tpu.data.loader import DataLoader as JLoader
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu_torch.data import audio, dataset, native, sampler
from vae_gslm_tpu_torch.data.features import MelSpecFeatureProcessor
from vae_gslm_tpu_torch.data.loader import get_dataloader
from vae_gslm_tpu_torch.hparams.hp import Hparams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_VOCODER = os.path.join(ROOT, "configs", "train", "vocoder",
                                "hfgan_16k_50hz_librispeech.yaml")
SR = 16000


def _feature_hp(which: str) -> dict:
    if which == "flagship":     # n_fft 1025, 80 bins: frames = n / 320
        return Hparams.from_yamlfile(FLAGSHIP_VOCODER).feature.to_dict()
    return Hparams.from_yaml(VOCODER_HP).feature.to_dict()


@pytest.mark.parametrize("which", ["flagship", "e2e"])
@pytest.mark.parametrize("n", [320 * 57, 12345])
def test_log_mel_matches_jax(which, n):
    feat = _feature_hp(which)
    rng = np.random.RandomState(n)
    wave = (0.3 * rng.randn(n)).astype(np.float32)
    want = np.asarray(JMelSpec(JHparams(**feat)).encode_single(wave))
    got = MelSpecFeatureProcessor(Hparams(**feat), device="cpu"
                                  ).encode_single(wave)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_masked_encode_matches_jax():
    from vae_gslm_tpu.core.masked import Masked as JMasked
    from vae_gslm_tpu_torch.core.masked import Masked

    feat = _feature_hp("flagship")
    rng = np.random.RandomState(3)
    wave = (0.3 * rng.randn(2, 320 * 20)).astype(np.float32)
    lengths = np.asarray([320 * 20, 320 * 13 + 5], np.int32)
    want = JMelSpec(JHparams(**feat)).encode(JMasked.from_lengths(
        wave, lengths))
    got = MelSpecFeatureProcessor(Hparams(**feat), device="cpu").encode(
        Masked.from_lengths(torch.from_numpy(wave), lengths))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=0, atol=1e-3)


def test_wav_decode_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    x = (0.5 * rng.randn(12345)).clip(-1, 1).astype(np.float32)
    p = str(tmp_path / "t.wav")
    audio.save_wav(p, x, SR)
    got, sr = audio.load_audio(p)
    want, jsr = jaudio.load_audio(p)
    assert sr == jsr == SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, jaudio.to_mono(want))


@pytest.mark.parametrize("stereo", [None, "mid_side"])
def test_flac_decode_matches_jax(tmp_path, monkeypatch, stereo):
    """The JAX side decodes FLAC only through its native library; it is
    given the port's build of the same source, so the comparison does
    not depend on whether the JAX package's own build in ``native/``
    (made at first use, shared by every test process) was ready."""
    rng = np.random.RandomState(1)
    t = np.arange(5000)
    mono = (8000 * np.sin(2 * np.pi * 440 * t / SR)
            + rng.randint(-300, 300, t.shape)).astype(np.int64)
    samples = mono if stereo is None else np.stack([mono, mono // 2 + 7])
    p = str(tmp_path / "t.flac")
    write_flac(p, samples, SR, **({} if stereo is None
                                  else {"stereo": stereo}))
    got, sr = audio.load_audio(p)
    monkeypatch.setattr(jnative, "_LIB", native.get_lib())
    want, jsr = jaudio.load_audio(p)
    assert sr == jsr == SR
    np.testing.assert_array_equal(got, want)
    ref = (np.atleast_2d(samples).astype(np.float64).mean(0)
           / 32768.0).astype(np.float32)
    np.testing.assert_allclose(got, ref, atol=2e-7)


def test_pad_to_max_length_matches_jax():
    rng = np.random.RandomState(2)
    items = [{"mel": rng.randn(n, 3).astype(np.float32),
              "tokens": rng.randint(0, 9, n).astype(np.int64),
              "sid": np.asarray(i), "name": f"u{i}"}
             for i, n in enumerate((7, 3, 11))]
    for max_lengths in (None, {"tokens": 5}):
        want = jdataset.pad_to_max_length(items, max_lengths)
        got = dataset.pad_to_max_length(items, max_lengths)
        assert sorted(got) == sorted(want)
        for k in ("mel", "tokens"):
            np.testing.assert_array_equal(got[k].value.numpy(),
                                          want[k].value)
            np.testing.assert_array_equal(got[k].lengths.numpy(),
                                          want[k].lengths)
            assert got[k].lengths.dtype == torch.int32
        np.testing.assert_array_equal(got["sid"].numpy(), want["sid"])
        assert got["name"] == want["name"]


def _batches(s):
    return [list(map(int, b)) for b in s]


@pytest.mark.parametrize("kw", [
    dict(shuffle=False, drop_last=False), dict(shuffle=False),
    dict(shuffle=True, seed=7), dict(shuffle=True, seed=7, drop_last=False)])
def test_sampler_orders_match_jax(kw):
    ours = sampler.standard_sampler(23, 4, **kw)
    theirs = jsampler.standard_sampler(23, 4, **kw)
    for _ in range(2):              # epochs: the rng state carries over
        assert _batches(ours) == _batches(theirs)
    assert len(ours) == len(theirs) == (6 if kw.get("drop_last") is False
                                        else 5)


@pytest.mark.parametrize("typ, distributed", [
    ("standard", True), ("bucket", False), ("concat", False)])
def test_dataloader_refuses_unported_samplers(typ, distributed):
    """An unknown sampler type raises before the dataset is read; the
    bucket and concat samplers refuse a config without their settings
    (``sampler.num_buckets``, ``length``) and build from the dataset's
    ``lengths`` with them.  The standard sampler is ported for one
    process and for one rank; a rank's loader needs the world size and
    rank."""
    hp = Hparams.from_dict({"num_workers": 1, "batch_size": 4,
                            "sampler": {"type": typ, "shuffle": False}})
    if typ == "standard":
        with pytest.raises(ValueError, match="world_size and rank"):
            get_dataloader(hp, [], distributed)
        items = type("Items", (list,), {"seq_collate": staticmethod(list)})
        loader = get_dataloader(hp, items(range(10)), distributed, 2, 1)
        assert isinstance(loader.sampler, sampler.DistributedSampler)
        assert _batches(loader.sampler) == [[1, 3, 5, 7]]
        return
    with pytest.raises(ValueError, match="not specified"):
        get_dataloader(hp, [], distributed)
    hp.sampler.num_buckets = 2
    hp.length = 2.0
    items = type("Items", (list,), {"seq_collate": staticmethod(list),
                                    "lengths": [1.0, 3.0, 2.0, 0.5]})
    loader = get_dataloader(hp, items(range(4)), distributed)
    want = (sampler.SingleRandomBucketSampler if typ == "bucket"
            else sampler.SingleConcatLengthSampler)
    assert isinstance(loader.sampler, want)
    hp.sampler.type = "nope"
    with pytest.raises(NotImplementedError, match="nope"):
        get_dataloader(hp, [], distributed)


def write_corpus(root, durations, vocab: int = 32, seed: int = 0):
    """WAVs of the given durations (s) at 16 kHz and a ``tokens.txt`` of
    ``name|tokens`` lines at 50 tokens/s; returns the metadata path."""
    rng = np.random.RandomState(seed)
    lines = []
    for i, dur in enumerate(durations):
        n = int(round(dur * SR))
        t = np.arange(n) / SR
        wave = (0.2 * np.sin(2 * np.pi * (180 + 35 * i) * t)
                + 0.02 * rng.randn(n)).astype(np.float32)
        name = f"utt{i:03d}.wav"
        audio.save_wav(os.path.join(root, name), wave, SR)
        toks = rng.randint(0, vocab, size=int(dur * 50))
        lines.append(f"{name}|{' '.join(map(str, toks))}")
    path = os.path.join(root, "tokens.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


DATA_YAML = """
path: "{corpus}/tokens.txt"
wavdir: "{corpus}"
sample_rate: 16000
with_text: false
with_tokens: true
batch_size: 2
num_workers: 1
min_audio_length: 0.5
bits_per_second: 32000
pad: {{multiple_of: 320, mode: "constant"}}
sampler: {{type: "standard", shuffle: false, drop_last: false}}
"""


def test_metadata_filter_matches_jax(tmp_path):
    write_corpus(str(tmp_path), [0.3, 0.62, 1.1, 0.8])
    args = (str(tmp_path / "tokens.txt"), False, " ", 0.5, None, 32000,
            str(tmp_path), 2 ** 62, 0, True)
    got, want = dataset.load_dataset(*args), jdataset.load_dataset(*args)
    assert got[0] == want[0] == ["utt001.wav", "utt002.wav", "utt003.wav"]
    assert got[3] == want[3]
    for a, b in zip(got[4], want[4]):
        np.testing.assert_array_equal(a, b)


def test_token_dataset_batches_match_jax(tmp_path):
    """The likelihood estimator's dataset (whole utterances, padded to a
    multiple of 320 samples, mel rescale) through the port's loader
    against the JAX loader: same utterances, tokens, lengths; mels to
    1e-3."""
    write_corpus(str(tmp_path), [0.3, 0.62, 1.1, 0.8, 0.7011])
    data = DATA_YAML.format(corpus=tmp_path)
    feat = _feature_hp("flagship")
    rescale = {"mean": -1.5, "std": 2.0}
    ours = dataset.DiscreteTokenDataset(
        Hparams.from_yaml(data), Hparams(**feat),
        Hparams(deduplicate=False, sample_rate=50), Hparams(**rescale),
        device="cpu")
    theirs = jdataset.DiscreteTokenDataset(
        JHparams.from_yaml(data), JHparams(**feat),
        JHparams(deduplicate=False, sample_rate=50), JHparams(**rescale))
    jhp = JHparams.from_yaml(data)
    want = list(JLoader(theirs, jsampler.standard_sampler(
        len(theirs), jhp.batch_size, shuffle=False, drop_last=False),
        num_workers=1))
    got = list(get_dataloader(Hparams.from_yaml(data), ours))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("tokens", "mel", "audio"):
            np.testing.assert_array_equal(g[k].lengths.numpy(),
                                          w[k].lengths)
            atol = 1e-3 if k == "mel" else 0.0
            np.testing.assert_allclose(g[k].value.numpy(), w[k].value,
                                       rtol=0, atol=atol)
        # frames = samples / 320 after the padding; tokens cap the mels
        assert g["mel"].value.shape[1] == g["tokens"].value.shape[1]


TRAIN_DATA_YAML = """
path: "{corpus}/tokens.txt"
wavdir: "{corpus}"
preprocess_mels: "{mels}"
preprocess_mels_recursive_dir: true
sample_rate: 16000
with_text: false
with_tokens: true
batch_size: 2
num_workers: 1
min_audio_length: 0.5
bits_per_second: 32000
token_segment_size: 30
post_pad:
    tokens: {{num_tokens: 30}}
    mel: {{length: 0.6}}
random_crop_mel_utt: {{min_seg_sec: 0.2, max_seg_sec: 0.4}}
sampler: {{type: "standard", shuffle: true}}
"""


@pytest.mark.parametrize("world, rank", [(1, 0), (2, 1)])
def test_training_data_settings_match_jax(tmp_path, world, rank):
    """The shipped training config's data settings (``preprocess_mels``
    from a recursive directory, ``token_segment_size`` crops,
    ``post_pad``, seeded ``random_crop_mel_utt`` crops, mel rescale)
    through each package's loader with the distributed sampler of
    ``(world, rank)`` over two epochs: the same batches, tokens and
    lengths exactly, mels to 1e-6."""
    corpus, mels = tmp_path / "corpus", tmp_path / "mels"
    os.makedirs(corpus / "sub")
    write_corpus(str(corpus), [0.8, 1.1, 0.62, 0.9, 1.3, 0.7])
    lines = []
    with open(corpus / "tokens.txt") as f:     # the WAVs one level down
        for line in f.read().split():
            if "|" in line:
                name, rest = line.split("|", 1)
                os.replace(corpus / name, corpus / "sub" / name)
                line = f"sub/{name}|{rest}"
            lines.append(line)
    with open(corpus / "tokens.txt", "w") as f:
        f.write(" ".join(lines).replace(" sub/", "\nsub/") + "\n")
    feat = _feature_hp("flagship")
    proc = MelSpecFeatureProcessor(Hparams(**feat), device="cpu")
    os.makedirs(mels / "sub")
    for name in os.listdir(corpus / "sub"):
        wave, _ = audio.load_audio(str(corpus / "sub" / name))
        np.save(mels / "sub" / name.replace(".wav", ".npy"),
                proc.encode_single(wave).numpy())
    data = TRAIN_DATA_YAML.format(corpus=corpus, mels=mels)
    rescale = {"mean": -1.5, "std": 2.0}
    ours = dataset.DiscreteTokenDataset(
        Hparams.from_yaml(data), Hparams(**feat),
        Hparams(deduplicate=False, sample_rate=50), Hparams(**rescale),
        device="cpu")
    theirs = jdataset.DiscreteTokenDataset(
        JHparams.from_yaml(data), JHparams(**feat),
        JHparams(deduplicate=False, sample_rate=50), JHparams(**rescale))
    jsamp = jsampler.standard_sampler(len(theirs), 2, shuffle=True,
                                      distributed=True, world_size=world,
                                      rank=rank)
    loader = get_dataloader(Hparams.from_yaml(data), ours, True, world, rank)
    assert len(ours) == len(theirs) == 6
    for epoch in (0, 1):
        jsamp.set_epoch(epoch)
        loader.sampler.set_epoch(epoch)
        want = list(JLoader(theirs, jsamp, num_workers=1))
        got = list(loader)
        assert len(got) == len(want) == 3 // world
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in ("tokens", "mel", "cropped_mel_utt"):
                np.testing.assert_array_equal(g[k].lengths.numpy(),
                                              w[k].lengths)
                np.testing.assert_allclose(g[k].value.numpy(), w[k].value,
                                           rtol=0,
                                           atol=0 if k == "tokens" else 1e-6)
            assert g["tokens"].value.shape[1] == 30
            assert g["mel"].value.shape[1] == 30


def _build_and_read(build_dir, wav, queue):
    from vae_gslm_tpu_torch.data import native as nat

    lib = nat.get_lib(build_dir)
    wave, sr = nat.wav_read(wav)
    queue.put((os.path.basename(lib._name), int(sr), float(wave.sum())))


def test_native_builds_race_free(tmp_path):
    """Two processes build the library into one empty directory at once:
    both load it and decode, and only the finished library is left."""
    wav = str(tmp_path / "a.wav")
    audio.save_wav(wav, np.linspace(-0.5, 0.5, 4000, dtype=np.float32), SR)
    build_dir = str(tmp_path / "build")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_build_and_read,
                         args=(build_dir, wav, queue)) for _ in range(2)]
    for p in procs:
        p.start()
    results = [queue.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert results[0] == results[1]
    assert results[0][0] == os.path.basename(native.library_path(build_dir))
    assert sorted(os.listdir(build_dir)) == sorted(
        [results[0][0], "libdataio.lock"])
