"""The port's tokenizer CLI (``scripts/hubert_kmeans.py``) on the CPU,
on a tiny random HuBERT (d 32, 1 layer, the full 7-conv stack of 16
channels) over six 16 kHz WAVs of 0.6-2.6 s, ``-s 2.5`` (the longest
clip is skipped):

  * mode A (``-p 1.0``) by structure: ``kmeans_v8.npy`` of shape (8, 32)
    beside ``-o``, one ``line|tok ...`` per kept file in metadata order,
    as many tokens as the encoder's frames, each in [0, 8); its subset
    is an unseeded ``random.sample``, as in JAX, so nothing is compared
    token for token;
  * mode B (``-c`` those centroids) writes mode A's lines again;
  * mode B token for token against the JAX CLI on the same directory
    (one ``transformers`` writes: the JAX CLI loads it through
    ``transformers``) and the same centroids, float32 and ``--bf16``'s
    lines equal in count and shape.
Modes A and B read a ``-m`` directory written without ``transformers``
(``config.json`` and ``model.safetensors``)."""
import json
import sys

import numpy as np
import pytest

from tests.test_torch_hubert import hf_state_dict
from vae_gslm_tpu_torch.data import audio as audio_lib
from vae_gslm_tpu_torch.models.ssl import hubert
from vae_gslm_tpu_torch.scripts import hubert_kmeans as cli

SR = 16000
CFG = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
           intermediate_size=64, conv_dim=[16] * 7,
           conv_kernel=[10, 3, 3, 3, 3, 2, 2],
           conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=True,
           feat_extract_norm="layer", do_stable_layer_norm=True,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           layer_norm_eps=1e-5)
SECONDS = [1.0, 0.6, 2.6, 1.7, 1.2, 2.2]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hk")
    wavdir = root / "wavs"
    wavdir.mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i, sec in enumerate(SECONDS):
        n = int(sec * SR)
        t = np.arange(n) / SR
        wave = (0.2 * np.sin(2 * np.pi * (150 + 60 * i) * t)
                + 0.05 * rng.randn(n)).astype(np.float32)
        audio_lib.save_wav(str(wavdir / f"u{i}.wav"), wave, SR)
        lines.append(f"u{i}.wav|text {i}")
    meta = root / "metadata.txt"
    meta.write_text("\n".join(lines) + "\n")
    model = root / "hubert_tiny"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(
        dict(CFG, model_type="hubert", architectures=["HubertModel"])))
    hubert.write_safetensors(str(model / "model.safetensors"),
                             hf_state_dict(CFG, 0, wn="param"))
    return root, wavdir, meta, model


def _args(corpus, out, model, *extra):
    _, wavdir, meta, _ = corpus
    return ["-i", str(meta), "-w", str(wavdir), "-o", str(out), "-m",
            str(model), "-v", "8", "-s", "2.5", "-b", "2", *extra]


@pytest.fixture(scope="module")
def mode_a(corpus):
    root, _, _, model = corpus
    out = root / "a" / "tokens.txt"
    out.parent.mkdir()
    timings = {}
    n = cli.main(_args(corpus, out, model, "-p", "1.0", "--device", "cpu"),
                 timings=timings)
    return out, n, timings


def test_mode_a_by_structure(corpus, mode_a):
    root, _, _, model = corpus
    out, n, timings = mode_a
    cents = np.load(out.parent / "kmeans_v8.npy")
    assert cents.shape == (8, 32) and cents.dtype == np.float32
    lines = out.read_text().splitlines()
    kept = [i for i, s in enumerate(SECONDS) if s < 2.5]
    assert n == len(lines) == len(kept)
    enc = hubert.from_hf_pretrained(str(model), device="cpu")
    for i, line in zip(kept, lines):
        name, text, toks = line.split("|")
        assert (name, text) == (f"u{i}.wav", f"text {i}")
        ids = [int(t) for t in toks.split(" ")]
        assert len(ids) == enc.frame_count(int(SECONDS[i] * SR))
        assert all(0 <= t < 8 for t in ids)
    assert timings["audio_s"] > 0 and timings["kmeans_s"] > 0


def test_mode_b_repeats_mode_a(corpus, mode_a):
    root, _, _, model = corpus
    out, _, _ = mode_a
    out_b = root / "b_tokens.txt"
    cli.main(_args(corpus, out_b, model, "-c",
                   str(out.parent / "kmeans_v8.npy"), "--device", "cpu"))
    assert out_b.read_text() == out.read_text()


def test_mode_b_matches_the_jax_cli(corpus, mode_a, monkeypatch):
    transformers = pytest.importorskip("transformers")
    import torch

    from vae_gslm_tpu.scripts import hubert_kmeans as jcli

    root, _, _, _ = corpus
    hf_dir = root / "hubert_hf"
    torch.manual_seed(0)
    transformers.HubertModel(transformers.HubertConfig(**CFG)).save_pretrained(
        str(hf_dir))
    cents = str(mode_a[0].parent / "kmeans_v8.npy")
    ours, theirs = root / "ours.txt", root / "theirs.txt"
    cli.main(_args(corpus, ours, hf_dir, "-c", cents, "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["hubert_kmeans"] + _args(
        corpus, theirs, hf_dir, "-c", cents))
    jcli.main()
    assert ours.read_text() == theirs.read_text()
    assert len(ours.read_text().splitlines()) == 5
    bf16 = root / "ours_bf16.txt"
    cli.main(_args(corpus, bf16, hf_dir, "-c", cents, "--bf16",
                   "--device", "cpu"))
    a, b = ours.read_text().splitlines(), bf16.read_text().splitlines()
    assert [len(x.split(" ")) for x in a] == [len(x.split(" ")) for x in b]
