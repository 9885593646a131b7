"""``ARTRSampler``'s per-layer routes against the JAX package's
``ARTRSampler``, on the same exported weights, float32 on the CPU:

  * int8 weights with an int8 cache past the mega batches (B = 33, where
    JAX's CPU run takes its per-layer route too);
  * a float cache (JAX takes its stacked float route at B = 2) at 1 and 8
    segments, with each step's window;
  * ``return_attn`` (JAX's maps from its stacked step);
  * the trainer's validation continuation, which samples with a float
    cache as JAX's trainer does, at float32 and at ``16-mixed`` (where
    both caches are float32 at B <= 32); ``SpeechInferer`` on a config
    without ``kv_cache_dtype``.

Deterministic protocol of ``tests/test_reference_parity.py``: temperature
0, token temperature 1e-4 (an argmax), encoder temperature 0, the initial
AR state pinned with one numpy array.  Tokens must be equal and latents
agree to atol 2e-3 / rtol 1e-2; the sampler's attention maps, which both
packages round to bfloat16 per step, to 4e-3."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import (TRAIN_HP, corpus,  # noqa: F401 (fixtures)
                                 vocoder_dir)
from tests.test_torch_infer import INFER_YAML
from tests.test_torch_infer import dirs as infer_dirs  # noqa: F401
from tests.test_torch_mega_step import mega_lvtr_pair
from tests.test_torch_per_layer import (  # noqa: F401 (autouse fixture)
    B, DETERMINISTIC, TP, _close, _pair, _pin_initial_state, _prompt,
    one_torch_thread)
from tests.test_torch_trunk import N_MELS
from vae_gslm_tpu.core import precision as jprecision
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech import sampler as jsampler
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.training import checkpoint as jckpt
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.core.precision import policy_scope
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech import sampler as tsampler
from vae_gslm_tpu_torch.inference.speech.inferer import SpeechInferer
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.trainers.speech import lvtr as tlvtr
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer
from vae_gslm_tpu_torch.training.checkpoint import save_compact
from vae_gslm_tpu_torch.training.logging import ExperimentLogger


def _sample_both(jsamp, tsamp, length, prompt, until_tie=False,
                 parted_after=None, atol=2e-3, rtol=1e-2, **kw):
    """Both samplers on ``prompt``; tokens equal and latents close.  With
    ``until_tie``, only up to the first step whose token the port draws
    differently under another seed: there the top two token logits lie
    within the draw's noise at token temperature 1e-4 (a near-tie of the
    random model), and neither package's float32 rounding decides it.
    With ``parted_after`` (bf16 compute), only up to the first frame whose
    token the two packages draw differently, which must come no earlier
    than ``parted_after`` generated steps."""
    lengths = np.full((prompt.shape[0],), TP)
    want = jsamp(length, JMasked.from_lengths(jnp.asarray(prompt),
                                              jnp.asarray(lengths)),
                 jax.random.PRNGKey(0), **DETERMINISTIC, **kw)

    def port(seed):
        return tsamp(length, Masked.from_lengths(torch.from_numpy(prompt),
                                                 lengths),
                     torch.Generator().manual_seed(seed), **DETERMINISTIC,
                     **kw)

    got = port(0)
    jf, tf = np.array(want["frames"].value), got["frames"].value.numpy()
    assert tf.shape == jf.shape
    n = tf.shape[1]
    if until_tie:
        other = port(7)["frames"].value.numpy()
        tie = (other[..., 0] != tf[..., 0]).any(0)
        n = int(tie.argmax()) if tie.any() else n
        assert n >= TP + 30, n
    if parted_after is not None:
        parted = (jf[..., 0] != tf[..., 0]).any(0)
        n = int(parted.argmax()) if parted.any() else n
        assert n >= TP + 1 + parted_after, n
    np.testing.assert_array_equal(tf[:, :n, 0], jf[:, :n, 0],
                                  err_msg="tokens")
    np.testing.assert_allclose(tf[:, :n, 1:], jf[:, :n, 1:], atol=atol,
                               rtol=rtol, err_msg="latents")
    assert got["output"].value.shape == want["output"].value.shape
    return want, got


def test_sampler_int8_weights_past_the_mega_batches(monkeypatch):
    """B = 33 with int8 weights and an int8 cache: the port (mega batch
    16, so 33 > 2 x 16) and JAX on the CPU (B > 32) both take the
    per-layer route, JAX in its base layout (``VAE_GSLM_PACKED_CACHE``
    0; its lane-packed one is not ported)."""
    jm, tm = mega_lvtr_pair(seed=5)
    _pin_initial_state(monkeypatch, tm, b=33)
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "0")
    monkeypatch.setenv("VAE_GSLM_PACKED_CACHE", "0")
    made = []
    init = tm.init_cache
    monkeypatch.setattr(tm, "init_cache", lambda *a, **k: made.append(
        k.get("dtype")) or init(*a, **k))
    tsamp = ARTRSampler(tm, kv_dtype=torch.int8, quantize_weights=True,
                        mega_max_batch=16, device="cpu")
    assert tsamp.use_mega and tsamp.route(33) == "per_layer"
    jsamp = jsampler.ARTRSampler(jm, kv_dtype=jnp.int8,
                                 quantize_weights=True)
    _sample_both(jsamp, tsamp, 12, _prompt(b=33, nfeat=N_MELS))
    assert made == [torch.int8]


@pytest.mark.parametrize("segments", [1, 8])
def test_sampler_float_cache_matches_jax(monkeypatch, segments):
    """``kv_dtype`` None on both sides (the port's per-layer route, JAX's
    stacked float route at B = 2), 100 steps in ``decode_segments``
    segments (``VAE_GSLM_DECODE_SEGMENTS`` for JAX): at most one per 48
    steps, so 1 and 2 here; each step attends over its segment's
    window.  This random model reaches a near-tie of two tokens after
    about 30 steps (``_sample_both``'s ``until_tie``)."""
    jm, tm = _pair(seed=6)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_DECODE_SEGMENTS", str(segments))
    windows = []
    step = tm.step
    monkeypatch.setattr(tm, "step", lambda *a, **k: windows.append(
        k.get("window")) or step(*a, **k))
    tsamp = ARTRSampler(tm, device="cpu", decode_segments=segments)
    assert tsamp.route(B) == "per_layer"
    _sample_both(jsampler.ARTRSampler(jm), tsamp, 100,
                 _prompt(nfeat=N_MELS), until_tie=True)
    windows = windows[:101]                          # the first port run
    n_seg = jsampler._n_segments(100)
    assert n_seg == tsampler.n_segments(100, segments) == min(segments, 2)
    max_len = TP + 1 + 100
    want = [None]                                    # the prefill
    for i in range(n_seg):
        end = round(100 * (i + 1) / n_seg)
        want += [min(-(-(TP + 1 + end) // 64) * 64, max_len)] * (
            end - round(100 * i / n_seg))
    assert windows == want


def test_sampler_return_attn_matches_jax(monkeypatch):
    """``return_attn`` with an int8 cache: the port's per-layer route (one
    full-window segment) against JAX's stacked step at B = 2: frames, and
    maps (B, L, H, steps, max_len)."""
    jm, tm = _pair(seed=7)
    _pin_initial_state(monkeypatch, tm)
    tsamp = ARTRSampler(tm, kv_dtype=torch.int8, device="cpu")
    assert tsamp.route(B) == "hybrid"
    assert tsamp.route(B, return_attn=True) == "per_layer"
    want, got = _sample_both(jsampler.ARTRSampler(jm, kv_dtype=jnp.int8),
                             tsamp, 30, _prompt(nfeat=N_MELS),
                             return_attn=True)
    assert tuple(got["attn"].shape) == (B, 2, 4, 30, TP + 1 + 30)
    assert got["attn"].dtype == torch.float32
    _close(got["attn"], want["attn"], "maps", atol=4e-3, rtol=0)


def _f32_products_of_bf16(monkeypatch):
    """XLA's CPU backend has no bf16 x bf16 -> f32 dot; JAX's products
    with ``preferred_element_type=float32`` are computed here on float32
    copies of their bf16 operands, which is the same product (a product
    of two bf16 values is exact in float32) summed in float32."""
    def patch(name):
        fn = getattr(jnp, name)

        def f32(*args, preferred_element_type=None, **kw):
            if preferred_element_type == jnp.float32:
                args = [a.astype(jnp.float32)
                        if getattr(a, "dtype", None) == jnp.bfloat16 else a
                        for a in args]
            return fn(*args, preferred_element_type=preferred_element_type,
                      **kw)

        monkeypatch.setattr(jnp, name, f32)

    patch("einsum")
    patch("matmul")


def _trainer_sampler_against_jax(monkeypatch, tmp_path, corpus,
                                 vocoder_dir, precision, **kw):
    """The sampler that ``LVTRTrainer._log_audio_samples`` builds under
    ``trainer.precision`` = ``precision``, and the dtypes of the per-layer
    caches it allocated; then that sampler against JAX's
    ``ARTRSampler(model)`` on the trainer's weights under the trainer's
    policy and the deterministic protocol (B = 2; ``kw`` to
    ``_sample_both``)."""
    cfg = yaml.safe_load(TRAIN_HP.format(log_dir=tmp_path,
                                         vocoder_dir=vocoder_dir,
                                         corpus=corpus))
    cfg["trainer"]["precision"] = precision
    trainer = LVTRTrainer(Hparams.from_dict(cfg), device="cpu")
    made, dtypes = [], []
    tm = trainer.model
    init = tm.init_cache
    monkeypatch.setattr(tm, "init_cache", lambda *a, **k: dtypes.append(
        k.get("dtype")) or init(*a, **k))

    class Recorded(ARTRSampler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tlvtr, "ARTRSampler", Recorded)
    trainer.logger = ExperimentLogger(str(tmp_path / "log"))
    trainer._log_audio_samples(next(iter(trainer.val_dataloader())), 0)
    trainer.logger.close()
    (sampler,) = made
    assert sampler.kv_dtype is None and sampler.route(1) == "per_layer"
    assert sampler.model is tm
    jm = JLVTR(JHparams.from_dict(cfg["model"]),
               input_dim=tm.input_dim, rngs=nnx.Rngs(1))
    save_compact(tm, str(tmp_path / "m.npz"))
    jckpt.load_compact(jm, str(tmp_path / "m.npz"))
    _pin_initial_state(monkeypatch, tm, nfeat=tm.token_embedding_dim)
    prompt = np.concatenate([
        np.random.RandomState(0).randint(0, 11, (B, TP, 1)),
        np.random.RandomState(1).randn(B, TP, tm.input_dim)],
        -1).astype(np.float32)
    jpolicy = jprecision.Policy()
    if precision == "16-mixed":
        jpolicy = jprecision.bf16_mixed()
        _f32_products_of_bf16(monkeypatch)
    with jprecision.policy_scope(jpolicy), policy_scope(trainer.policy):
        _sample_both(jsampler.ARTRSampler(jm), sampler, 20, prompt, **kw)
    return sampler, dtypes


def test_trainer_samples_with_a_float_cache(monkeypatch, corpus,  # noqa: F811
                                            vocoder_dir, tmp_path):  # noqa
    """``LVTRTrainer._log_audio_samples`` builds its sampler with a float
    cache (JAX's trainer builds ``ARTRSampler(model)``, ``kv_dtype``
    None), and that sampler agrees with JAX's on the trainer's weights
    under the deterministic protocol."""
    _trainer_sampler_against_jax(monkeypatch, tmp_path, corpus, vocoder_dir,
                                 "32")


def test_trainer_samples_at_16_mixed_with_jax_float32_cache(
        monkeypatch, corpus, vocoder_dir, tmp_path):  # noqa: F811
    """Under ``16-mixed`` (bf16 compute) JAX samples B <= 32 through its
    stacked step, whose ``kv_dtype`` None cache is float32; the port's
    per-layer caches are float32 there too (so the V product runs on
    float32 weights, as JAX's), and the compute dtype past B = 32.  The
    trainer's continuation agrees with JAX's at bf16 compute: tokens
    equal and latents within atol 1e-2 / rtol 2e-2 (bf16 activations; the
    prompt's encoded latents already differ by ~7e-3) up to the frame
    where the two packages' bf16 roundings part the continuations, which
    is 14 generated steps into this random model (with a float32 or a
    bf16 cache alike), held to come no earlier than 8."""
    sampler, dtypes = _trainer_sampler_against_jax(
        monkeypatch, tmp_path, corpus, vocoder_dir, "16-mixed",
        parted_after=8, atol=1e-2, rtol=2e-2)
    assert dtypes and set(dtypes) == {torch.float32}
    assert sampler.per_layer_kv_dtype(32) == torch.float32
    assert sampler.per_layer_kv_dtype(33) is None


def test_speech_inferer_runs_without_a_kv_cache_dtype(infer_dirs):
    """An infer config without ``kv_cache_dtype`` (nor ``weight_dtype``):
    JAX's inferer builds its sampler with ``kv_dtype`` None, and so does
    the port's, whose run takes the per-layer float route and writes one
    WAV per row."""
    d = yaml.safe_load(INFER_YAML.format(
        out=infer_dirs["root"] + "/float_out",
        **{k: infer_dirs[k] for k in ("ckpt", "exp", "voc", "corpus")}))
    del d["kv_cache_dtype"], d["weight_dtype"]
    inf = SpeechInferer(Hparams.from_dict(d), device="cpu")
    assert inf.sampler.kv_dtype is None
    assert inf.sampler.route(2) == "per_layer"
    assert inf.run(max_batches=1) == 2
    assert sorted(os.listdir(d["output_dir"])) == ["1.wav", "2.wav"]
