"""The token LM (``models/speech/discrete.py``) and its sampler against
the JAX package's, float32 on the CPU, the weights drawn once with numpy
in JAX's layout (``tests/test_torch_lvtr_options.py::fill_jax``) and
carried into the port through ``load_flat``:

  * ``DiscreteAR`` forward (logits, the f0 head) and ``likelihood``:
    single-VQ, RVQ with ``ARCTransformer``, and single-VQ with f0, at
    rtol/atol 1e-5;
  * ``step`` (the per-layer prefill and AR steps on a float32 cache) and
    ``step_hybrid`` (the stacked int8 prefill, then the hybrid cache; the
    port's plain K1 against JAX's kernel interpreted) against JAX's, the
    token draw replaced by the logits on both sides;
  * ``DiscreteARSampler`` on both routes (int8: hybrid; None: per-layer
    float32, where JAX takes its stacked float step) under the
    deterministic protocol: token temperature 1e-4 and the same SOS
    start.  Tokens must be equal; a flip is allowed only where the top
    two logits lie within 1e-5 (after it the rows part), and the test
    prints how many it allowed;
  * ``load_reference_discrete_ar`` on a synthetic reference state dict,
    held against JAX's ``load_torch_discrete_ar`` of the same dict."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_lvtr_options import fill_jax
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.inference.speech import sampler as jsampler
from vae_gslm_tpu.models import convert_torch
from vae_gslm_tpu.models.speech.discrete import DiscreteAR as JDiscreteAR
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import DiscreteARSampler
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.speech.discrete import DiscreteAR

VOCAB, B, T, TP = 32, 2, 14, 6
LOGIT_SCALE = 30.0      # well-separated logits: a near-tie is rare
TRUNK = {
    "num_layers": 2, "bias": False,
    "rpe": {"identifier": "ALiBi", "maxpos": 512},
    "layer": {"dim": 64, "ffd_size": 128,
              "norm": {"identifier": "RMSNorm", "eps": 1e-6},
              "activation": {"identifier": "GELU"},
              "self_attn": {"nheads": 4, "causal": True}}}
ARC = {"num_layers": 1, "bias": False,
       "layer": {"dim": 32, "ffd_size": 64,
                 "norm": {"identifier": "RMSNorm", "eps": 1e-6},
                 "activation": {"identifier": "GELU"},
                 "self_attn": {"nheads": 2, "causal": True}}}
KINDS = ("single", "rvq", "f0")


def model_hp(kind: str):
    hp = {"transformer": copy.deepcopy(TRUNK)}
    if kind == "rvq":
        hp["arc_transformer"] = copy.deepcopy(ARC)
        vq = {"num_quantizers": 3, "codebook_size": 16, "dim": 16}
    else:
        vq = {"num_quantizers": 1, "codebook_size": VOCAB, "dim": 16}
    if kind == "f0":
        hp["f0"] = True
    return hp, vq


def discrete_pair(kind: str, seed: int = 0):
    """A JAX DiscreteAR with numpy-drawn weights (its output layer scaled
    by ``LOGIT_SCALE``) and the port's loaded from its flat state."""
    hp, vq = model_hp(kind)
    tm = DiscreteAR(Hparams.from_dict(copy.deepcopy(hp)),
                    Hparams.from_dict(vq), device="cpu")
    jm = fill_jax(lambda: JDiscreteAR(JHparams.from_dict(copy.deepcopy(hp)),
                                      JHparams.from_dict(vq),
                                      rngs=nnx.Rngs(0)), tm, seed)
    if kind != "rvq":
        jm.transformer.out.kernel[...] = (jm.transformer.out.kernel[...]
                                          * LOGIT_SCALE)
    convert.load_flat(tm, _flatten_state(nnx.state(jm)))
    return jm, tm


def _tokens(kind, seed=0, b=B, t=T):
    rng = np.random.RandomState(seed)
    if kind == "rvq":
        return rng.randint(0, 16, (b, t, 3))
    return rng.randint(0, VOCAB, (b, t))


def _f0(seed=1, b=B, t=T):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


LENGTHS = [T, 9]


@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_likelihood_match_jax(kind):
    jm, tm = discrete_pair(kind, KINDS.index(kind))
    x = _tokens(kind)
    jx = JMasked.from_lengths(jnp.asarray(x), jnp.asarray(LENGTHS))
    tx = Masked.from_lengths(torch.from_numpy(x), LENGTHS)
    jf0 = tf0 = None
    if kind == "f0":
        f0 = _f0()
        jf0 = JMasked.from_lengths(jnp.asarray(f0), jnp.asarray(LENGTHS))
        tf0 = Masked.from_lengths(torch.from_numpy(f0), LENGTHS)
    want, got = jm(jx, f0=jf0), tm(tx, f0=tf0)
    np.testing.assert_allclose(got["logits"].value.detach().numpy(),
                               np.asarray(want["logits"].value), rtol=1e-5,
                               atol=1e-5 * LOGIT_SCALE)
    np.testing.assert_array_equal(got["labels"].value.numpy(),
                                  np.asarray(want["labels"].value))
    if kind == "f0":
        np.testing.assert_allclose(got["f0"].value.detach().numpy(),
                                   np.asarray(want["f0"].value), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["f0"].lengths.numpy(),
                                      np.asarray(want["f0"].lengths))
    if kind == "rvq":
        # JAX's RVQ likelihood cannot broadcast its mask: held against its
        # logits, each frame's codebook log-probs summed
        logp = jax.nn.log_softmax(want["logits"].value, axis=-1)
        lp = jnp.take_along_axis(logp, jnp.asarray(x)[..., None],
                                 axis=-1)[..., 0].sum(-1)
        lp = jnp.where(want["logits"].mask(), lp, 0.0)
        lw = lp.sum(-1) / jnp.asarray(LENGTHS)
    else:
        lw = jm.likelihood(jx, f0=jf0)
    lg = tm.likelihood(tx, f0=tf0)
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lw),
                               rtol=1e-5, atol=1e-5)


def _logits_out(monkeypatch, tm):
    """Both packages' token draw replaced by the trunk's logits."""
    monkeypatch.setattr(JDiscreteAR, "_sample_from_hidden",
                        lambda self, h, key, temperature: h)
    monkeypatch.setattr(tm, "_sample_from_hidden",
                        lambda h, generator, temperature: tm.transformer.out(h))


def _step_inputs(kind):
    x = _tokens(kind, 3, t=TP + 4)
    sos = np.full((B, 1), VOCAB, np.int64)
    seq = np.concatenate([sos, x], axis=1)
    if kind == "f0":
        f0 = np.concatenate([np.zeros((B, 1), np.float32),
                             _f0(4, t=TP + 4)], axis=1)
        seq = np.stack([seq.astype(np.float32), f0], axis=-1)
    return seq


@pytest.mark.parametrize("kind", ["single", "f0"])
def test_step_per_layer_matches_jax(monkeypatch, kind):
    jm, tm = discrete_pair(kind, 5)
    _logits_out(monkeypatch, tm)
    seq = _step_inputs(kind)
    max_len = seq.shape[1]
    jc = jm.init_cache(B, max_len, dtype=jnp.float32)
    tc = tm.init_cache(B, max_len, dtype=torch.float32)
    jo, jc = jm.step(jnp.asarray(seq[:, :TP + 1]), jc, jnp.asarray(0),
                     jax.random.PRNGKey(0))
    to, tc = tm.step(torch.from_numpy(seq[:, :TP + 1]), tc, 0, None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4 * LOGIT_SCALE)
    for pos in range(TP + 1, max_len):
        jo, jc = jm.step(jnp.asarray(seq[:, pos:pos + 1]), jc,
                         jnp.asarray(pos), jax.random.PRNGKey(pos),
                         window=64)
        to, tc = tm.step(torch.from_numpy(seq[:, pos:pos + 1]), tc, pos,
                         None, window=64)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-4 * LOGIT_SCALE,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("kind", ["single", "f0"])
def test_step_hybrid_matches_jax(monkeypatch, kind):
    """The stacked int8 prefill, the conversion and four hybrid steps;
    JAX's step runs its K1 Pallas kernel interpreted, the port the plain
    K1 (an int8 requantization flip moves a logit by ~1e-4 of its
    scale)."""
    jm, tm = discrete_pair(kind, 6)
    _logits_out(monkeypatch, tm)
    seq = _step_inputs(kind)
    total = seq.shape[1]
    jw = jm.transformer.build_stacked_decode()
    tw = tm.transformer.build_stacked_decode()
    jpre = jm.init_cache(B, TP + 1, dtype=jnp.int8, stacked=True)
    tpre = tm.init_cache(B, TP + 1, dtype=torch.int8, stacked=True)
    jo, jpre = jm.step(jnp.asarray(seq[:, :TP + 1]), jpre, jnp.asarray(0),
                       jax.random.PRNGKey(0), stacked=jw)
    to, tpre = tm.step(torch.from_numpy(seq[:, :TP + 1]), tpre, 0, None,
                       stacked=tw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4 * LOGIT_SCALE)
    jc, jfl = jm.transformer.hybrid_cache_from_prefill(jpre, TP + 1, total)
    tc, tfl = tm.transformer.hybrid_cache_from_prefill(tpre, TP + 1, total)
    assert jfl == tfl == 0
    for pos in range(TP + 1, total):
        jo, jc = jm.step_hybrid(jnp.asarray(seq[:, pos:pos + 1]), jw, jc,
                                jnp.asarray(pos), 0, jax.random.PRNGKey(1),
                                interpret=True)
        to, tc = tm.step_hybrid(torch.from_numpy(seq[:, pos:pos + 1]), tw,
                                tc, pos, 0, None)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-3,
                                   atol=2e-4 * LOGIT_SCALE,
                                   err_msg=f"pos {pos}")


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@pytest.mark.parametrize("route", ["hybrid", "per_layer"])
def test_sampler_matches_jax(monkeypatch, route):
    """Both samplers from the same prompt at token temperature 1e-4: the
    same tokens up to a flip, which is allowed only at a top-two gap under
    1e-5 (the port's logits at that draw, equal to JAX's to rounding
    until then); after it the row's draws part."""
    jm, tm = discrete_pair("single", 7 + len(route))
    length = 60
    kv = {"hybrid": (jnp.int8, torch.int8),
          "per_layer": (None, None)}[route]
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_PACKED_CACHE", "0")
    x = _tokens("single", 8, t=TP)
    lengths = np.full((B,), TP)
    jsamp = jsampler.DiscreteARSampler(jm, kv_dtype=kv[0])
    want = jsamp(length, JMasked.from_lengths(jnp.asarray(x),
                                             jnp.asarray(lengths)),
                 jax.random.PRNGKey(0), temperature=1e-4)
    gaps = []
    orig = tm._sample_from_hidden

    def record(h, generator, temperature):
        gaps.append(_top2_gap(tm.transformer.out(h[:, -1])))
        return orig(h, generator, temperature)

    monkeypatch.setattr(tm, "_sample_from_hidden", record)
    tsamp = DiscreteARSampler(tm, kv_dtype=kv[1], device="cpu")
    assert tsamp.route(B) == route
    got = tsamp(length, Masked.from_lengths(torch.from_numpy(x), lengths),
                torch.Generator().manual_seed(0), temperature=1e-4)
    jt, tt = np.asarray(want.value), got.value.numpy()
    assert tt.shape == jt.shape == (B, TP + length)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    gap = torch.stack(gaps, dim=1).numpy()       # (B, 1 + length)
    allowed = 0
    for r in range(B):
        diff = np.flatnonzero(jt[r] != tt[r])
        n = TP + length if diff.size == 0 else int(diff[0])
        if diff.size:
            step = n - TP                        # the draw that parted
            assert gap[r, step] < 1e-5, (r, n, gap[r, step])
            allowed += 1
        np.testing.assert_array_equal(tt[r, :n], jt[r, :n])
    print(f"{route}: {allowed} flips allowed at a near-tie")


@pytest.mark.parametrize("route", ["hybrid", "per_layer"])
def test_f0_sampler_agrees_with_the_forward(route):
    """With f0 (which JAX's sampler cannot run: its f0 head reads the
    vocabulary logits) the continuation's tokens are the argmax of the
    teacher-forced forward's logits and its f0 values that forward's f0
    head, on the float32 per-layer route to 1e-4; on the int8 hybrid
    route the row runs, stays finite and in the vocabulary."""
    _, tm = discrete_pair("f0", 10)
    length = 20
    x = np.stack([_tokens("single", 11, t=TP).astype(np.float32),
                  _f0(12, t=TP)], axis=-1)
    lengths = np.full((B,), TP)
    samp = DiscreteARSampler(tm, kv_dtype=torch.int8 if route == "hybrid"
                             else None, device="cpu")
    assert samp.route(B) == route
    got = samp(length, Masked.from_lengths(torch.from_numpy(x), lengths),
               torch.Generator().manual_seed(0), temperature=1e-4)
    v = got.value
    assert v.shape == (B, TP + length, 2) and torch.isfinite(v).all()
    np.testing.assert_array_equal(v[:, :TP].numpy(), x)
    toks = v[..., 0]
    assert ((toks >= 0) & (toks < VOCAB)).all()
    if route == "hybrid":
        return
    full = Masked.from_lengths(toks.long(), torch.full((B,), TP + length))
    f0 = Masked.from_lengths(v[..., 1].contiguous(),
                             torch.full((B,), TP + length))
    out = tm(full, f0=f0)
    pred = out["logits"].value.argmax(-1)
    # teacher forcing: position t reads [SOS, x[:t]] and predicts x[t]
    np.testing.assert_array_equal(toks[:, TP:].numpy(),
                                  pred[:, TP:].numpy())
    np.testing.assert_allclose(v[:, TP:, 1].numpy(),
                               out["f0"].value[:, TP:, 0].detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def _reference_sd(tm: DiscreteAR) -> dict:
    """The port's weights under the reference's names (a synthetic
    reference checkpoint)."""
    sd = {}
    for k, v in tm.state_dict().items():
        v = v.detach().clone()
        if k == "embedding.weight":
            sd["transformer.0.weight"] = v
        elif k == "embedding.tables":
            for i in range(v.shape[0]):
                sd[f"transformer.0.embeddings.{i}.weight"] = v[i]
        elif k.startswith("transformer."):
            sd["transformer.1." + k[len("transformer."):]] = v
        else:
            sd[k] = v
    return sd


@pytest.mark.parametrize("kind", KINDS)
def test_load_reference_discrete_ar(kind):
    """A reference-keyed state dict (drawn by the port at another seed)
    loads strictly into the port and, through JAX's
    ``load_torch_discrete_ar``, into JAX: both give the same logits.  A
    dict missing a key is refused."""
    hp, vq = model_hp(kind)
    src = DiscreteAR(Hparams.from_dict(copy.deepcopy(hp)),
                     Hparams.from_dict(vq), device="cpu",
                     generator=torch.Generator().manual_seed(11))
    sd = _reference_sd(src)
    jm, tm = discrete_pair(kind, 12)
    convert.load_reference_discrete_ar(tm, sd)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)
    x = _tokens(kind, 13)
    if kind == "rvq":
        # JAX's loader writes into a read-only view of its RVQ tables, so
        # it cannot load this dict: the port is held to the source model
        np.testing.assert_array_equal(
            tm(Masked.from_lengths(torch.from_numpy(x), LENGTHS))[
                "logits"].value.detach().numpy(),
            src(Masked.from_lengths(torch.from_numpy(x), LENGTHS))[
                "logits"].value.detach().numpy())
        return
    convert_torch.load_torch_discrete_ar(jm, {k: v.numpy()
                                              for k, v in sd.items()})
    jx = JMasked.from_lengths(jnp.asarray(x), jnp.asarray(LENGTHS))
    tx = Masked.from_lengths(torch.from_numpy(x), LENGTHS)
    f0 = None
    if kind == "f0":
        f0 = _f0(14)
    want = jm(jx, f0=None if f0 is None else JMasked.from_lengths(
        jnp.asarray(f0), jnp.asarray(LENGTHS)))["logits"].value
    got = tm(tx, f0=None if f0 is None else Masked.from_lengths(
        torch.from_numpy(f0), LENGTHS))["logits"].value
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    bad = dict(sd)
    bad.pop("f0_dense.weight" if kind == "f0" else "transformer.0.weight")
    with pytest.raises(KeyError):
        convert.load_reference_discrete_ar(tm, bad)


def test_flat_checkpoint_round_trips_through_jax():
    """The port's flat dict is JAX's state, array for array."""
    jm, tm = discrete_pair("rvq", 15)
    flat = convert.to_flat(tm)
    want = _flatten_state(nnx.state(jm))
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]),
                                      err_msg=k)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hp, vq = model_hp("single")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiscreteAR(Hparams.from_dict(hp), Hparams.from_dict(vq))
    tm = DiscreteAR(Hparams.from_dict(hp), Hparams.from_dict(vq),
                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiscreteARSampler(tm)
