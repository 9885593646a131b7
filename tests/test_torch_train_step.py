"""The port's LVTR training step against the JAX package's, float32 on
the CPU.

The JAX ``LVTRTrainer`` is built as ``tests/test_e2e_lvtr.py`` builds it
(its tiny ``TRAIN_HP``, a saved vocoder directory, here with a
one-stage generator), plus an utterance encoder; its initial weights go
to the port's trainer through ``export_torch_lvtr``.  One stacked batch
of two micro-batches comes from a numpy seed.  JAX's random draws are reproduced with ``jax.random``
and the key splits of ``trainers/speech/lvtr.py:214`` (one key per
micro-batch), ``models/speech/lvtr.py:174`` (five keys) and
``nn/diffusion.py:219-221`` (step, then noise), and handed to the port
as ``draws=``.  Tolerances: the forward's outputs rtol 1e-5 / atol 1e-6;
gradients 1e-4 x max|g| per leaf; the optimizer 1e-6; one whole step's
parameters 1e-6 where the gradient is above 1e-6 and within 2 lr
elsewhere (Adam's first step is about lr x sign(g), which a tiny
gradient's rounding can flip); a bf16-mixed loss rtol 1e-2."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from vae_gslm_tpu.core import precision as jprecision
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.vocoder.vocoder import HiFiGAN
from vae_gslm_tpu.trainers.speech.lvtr import LVTRTrainer as JTrainer
from vae_gslm_tpu.training.optimizer import create_optimizer as jcreate
from vae_gslm_tpu_torch.core import precision
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer
from vae_gslm_tpu_torch.training.optimizer import create_optimizer

ACCUM, B, T, T_UTT, N_MELS, VOCAB = 2, 2, 12, 10, 20, 32
UTTERANCE = {"embedding_dim": 8, "num_layers": 2, "init_channel": 8,
             "out_channels": [8, 16], "resample_rates": [-2, -2],
             "resample_ksize": [4, 4],
             "layer": {"norm": {"identifier": "InstanceNorm", "eps": 1e-6},
                       "activation": {"identifier": "ReLU"}}}
# test_e2e_lvtr's vocoder cut to one upsampling stage: the trainer reads
# only its feature block, and a smaller generator saves set-up time
SMALL_VOCODER = {"upsample_rates": [2], "upsample_kernel_sizes": [4],
                 "upsample_initial_channel": 8, "resblock_kernel_sizes": [3],
                 "resblock_dilation_sizes": [[1]]}
OUT_KEYS = ("log_p", "log_q", "rec_loss", "ce_loss", "sample_q",
            "transformer_latent", "logstd", "mean", "q_logstd", "q_mean",
            "q_mean_abs", "u_c")


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    voc = tmp_path_factory.mktemp("vocoder")
    voc_hp = yaml.safe_load(VOCODER_HP)
    voc_hp["model"]["generator"].update(SMALL_VOCODER)
    HiFiGAN(JHparams.from_dict(voc_hp),
            rngs=nnx.Rngs(0)).save_pretrained(str(voc))
    d = yaml.safe_load(TRAIN_HP.format(
        log_dir=tmp_path_factory.mktemp("log"), vocoder_dir=voc,
        corpus=tmp_path_factory.mktemp("corpus")))
    d["model"]["utterance_encoder"] = UTTERANCE
    d["trainer"]["n_devices"] = 1
    return d


def _pair(cfg):
    """A JAX trainer and the port's, on the JAX trainer's weights."""
    jt = JTrainer(JHparams.from_dict(copy.deepcopy(cfg)))
    tt = LVTRTrainer(Hparams.from_dict(copy.deepcopy(cfg)), device="cpu")
    load_reference_lvtr(tt.model, export_torch_lvtr(jt.model))
    return jt, tt


@pytest.fixture(scope="module")
def pair(cfg):
    return _pair(cfg)


def _batch():
    """Stacked (ACCUM, B, ...) numpy arrays and lengths."""
    rng = np.random.RandomState(0)
    lengths = np.asarray([[T, 9], [11, 7]], np.int32)
    utt_lengths = np.asarray([[T_UTT, 6], [8, T_UTT]], np.int32)
    return {
        "mel": (rng.randn(ACCUM, B, T, N_MELS).astype(np.float32), lengths),
        "tokens": (rng.randint(0, VOCAB, (ACCUM, B, T)).astype(np.int32),
                   lengths),
        "cropped_mel_utt": (rng.randn(ACCUM, B, T_UTT, N_MELS).astype(
            np.float32), utt_lengths),
    }


def _jax_batch(raw, i=None):
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    return {k: JMasked(jnp.asarray(pick(v)), jnp.asarray(pick(ln)), 1)
            for k, (v, ln) in raw.items()}


def _torch_batch(raw, i=None):
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    return {k: Masked(torch.from_numpy(np.array(pick(v))),
                      torch.from_numpy(np.array(pick(ln))), 1)
            for k, (v, ln) in raw.items()}


def _draws(key, cfg):
    """The draws of one JAX ``LVTR.__call__`` under ``key``."""
    m = cfg["model"]
    k_enc, k_init, k_prior, k_diff, _ = jax.random.split(key, 5)
    kt, kn = jax.random.split(k_diff)
    lat = (B, T, m["latent_dim"])
    out = {
        "posterior": jax.random.normal(k_enc, lat, jnp.float32),
        "initial": jax.random.uniform(
            k_init, (B, 1, m["tokens"]["embedding_dim"]), jnp.float32, -1.0,
            1.0),
        "prior": jax.random.normal(k_prior, lat, jnp.float32),
        "t": jax.random.randint(kt, (B,), 0,
                                m["decoder"]["diffusion"]["timesteps"]),
        "noise": jax.random.normal(kn, (B, T, N_MELS), jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _model_input(batch, masked):
    tok = batch["tokens"]
    return masked(tok.value[..., None].astype(np.float32)
                  if isinstance(tok.value, jax.Array)
                  else tok.value[..., None].float(),
                  tok.lengths, 1).cat(batch["mel"])


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _value(x):
    x = x.value if hasattr(x, "value") else x
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_lvtr_forward_matches_jax(pair, cfg):
    jt, tt = pair
    raw = _batch()
    key = jax.random.PRNGKey(7)
    jb, tb = _jax_batch(raw, 0), _torch_batch(raw, 0)

    @jax.jit
    def forward(params, batch, key):
        out = jt._merge(params, jt.rest)(_model_input(batch, JMasked), key,
                                         utterance=batch["cropped_mel_utt"])
        return {k: out[k] for k in OUT_KEYS}

    want = forward(jt.params, jb, key)
    with torch.no_grad():
        got = tt.model(_model_input(tb, Masked), None,
                       utterance=tb["cropped_mel_utt"],
                       draws=_draws(key, cfg))
    for k in OUT_KEYS:
        _close(_value(got[k]), _value(want[k]), 1e-5, 1e-6, k)


def test_loss_gradients_match_jax(pair, cfg):
    jt, tt = pair
    raw = _batch()
    key = jax.random.PRNGKey(8)
    kld_weight = 0.3
    jgrads, jmetrics = jax.jit(jax.grad(jt._loss_fn, has_aux=True))(
        jt.params, jt.rest, _jax_batch(raw, 1), jnp.float32(kld_weight),
        key)
    ref = LVTR(Hparams.from_dict(copy.deepcopy(cfg["model"])),
               input_dim=N_MELS, device="cpu")
    load_reference_lvtr(ref, export_torch_lvtr(jt._merge(jgrads, jt.rest)))
    want = dict(ref.named_parameters())
    for p in tt.params:
        p.grad = None
    loss, metrics = tt._loss_fn(_torch_batch(raw, 1), kld_weight, None,
                                _draws(key, cfg))
    loss.backward()
    for k in ("kld", "rec_loss", "token_kld", "log_p", "log_q"):
        _close(metrics[k].numpy(), np.asarray(jmetrics[k]), 1e-5, 1e-6, k)
    assert set(want) == set(tt.names)
    for name, p in zip(tt.names, tt.params):
        w = want[name].detach().numpy()
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def _opt_hp(identifier):
    return {"gradient_clip_val": 1.0,
            "optimizer": {"identifier": identifier, "lr": 1e-2,
                          "beta1": 0.9, "beta2": 0.98, "weight_decay": 0.1,
                          "exclude_norm_and_bias_from_weight_decay": True},
            "scheduler": {"identifier": "cosine", "min_lr": 1e-3,
                          "warmup_steps": 1, "flat_steps": 1,
                          "finish_steps": 1}}


@pytest.mark.parametrize("identifier", ["Adam", "AdamW"])
def test_optimizer_matches_optax(identifier):
    """Five steps across warmup -> flat -> cosine -> finish, clipping on
    some steps (gradient norms on both sides of 1)."""
    rng = np.random.RandomState(9)
    shapes = {"a": (3, 4), "b": (4,), "c": (2, 3, 5)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    total = 5
    tx, jsched = jcreate(JHparams.from_dict(_opt_hp(identifier)), total)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = [torch.from_numpy(init[k].copy()) for k in sorted(shapes)]
    opt, sched = create_optimizer(Hparams.from_dict(_opt_hp(identifier)),
                                  total, tparams)
    for step in range(total):
        _close(sched(step), np.asarray(jsched(step)), 1e-6, 0, "lr")
        scale = 0.05 if step % 2 else 2.0
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in sorted(shapes)])
        for k, tp in zip(sorted(shapes), tparams):
            _close(tp.numpy(), np.asarray(jparams[k]), 0, 1e-6,
                   f"{k} step {step}")


def test_kld_weight_matches_jax(pair):
    jt, tt = pair
    saved = [(t.zero_kld, t.warmup_kld) for t in (jt, tt)]
    try:
        for t in (jt, tt):
            t.zero_kld, t.warmup_kld = 3, 10
        for step in (0, 2, 3, 4, 5, 9, 10, 11, 20):
            want = float(jt._kld_weight(jnp.asarray(step)))
            assert tt._kld_weight(step) == want, step
    finally:
        for t, (z, w) in zip((jt, tt), saved):
            t.zero_kld, t.warmup_kld = z, w


def test_bf16_mixed_loss_matches_jax(pair, cfg):
    jt, tt = pair
    raw = _batch()
    key = jax.random.PRNGKey(10)
    with jprecision.policy_scope(jprecision.bf16_mixed()):
        want, _ = jax.jit(jt._loss_fn)(jt.params, jt.rest,
                                       _jax_batch(raw, 0), jnp.float32(0.5),
                                       key)
    with precision.policy_scope(precision.bf16_mixed()), torch.no_grad():
        got, _ = tt._loss_fn(_torch_batch(raw, 0), 0.5, None,
                             _draws(key, cfg))
    _close(got.item(), float(want), 1e-2, 0, "bf16-mixed loss")


def test_frozen_encoder_takes_no_gradient(cfg):
    """With the encoder frozen (JAX: after its warm start) its gradients
    are zeroed before the update, as JAX's ``grad_mask`` does; AdamW's
    decoupled decay still moves its matrices."""
    tt = LVTRTrainer(Hparams.from_dict(copy.deepcopy(cfg)), device="cpu")
    tt.freeze_encoder = True
    before = {n: p.detach().clone() for n, p in zip(tt.names, tt.params)}
    tt.run_step(_torch_batch(_batch()))
    lr = tt.lr_schedule(0)
    wd = cfg["training"]["optimizer"]["weight_decay"]
    for name, p in zip(tt.names, tt.params):
        if name.startswith(("encoder_net.", "encoder_head.")):
            assert not p.grad.any(), name
            want = before[name] * (1 - lr * wd) if p.dim() != 1 \
                else before[name]
            torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)


def test_fused_accumulation_sums_the_same_gradients(cfg):
    """``fuse_accumulation`` runs the two micro-batches as one batch of
    2B rows: with the same draws per row, the summed gradient is the
    same up to float32 summation order."""
    raw = _batch()
    draws = [_draws(jax.random.PRNGKey(i), cfg) for i in (11, 12)]
    grads = []
    for fuse in (False, True):
        d = copy.deepcopy(cfg)
        d["training"]["fuse_accumulation"] = fuse
        tt = LVTRTrainer(Hparams.from_dict(d), device="cpu")
        step_draws = ([{k: torch.cat([x[k] for x in draws])
                        for k in draws[0]}] if fuse else draws)
        tt.run_step(_torch_batch(raw), draws=step_draws)
        grads.append([p.grad.clone() for p in tt.params])
    for name, a, b in zip(tt.names, *grads):
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-5 * max(a.abs().max(), 1e-30),
                                   msg=name)


def test_train_step_matches_jax(cfg):
    """One whole step with accumulation 2 (gradients summed over the
    micro-batches, metrics aggregated, clip, AdamW, lr schedule)."""
    jt, tt = _pair(cfg)
    raw = _batch()
    _, key = jax.random.split(jt.rng)     # run_step's split
    keys = jax.random.split(key, ACCUM)
    draws = [_draws(k, cfg)
             for k in keys]
    want = jt.run_step(_jax_batch(raw))
    got = tt.run_step(_torch_batch(raw), draws=draws)
    assert set(got) == set(want)
    for k in want:
        _close(np.asarray(got[k]), np.asarray(want[k]),
               1e-4 if k == "grad_norm" else 1e-5, 1e-6, k)
    jt.sync_model()
    ref = export_torch_lvtr(jt.model)
    port = LVTR(Hparams.from_dict(copy.deepcopy(cfg["model"])),
                input_dim=N_MELS, device="cpu")
    load_reference_lvtr(port, ref)
    want_p = dict(port.named_parameters())
    lr = float(want["lr"])
    for name, p in zip(tt.names, tt.params):
        w = want_p[name].detach().numpy()
        diff = np.abs(p.detach().numpy() - w)
        big = np.abs(p.grad.numpy()) > 1e-6
        assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
        assert (diff <= 2 * lr).all(), (name, diff.max())
