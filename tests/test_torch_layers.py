"""The port's modules on the speech path against their JAX counterparts,
float32 on the CPU, on the same numpy inputs and the same weights.

One test, one case per module family.  Tolerance atol 2e-5 / rtol 1e-4,
the JAX parity budget (``tests/test_reference_parity.py``); the vocoder
1e-5 absolute, as there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_models import HFG_HP
from tests.test_torch_trunk import N_MELS, lvtr_pair
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.vocoder.hfgan import Generator as JGenerator
from vae_gslm_tpu.models.vocoder.vocoder import load_torch_generator
from vae_gslm_tpu.nn import linear as jlinear
from vae_gslm_tpu.nn import norms as jnorms
from vae_gslm_tpu.nn import positions as jpositions
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_generator
from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator
from vae_gslm_tpu_torch.nn import linear, norms, positions

ATOL, RTOL = 2e-5, 1e-4
RNG = np.random.RandomState


def t(x):
    return torch.from_numpy(np.array(x))


def masked_pair(x, lengths):
    return (JMasked.from_lengths(jnp.asarray(x), jnp.asarray(lengths)),
            Masked.from_lengths(t(x), lengths))


def case_norms():
    rng = RNG(0)
    x = rng.randn(2, 5, 12).astype(np.float32) * 3 + 1
    w = rng.randn(12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32)
    out = []
    for name in ("RMSNorm", "InstanceNorm", "LayerNorm"):
        jn = jnorms.get_norm(12, JHparams(identifier=name, eps=1e-6),
                             rngs=nnx.Rngs(0))
        tn = norms.get_norm(12, Hparams(identifier=name, eps=1e-6))
        if name == "RMSNorm":
            jn.scale[...] = jnp.asarray(w)
            tn.scale.data = t(w)
        else:
            jn.weight[...], jn.bias[...] = jnp.asarray(w), jnp.asarray(bias)
            tn.weight.data, tn.bias.data = t(w), t(bias)
        out.append((tn(t(x)), jn(jnp.asarray(x))))
        # the NCW form used inside the conv stacks: channel axis 1
        out.append((tn(t(x).transpose(1, 2), dim=1).transpose(1, 2),
                    jn(jnp.asarray(x))))
    return out


def case_dense_embedding_gaussian():
    rng = RNG(1)
    x = rng.randn(2, 5, 6).astype(np.float32)
    jd = jlinear.Dense(6, 7, rngs=nnx.Rngs(0))
    td = linear.Dense(6, 7)
    td.weight.data = t(np.asarray(jd.kernel[...]).T)
    td.bias.data = t(jd.bias[...])
    je = jlinear.Embedding(11, 4, rngs=nnx.Rngs(1))
    te = linear.Embedding(11, 4)
    te.weight.data = t(je.table[...])
    ids = rng.randint(0, 11, (2, 5))
    jids, tids = masked_pair(ids, [5, 3])
    jg = jlinear.GaussianParameterize(6, 3, std_range=(0.1, 1.0),
                                      rngs=nnx.Rngs(2))
    tg = linear.GaussianParameterize(6, 3, std_range=(0.1, 1.0))
    for tm, jm in ((tg.mean, jg.mean_head), (tg.logstd, jg.logstd_head)):
        tm.weight.data = t(np.asarray(jm.kernel[...]).T)
        tm.bias.data = t(jm.bias[...])
    jx, tx = masked_pair(x, [5, 5])
    jo = jg(jx, jax.random.PRNGKey(0), temperature=0.0)
    to = tg(tx, torch.Generator().manual_seed(0), temperature=0.0)
    return [(td(t(x)), jd(jnp.asarray(x))),
            (te(tids).value, je(jids).value),
            (to.sample.value, jo.sample.value),
            (to.logstd.value, jo.logstd.value)]


def case_alibi():
    ja = jpositions.ALiBi(6)
    ta = positions.ALiBi(6)
    qp, kp = np.arange(3, 9), np.arange(12)
    return [(ta.slopes, ja.slopes[...]),
            (ta.bias(t(qp), t(kp)), ja.bias(jnp.asarray(qp),
                                            jnp.asarray(kp)))]


def case_bottleneck_resnet():
    jm, tm = lvtr_pair(seed=3)
    x = RNG(2).randn(2, 9, N_MELS).astype(np.float32)
    jx, tx = masked_pair(x, [9, 6])
    return [(tm.encoder_net(tx).value, jm.encoder_net(jx).value)]


def case_coupling_reverse():
    jm, tm = lvtr_pair(seed=4)
    rng = RNG(3)
    z = rng.randn(2, 7, 4).astype(np.float32)
    c = rng.randn(2, 7, 32).astype(np.float32)
    jz, tz = masked_pair(z, [7, 7])
    jc, tc = masked_pair(c, [7, 7])
    return [(tm.transformer_flow.reverse(tz, c=tc).value,
             jm.transformer_flow.reverse(jz, c=jc).value)]


def case_unet():
    jm, tm = lvtr_pair(seed=5)
    rng = RNG(4)
    x = rng.randn(2, 11, N_MELS).astype(np.float32)
    cond = rng.randn(2, 11, 16).astype(np.float32)
    steps = np.asarray([3, 17], np.int32)
    jx, tx = masked_pair(x, [11, 8])
    jc, tc = masked_pair(cond, [11, 8])
    return [(tm.decoder.model(tx, t(steps), tc).value,
             jm.decoder.model(jx, jnp.asarray(steps), jc).value)]


def case_ddim_eta0():
    jm, tm = lvtr_pair(seed=6)
    rng = RNG(5)
    start = rng.randn(2, 10, N_MELS).astype(np.float32)
    cond = rng.randn(2, 10, 16).astype(np.float32)
    for d in (jm.decoder, tm.decoder):
        d.override_sampling(sampling_timesteps=5, ddim_sampling_eta=0.0)
    js, ts = masked_pair(start, [10, 7])
    jc, tc = masked_pair(cond, [10, 7])
    with torch.no_grad():
        ours = tm.decoder.ddim_sample(ts, tc,
                                      torch.Generator().manual_seed(0))
    return [(ours.value, jm.decoder.ddim_sample(
        js, jc, jax.random.PRNGKey(0)).value)]


def _reference_generator_sd(jg):
    """A reference-layout weight-normed state dict from the JAX
    generator's random g/v (torch layout, ``weight_g``/``weight_v``)."""
    sd = {}

    def put(prefix, mod):
        v = np.asarray(mod.v[...]).transpose(2, 1, 0)
        sd[f"{prefix}.weight_v"] = v
        sd[f"{prefix}.weight_g"] = (np.asarray(mod.g[...]) * 1.3).reshape(
            -1, 1, 1)
        sd[f"{prefix}.bias"] = np.asarray(mod.bias[...])

    put("conv_pre", jg.conv_pre)
    put("conv_post", jg.conv_post)
    for i, up in enumerate(jg.ups):
        put(f"ups.{i}", up)
    for i, rb in enumerate(jg.resblocks):
        for j, c in enumerate(rb.convs1):
            put(f"resblocks.{i}.convs1.{j}", c)
        for j, c in enumerate(rb.convs2):
            put(f"resblocks.{i}.convs2.{j}", c)
    return sd


def case_generator():
    jg = JGenerator(HFG_HP, rngs=nnx.Rngs(7))
    sd = _reference_generator_sd(jg)
    load_torch_generator(jg, sd)
    jg.remove_weight_norm()
    tg = Generator(Hparams.from_dict(HFG_HP.to_dict()), device="cpu")
    load_reference_generator(tg, {k: t(v) for k, v in sd.items()})
    mel = RNG(6).randn(2, 17, 10).astype(np.float32)
    jx, tx = masked_pair(mel, [17, 13])
    jo, to = jg(jx), tg(tx)
    np.testing.assert_array_equal(to.lengths.numpy(), np.asarray(jo.lengths))
    return [(to.value, jo.value, 1e-5, 0.0)]


def _dense_from_jax(td, jd):
    td.weight.data = t(np.asarray(jd.kernel[...]).T)
    if jd.bias is not None:
        td.bias.data = t(jd.bias[...])


def case_self_attention():
    """Both branches: fused (causal, ALiBi or none: the plain K3 on the
    CPU) and dense (not causal)."""
    from vae_gslm_tpu.nn.attention import SelfAttention as JSelfAttention
    from vae_gslm_tpu_torch.nn.attention import SelfAttention

    x = RNG(7).randn(2, 9, 16).astype(np.float32)
    jx, tx = masked_pair(x, [9, 5])
    out = []
    for causal, alibi in ((True, True), (True, False), (False, True)):
        jm = JSelfAttention(16, JHparams(nheads=4, causal=causal),
                            rngs=nnx.Rngs(8))
        tm = SelfAttention(16, Hparams(nheads=4, causal=causal))
        _dense_from_jax(tm.in_proj, jm.in_proj)
        _dense_from_jax(tm.out_proj, jm.out_proj)
        pair = ("ALiBi", jpositions.ALiBi(4)) if alibi else None
        out.append((tm(tx, positions.ALiBi(4) if alibi else None).value,
                    jm(jx, rpe_pair=pair)["output"].value))
    return out


def case_transformer_run():
    jm, tm = lvtr_pair(seed=9)
    x = RNG(8).randn(2, 13, 16).astype(np.float32)
    jx, tx = masked_pair(x, [13, 6])
    jo, to = jm.transformer.run(jx), tm.transformer.run(tx)
    return ([(to["output"].value, jo["output"].value)]
            + [(a.value, b.value) for a, b in zip(to["layers"],
                                                  jo["layers"])])


def case_coupling_forward():
    from vae_gslm_tpu.nn.flow import TensorLogdet as JTensorLogdet
    from vae_gslm_tpu_torch.nn.flow import TensorLogdet

    jm, tm = lvtr_pair(seed=10)
    rng = RNG(9)
    z = rng.randn(2, 7, 4).astype(np.float32)
    c = rng.randn(2, 7, 32).astype(np.float32)
    jz, tz = masked_pair(z, [7, 4])
    jc, tc = masked_pair(c, [7, 4])
    jo = jm.transformer_flow.forward(JTensorLogdet(jz, 0.0), c=jc)
    to = tm.transformer_flow(TensorLogdet(tz, 0.0), c=tc)
    return [(to.tensor.value, jo.tensor.value), (to.logdet, jo.logdet)]


def case_cnn_stack():
    from vae_gslm_tpu.models.convert_torch import _x_cnnstack
    from vae_gslm_tpu.nn.conv import CNNStack as JCNNStack
    from vae_gslm_tpu_torch.nn.conv import CNNStack

    hp = dict(embedding_dim=6, num_layers=2, init_channel=8,
              out_channels=[8, 12], resample_rates=[-2, -2],
              resample_ksize=[4, 4],
              layer=dict(norm=dict(identifier="InstanceNorm", eps=1e-6),
                         activation=dict(identifier="ReLU")))
    jm = JCNNStack(JHparams.from_dict(hp), input_dim=N_MELS, output_dim=6,
                   rngs=nnx.Rngs(11))
    tm = CNNStack(Hparams.from_dict(hp), input_dim=N_MELS, output_dim=6)
    sd = {}
    _x_cnnstack(sd, jm, "net")
    tm.load_state_dict({k[4:]: t(v) for k, v in sd.items()}, strict=True)
    x = RNG(10).randn(2, 15, N_MELS).astype(np.float32)
    jx, tx = masked_pair(x, [15, 9])
    jo, to = jm(jx), tm(tx)
    np.testing.assert_array_equal(to.lengths.numpy(), np.asarray(jo.lengths))
    return [(to.value, jo.value),
            (to.time_mean(), jlinear.TimeAggregation()(jo))]


def case_diffusion_loss():
    jm, tm = lvtr_pair(seed=12)
    rng = RNG(11)
    x = rng.randn(2, 10, N_MELS).astype(np.float32)
    cond = rng.randn(2, 10, 16).astype(np.float32)
    jx, tx = masked_pair(x, [10, 7])
    jc, tc = masked_pair(cond, [10, 7])
    key = jax.random.PRNGKey(3)
    kt, kn = jax.random.split(key)
    steps = jax.random.randint(kt, (2,), 0, jm.decoder.num_timesteps)
    noise = jax.random.normal(kn, x.shape, jnp.float32)
    return [(tm.decoder(tx, tc, None, t=t(steps), noise=t(noise)),
             jm.decoder(jx, jc, key))]


def case_losses():
    from vae_gslm_tpu.core import losses as jlosses
    from vae_gslm_tpu_torch.core import losses

    rng = RNG(12)
    a = rng.randn(3, 6, 5).astype(np.float32)
    b = rng.randn(3, 6, 5).astype(np.float32)
    ids = rng.randint(0, 5, (3, 6))
    (ja, ta), (jb, tb) = masked_pair(a, [6, 4, 1]), masked_pair(b, [6, 4, 1])
    jl, tl = masked_pair(ids, [6, 4, 1])
    out = [(losses.masked_ce_loss(ta, tl, reduction=r),
            jlosses.masked_ce_loss(ja, jl, reduction=r))
           for r in ("sum", "mean")]
    for fn in ("masked_l1_loss", "masked_l2_loss"):
        for tr, br in ((False, False), (True, False), (False, True),
                       (True, True)):
            kw = dict(time_reduction=tr, batch_reduction=br)
            out.append((getattr(losses, fn)(ta, tb, **kw),
                        getattr(jlosses, fn)(ja, jb, **kw)))
    out.append((ta.mean(), ja.mean()))
    out.append((ta.shift_right(t(b[:, :2])).value,
                ja.shift_right(jnp.asarray(b[:, :2])).value))
    return out


CASES = {
    "self_attention": case_self_attention,
    "transformer_run": case_transformer_run,
    "coupling_forward": case_coupling_forward,
    "cnn_stack_time_pool": case_cnn_stack,
    "diffusion_loss": case_diffusion_loss,
    "losses_and_masked": case_losses,
    "norms": case_norms,
    "dense_embedding_gaussian": case_dense_embedding_gaussian,
    "alibi": case_alibi,
    "bottleneck_resnet": case_bottleneck_resnet,
    "coupling_reverse": case_coupling_reverse,
    "conditional_bottleneck_unet": case_unet,
    "ddim_eta0": case_ddim_eta0,
    "hfgan_generator": case_generator,
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_layer_matches_jax(family):
    for i, (ours, ref, *tol) in enumerate(CASES[family]()):
        atol, rtol = tol if tol else (ATOL, RTOL)
        ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
        np.testing.assert_allclose(ours, np.asarray(ref), atol=atol,
                                   rtol=rtol, err_msg=f"{family}[{i}]")
