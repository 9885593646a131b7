"""The port's hybrid trunk against the JAX ``TransformerLayerStack``.

Prefill, ``hybrid_cache_from_prefill`` and ``decode_hybrid`` steps
across a ``flush_hybrid`` run on the same exported weights in both
packages, float32 on the CPU; the JAX hybrid step runs its Pallas
kernel in interpret mode.  Also holds the tiny LVTR config the
``test_torch_*`` files share: shaped like
``configs/train/speech/vae-gslm.yaml`` (tokens, BottleNeckResNet
encoder, ALiBi/RMSNorm/GELU trunk, conditional LinearCoupling flow,
BottleNeckUNet with skips and an ``upward_layer`` boundary), without an
utterance encoder."""
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu.nn.attention import LayerKVCache as JCache
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR

TINY_YAML = """
tokens: {embedding_dim: 16, vocab_size: 11}
latent_dim: 4
encoder:
    identifier: BottleNeckResNet
    num_layers: 2
    init_channel: 16
    out_channels: [16, 16]
    hidden_channels: [32, 32]
    resample_rates: [1, 1]
    resample_ksize: [1, 1]
    final_norm: true
    layer:
        kernel_size: 3
        causal_padding: true
        norm: {identifier: InstanceNorm, eps: 1.0e-6}
        activation: {identifier: ReLU}
transformer:
    num_layers: 2
    bias: false
    rpe: {identifier: ALiBi, maxpos: 512}
    layer:
        dim: 32
        ffd_size: 64
        norm: {identifier: RMSNorm, eps: 1.0e-6}
        activation: {identifier: GELU}
        self_attn: {nheads: 4, causal: true}
    flow:
        num_layers: 2
        conditional: true
        layer:
            hidden_dim: 8
            mean_only: false
            scale_range: [0.5, 2.0]
            activation: {identifier: GELU}
            norm: {identifier: LayerNorm, eps: 1.0e-6}
decoder:
    diffusion:
        identifier: ConditionalBottleNeckUNet
        timesteps: 20
        beta_schedule: {identifier: cosine}
        objective: pred_noise
        loss_type: l1
        input_scale: 5.0
        clamp_range: [-3.0, 1.2]
        ddim_sampling_eta: 1.0
    cond_unet:
        unet:
            condition_dim: 8
            num_layers: 4
            init_channel: 16
            out_channels: [16, 16, 16, 16]
            hidden_channels: [32, 32, 32, 32]
            resample_rates: [1, 1, 1, 1]
            resample_ksize: [1, 1, 1, 1]
            conditional: [false, true, true, false]
            skip_connection: [null, null, 1, 0]
            connection_type: concat
            final_norm: true
            layer:
                kernel_size: 3
                causal_padding: true
                condition_type: concat
                norm: {identifier: InstanceNorm, eps: 1.0e-6}
                activation: {identifier: SiLU}
            upward_layer:
                boundary: 2
                kernel_size: 3
                future_padding: true
                condition_type: concat
                norm: {identifier: InstanceNorm, eps: 1.0e-6}
                activation: {identifier: SiLU}
        time_embedding:
            dim: 16
            maxpos: 20
            activation: {identifier: SiLU}
"""
N_MELS = 10


def lvtr_pair(seed=0):
    """A JAX LVTR with random weights and the port's LVTR loaded from
    its export (both float32, CPU)."""
    jm = JLVTR(JHparams.from_yaml(TINY_YAML), input_dim=N_MELS,
               rngs=nnx.Rngs(seed))
    tm = LVTR(Hparams.from_yaml(TINY_YAML), input_dim=N_MELS, device="cpu")
    load_reference_lvtr(tm, export_torch_lvtr(jm))
    return jm, tm


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_hybrid_trunk_matches_jax_across_flush():
    jm, tm = lvtr_pair(seed=1)
    rng = np.random.RandomState(0)
    b, s, prompt = 2, 253, 253          # tail fills at position 256
    total = prompt + 6
    x = rng.randn(b, s, 16).astype(np.float32)

    jstack = jm.transformer
    jw = jstack.build_stacked_decode()
    jcache = jstack.init_stacked_cache(b, prompt, dtype=jnp.int8)
    jh, jcache = jstack.decode_stacked(jnp.asarray(x), jw, jcache,
                                       jnp.asarray(0))
    tstack = tm.transformer
    tw = tstack.build_stacked_decode()
    tcache = tstack.init_stacked_cache(b, prompt)
    th, tcache = tstack.decode_stacked(t(x), tw, tcache, 0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))

    jhc, flushed = jstack.hybrid_cache_from_prefill(jcache, prompt, total)
    thc, tflushed = tstack.hybrid_cache_from_prefill(tcache, prompt, total)
    assert flushed == tflushed == 0
    _assert_cache_close(thc, jhc)
    errs = []
    for pos in range(prompt, total):
        if pos - flushed == 256:
            jhc = jstack.flush_hybrid(jhc, flushed)
            thc = tstack.flush_hybrid(thc, flushed)
            flushed += 256
        xs = rng.randn(b, 1, 16).astype(np.float32)
        jo, jhc = jstack.decode_hybrid(jnp.asarray(xs), jw, jhc,
                                       jnp.asarray(pos), flushed,
                                       interpret=True)
        to, thc = tstack.decode_hybrid(t(xs), tw, thc, pos, flushed)
        errs.append(np.abs(to.numpy() - np.asarray(jo)).max())
        # an exp one ulp apart can flip one requantized probability by
        # one int8 step, which moves the hidden state by ~1e-4
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-3,
                                   atol=2e-4, err_msg=f"pos {pos}")
    assert flushed == 256
    # without a flip the two agree to float32 rounding
    assert np.median(errs) < 2e-6, errs
    _assert_cache_close(thc, jhc, after_steps=True)


def _assert_cache_close(thc, jhc, after_steps=False):
    """int8 planes equal and float32 scales to 1e-6; after decode steps,
    whose K/V rows carry the flips above, within one int8 step and
    1e-4."""
    int_atol, rtol = (1, 1e-4) if after_steps else (0, 1e-6)
    assert sorted(thc) == sorted(jhc)
    for k in jhc:
        ours, ref = thc[k].numpy(), np.asarray(jhc[k])
        if ref.dtype == np.int8:
            np.testing.assert_allclose(ours.astype(np.int32),
                                       ref.astype(np.int32), rtol=0,
                                       atol=int_atol, err_msg=k)
        else:
            np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0,
                                       err_msg=k)


def test_stacked_cache_matches_jax_layout():
    jm, tm = lvtr_pair(seed=2)
    jc = jm.transformer.init_stacked_cache(3, 7, dtype=jnp.int8)
    tc = tm.transformer.init_stacked_cache(3, 7)
    assert isinstance(jc, JCache)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b_ = getattr(jc, name), getattr(tc, name)
        assert tuple(a.shape) == tuple(b_.shape), name
        assert str(a.dtype) == str(b_.dtype).replace("torch.", ""), name
