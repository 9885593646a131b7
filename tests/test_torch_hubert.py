"""The port's HuBERT tokenizer encoder against the JAX package's, on the
CPU, at tiny sizes (d 32, 2 layers, 4 heads, a 3-conv stack), float32:

  * both variants (stable-LN "large", post-LN "base" with the group
    norm and no conv bias) on the same random weights (a random HF
    model through each package's ``convert_hf_state_dict``): outputs
    within 1e-5 abs; a bucket-padded batch with ``lengths`` against
    JAX's the same way, and (stable-LN, whose norms are per frame) its
    frames against the unpadded clip away from the positional conv's
    edge; ``frame_count`` on ints and on a tensor;
  * ``convert_hf_state_dict`` against JAX's on HF-keyed dicts with the
    positional conv as ``weight_g``/``weight_v``, as
    ``parametrizations.weight.original0/1`` and folded: every parameter
    bit for bit (both fold in numpy float32);
  * ``load_hubert_flat`` carries JAX's parameters across bit for bit;
  * ``from_hf_pretrained`` on a directory written without
    ``transformers`` (``config.json`` with ``model.safetensors``, or with
    ``pytorch_model.bin``) and on one that ``transformers`` writes
    (``importorskip``); a hub name raises naming the directory;
  * the device rule."""
import json

import jax
import numpy as np
import pytest
import torch

from vae_gslm_tpu.models.ssl import hubert as jhubert
from vae_gslm_tpu.training.checkpoint import _flatten_state
from vae_gslm_tpu_torch.models import convert
from vae_gslm_tpu_torch.models.ssl import hubert

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=[16, 16, 16],
            conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            layer_norm_eps=1e-5)


def _config(stable: bool) -> dict:
    return dict(TINY, conv_bias=stable,
                feat_extract_norm="layer" if stable else "group",
                do_stable_layer_norm=stable)


def hf_state_dict(cfg: dict, seed: int, wn: str = "g_v") -> dict:
    """A random HF-keyed ``HubertModel`` state dict (numpy float32)
    written without ``transformers``; the positional conv's weight norm
    as ``wn``: "g_v" (``weight_g``/``weight_v``), "param"
    (``parametrizations.weight.original0/1``) or "plain" (``weight``)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def put(name, *shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[-1])
        sd[name] = (s * rng.randn(*shape)).astype(np.float32)

    in_ch = 1
    for i, (dim, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}"
        put(f"{pre}.conv.weight", dim, in_ch, k, scale=1 / np.sqrt(in_ch * k))
        if cfg["conv_bias"]:
            put(f"{pre}.conv.bias", dim, scale=0.1)
        if cfg["feat_extract_norm"] == "layer" or i == 0:
            sd[f"{pre}.layer_norm.weight"] = (
                1 + 0.1 * rng.randn(dim)).astype(np.float32)
            put(f"{pre}.layer_norm.bias", dim, scale=0.1)
        in_ch = dim
    d, c = cfg["hidden_size"], cfg["conv_dim"][-1]
    sd["feature_projection.layer_norm.weight"] = (
        1 + 0.1 * rng.randn(c)).astype(np.float32)
    put("feature_projection.layer_norm.bias", c, scale=0.1)
    put("feature_projection.projection.weight", d, c)
    put("feature_projection.projection.bias", d, scale=0.1)
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    pc = "encoder.pos_conv_embed.conv"
    v = (rng.randn(d, d // g, k) / np.sqrt(d // g * k)).astype(np.float32)
    gain = (1 + 0.1 * rng.rand(1, 1, k)).astype(np.float32)
    if wn == "g_v":
        sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"] = gain, v
    elif wn == "param":
        sd[f"{pc}.parametrizations.weight.original0"] = gain
        sd[f"{pc}.parametrizations.weight.original1"] = v
    else:
        sd[f"{pc}.weight"] = v
    put(f"{pc}.bias", d, scale=0.1)
    sd["encoder.layer_norm.weight"] = (1 + 0.1 * rng.randn(d)).astype(
        np.float32)
    put("encoder.layer_norm.bias", d, scale=0.1)
    ffd = cfg["intermediate_size"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        for name, dout, din in (("attention.q_proj", d, d),
                                ("attention.k_proj", d, d),
                                ("attention.v_proj", d, d),
                                ("attention.out_proj", d, d),
                                ("feed_forward.intermediate_dense", ffd, d),
                                ("feed_forward.output_dense", d, ffd)):
            put(f"{pre}.{name}.weight", dout, din)
            put(f"{pre}.{name}.bias", dout, scale=0.1)
        for ln in ("layer_norm", "final_layer_norm"):
            sd[f"{pre}.{ln}.weight"] = (1 + 0.1 * rng.randn(d)).astype(
                np.float32)
            put(f"{pre}.{ln}.bias", d, scale=0.1)
    return sd


def _pair(stable: bool, seed: int = 0, wn: str = "g_v"):
    cfg = _config(stable)
    sd = hf_state_dict(cfg, seed, wn)
    jm = jhubert.HubertEncoder(jhubert.HubertConfig.from_hf(
        type("C", (), cfg)))
    jhubert.convert_hf_state_dict(jm, sd)
    tm = hubert.HubertEncoder(hubert.HubertConfig.from_hf(cfg), device="cpu")
    hubert.convert_hf_state_dict(tm, sd)
    return jm, tm


def _jax_flat(jm) -> dict:
    from flax import nnx

    return {k: np.asarray(v) for k, v in
            _flatten_state(nnx.state(jm, nnx.Param)).items()}


@pytest.mark.parametrize("stable", [True, False])
def test_encoder_matches_jax(stable):
    jm, tm = _pair(stable)
    wave = hubert.normalize_input(
        np.random.RandomState(1).randn(2, 3200).astype(np.float32))
    want = np.asarray(jm(wave))
    with torch.no_grad():
        got = tm(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (2, tm.frame_count(3200), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stable", [True, False])
def test_padded_batch_with_lengths_matches_jax(stable):
    jm, tm = _pair(stable, seed=2)
    rng = np.random.RandomState(3)
    wave = np.zeros((3, 4000), np.float32)
    lengths = np.asarray([4000, 2600, 1200], np.int32)
    for i, n in enumerate(lengths):
        wave[i, :n] = hubert.normalize_input(rng.randn(n).astype(
            np.float32))
    want = np.asarray(jm(wave, lengths=lengths))
    with torch.no_grad():
        got = tm(torch.from_numpy(wave), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    nf = [tm.frame_count(int(n)) for n in lengths]
    assert nf == [jm.frame_count(int(n)) for n in lengths]
    assert tm.frame_count(torch.from_numpy(lengths).long()).tolist() == nf
    if not stable:
        return          # the base variant's group norm reads the padding
    # padded frames are zero before the projection: a clip's frames
    # differ from its unpadded run by the positional conv's edge only
    with torch.no_grad():
        alone = tm(torch.from_numpy(wave[2:3, :1200])).numpy()
    np.testing.assert_allclose(got[2, :nf[2] - 8], alone[0, :nf[2] - 8],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("wn", ["g_v", "param", "plain"])
@pytest.mark.parametrize("stable", [True, False])
def test_convert_hf_state_dict_matches_jax(stable, wn):
    jm, tm = _pair(stable, seed=4, wn=wn)
    flat = _jax_flat(jm)
    params = dict(tm.named_parameters())
    assert len(flat) == len(params)
    for name, p in params.items():
        a = flat[name.replace(".", "/")]
        if name == "pos_conv_w" or name.startswith("feature_encoder.conv_w"):
            a = a.transpose(2, 1, 0)
        np.testing.assert_array_equal(p.detach().numpy(), a, err_msg=name)


@pytest.mark.parametrize("stable", [True, False])
def test_load_hubert_flat_carries_jax_parameters(stable):
    jm, tm = _pair(stable, seed=5)
    other = hubert.HubertEncoder(tm.cfg, device="cpu")
    convert.load_hubert_flat(other, _jax_flat(jm))
    for (n, a), (_, b) in zip(other.named_parameters(),
                              tm.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=n)
    bad = _jax_flat(jm)
    bad.pop("enc_ln/w")
    with pytest.raises(KeyError, match="enc_ln/w"):
        convert.load_hubert_flat(other, bad)


def _hf_json(cfg: dict) -> dict:
    return dict(cfg, model_type="hubert", architectures=["HubertModel"])


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_from_hf_pretrained_without_transformers(tmp_path, fmt):
    cfg = _config(True)
    sd = hf_state_dict(cfg, 6, wn="param")
    (tmp_path / "config.json").write_text(json.dumps(_hf_json(cfg)))
    if fmt == "safetensors":
        hubert.write_safetensors(str(tmp_path / "model.safetensors"), sd)
        back = hubert.read_safetensors(str(tmp_path / "model.safetensors"))
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(tmp_path / "pytorch_model.bin"))
    got = hubert.from_hf_pretrained(str(tmp_path), device="cpu")
    want = hubert.HubertEncoder(hubert.HubertConfig.from_hf(cfg),
                                device="cpu")
    hubert.convert_hf_state_dict(want, sd)
    assert got.cfg == want.cfg
    for (n, a), (_, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=n)


def test_read_safetensors_widens_bfloat16(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    raw = x.view(torch.int16).numpy().astype("<i2").tobytes()
    head = json.dumps({"x": {"dtype": "BF16", "shape": [3, 5],
                             "data_offsets": [0, len(raw)]}}).encode()
    path = tmp_path / "t.safetensors"
    path.write_bytes(np.uint64(len(head)).astype("<u8").tobytes() + head
                     + raw)
    np.testing.assert_array_equal(hubert.read_safetensors(str(path))["x"],
                                  x.float().numpy())


def test_from_hf_pretrained_on_a_transformers_directory(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = _config(True)
    hf_cfg = transformers.HubertConfig(**cfg)
    torch.manual_seed(0)
    hf = transformers.HubertModel(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path))
    model = hubert.from_hf_pretrained(str(tmp_path), device="cpu")
    wave = hubert.normalize_input(
        np.random.RandomState(0).randn(2, 3200).astype(np.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(wave)).numpy()
        ref = hf(torch.from_numpy(wave)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_hub_name_raises_naming_the_directory():
    with pytest.raises(FileNotFoundError, match="facebook/hubert-large"):
        hubert.from_hf_pretrained("facebook/hubert-large-ll60k",
                                  device="cpu")


def test_large_and_base_configs_match_jax():
    for name in ("large", "base"):
        a = getattr(hubert.HubertConfig, name)()
        b = getattr(jhubert.HubertConfig, name)()
        assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
            f: getattr(b, f) for f in b.__dataclass_fields__}


def test_encoder_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = hubert.HubertConfig.from_hf(_config(True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hubert.HubertEncoder(cfg)
    hubert.HubertEncoder(cfg, device="cpu")


def test_jax_is_not_needed_by_the_port_module():
    assert jax is not None        # the test imports both; the port none
    import sys
    mod = sys.modules["vae_gslm_tpu_torch.models.ssl.hubert"]
    src = open(mod.__file__).read()
    for word in ("import jax", "flax", "vae_gslm_tpu.", "transformers import"):
        assert word not in src
