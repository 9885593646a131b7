"""A reference-keyed LVTTS checkpoint through the port's ``BaseInferer``.

The reference LVTTS keys are the LVTR's plus ``text_encoder.0`` (the
text embedding), ``text_encoder.1`` (the text stack), ``eos_head``,
``spkr_encoder.0`` and the time-first ``spkr_film``, as JAX's
``load_torch_lvtts`` reads them.  The dict is made from JAX's ``LVTTS``
(the ``trainers`` fixture of ``tests/test_torch_tts.py``) with JAX's
exporter pieces, written as a ``step=N-cpt.ckpt`` beside ``hp.yaml`` and
``symbols.json``; ``TTSInferer`` must take ``load_reference_lvtts`` (not
the LVTR loader, which refuses the text keys) and then equal JAX's model
on one input: the text memory, the speaker embedding, ``log_q``,
``log_p``, ``eos`` and ``rec_loss`` at float32, rtol/atol 1e-5."""
import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_tts import (_both, _close, _inputs, _jax_draws,
                                  _tts_dict, trainers)  # noqa: F401
from tests.test_trainers import corpus, vocoder_dir  # noqa: F401
from vae_gslm_tpu.models import convert_torch as ct
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.tts.inferer import TTSInferer
from vae_gslm_tpu_torch.models import convert


def _reference_lvtts_dict(jm):
    """JAX's LVTTS as the reference's state dict (JAX has no LVTTS
    exporter: the LVTR's, then the pieces ``load_torch_lvtts`` reads)."""
    out = ct.export_torch_lvtr(jm)
    out["text_encoder.0.weight"] = np.asarray(jm.text_embedding.table[...])
    ct._x_transformer_stack(out, jm.text_encoder, "text_encoder.1")
    eos = jm.eos_head
    for i, blk in enumerate(eos.layers):
        p = f"eos_head.layers.{i}"
        ct._x_dense(out, blk.linear1, f"{p}.linear1")
        ct._x_dense(out, blk.linear2, f"{p}.linear2")
        ct._x_norm(out, blk.norm1, f"{p}.norm1")
        ct._x_norm(out, blk.norm2, f"{p}.norm2")
    if eos.linear is not None:
        ct._x_dense(out, eos.linear, "eos_head.linear")
    if eos.out_linear is not None:
        ct._x_dense(out, eos.out_linear, "eos_head.out_linear")
    ct._x_bottleneck(out, jm.spkr_encoder, "spkr_encoder.0")
    ct._x_film(out, jm.spkr_film, "spkr_film", time_first=True)
    return out


@pytest.fixture(scope="module")
def ckpt_dir(trainers, corpus, vocoder_dir, tmp_path_factory):  # noqa: F811
    jt, tt = trainers
    d = tmp_path_factory.mktemp("lvtts_ckpt")
    Hparams.from_dict(_tts_dict(corpus, vocoder_dir)).save(
        str(d / "hp.yaml"))
    tt.symbols.save(str(d / "symbols.json"))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in _reference_lvtts_dict(jt.model).items()}
    torch.save({"state_dict": sd}, str(d / "step=3-cpt.ckpt"))
    return str(d), sd


def test_reference_lvtts_dict_is_refused_by_the_lvtr_loader(ckpt_dir,
                                                            trainers):
    _, sd = ckpt_dir
    with pytest.raises(KeyError, match="text_encoder"):
        convert.load_reference_lvtr(trainers[1].model, sd)


def test_inferer_loads_reference_lvtts_and_matches_jax(ckpt_dir, trainers):
    jt, tt = trainers
    path, _ = ckpt_dir
    hp = Hparams.from_dict({
        "ckpt_path": path, "output_dir": os.path.join(path, "out"),
        "model": {"identifier": "models.tts.lvtr.LVTTS"},
        "max_sample_length": 0.3, "min_sample_length": 0.1,
        "temperature": 1.0, "eos_threshold": 0.5})
    inf = TTSInferer(hp, device="cpu")
    want = dict(tt.model.named_parameters())
    for name, p in inf.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[name].detach().numpy(),
                                      err_msg=name)
    jm = jt.model
    (mel, ml), (text, tl), (spkr, sl) = _inputs(7, tt.symbols.num_symbols)
    jmel, tmel = _both(mel, ml)
    jtext, ttext = _both(text, tl)
    jspk, tspk = _both(spkr, sl)
    key = jax.random.PRNGKey(11)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def run(state, mel, text, spkr):
        m = nnx.merge(graphdef, state)
        mem, emb = m.encode_condition(text, spkr)
        out = m(mel, key, text=text, spkr=spkr)
        return mem, emb, {k: out[k] for k in ("log_q", "log_p", "eos",
                                              "rec_loss")}

    jmem, jemb, jout = run(state, jmel, jtext, jspk)
    with torch.no_grad():
        tmem, temb = inf.model.encode_condition(ttext, tspk)
        tout = inf.model(tmel, None, text=ttext, spkr=tspk,
                         draws=_jax_draws(key))
    _close(tmem.value, jmem.value, err_msg="text memory")
    _close(temb, jemb, err_msg="speaker embedding")
    for k in ("log_q", "log_p", "eos"):
        _close(tout[k].value, jout[k].value, err_msg=k)
    _close(tout["rec_loss"], jout["rec_loss"], err_msg="rec_loss")
