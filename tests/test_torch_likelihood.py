"""The port's ``LVTR.likelihood`` against the JAX package's.

Three configurations of the tiny LVTR shared by the ``test_torch_*``
files (``tests/test_torch_trunk.py``): tokens + conditional flow (the
token branch), no tokens with the flow (the flow-corrected continuous
branch) and no tokens without a flow (the plain Gaussian branch).  The
weights are the JAX model's, exported; the uniform initial AR state,
the one sampled quantity at temperature 0, is pinned on both sides as
``tests/test_reference_parity.py`` pins it.  Two batches: 40 frames
(the trunk's attention off the packed envelope at T <= 1024: K4's
plain version) and 1030 frames (past 1024: K5's plain version).
float32 on the CPU; scores agree to rtol 1e-4 / atol 1e-4 (sums over up
to 1030 frames of float32 terms computed in another order)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.core.masked import Masked as JMasked
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu.models.convert_torch import export_torch_lvtr
from vae_gslm_tpu.models.speech.lvtr import LVTR as JLVTR
from vae_gslm_tpu_torch.core.masked import Masked
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.models.convert import load_reference_lvtr
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.ops import flash_attention as fa

VOCAB = 11


def config(branch: str) -> dict:
    d = Hparams.from_yaml(TINY_YAML).to_dict()
    d["transformer"]["rpe"]["maxpos"] = 2048
    if branch != "tokens_flow":
        del d["tokens"]
    if branch == "continuous":
        del d["transformer"]["flow"]
    return d


def pair(branch: str, seed: int):
    d = config(branch)
    jm = JLVTR(JHparams.from_json(json.dumps(d)), input_dim=N_MELS,
               rngs=nnx.Rngs(seed))
    tm = LVTR(Hparams.from_dict(d), input_dim=N_MELS, device="cpu")
    load_reference_lvtr(tm, export_torch_lvtr(jm))
    return jm, tm


def batch(branch: str, t: int, lengths, seed: int):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    x = rng.randn(b, t, N_MELS).astype(np.float32)
    if branch == "tokens_flow":
        toks = rng.randint(0, VOCAB, (b, t, 1)).astype(np.float32)
        x = np.concatenate([toks, x], -1)
    return x, np.asarray(lengths, np.int32)


def pin(jm, tm, nfeat: int, b: int, seed: int):
    init = (np.random.RandomState(seed).rand(b, 1, nfeat) * 2 - 1).astype(
        np.float32)
    jm.initial_state = lambda key, bsize, nfeat=None: jnp.asarray(init)
    tm.initial_state = (lambda generator, bsize, nfeat=None:
                        torch.from_numpy(init))


@pytest.mark.parametrize("branch", ["tokens_flow", "continuous_flow",
                                    "continuous"])
@pytest.mark.parametrize("t,lengths", [(40, [40, 23, 1]),
                                       (1030, [1030, 611])])
def test_likelihood_matches_jax(branch, t, lengths):
    jm, tm = pair(branch, seed=len(branch))
    x, ln = batch(branch, t, lengths, seed=t)
    pin(jm, tm, 16 if branch == "tokens_flow" else 4, len(lengths), seed=t)
    want = np.asarray(jm.likelihood(
        JMasked.from_lengths(jnp.asarray(x), jnp.asarray(ln)),
        jax.random.PRNGKey(0), temperature=0.0))
    before = (fa.flash_forward_full.launches, fa.flash_forward_tiled.launches)
    with torch.no_grad():
        got = tm.likelihood(Masked.from_lengths(torch.from_numpy(x), ln),
                            torch.Generator().manual_seed(0))
    assert got.shape == (len(lengths),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(want).all()
    # the CPU runs the plain versions: no kernel was launched
    assert (fa.flash_forward_full.launches,
            fa.flash_forward_tiled.launches) == before


def test_likelihood_draws_only_the_initial_state():
    """At temperature 0 the generator is consumed by the initial state
    alone: two calls from generators of one seed agree, and the score
    moves with the initial state."""
    _, tm = pair("tokens_flow", seed=5)
    x, ln = batch("tokens_flow", 24, [24, 17], seed=1)
    xm = Masked.from_lengths(torch.from_numpy(x), ln)
    with torch.no_grad():
        a = tm.likelihood(xm, torch.Generator().manual_seed(3))
        b = tm.likelihood(xm, torch.Generator().manual_seed(3))
        c = tm.likelihood(xm, torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
