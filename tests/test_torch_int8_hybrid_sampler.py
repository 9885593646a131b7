"""The int8-weight hybrid path against the JAX package on the CPU (moved
out of ``tests/test_torch_mega_sampler.py`` so that no test file keeps one
worker for minutes): a model K2 cannot take (dim 32) serves with int8
weights through the hybrid path in both packages, under the
deterministic protocol of ``tests/test_torch_mega_sampler.py``."""
import numpy as np
import pytest
import torch

from tests.test_torch_mega_sampler import _pin_initial_state, _run_both
from tests.test_torch_per_layer import one_torch_thread  # noqa: F401
from tests.test_torch_trunk import lvtr_pair


@pytest.mark.parametrize("length", [8, 280])
def test_int8_weight_hybrid_matches_jax(monkeypatch, length):
    """A model K2 cannot take (dim 32) with int8 weights serves through
    the hybrid path (K1 per layer, the stacked matmuls upconverting the
    int8 weights) in both packages; 280 steps cross the 256-position
    flush."""
    jm, tm = lvtr_pair(seed=11)
    _pin_initial_state(monkeypatch, tm)
    monkeypatch.setenv("VAE_GSLM_HYBRID_DECODE", "1")
    monkeypatch.setenv("VAE_GSLM_MEGA_DECODE", "1")
    sampler, jf, tf = _run_both(jm, tm, length)
    assert not sampler.use_mega
    assert tm.transformer.layers[0].linear1.weight.dtype == torch.int8
    np.testing.assert_array_equal(tf[..., 0], jf[..., 0],
                                  err_msg=f"{length}-step token stream")
    np.testing.assert_allclose(tf[..., 1:], jf[..., 1:], atol=2e-3,
                               rtol=1e-2, err_msg="latents")
