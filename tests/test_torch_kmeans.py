"""The port's k-means (``ops/kmeans.py``) against the JAX package's on
the CPU, float32:

  * ``assign`` labels equal JAX's (chunked and whole) on data with no
    near-ties;
  * ``_lloyd`` from the same initial centroids: labels identical,
    centroids within 1e-5; an empty cluster keeps its centroid;
  * ``KMeans.train``: the k-means++ draws equal JAX's (the same
    ``RandomState``), then the same labels and centroids within 1e-5;
    ``search``, ``save``/``load`` and ``inertia`` (rtol 1e-5);
  * every product runs with TF32 off whatever the caller's switches
    (the float32 policy), and the switches are back after;
  * the device rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_gslm_tpu.ops import kmeans as jkmeans
from vae_gslm_tpu_torch.core import precision
from vae_gslm_tpu_torch.ops import kmeans


def _blobs(n=600, d=12, k=5, seed=0):
    rng = np.random.RandomState(seed)
    centers = 4 * rng.randn(k, d)
    x = centers[rng.randint(k, size=n)] + rng.randn(n, d)
    return x.astype(np.float32)


@pytest.mark.parametrize("chunk", [65536, 97])
def test_assign_matches_jax(chunk):
    x = _blobs()
    c = x[np.random.RandomState(1).choice(len(x), 7, replace=False)]
    got = kmeans.assign(x, c, chunk=chunk, device="cpu")
    want = jkmeans.assign(x, c, chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert kmeans.assign(x[:0], c, device="cpu").shape == (0,)


def test_lloyd_matches_jax_from_the_same_init():
    x = _blobs(seed=2)
    init = x[:6].copy()
    jc, jl = jkmeans._lloyd(jnp.asarray(x), jnp.asarray(init), 6, 7)
    tc, tl = kmeans._lloyd(torch.from_numpy(x), torch.from_numpy(init), 6, 7)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)


def test_empty_cluster_keeps_its_centroid():
    x = _blobs(n=200, seed=3)
    far = np.full((1, x.shape[1]), 1e3, np.float32)
    init = np.concatenate([x[:3], far])
    jc, jl = jkmeans._lloyd(jnp.asarray(x), jnp.asarray(init), 4, 3)
    tc, tl = kmeans._lloyd(torch.from_numpy(x), torch.from_numpy(init), 4, 3)
    assert not (tl.numpy() == 3).any()
    np.testing.assert_array_equal(tc.numpy()[3], far[0])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)


def test_kmeans_train_search_save_load_match_jax(tmp_path):
    x = _blobs(n=800, seed=4)
    jm = jkmeans.KMeans(x.shape[1], 8, niter=10, seed=7)
    tm = kmeans.KMeans(x.shape[1], 8, niter=10, seed=7, device="cpu")
    rng_a, rng_b = np.random.RandomState(7), np.random.RandomState(7)
    np.testing.assert_array_equal(tm._kmeanspp_init(x, rng_a),
                                  jm._kmeanspp_init(x, rng_b))
    want = jm.train(x)
    got = tm.train(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.search(x), jm.search(x))
    path = str(tmp_path / "kmeans_v8.npy")
    tm.save(path)
    back = kmeans.KMeans.load(path, device="cpu")
    assert (back.d, back.k) == (x.shape[1], 8)
    np.testing.assert_array_equal(back.centroids, got)
    np.testing.assert_array_equal(back.search(x), tm.search(x))
    np.testing.assert_allclose(kmeans.inertia(x, got, device="cpu"),
                               jkmeans.inertia(x, want), rtol=1e-5)


@pytest.fixture
def tf32_on():
    flags = precision.tf32_flags()
    precision._set_tf32(True, True)
    yield
    precision._set_tf32(*flags)


def test_products_run_with_tf32_off(tf32_on, monkeypatch):
    seen = []
    real = kmeans._assign_chunk

    def spy(x, c):
        seen.append(precision.tf32_flags())
        return real(x, c)

    monkeypatch.setattr(kmeans, "_assign_chunk", spy)
    x = _blobs(n=100, seed=5)
    with precision.policy_scope(precision.bf16_mixed()):
        kmeans.assign(x, x[:4], chunk=40, device="cpu")
        kmeans.KMeans(x.shape[1], 4, niter=2, device="cpu").train(x)
    assert seen and all(f == (False, False) for f in seen)
    assert precision.tf32_flags() == (True, True)


def test_kmeans_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _blobs(n=50)
    for make in (lambda **kw: kmeans.KMeans(12, 3, **kw),
                 lambda **kw: kmeans.assign(x, x[:3], **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
