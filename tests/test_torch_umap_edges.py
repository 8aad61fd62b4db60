"""UMAP's edge-list tier (SPH_UMAP_EDGE_PATH=1) and the sequential oracle
in the PyTorch port against the JAX package on the CPU.

Tolerances: the fold of a scatter-add equals XLA-CPU's ``.at[].add`` bit
for bit; the port's ``native.umap_sequential`` and ``argsort_i64`` are the
same C++ as the JAX package's and equal bit for bit; the first epoch from
one state is bit-equal, and each of 10 epochs taken from the JAX state and
key is within 1e-4 x max|y| (the two packages' float32 pow differ in the
last bit: 10 % of the attraction coefficients by an ulp); the schedule is
equal.  Quality: the edge tier's trustworthiness at k = 10 at least 0.99 x
the sequential oracle's, from the same memberships, layout and epochs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_tpu import native as jnative
from sph_tpu.models import umap as jumap
from sph_tpu.ops.knn import knn_bruteforce
from sph_tpu.utils.testdata import create_3d_gaussians
from sph_tpu_torch import native as tnative
from sph_tpu_torch.models import umap as tumap
from test_torch_reference_native import use_reference_native

use_reference_native()

UMAP_ENV = ("SPH_UMAP_DENSE_MAX", "SPH_UMAP_ROWS_WIDTH", "SPH_UMAP_NEG_BUDGET",
            "SPH_UMAP_EDGE_PATH", "SPH_UMAP_DISPATCH_BUDGET")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def umap_env(monkeypatch):
    for name in UMAP_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPH_UMAP_PACKED", "0")
    return monkeypatch


@pytest.fixture(scope="module")
def blobs():
    centers = np.array([[0, 0, 0], [14, 0, 0], [0, 14, 0], [9, 9, 9]])
    pos, _ = create_3d_gaussians(300, random_state=9, centers=centers)
    idx, dist = knn_bruteforce(pos, 15)
    return pos, idx, dist


@pytest.mark.parametrize("n,e", [(50, 2000), (7, 3), (300, 0)])
def test_fold_equals_xla_scatter_add(n, e):
    rng = np.random.default_rng(n + e)
    t = rng.integers(0, n, e)
    v = (rng.standard_normal(e) * 1e3).astype(np.float32)
    base = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jax.jit(lambda b, t, v: b.at[t].add(v))(
        jnp.asarray(base), jnp.asarray(t, jnp.int32), jnp.asarray(v)))
    got = tumap.FoldLayout(torch.as_tensor(t), n).add(
        torch.as_tensor(base), torch.as_tensor(v))
    assert np.array_equal(got.numpy(), ref)


def test_argsort_i64_matches():
    keys = np.random.default_rng(3).integers(0, 50, 5000).astype(np.int64)
    got = tnative.argsort_i64(keys)
    assert np.array_equal(got, jnative.argsort_i64(keys))
    assert np.array_equal(got, np.argsort(keys, kind="stable"))
    with pytest.raises(ValueError):
        tnative.argsort_i64(np.array([3, -1]))


def _edges(m_idx, m_val, n_epochs):
    mask = (m_idx >= 0) & (m_val > 0)
    src = np.broadcast_to(np.arange(m_idx.shape[0])[:, None],
                          m_idx.shape)[mask]
    eps = jumap.make_epochs_per_sample(m_val[mask], n_epochs)
    return (src.astype(np.int32), m_idx[mask].astype(np.int32),
            eps.astype(np.float32))


def test_umap_sequential_matches(blobs):
    _, idx, dist = blobs
    ju = jumap.UmapComputation()
    ju.set_neighbor_graph(idx, dist)
    m = ju._memberships()
    src, dst, eps = _edges(np.asarray(m.indices), np.asarray(m.values), 50)
    a, b = jumap.find_ab()
    init = np.random.default_rng(1).standard_normal((300, 2)).astype(
        np.float32) * 10
    ref = jnative.umap_sequential(init, src, dst, eps, 50, a, b, seed=42)
    got = tnative.umap_sequential(init, src, dst, eps, 50, a, b, seed=42)
    assert np.array_equal(got, ref)


def _pair(idx, dist, epochs=200):
    ju = jumap.UmapComputation()
    ju.params.num_epochs = epochs
    ju.set_neighbor_graph(idx, dist)
    ju.init_optimization()
    tu = tumap.UmapComputation(device="cpu")
    tu.params.num_epochs = epochs
    tu.set_neighbor_graph(idx, dist)
    tu.set_initial_embedding(np.asarray(ju._embedding))
    tu.init_optimization()
    return ju, tu


def test_edge_tier_set_up_and_epochs_match(umap_env, blobs):
    umap_env.setenv("SPH_UMAP_EDGE_PATH", "1")
    _, idx, dist = blobs
    ju, tu = _pair(idx, dist)
    assert ju._tier == tu.tier == "edges"
    assert np.array_equal(tu._src.numpy(), np.asarray(ju._src))
    assert np.array_equal(tu._dst.numpy(), np.asarray(ju._dst))
    assert np.array_equal(tu._eps.numpy(), np.asarray(ju._eps))
    y, nxt = ju._y, ju._next_sample
    c = ju._const
    for ep in range(11):
        tu._y = torch.as_tensor(np.asarray(y))
        tu._next_sample = torch.as_tensor(np.asarray(nxt))
        tu._edges_epoch(ep)
        alpha = c[1] * (1.0 - jnp.float32(ep) / c[0])
        y, nxt = jumap._epoch_update(
            y, ju._src, ju._dst, ju._eps, nxt, jnp.float32(ep), alpha,
            c[2], c[3], jax.random.fold_in(ju._key, ep), ju._n_dev, 5)
        ref = np.asarray(y)
        assert np.abs(tu._y.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
        assert np.array_equal(tu._next_sample.numpy(), np.asarray(nxt))


def test_edge_tier_pinned_by_argument_and_repeatable(umap_env, blobs):
    _, idx, dist = blobs
    init = np.random.default_rng(2).standard_normal((300, 2)).astype(
        np.float32)
    runs = []
    for _ in range(2):
        u = tumap.UmapComputation(device="cpu")
        u.params.num_epochs = 30
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)      # eigsh starts at random
        u.init_optimization(edge_path=True)
        u.run_for_epochs(30)
        assert u.tier == "edges" and "SPH_UMAP_EDGE_PATH" not in os.environ
        runs.append(u.embedding)
    assert np.array_equal(runs[0], runs[1])
    u = tumap.UmapComputation(device="cpu")
    u.set_neighbor_graph(idx, dist)
    umap_env.setenv("SPH_UMAP_EDGE_PATH", "1")
    u.init_optimization(edge_path=False)
    assert u.tier == "dense"


def test_edge_tier_trustworthiness_against_the_sequential_oracle(umap_env,
                                                                  blobs):
    from sklearn.manifold import trustworthiness
    pos, idx, dist = blobs
    epochs = 200
    u = tumap.UmapComputation(device="cpu")
    u.params.num_epochs = epochs
    u.set_neighbor_graph(idx, dist)
    init = np.random.default_rng(7).standard_normal((300, 2)).astype(
        np.float32) * 10
    u.set_initial_embedding(init)
    u.init_optimization(edge_path=True)
    u.run_for_epochs(epochs)
    m = u.memberships
    src, dst, eps = _edges(m.indices, m.values, epochs)
    seq = tnative.umap_sequential(init, src, dst, eps, epochs, u._a, u._b,
                                  seed=42)
    t_edges = trustworthiness(pos, u.embedding, n_neighbors=10)
    t_seq = trustworthiness(pos, seq, n_neighbors=10)
    assert t_edges >= 0.99 * t_seq
