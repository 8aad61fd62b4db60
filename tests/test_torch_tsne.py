"""t-SNE parity of the PyTorch port (dense-P tier) against the JAX package.

The port implements the JAX package's dense-P tier, which on a TPU runs the
Pallas kernel tsne_forces_dense; here the JAX side runs that tier with the
kernel in interpret mode, as tests/test_pallas_kernels.py runs it.

Free-running trajectories of two float32 implementations part after a few
iterations: during early exaggeration the dynamics amplify last-bit force
differences about twofold per step (the JAX package's own sparse and dense
tiers differ by 2e-5 to 4e-4 of the embedding scale after 10 iterations).
So the 10-iteration check is made step by step: before each step the port
takes the JAX state, and each step's result is held to 1e-5 of the scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
import sph_tpu.ops.pallas.tsne_kernels as jax_kernels
import sph_tpu_torch as T
from sph_tpu.models.tsne import _repulsive_forces, tsne_kl_divergence
from sph_tpu.ops.math import random_disk_init
from sph_tpu.ops.sparse import normalize_rows, symmetrize_tsne
from sph_tpu_torch.models import tsne as ttsne
from test_torch_reference_native import use_reference_native

use_reference_native()


@pytest.fixture
def jax_dense_tier(monkeypatch):
    """Route the JAX package's dense-P tier through the interpret-mode
    kernel (the compiled one exists only on a TPU)."""
    monkeypatch.setattr(jax_kernels, "tsne_forces_dense", functools.partial(
        jax_kernels.tsne_forces_dense, interpret=True))


def _joint_p(n=300, k=20, seed=3):
    r = np.random.default_rng(seed)
    idx = np.sort(np.stack([r.choice(n, k, replace=False)
                            for _ in range(n)]), 1).astype(np.int32)
    val = r.random((n, k), dtype=np.float32)
    return symmetrize_tsne(normalize_rows(J.SparseRows(idx, val, n)))


def _pair(p, params_j=None, params_t=None):
    n = p.num_rows
    init = random_disk_init(n, 0.1, seed=0)
    tj = J.TsneComputation(params_j or J.TsneParameters(), use_pallas=True)
    tj.set_probability_distribution(p)
    tj.set_initial_embedding(init)
    tj._init_gradient_descent()
    tt = ttsne.TsneComputation(params_t or T.TsneParameters(), device="cpu")
    tt.set_probability_distribution(T.SparseRows(p.indices, p.values, n,
                                                  device="cpu"))
    tt.set_initial_embedding(init)
    tt._init_gradient_descent()
    return tj, tt


@pytest.mark.parametrize("start", [0, 245])
def test_ten_iterations_step_by_step(jax_dense_tier, start):
    """Iterations start..start+9 from the same P and init: the early
    exaggeration, and the momentum switch plus exaggeration decay at 250."""
    tj, tt = _pair(_joint_p())
    assert tj._use_dense_p and tj._npad == tt._npad
    assert tj.params.exaggeration_factor == tt.params.exaggeration_factor
    if start:
        tj.continue_gradient_descent(start)
    for _ in range(10):
        s = tj._state
        tt._y = torch.tensor(np.array(s.embedding))
        tt._vel = torch.tensor(np.array(s.velocity))
        tt._gain = torch.tensor(np.array(s.gain))
        tt._iteration = s.iteration
        tt._step()
        tj.continue_gradient_descent(1)
        s = tj._state
        for got, ref in ((tt._y, s.embedding), (tt._vel, s.velocity),
                         (tt._gain, s.gain)):
            ref = np.asarray(ref)
            scale = float(np.abs(ref).max())
            assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
        assert tt._iteration == s.iteration


def test_dense_p_and_padding_match(jax_dense_tier):
    tj, tt = _pair(_joint_p(n=257))
    assert tt._npad == tj._npad == 512
    assert np.allclose(tt._p_dense.numpy(), np.asarray(tj._p_dense),
                       rtol=1e-6, atol=0)
    assert np.array_equal(tt._y.numpy(), np.asarray(tj._state.embedding))


def test_kl_and_repulsion_match():
    p = _joint_p()
    tj, tt = _pair(p)
    r = np.random.default_rng(4)
    y = np.zeros((tt._npad, 2), np.float32)
    y[:p.num_rows] = r.standard_normal((p.num_rows, 2)).astype(np.float32)
    rep_j, z_j = _repulsive_forces(jnp.asarray(y), jnp.int32(p.num_rows), 128)
    rep_t, z_t = ttsne.repulsive_forces(torch.from_numpy(y), p.num_rows)
    assert np.isclose(float(z_t), float(z_j), rtol=1e-5)
    scale = float(np.abs(np.asarray(rep_j)).max())
    assert np.abs(rep_t.numpy() - np.asarray(rep_j)).max() <= 1e-5 * scale
    kl_j = tsne_kl_divergence(jnp.asarray(y), tj._p_idx, tj._p_val,
                              jnp.int32(p.num_rows), 128)
    kl_t = ttsne.tsne_kl_divergence(torch.from_numpy(y), tt._p_idx,
                                    tt._p_val, p.num_rows)
    assert np.isclose(float(kl_t), float(kl_j), rtol=1e-5)


def test_compute_embedding_chunks_and_kl():
    """The facade's 50-iteration chunks run every iteration once, and the
    KL it tracks is the one the computation reports."""
    p = _joint_p(n=120, k=12)
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 120
    ce = T.ComputeEmbedding(es, device="cpu")
    emb = ce.compute_tsne(T.SparseRows(p.indices, p.values, p.num_rows,
                                         device="cpu"),
                          track_kl=True)
    assert emb.shape == (120, 2) and np.all(np.isfinite(emb))
    assert np.isfinite(ce.last_kl) and ce.last_kl > 0


def test_unported_tiers_raise(monkeypatch):
    """A kNN graph is taken; above 32768 points the default tier is the
    grid, SPH_TSNE_GRID=0 takes the exact tier, and compute_umap runs (the
    grid tier and UMAP raised until they were ported).  The u16-packed
    gathers and the UMAP edge-list tier, which raised too, run since they
    were ported: the grid tier packs by default, the exact tier when
    SPH_TSNE_ATTR_PACKED=1, and SPH_UMAP_PACKED=1 packs the rows tier."""
    for name in ("SPH_TSNE_GRID", "SPH_TSNE_DENSE_P", "SPH_TSNE_GRID_MIN",
                 "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_ATTR_PACKED",
                 "SPH_UMAP_EDGE_PATH", "SPH_UMAP_PACKED"):
        monkeypatch.delenv(name, raising=False)
    tt = ttsne.TsneComputation(device="cpu")
    tt.set_neighbor_graph(np.array([[0, 1], [1, 0], [2, 1], [3, 2]],
                                   np.int32),
                          np.array([[0, 1], [0, 1], [0, 2], [0, 1]],
                                   np.float32))
    assert tt._n == 4
    big = T.SparseRows(np.zeros((ttsne.DENSE_P_MAX + 1, 1), np.int64),
                       np.ones((ttsne.DENSE_P_MAX + 1, 1), np.float32),
                       ttsne.DENSE_P_MAX + 1, device="cpu")
    tt.set_probability_distribution(big)
    tt._init_gradient_descent()
    assert tt.tier == "grid" and tt.attr_packed
    monkeypatch.setenv("SPH_TSNE_GRID", "0")
    tt._init_gradient_descent()
    assert tt.tier == "exact" and not tt.attr_packed
    monkeypatch.setenv("SPH_TSNE_ATTR_PACKED", "1")
    tt._init_gradient_descent()
    assert tt.tier == "exact" and tt.attr_packed
    attr = ttsne.attractive_forces(tt._y, tt._p_idx32, tt._p_val,
                                   packed=True)
    assert attr.shape == tt._y.shape and bool(torch.isfinite(attr).all())
    p = _joint_p(n=40, k=6)
    small = T.SparseRows(p.indices, p.values, 40, device="cpu")
    es = T.ComputeEmbeddingSettings()
    es.umap.num_epochs = 5
    assert T.ComputeEmbedding(es, device="cpu").compute_umap(small).shape == (
        40, 2)
    monkeypatch.setenv("SPH_UMAP_EDGE_PATH", "1")
    ce = T.ComputeEmbedding(es, device="cpu")
    assert ce.compute_umap(small).shape == (40, 2)
    assert ce.last_computation.tier == "edges"
    monkeypatch.delenv("SPH_UMAP_EDGE_PATH")
    monkeypatch.setenv("SPH_UMAP_PACKED", "1")
    monkeypatch.setenv("SPH_UMAP_DENSE_MAX", "10")
    ce = T.ComputeEmbedding(es, device="cpu")
    emb = ce.compute_umap(small)
    assert ce.last_computation.tier == "rows" and ce.last_computation.packed
    assert emb.shape == (40, 2) and np.all(np.isfinite(emb))
    monkeypatch.delenv("SPH_UMAP_PACKED")
    monkeypatch.delenv("SPH_UMAP_DENSE_MAX")
