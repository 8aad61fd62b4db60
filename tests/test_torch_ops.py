"""Op-level parity of the PyTorch port against the JAX package on the CPU.

Each test makes its inputs with numpy from a seed, runs the sph_tpu function
on JAX-CPU and its sph_tpu_torch counterpart on device="cpu", and compares:
threefry bits, float32 sums/exp/log, exact kNN, Gaussian rows, random walks,
Bhattacharyya pairs, pairwise similarities and the t-SNE symmetrization.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sph_tpu as J
import sph_tpu_torch as T
from sph_tpu.ops import distributions as jdist
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import sparse as jsparse
from sph_tpu.ops import walks as jwalks
from sph_tpu_torch.ops import distributions as tdist
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import numerics, rng
from sph_tpu_torch.ops import sparse as tsparse
from sph_tpu_torch.ops import walks as twalks
from test_torch_reference_native import use_reference_native

use_reference_native()

CPU = torch.device("cpu")


def _dense(sr):
    return sr.to_dense()


def _assert_same_rows(a, b, atol):
    """Same support (non-zero pattern) and values within atol."""
    da, db = _dense(a), _dense(b)
    assert da.shape == db.shape
    assert np.array_equal(da != 0, db != 0)
    assert np.abs(da - db).max() <= atol


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 + 5])
def test_threefry_uniform_bit_exact(seed):
    for step in (0, 1, 9):
        key = jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), step)
        key_t = rng.fold_in(rng.prng_key(seed), step)
        assert tuple(int(v) for v in np.asarray(key)) == key_t
        for n in (1, 5, 1000, 4097):
            u_j = np.asarray(jax.random.uniform(key, (n,)))
            u_t = rng.uniform(key_t, n, CPU).numpy()
            assert np.array_equal(u_j.view(np.uint32), u_t.view(np.uint32))


def test_threefry_raw_bits_bit_exact():
    key = jax.random.PRNGKey(jnp.uint32(42))
    bits_j = np.asarray(jax.random.bits(key, (777,), jnp.uint32))
    bits_t = rng.random_bits(rng.prng_key(42), 777, CPU).numpy()
    assert np.array_equal(bits_j.astype(np.int64), bits_t)


# ---------------------------------------------------------------------------
# float32 numerics in XLA-CPU order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [5, 32, 33, 200, 1000, 5000])
def test_row_sum_and_cumsum_bit_exact(width):
    x = np.random.default_rng(width).random((16, width), dtype=np.float32)
    assert np.array_equal(np.asarray(jnp.sum(jnp.asarray(x), axis=1)),
                          numerics.row_sum(torch.from_numpy(x)).numpy())
    assert np.array_equal(np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)),
                          numerics.cumsum(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("width", [5, 16, 32, 33, 64, 200])
def test_row_dot_bit_exact(width):
    """A sum of products inside one jitted fusion: fused multiply-adds left
    to right up to 32 terms, the rounded products' windowed sum above."""
    r = np.random.default_rng(width)
    a = r.random((4096, width), dtype=np.float32)
    b = r.random((4096, width), dtype=np.float32) * np.float32(0.1)
    ref = np.asarray(jax.jit(lambda x, y: jnp.sum(x * y, axis=1))(a, b))
    got = numerics.row_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(ref, got)


def test_exp_log_sqrt_bit_exact():
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(-100, 90, 20000), r.uniform(-5, 5, 20000),
                        [0.0, -0.0, np.inf, -np.inf]]).astype(np.float32)
    pos = np.concatenate([r.uniform(1e-3, 10, 20000),
                          np.exp(r.uniform(-80, 80, 20000)),
                          [0.0, 1.0, np.inf, 1e-40]]).astype(np.float32)
    for jf, tf, arg in ((jnp.exp, numerics.exp, x),
                        (jnp.log, numerics.log, pos),
                        (jnp.sqrt, numerics.sqrt, pos)):
        a = np.asarray(jf(jnp.asarray(arg)))
        b = tf(torch.from_numpy(arg)).numpy()
        assert np.array_equal(a, b, equal_nan=True)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

def _knn_data():
    r = np.random.default_rng(3)
    data = r.random((300, 24), dtype=np.float32)
    # duplicated points give exactly tied distances
    data[100:110] = data[0]
    data[200:205] = data[50]
    return data


@pytest.mark.parametrize("metric", [J.KnnMetric.L2, J.KnnMetric.COSINE])
def test_knn_bruteforce_identical_with_ties(metric):
    data = _knn_data()
    ij, dj = jknn.knn_bruteforce(data, 16, metric)
    it, dt = tknn.knn_bruteforce(data, 16, T.KnnMetric(metric.value),
                                 device=CPU)
    assert np.array_equal(ij, it)
    assert np.allclose(dt, dj, rtol=1e-6, atol=0)
    # the duplicated block really ties: all ten copies in each other's rows
    assert set(range(100, 110)) <= set(it[0].tolist())


def test_knn_exact_rows_matches_bruteforce():
    data = _knn_data()
    rows = np.array([0, 5, 101, 299])
    ij, dj = jknn.knn_exact_rows(data, rows, 12)
    it, dt = tknn.knn_exact_rows(data, rows, 12, device=CPU)
    assert np.array_equal(ij, it)
    assert np.allclose(dt, dj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("index", ["ivf_flat", "hnsw", "hnswsq",
                                   "hnsw_ivfpq"])
def test_compute_knn_dispatches_approximate_index(index):
    """Each approximate index runs its IVF tier at the default 100 clusters
    and 10 probes (flat for IVF_FLAT and HNSW, SQ8 for HNSWSQ, PQ with a
    512-wide shortlist for HNSW_IVFPQ) and returns a complete graph, self
    first; tests/test_torch_knn_ivf.py holds each tier against the JAX
    package."""
    stats = {}
    idx, dist = tknn.compute_knn(_knn_data(), 5, T.KnnIndex(index),
                                 device=CPU, stats=stats)
    assert idx.shape == (300, 5) and np.all(idx >= 0)
    assert np.all(idx[:, 0] == np.arange(300))
    assert np.all(np.diff(dist, axis=1) >= 0)
    assert stats["nlist"] == 100 and stats["nprobe"] == 10
    assert stats["shortlist"] == (512 if index == "hnsw_ivfpq" else 5)
    assert not stats["exact_fallback"]


# ---------------------------------------------------------------------------
# Gaussian rows (the perplexity beta search)
# ---------------------------------------------------------------------------

def _graph(seed=4, n=400, k=40):
    """A symmetrized kNN graph on clustered data: tight clusters make the
    beta search run up against its float32 tolerance."""
    r = np.random.default_rng(seed)
    centers = r.random((6, 30), dtype=np.float32)
    data = (centers[r.integers(0, 6, n)]
            + 0.02 * r.standard_normal((n, 30))).astype(np.float32)
    idx, dist = jknn.knn_bruteforce(data, k)
    g = J.ops.graph.symmetrize_graph(J.KnnGraph(idx, dist))
    return g


@pytest.mark.parametrize("perplexity", [-1.0, 10.0])
def test_gaussian_rows_match(perplexity):
    g = _graph()
    dist = np.where(g.mask, g.distances, 0.0).astype(np.float32)
    pj = jdist.distance_rows_to_probabilities(
        dist, g.mask, J.NormalizationScheme.TSNE, perplexity, True)
    pt = tdist.distance_rows_to_probabilities(
        torch.from_numpy(dist), torch.from_numpy(g.mask),
        T.NormalizationScheme.TSNE, perplexity, True).numpy()
    assert np.abs(pj - pt).max() <= 1e-6
    live = pt.sum(1) > 0
    assert np.allclose(pt[live].sum(1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# random walks
# ---------------------------------------------------------------------------

def _probdist():
    g = _graph(seed=5, n=300, k=20)
    dist = np.where(g.mask, g.distances, 0.0).astype(np.float32)
    p = np.array(jdist.distance_rows_to_probabilities(
        dist, g.mask, J.NormalizationScheme.TSNE, -1.0, True))
    idx = np.where(g.mask, g.indices, -1).astype(np.int32)
    return idx, p


@pytest.mark.parametrize("weighting", ["normal", "constant", "first_visit"])
def test_random_walks_match(weighting):
    idx, p = _probdist()
    n = idx.shape[0]
    visited_j = np.asarray(jwalks._simulate(jnp.asarray(idx), jnp.asarray(p),
                                            jnp.uint32(3), 10, 6))
    visited_t = twalks.simulate(torch.from_numpy(idx.astype(np.int64)),
                                torch.from_numpy(p), 3, 10, 6).numpy()
    assert np.array_equal(visited_j, visited_t)

    kw = dict(num_random_walks=10, single_walk_length=6, random_seed=3,
              importance_weighting=J.ImportanceWeighting(weighting))
    wj = jwalks.do_random_walks(J.SparseRows(idx, p, n),
                                J.RandomWalkSettings(**kw))
    kw["importance_weighting"] = T.ImportanceWeighting(weighting)
    wt = twalks.do_random_walks(T.SparseRows(idx, p, n, device=CPU),
                                T.RandomWalkSettings(**kw))
    # visit sums differ from XLA's only in the order of equal-id visits
    # (XLA sorts them with an unstable sort), a few float32 ulps
    _assert_same_rows(wj, wt, atol=1e-6)


# ---------------------------------------------------------------------------
# sparse rows: Bhattacharyya, pairwise similarities, symmetrization
# ---------------------------------------------------------------------------

def _walk_rows(n=200, seed=6):
    r = np.random.default_rng(seed)
    width = 24
    idx = np.sort(np.stack([r.choice(n, width, replace=False)
                            for _ in range(n)]), 1).astype(np.int32)
    val = r.random((n, width), dtype=np.float32)
    val[:, ::5] = 0.0                       # some explicit zeros
    idx[::7, -4:] = -1                      # ragged rows
    val[::7, -4:] = 0.0
    val /= val.sum(1, keepdims=True)
    return idx, val


def test_bhattacharyya_pairs_match():
    idx, val = _walk_rows()
    n = idx.shape[0]
    r = np.random.default_rng(7)
    a, b = r.integers(0, n, 500), r.integers(0, n, 500)
    bj = jsparse.bhattacharyya_pairs(J.SparseRows(idx, val, n), a, b)
    bt = tsparse.bhattacharyya_pairs(T.SparseRows(idx, val, n, device=CPU),
                                     a, b)
    assert np.array_equal(bj > 0, bt > 0)
    assert np.abs(bj - bt).max() <= 1e-6


@pytest.mark.parametrize("sizes", [False, True])
def test_pairwise_similarities_match(sizes):
    idx, val = _walk_rows()
    n = idx.shape[0]
    comp = np.random.default_rng(8).integers(1, 9, n) if sizes else None
    pj = jsparse.pairwise_similarities(J.SparseRows(idx, val, n), 30,
                                       component_sizes=comp)
    pt = tsparse.pairwise_similarities(
        T.SparseRows(idx, val, n, device=CPU), 30, component_sizes=comp)
    _assert_same_rows(pj, pt, atol=1e-6)


def test_symmetrize_tsne_matches():
    idx, val = _walk_rows(seed=9)
    n = idx.shape[0]
    pj = jsparse.symmetrize_tsne(J.SparseRows(idx, val, n))
    pt = tsparse.symmetrize_tsne(T.SparseRows(idx, val, n, device=CPU))
    _assert_same_rows(pj, pt, atol=1e-6)
    rows = pt.idx
    assert bool((rows[:, 1:] > rows[:, :-1])[rows[:, 1:] >= 0].all())


@pytest.fixture
def jax_native_merge(monkeypatch):
    """The JAX package's C++ merge, whatever this worker's loader did.
    sph_tpu/native/__init__.py builds straight into its library file, so a
    worker whose first load met another worker's half-written build keeps
    get_lib() None for the rest of the run, and merge_rows_by_parents takes
    its numpy fallback, which is not bit-identical to the C++ sums.  The
    build has finished by now: load again (both module flags restored
    afterwards)."""
    from sph_tpu import native as jnative
    if jnative.get_lib() is None:
        monkeypatch.delenv("SPH_TPU_NO_NATIVE", raising=False)
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.get_lib() is not None, (
            "the JAX package's native library does not load")


def test_merge_rows_by_parents_bit_exact(jax_native_merge):
    idx, val = _walk_rows(seed=10)
    n = idx.shape[0]
    parents = np.random.default_rng(11).integers(0, 40, n)
    parents[:40] = np.arange(40)
    for norm in (False, True):
        mj = jsparse.merge_rows_by_parents(J.SparseRows(idx, val, n), parents,
                                           40, norm=norm)
        mt = tsparse.merge_rows_by_parents(
            T.SparseRows(idx, val, n, device=CPU), parents, 40, norm=norm)
        assert np.array_equal(_dense(mj), _dense(mt))


def test_row_cleanups_match():
    idx, val = _walk_rows(seed=12)
    n = idx.shape[0]
    sj, st = J.SparseRows(idx, val, n), T.SparseRows(idx, val, n, device=CPU)
    pairs = [
        (jsparse.remove_diagonal(sj), tsparse.remove_diagonal(st)),
        (jsparse.prune_values(sj, 0.04), tsparse.prune_values(st, 0.04)),
        (jsparse.topk_rows(sj, 7), tsparse.topk_rows(st, 7)),
        (jsparse.drop_zero_entries(sj), tsparse.drop_zero_entries(st)),
        (jsparse.normalize_rows(sj), tsparse.normalize_rows(st)),
    ]
    for a, b in pairs:
        _assert_same_rows(a, b, atol=1e-7)
