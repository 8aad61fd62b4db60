"""The approximate kNN tiers of the PyTorch port (IVF flat, SQ8, PQ) against
the JAX package on the CPU.

The k-means is held with a tolerance: its centroid sums are one-hot matmuls
over thousands of rows, which torch and XLA-CPU sum in different orders.
Everything after it is held by injecting the JAX package's clustering: its
``_kmeans`` is wrapped to record what it returned, and the port's
``_kmeans`` replays those results (after checking that it was handed the
same initial centroids, which holds the numpy draws).  With the same
clustering the flat and SQ8 tiers give the JAX package's ids and
distances bit for bit.  The PQ tier's final distances come from its exact
re-rank, a batched dot that XLA-CPU sums in eight lanes and torch in one,
so they are held to the float32 band of the expansion,
sqrt(D) eps (|q|^2 + |c|^2), the band chip_smoke.py holds the exact tier
to, and its ids may differ only between neighbours whose float64
distances lie within that band of each other (near-ties the summation
order breaks either way).  JAX-CPU sorts every probe segment's tile (about
25 ms a probe step at seg = 256), so the parity runs use 20 clusters and
5 probes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.ops import knn as jknn
import sph_tpu_torch as T
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.utils.testdata import create_clustered_points

CPU = torch.device("cpu")
N, D, K = 3000, 16, 10
IVF = dict(nlist=20, nprobe=5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class KmeansTape:
    """Records the JAX package's _kmeans results and replays them through
    the port's _kmeans, call by call."""

    def __init__(self):
        self.calls = []

    def recorder(self, original):
        def record(data, n_valid, init, nlist, iters, block=65536):
            cents, assign = original(data, n_valid, init, nlist, iters,
                                     block=block)
            self.calls.append((np.asarray(init), np.array(cents),
                               np.array(assign)))
            return cents, assign
        return record

    def replayer(self):
        calls = iter(self.calls)

        def replay(data, n_valid, init, nlist, iters, block=65536):
            want_init, cents, assign = next(calls)
            assert np.array_equal(init.cpu().numpy(), want_init)
            return (torch.as_tensor(cents, device=data.device),
                    torch.as_tensor(assign.astype(np.int64),
                                    device=data.device))
        self.left = calls
        return replay

    def consumed(self) -> bool:
        return next(self.left, None) is None


def assert_pq_matches_up_to_the_band(data, it, dt, ij, dj):
    """The PQ tier's result against the JAX package's: in every slot the
    two neighbours are the same point, or two points whose float64 squared
    distances to the row's point lie within the band of each other (a
    near-tie that the re-rank's summation order may break either way); the
    squared distances in each slot within the band.  The band is
    sqrt(D) eps (|q|^2 + |c|^2) for each of the two neighbours."""
    x = data.astype(np.float64)
    sq = (x * x).sum(1)
    eps = float(np.finfo(np.float32).eps)
    rows = np.arange(data.shape[0])[:, None]

    def exact_d2(idx):
        return ((x[:, None, :] - x[idx]) ** 2).sum(-1)

    band = np.sqrt(data.shape[1]) * eps * (2 * sq[rows] + sq[it] + sq[ij])
    assert np.all(np.abs(exact_d2(it) - exact_d2(ij)) <= band)
    gap = np.abs(dt.astype(np.float64) ** 2 - dj.astype(np.float64) ** 2)
    assert np.all(gap <= band)
    assert np.mean(np.all(it == ij, axis=1)) >= 0.95


@pytest.fixture(scope="module")
def data():
    return create_clustered_points(N, D, seed=0)


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX package's knn_ivf for each codec and COSINE, with its
    clustering recorded."""
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for name, kw in (("flat", {}), ("sq8", {"quantize": True}),
                         ("pq", {"pq": True}),
                         ("cosine", {"metric": J.KnnMetric.COSINE})):
            tape = KmeansTape()
            mp.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
            runs[name] = (jknn.knn_ivf(data, K, **IVF, **kw), tape, kw)
            mp.undo()
    finally:
        mp.undo()
    return runs


def _port_kw(kw):
    return {key: (T.KnnMetric(v.value) if key == "metric" else v)
            for key, v in kw.items()}


def test_kmeans_matches_jax_with_pad_rows():
    """Separated blobs, 3000 rows in blocks of 1024 (72 pad rows): the same
    assignment, centroids within 1e-5 relative, pads assigned nlist."""
    r = np.random.default_rng(4)
    centers = r.standard_normal((12, 8)).astype(np.float32) * 10.0
    x = np.zeros((3072, 8), np.float32)
    x[:3000] = centers[r.integers(0, 12, 3000)] + r.standard_normal(
        (3000, 8)).astype(np.float32)
    init = x[r.choice(3000, 12, replace=False)]
    cj, aj = jknn._kmeans(jnp.asarray(x), jnp.int32(3000), jnp.asarray(init),
                          12, 10, block=1024)
    ct, at = tknn._kmeans(torch.from_numpy(x), 3000, torch.from_numpy(init),
                          12, 10, block=1024)
    cj, aj = np.asarray(cj), np.asarray(aj)
    assert np.array_equal(aj, at.numpy())
    assert np.all(at.numpy()[3000:] == 12)
    assert np.allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5 * np.abs(cj).max())


def test_sq8_reconstruct_bit_equal(data):
    assert np.array_equal(jknn.sq8_reconstruct(data),
                          tknn.sq8_reconstruct(data))


def test_pq_codec_matches_jax():
    """pq_train's codebooks within 1e-5 of the JAX package's from the same
    coarse clustering; pq_encode's codes equal and pq_reconstruct_rows
    bit-equal given the same codebooks.  D = 64 gives subspaces of 4
    dimensions: in subspaces of 1 or 2, 256 centroids over 3000 points sit
    so close that the centroid sums' ulps flip boundary points (37 of 4096
    codebook entries apart at D = 16)."""
    data = create_clustered_points(N, 64, seed=0)
    r = np.random.default_rng(5)
    cents = data[r.choice(N, 20, replace=False)]
    assign = r.integers(0, 20, N)
    cb_j = jknn.pq_train(data, cents, assign, seed=3)
    cb_t = tknn.pq_train(data, cents, assign, seed=3, device=CPU)
    assert cb_t.shape == cb_j.shape == (16, 256, 4)
    assert np.allclose(cb_t, cb_j, rtol=1e-5, atol=1e-5 * np.abs(cb_j).max())
    codes_j = jknn.pq_encode(data, cents, assign, cb_j)
    codes_t = tknn.pq_encode(data, cents, assign, cb_j, device=CPU)
    assert codes_t.dtype == np.uint8 and np.array_equal(codes_t, codes_j)
    assert np.array_equal(
        tknn.pq_reconstruct_rows(codes_j, cents, assign, cb_j, 64,
                                 device=CPU),
        jknn.pq_reconstruct_rows(codes_j, cents, assign, cb_j, 64))


@pytest.mark.parametrize("name", ["flat", "sq8", "pq", "cosine"])
def test_knn_ivf_matches_jax_with_its_clustering(jax_runs, data, name,
                                                 monkeypatch):
    (ij, dj), tape, kw = jax_runs[name]
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    stats = {}
    it, dt = tknn.knn_ivf(data, K, **IVF, **_port_kw(kw), device=CPU,
                          stats=stats)
    assert tape.consumed()
    assert stats["nlist"] == 20 and stats["nprobe"] == 5
    assert stats["seg"] == 256 and stats["segments"] >= 20
    if name == "pq":
        assert_pq_matches_up_to_the_band(data, it, dt, ij, dj)
    else:
        assert np.array_equal(it, ij) and np.array_equal(dt, dj)


def _recall(idx, ref):
    return np.mean([len(np.intersect1d(a, b)) / ref.shape[1]
                    for a, b in zip(idx, ref)])


def test_knn_ivf_own_clustering_recall_matches_jax(jax_runs, data):
    """Without injection the port clusters on its own: its recall against
    the exact kNN within 0.01 of the JAX package's, and at least 99 % of
    the rows identical."""
    (ij, _), _, _ = jax_runs["flat"]
    it, _ = tknn.knn_ivf(data, K, **IVF, device=CPU)
    exact, _ = tknn.knn_bruteforce(data, K, device=CPU)
    assert abs(_recall(it, exact) - _recall(ij, exact)) <= 0.01
    assert np.mean(np.all(it == ij, axis=1)) >= 0.99


def test_knn_ivf_query_rows(jax_runs, data, monkeypatch):
    (ij, dj), tape, _ = jax_runs["flat"]
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    rows = np.array([3, 77, 410, 2999])
    qi, qd = tknn.knn_ivf(data, K, **IVF, query_rows=rows, device=CPU)
    assert np.array_equal(qi, ij[rows]) and np.array_equal(qd, dj[rows])


@pytest.mark.parametrize("index,k,nprobe,path", [
    ("ivf_flat", K, 5, "none"), ("hnsw", K, 5, "none"),
    ("hnswsq", K, 5, "none"), ("hnsw_ivfpq", K, 5, "none"),
    ("ivf_flat", 100, 1, "refill"), ("hnswsq", 100, 1, "refill"),
    ("hnsw_ivfpq", 100, 1, "refill"), ("ivf_flat", 200, 1, "fallback")])
def test_compute_knn_approximate_indexes(data, monkeypatch, index, k, nprobe,
                                         path):
    """compute_knn's dispatch with the JAX package's clustering injected:
    the same ids for every approximate index, including the exact refill
    of rows with fewer than k candidates (on the SQ8 reconstruction for
    HNSWSQ) and the exact fallback above max(1024, n / 4) of them.  Both
    packages' knn_ivf run at 20 clusters and `nprobe` probes (one probe
    leaves 649 rows of this data short of 100 candidates and 1559 short of
    200)."""
    import functools
    ivf = dict(nlist=20, nprobe=nprobe)
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    monkeypatch.setattr(jknn, "knn_ivf",
                        functools.partial(jknn.knn_ivf, **ivf))
    ij, dj = jknn.compute_knn(data, k, J.KnnIndex(index))
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    monkeypatch.setattr(tknn, "knn_ivf",
                        functools.partial(tknn.knn_ivf, **ivf))
    stats = {}
    it, dt = tknn.compute_knn(data, k, T.KnnIndex(index), device=CPU,
                              stats=stats)
    assert tape.consumed()
    assert (stats["refilled_rows"] > 0) == (path == "refill")
    assert stats["refilled_rows"] <= 1024
    assert stats["exact_fallback"] == (path == "fallback")
    assert np.all(it >= 0) and np.all(it[:, 0] == np.arange(N))
    if index == "hnsw_ivfpq":
        assert_pq_matches_up_to_the_band(data, it, dt, ij, dj)
    else:
        assert np.array_equal(it, ij) and np.array_equal(dt, dj)
