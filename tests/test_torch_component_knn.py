"""The approximate component kNN of the PyTorch port against the JAX package
on the CPU: the sketch, the IVF candidate table and the NEIGH_OVERLAP pair
metric on the candidates (sph_tpu/ops/component_knn.py:317-432), and the
LevelSimilarities rule that takes it above SPH_APPROX_KNN_THRESHOLD
components unless exact_knn is set.

As in tests/test_torch_knn_ivf.py, the k-means is injected: the JAX
package's ``_kmeans`` results are recorded and the port's ``_kmeans``
replays them.  With the same clustering every result below is equal.
"""

import functools

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.ops import component_knn as jck
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import similarities as jsim
import sph_tpu_torch as T
from sph_tpu_torch.ops import component_knn as tck
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import similarities as tsim
from sph_tpu_torch.utils.testdata import create_checker_image

from test_torch_knn_ivf import KmeansTape

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unions():
    """Union neighbourhoods of 800 components over 3000 pixels, drawn
    around 40 shared bases so that overlaps cluster: (knn ids, component
    of each pixel)."""
    r = np.random.default_rng(0)
    n, c, k = 3000, 800, 12
    comp = np.concatenate([np.arange(c), r.integers(0, c, n - c)])
    base = r.integers(0, n, (40, k))
    knn = (base[comp % 40] + r.integers(0, 30, (n, k))) % n
    return knn.astype(np.int32), comp, c


def _both(unions):
    knn, comp, c = unions
    return (jsim.build_union_neighborhoods(knn, comp, c),
            tsim.build_union_neighborhoods(knn, comp, c, device=CPU))


def test_sketch_and_pair_metric_equal(unions):
    uj, ut = _both(unions)
    fj = jck.project_sparse_rows(uj, seed=3)
    ft = tck.project_sparse_rows(ut, seed=3)
    assert np.array_equal(fj, ft)
    r = np.random.default_rng(1)
    a, b = r.integers(0, uj.num_rows, 5000), r.integers(0, uj.num_rows, 5000)
    assert np.array_equal(jsim.neighbor_overlap_distance(uj, a, b),
                          tsim.neighbor_overlap_distance(ut, a, b))


@pytest.mark.parametrize("k", [8, 31])
def test_approx_pair_metric_knn_equal_with_injected_clustering(
        unions, monkeypatch, k):
    uj, ut = _both(unions)
    feats = jck.project_sparse_rows(uj, seed=1)
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    cand_j = jck.ivf_candidate_table(feats, seed=1)
    ij, dj = jck.approx_pair_metric_knn(
        lambda a, b: jsim.neighbor_overlap_distance(uj, a, b), feats, k,
        seed=1)
    assert len(tape.calls) == 2
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    cand_t = tck.ivf_candidate_table(feats, seed=1, device=CPU)
    it, dt = tck.approx_pair_metric_knn(
        lambda a, b: tsim.neighbor_overlap_distance(ut, a, b), feats, k,
        seed=1, device=CPU)
    assert tape.consumed()
    assert np.array_equal(cand_t, cand_j)
    assert np.array_equal(it, ij) and np.array_equal(dt, dj)
    assert np.all(it[:, 0] == np.arange(uj.num_rows)) and np.all(dt[:, 0] == 0)


def test_approx_pair_metric_knn_own_clustering(unions):
    """Without injection: every row's neighbours are real components at
    their exact pair distances, ascending, and the recall against the
    exact kNN (counted by distance, chip_smoke.overlap_recall) within 0.01
    of the JAX package's."""
    import chip_smoke
    uj, ut = _both(unions)
    feats = tck.project_sparse_rows(ut, seed=2)
    k = 16
    it, dt = tck.approx_pair_metric_knn(
        lambda a, b: tsim.neighbor_overlap_distance(ut, a, b), feats, k,
        seed=2, device=CPU)
    ij, dj = jck.approx_pair_metric_knn(
        lambda a, b: jsim.neighbor_overlap_distance(uj, a, b), feats, k,
        seed=2)
    assert np.all(np.diff(dt, axis=1) >= 0)
    live = it >= 0
    rows = np.broadcast_to(np.arange(it.shape[0])[:, None], it.shape)
    assert np.array_equal(dt[live], tsim.neighbor_overlap_distance(
        ut, rows[live], it[live]))
    _, de = tck.knn_neighbor_overlap(ut, k)
    kth = de[:, k - 1]
    assert abs(chip_smoke.overlap_recall(it, dt, kth)
               - chip_smoke.overlap_recall(ij, dj, kth)) <= 0.01


def _pipeline(P, exact_knn, **kw):
    """A 10 x 10 checker through ComputeHierarchy on default NEIGH_OVERLAP
    settings with stage 1 on IVF_FLAT (the JAX package's own pipeline test
    of the approximate tier, test_approx_knn.py, with ks=[13])."""
    img = create_checker_image(10, 10, channels=4, block=5, noise=0.03)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    ch = P.ComputeHierarchy(**kw).init(
        data, 10, 10,
        ihs=P.ImageHierarchySettings(merge_multiple=False,
                                     use_percentile=False),
        lss=P.LevelSimilaritiesSettings(ks=[13], exact_knn=exact_knn),
        rws=P.RandomWalkSettings(num_random_walks=10, single_walk_length=5),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=13,
                                       knn_index=P.KnnIndex.IVF_FLAT))
    return ch.compute()


@pytest.mark.parametrize("exact_knn", [False, True])
def test_level_similarities_take_the_approximate_tier_above_the_threshold(
        monkeypatch, exact_knn):
    """SPH_APPROX_KNN_THRESHOLD lowered to 20: with default settings every
    level above 20 components takes the approximate component kNN in both
    packages, exact_knn=True the exact one; with the JAX package's
    clustering injected (stage 1's IVF at 8 clusters and 3 probes in both,
    and each approximate level's candidate table), the levels and every
    level's distance graph are equal."""
    monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "20")
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    monkeypatch.setattr(jknn, "knn_ivf", functools.partial(
        jknn.knn_ivf, nlist=8, nprobe=3))
    jch = _pipeline(J, exact_knn)
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    monkeypatch.setattr(tknn, "knn_ivf", functools.partial(
        tknn.knn_ivf, nlist=8, nprobe=3))
    tch = _pipeline(T, exact_knn, device="cpu")
    assert tape.consumed()
    levels = jch.image_hierarchy.hierarchy.num_components
    assert tch.image_hierarchy.hierarchy.num_components == levels
    tiers = tch.level_similarities.knn_tiers
    assert tiers[0] is None
    for level in range(1, len(levels)):
        want = "exact" if exact_knn or levels[level] <= 20 else "approximate"
        assert tiers[level] == want
        gj = jch.level_similarities.distance_graphs[level]
        gt = tch.level_similarities.distance_graphs[level]
        assert np.array_equal(gt[0], gj[0]) and np.array_equal(gt[1], gj[1])
    assert ("approximate" in tiers) != exact_knn
