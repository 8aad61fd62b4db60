"""EUCLID_CENTROID in the PyTorch port against the JAX package on the CPU:
the sampling of represented points, the Hausdorff pair metric, the exact
Hausdorff kNN, both stages through ComputeHierarchy, the embedding warm
starts, and the slice end to end.

Tolerances:
- ``sample_represented``, the exact Hausdorff kNN, the levels, the
  components and every P are bit-equal (the kNN's 2-D product sums as
  torch's CPU matmul does: one chain of fused multiply-adds).
- The Hausdorff pair metric: XLA-CPU's batched dot of the JAX package's
  per-pair [S, D] x [D, S] products does not sum in that order, so each
  squared distance is held to the float32 band of the expansion,
  sqrt(D) eps (|x|^2 + |y|^2), at the largest squared norms among the
  pair's samples (chip_smoke.knn_exactness's band).
- The slice end to end: the level-1 KL after 1000 iterations within 1 %
  (t-SNE trajectories part within a few steps; SKILL.md's rule to compare
  KLs after about 1000 iterations).
"""

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.models import compute_embedding as jce
from sph_tpu.ops import component_knn as jck
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import similarities as jsim
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch.ops import component_knn as tck
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import similarities as tsim
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene

from test_torch_knn_ivf import KmeansTape

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def quiet_one_thread():
    jset_level("WARNING")
    set_level("WARNING")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sets(n, c, d, seed):
    """n points in d dims (scale 3), grouped into c components of uneven
    size (every component has at least one point): data, the represented
    lists as Hierarchy.represented_points gives them."""
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    comp = np.concatenate([np.arange(c), rng.integers(0, c // 4, n - c)])
    order = np.argsort(comp, kind="stable")
    counts = np.bincount(comp, minlength=c)
    return data, np.split(order, np.cumsum(counts)[:-1])


@pytest.mark.parametrize("samples", [1, 6, 40])
def test_sample_represented_draws_the_same_numbers(samples):
    """Sets at most `samples` long are taken whole, larger ones drawn with
    the JAX package's rng.choice calls, in edge order."""
    _, reps = _sets(2000, 120, 4, seed=1)
    sizes = np.array([len(r) for r in reps])
    assert sizes.max() > samples
    ids = np.random.default_rng(2).integers(0, 120, 700)
    got = tsim.sample_represented(reps, ids, samples, seed=9)
    assert np.array_equal(got, jsim.sample_represented(reps, ids, samples,
                                                       seed=9))
    assert got.dtype == np.int64 and got.shape == (700, samples)
    assert tsim.sample_represented(reps, ids[:0], samples, 9).shape == (
        0, samples)


def _band_check(data, ra, rb, got, want):
    """Each squared Hausdorff distance within the float32 band of the
    expansion at the pair's largest squared norms."""
    sq = (data.astype(np.float64) ** 2).sum(1)
    top = np.maximum(np.where(ra >= 0, sq[np.maximum(ra, 0)], 0).max(1),
                     np.where(rb >= 0, sq[np.maximum(rb, 0)], 0).max(1))
    band = np.sqrt(data.shape[1]) * EPS * 2 * top
    gap = np.abs(got.astype(np.float64) ** 2 - want.astype(np.float64) ** 2)
    assert np.all(gap <= band)


@pytest.mark.parametrize("dim", [16, 224])
def test_hausdorff_point_set_distance_within_the_band(dim):
    """E = 1000 pairs (not a multiple of the JAX package's chunk of 32 nor
    of the port's, forced small), with pads, whole and drawn sets, and ten
    sets paired with themselves (near 0: the expansion's residue); and
    E = 0."""
    data, reps = _sets(1500, 100, dim, seed=dim)
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 100, 1000), rng.integers(0, 100, 1000)
    ra = jsim.sample_represented(reps, a, 12, seed=4)
    rb = jsim.sample_represented(reps, b, 12, seed=5)
    rb[:10] = ra[:10]
    assert (ra < 0).any() and (rb < 0).any()
    want = jsim.hausdorff_point_set_distance(data, ra, rb)
    budget = 4 * 77 * (2 * 12 * dim + 2 * 12 * 12)      # 77 pairs a chunk
    assert tsim.hausdorff_chunk(12, dim, budget) == 77
    got = tsim.hausdorff_point_set_distance(data, ra, rb, device="cpu",
                                            memory_budget=budget)
    assert got.dtype == np.float32 and got.shape == (1000,)
    _band_check(data, ra, rb, got, want)
    assert np.array_equal(got, tsim.hausdorff_point_set_distance(
        data, ra, rb, device="cpu"))
    assert np.all(got[:10] < 1e-2 * np.abs(got).max())
    empty = tsim.hausdorff_point_set_distance(data, ra[:0], rb[:0],
                                              device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.float32


def test_component_hausdorff_gathers_the_pairs_sets():
    data, reps = _sets(800, 60, 16, seed=7)
    rep = jsim.sample_represented(reps, np.arange(60), 10, seed=1)
    rng = np.random.default_rng(8)
    a, b = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    assert np.array_equal(
        tsim.component_hausdorff(data, rep, a, b, device="cpu"),
        tsim.hausdorff_point_set_distance(data, rep[a], rep[b],
                                          device="cpu"))


@pytest.mark.parametrize("dim,samples", [(16, 8), (224, 20)])
def test_knn_hausdorff_equal(dim, samples):
    """ids and distances equal to the JAX package's, whole and with the
    column components blocked by a small budget."""
    data, reps = _sets(2000, 150, dim, seed=dim + samples)
    rep = jsim.sample_represented(reps, np.arange(150), samples, seed=2)
    ij, dj = jck.knn_hausdorff(data, rep, 12)
    it, dt = tck.knn_hausdorff(data, rep, 12, device="cpu")
    assert np.array_equal(it, ij) and np.array_equal(dt, dj)
    budget = 8 * 150 * samples * samples * 40     # 40 columns a tile
    assert tck.hausdorff_blocks(150, samples, budget)[1] == 40
    ib, db = tck.knn_hausdorff(data, rep, 12, device="cpu",
                               memory_budget=budget)
    assert np.array_equal(ib, ij) and np.array_equal(db, dj)
    assert np.all(it[:, 0] == np.arange(150)) and np.all(dt[:, 0] == 0)


def _euclid_hierarchy(P, samples, side=(20, 16), **kw):
    """EUCLID_CENTROID in both stages on a small Salinas-like scene
    (create_hyperspectral_scene(20, 16, 12, seed=13)), with the settings of
    chip_smoke's salinas_euclid phase but k = 11."""
    import chip_smoke
    rows, cols = side
    img = create_hyperspectral_scene(rows, cols, 12, seed=13)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.NONE)
    ihs, lss, rws, nns = chip_smoke.salinas_settings(P)
    ihs.num_geodesic_samples = samples
    lss.ks = [11]
    nns.num_nearest_neighbors = 11
    return P.ComputeHierarchy(**kw).init(data, rows, cols, ihs=ihs, lss=lss,
                                         rws=rws, nns=nns)


@pytest.mark.parametrize("samples", [0, 8])
def test_image_hierarchy_levels_and_components_equal(samples):
    chs = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        ch = _euclid_hierarchy(P, samples, **kw)
        ch.compute_knn_graph()
        ch.compute_image_hierarchy()
        chs.append(ch.image_hierarchy.hierarchy)
    hj, ht = chs
    assert ht.num_components == hj.num_components
    assert len(hj.num_components) >= 4
    for a, b in zip(hj.pixel_components, ht.pixel_components):
        assert np.array_equal(a, b)


def _prob_dists_equal(jch, tch, levels):
    for level in levels:
        if level > 0:
            gj = jch.level_similarities.distance_graphs[level]
            gt = tch.level_similarities.distance_graphs[level]
            assert np.array_equal(gt[0], gj[0])
            assert np.array_equal(gt[1], gj[1])
        pj = jch.level_similarities.get_prob_dist(level).to_dense()
        pt = tch.level_similarities.get_prob_dist(level).to_dense()
        assert np.array_equal(pt, pj)


def test_level_similarities_exact_tier_equal():
    jch = _euclid_hierarchy(J, 8).compute()
    tch = _euclid_hierarchy(T, 8, device="cpu").compute()
    levels = jch.image_hierarchy.hierarchy.num_components
    assert tch.image_hierarchy.hierarchy.num_components == levels
    assert tch.level_similarities.knn_tiers == [None] + ["exact"] * (
        len(levels) - 1)
    _prob_dists_equal(jch, tch, range(len(levels)))


def test_level_similarities_approximate_tier_equal(monkeypatch):
    """SPH_APPROX_KNN_THRESHOLD at 40: levels above 40 components take the
    approximate tier (centroid sketches, IVF candidates, the Hausdorff pair
    metric), with the JAX package's clustering replayed.  The pair metric's
    values sit within the float32 band of the JAX package's (see the module
    doc), so level 1's distances are held to it slot by slot, and its ids
    may differ only where that moves a near-tie: at least 95 % of the slots
    hold the same id.  The exact levels' graphs and P are equal."""
    monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "40")
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    jch = _euclid_hierarchy(J, 8).compute()
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    tch = _euclid_hierarchy(T, 8, device="cpu").compute()
    assert tape.consumed() and len(tape.calls) >= 1
    levels = jch.image_hierarchy.hierarchy.num_components
    tiers = tch.level_similarities.knn_tiers
    assert tiers[1] == "approximate"
    for level in range(1, len(levels)):
        assert tiers[level] == ("approximate" if levels[level] > 40
                                else "exact")
    rep = tch.level_similarities._rep_samples(1)
    assert np.array_equal(rep, jch.level_similarities._rep_samples(1))
    ij, dj = jch.level_similarities.distance_graphs[1]
    it, dt = tch.level_similarities.distance_graphs[1]
    assert np.array_equal(it >= 0, ij >= 0)
    live = it >= 0
    rows = np.broadcast_to(np.arange(it.shape[0])[:, None], it.shape)[live]
    _band_check(tch.image_hierarchy._data, rep[rows], rep[it[live]],
                dt[live], dj[live])
    assert np.mean(it[live] == ij[live]) >= 0.95
    _prob_dists_equal(jch, tch, range(2, len(levels)))


def test_embedding_warm_starts_equal():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((500, 2)).astype(np.float32)
    parents = rng.integers(0, 70, 500)
    parents[:70] = np.arange(70)
    got = T.average_position_of_children(emb, parents)
    assert got.dtype == np.float32
    assert np.array_equal(got, jce.average_position_of_children(emb,
                                                                parents))
    assert np.array_equal(T.average_position_of_children(emb, parents, 80),
                          jce.average_position_of_children(emb, parents, 80))
    assert np.array_equal(T.broadcast_parent_positions(got, parents),
                          jce.broadcast_parent_positions(got, parents))
    assert {"average_position_of_children",
            "broadcast_parent_positions"} <= set(T.__all__)


def test_slice_end_to_end_kl_after_1000_iterations():
    """Both stages, then 1000 t-SNE iterations of level 1 from the same
    random disk, in both packages: level-1 KLs within 1 %."""
    kls = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        ch = _euclid_hierarchy(P, 8, side=(28, 24), **kw).compute()
        es = P.ComputeEmbeddingSettings()
        es.tsne.num_iterations = 1000
        ce = P.ComputeEmbedding(es, **kw)
        emb = ce.compute_tsne(ch.level_similarities.get_prob_dist(1),
                              track_kl=True)
        assert np.all(np.isfinite(emb))
        kls.append(float(ce.last_kl))
    assert abs(kls[1] - kls[0]) <= 0.01 * kls[0]
