"""The walk option space of the PyTorch port against the JAX package on the
CPU: the min merge, the single-overlap distance, the walk kNN (both
metrics, exact and approximate), the walk-length schedule, and whole
hierarchies under every walk handling, NEIGH_WALKS_SINGLE_OVERLAP,
GEO_WALKS and top-k walk rows.

Tolerances: the merges, the single overlap and the schedule are equal bit
for bit (no arithmetic beyond a min, a max, a subtraction and the JAX
package's own sums).  The Bhattacharyya kNN's ids are equal and its
distances within 1e-6: XLA-CPU and torch sum the float32 products in
other orders.  Whole hierarchies: levels, walk lengths and walk ids equal,
walk values and P within 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.models import image_hierarchy as jih
from sph_tpu.ops import component_knn as jck
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import similarities as jsim
from sph_tpu.ops import sparse as jsp
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch.models import image_hierarchy as tih
from sph_tpu_torch.ops import component_knn as tck
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import similarities as tsim
from sph_tpu_torch.ops import sparse as tsp
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene

from test_torch_knn_ivf import KmeansTape
from test_torch_reference_native import use_reference_native

use_reference_native()

CPU = torch.device("cpu")
HANDLINGS = ("merge_rw_new_walks", "merge_rw_new_walks_and_knn",
             "merge_data_new_walks")


@pytest.fixture(autouse=True)
def quiet_one_thread():
    jset_level("WARNING")
    set_level("WARNING")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_rows(c: int, width: int, seed: int, num_cols: int = 0):
    """c rows of up to `width` distinct ascending columns of num_cols (c by
    default), values summing to one: (indices int32, values f32)."""
    r = np.random.default_rng(seed)
    n = num_cols or c
    idx = np.full((c, width), -1, np.int32)
    val = np.zeros((c, width), np.float32)
    for i in range(c):
        m = int(r.integers(1, width + 1))
        idx[i, :m] = np.sort(r.choice(n, m, replace=False))
        v = r.random(m).astype(np.float32)
        val[i, :m] = v / v.sum()
    return idx, val


def both_rows(idx, val, num_cols):
    return (jsp.SparseRows(idx, val, num_cols),
            tsp.SparseRows(idx, val, num_cols, device=CPU))


@pytest.mark.parametrize("cap", [None, 7])
def test_merge_rows_min_by_parents_bit_equal(cap):
    """Distance rows min-merged into 37 parents; with the cap, rows wider
    than 7 keep their 7 smallest values."""
    idx, val = random_rows(300, 24, seed=1)
    val = (val * 10.0).astype(np.float32)
    parents = np.random.default_rng(2).integers(0, 37, 300)
    jr, tr = both_rows(idx, val, 300)
    want = jsp.merge_rows_min_by_parents(jr, parents, 37, max_width=cap)
    got = tsp.merge_rows_min_by_parents(tr, parents, 37, max_width=cap)
    assert got.device == CPU
    w = want.indices.shape[1]
    assert got.width == w
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.values, want.values)
    if cap is not None:
        assert w == cap


def test_remove_diagonal_keeps_single_entries_as_jax():
    """remove_diagonal(keep_single_entry=True) on merged walk rows, the step
    the new-walk handlings take after the merge: rows whose only entry is
    the diagonal keep it."""
    idx, val = random_rows(60, 12, seed=3)
    idx[5] = [5] + [-1] * 11
    val[5] = [1.0] + [0.0] * 11
    idx[6, :2], val[6, :2] = [3, 6], [0.5, 0.5]
    jr, tr = both_rows(idx, val, 60)
    want = jsp.remove_diagonal(jr, keep_single_entry=True)
    got = tsp.remove_diagonal(tr, keep_single_entry=True)
    w = got.width
    assert np.array_equal(got.indices, want.indices[:, :w])
    assert np.array_equal(got.values, want.values[:, :w])
    assert got.indices[5, 0] == 5 and 6 not in got.indices[6]


def test_walks_single_overlap_distance_bit_equal():
    idx, val = random_rows(400, 40, seed=4)
    jr, tr = both_rows(idx, val, 400)
    r = np.random.default_rng(5)
    a, b = r.integers(0, 400, 6000), r.integers(0, 400, 6000)
    want = jsim.walks_single_overlap_distance(jr, a, b)
    got = tsim.walks_single_overlap_distance(tr, a, b)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def scene_walks(level: int = 1):
    """The walk rows of `level` of a 20x16x8 NEIGH_WALKS hierarchy (JAX
    package, MERGE_RW_ONLY): (indices, values)."""
    img = create_hyperspectral_scene(20, 16, 8, seed=3)
    data = J.scale(J.ImageStack.from_array(img).data, J.Scaler.STANDARD)
    ch = J.ComputeHierarchy().init(
        data, 20, 16,
        ihs=J.ImageHierarchySettings(
            component_sim=J.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False, max_dist=0.0, min_reduction=98.0),
        lss=J.LevelSimilaritiesSettings(
            component_sim=J.ComponentSim.NEIGH_WALKS, ks=[16]),
        rws=J.RandomWalkSettings(num_random_walks=20, single_walk_length=8,
                                 random_seed=2),
        nns=J.NearestNeighborsSettings(num_nearest_neighbors=16))
    ch.compute_knn_graph()
    ch.compute_image_hierarchy()
    w = ch.image_hierarchy.hierarchy.random_walks[level]
    return np.asarray(w.indices), np.asarray(w.values)


@pytest.mark.parametrize("single", [False, True],
                         ids=["bhattacharyya", "single_overlap"])
@pytest.mark.parametrize("rows", ["scene_level_1", "random_1000"])
def test_knn_walks_equal(rows, single):
    """Level-1 walks of a 20x16x8 scene (k = 16), and 1000 random rows of
    width 70 (C not a multiple of the JAX package's 256-row block, width
    over 32, k = 37 not a multiple of 16) under a memory budget that
    splits them into several row and column tiles."""
    if rows == "scene_level_1":
        idx, val = scene_walks()
        k, block, budget = 16, 2048, None
    else:
        idx, val = random_rows(1000, 70, seed=1000)
        k, block, budget = 37, 256, 1 << 20
    c = idx.shape[0]
    jr, tr = both_rows(idx, val, c)
    ij, dj = jck.knn_walks(jr, k, single_overlap=single, block=block)
    kw = {} if budget is None else {"memory_budget": budget}
    it, dt = tck.knn_walks(tr, k, single_overlap=single, **kw)
    if budget is not None:
        assert tck.walks_blocks(c, budget)[0] < c
    assert it.dtype == np.int32 and dt.dtype == np.float32
    assert np.array_equal(it, ij)
    assert np.all(it[:, 0] == np.arange(c)) and np.all(dt[:, 0] == 0)
    if single:
        assert np.array_equal(dt, dj)
    else:
        assert np.abs(dt - dj).max() <= 1e-6


@pytest.mark.parametrize("fault", ["unsorted", "duplicate", "pad_first",
                                   "out_of_range"])
def test_knn_walks_raises_on_broken_rows(fault):
    """The densify trusts ascending, unique columns with pads last; rows
    that break it raise instead of giving a wrong graph."""
    idx, val = random_rows(50, 8, seed=6)
    idx[7, :3] = {"unsorted": [4, 2, 9], "duplicate": [2, 2, 9],
                  "pad_first": [-1, 2, 9], "out_of_range": [2, 9, 50]}[fault]
    val[7, :3] = 0.25
    rows = tsp.SparseRows(idx, val, 50, device=CPU)
    with pytest.raises(ValueError, match="knn_walks"):
        tck.knn_walks(rows, 5)


REDUCTIONS = (100.0, 97.5, 62.0, 40.0, 23.1, 10.0, 0.4)


@pytest.mark.parametrize("policy", [p.value for p in T.RandomWalkReduction])
@pytest.mark.parametrize("handling", ["merge_rw_new_walks", "merge_rw_only"])
def test_adapt_walk_length_equal(policy, handling):
    """The seven policies on a fixed list of reduction rates, from length
    15 with a minimum of 3: each level's length equal to the JAX
    package's; MERGE_RW_ONLY keeps no schedule."""
    out = []
    for P, mod in ((J, jih), (T, tih)):
        ihs = P.ImageHierarchySettings(
            component_sim=P.ComponentSim.NEIGH_WALKS,
            rw_handling=P.RandomWalkHandling(handling),
            rw_reduction=P.RandomWalkReduction(policy))
        rws = P.RandomWalkSettings(single_walk_length=15,
                                   minimum_single_walk_length=3)
        ih = mod.ImageHierarchy.__new__(mod.ImageHierarchy)
        ih._ihs, ih._rws, ih._rw_lengths = ihs, rws, [15]
        for r in REDUCTIONS:
            ih._adapt_walk_length(r)
        out.append(ih._rw_lengths)
    assert out[1] == out[0]
    assert len(out[1]) == (1 if handling == "merge_rw_only"
                           else 1 + len(REDUCTIONS))


def build(P, cs, handling, pair_sims=True, shape=(12, 10, 3), **kw):
    """A NEIGH_WALKS-family hierarchy of create_hyperspectral_scene(*shape,
    seed=3), min_reduction 98, 20 walks of 8 steps, k = 16."""
    img = create_hyperspectral_scene(*shape, seed=3)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    cs = P.ComponentSim(cs)
    return P.ComputeHierarchy(**kw).init(
        data, shape[0], shape[1],
        ihs=P.ImageHierarchySettings(
            component_sim=cs, merge_multiple=False, use_percentile=False,
            max_dist=0.0, min_reduction=98.0,
            rw_handling=P.RandomWalkHandling(handling),
            num_geodesic_samples=8),
        lss=P.LevelSimilaritiesSettings(component_sim=cs, ks=[16],
                                        random_walk_pair_sims=pair_sims),
        rws=P.RandomWalkSettings(num_random_walks=20, single_walk_length=8,
                                 random_seed=2),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=16,
                                       symmetric_neighbors=True,
                                       compute_connect_components=True,
                                       neighbor_connect_components=True))


def assert_same(jch, tch):
    hj, ht = jch.image_hierarchy.hierarchy, tch.image_hierarchy.hierarchy
    assert ht.num_components == hj.num_components
    assert (tch.image_hierarchy._rw_lengths
            == list(jch.image_hierarchy._rw_lengths))
    for level in range(hj.num_levels):
        a = np.asarray(hj.random_walks[level].to_dense())
        b = ht.random_walks[level].to_dense()
        assert np.array_equal(a != 0, b != 0)
        assert np.abs(a - b).max() <= 1e-6
        pj = jch.level_similarities.get_prob_dist(level).to_dense()
        pt = tch.level_similarities.get_prob_dist(level).to_dense()
        assert np.abs(pt - pj).max() <= 1e-6
    for level in range(1, hj.num_levels):
        gj = jch.level_similarities.distance_graphs[level]
        gt = tch.level_similarities.distance_graphs[level]
        assert (gj is None) == (gt is None)
        if gt is not None:
            assert np.array_equal(gt[0], gj[0])
            inf = np.isinf(gj[1])
            assert np.array_equal(np.isinf(gt[1]), inf)
            assert np.abs(gt[1][~inf] - gj[1][~inf]).max() <= 1e-6


@pytest.mark.parametrize("cs,handling", [
    *((cs, h) for cs in ("neigh_walks", "neigh_walks_single_overlap")
      for h in HANDLINGS),
    ("geo_walks", "merge_rw_new_walks")])
def test_hierarchy_equal(cs, handling):
    jch = build(J, cs, handling).compute()
    tch = build(T, cs, handling, device="cpu").compute()
    assert_same(jch, tch)
    ht = tch.image_hierarchy.hierarchy
    assert ht.num_levels >= 3
    assert len(tch.image_hierarchy._rw_lengths) == ht.num_levels
    tiers = tch.level_similarities.knn_tiers
    assert tiers[1:] == (["exact"] * (ht.num_levels - 1)
                         if handling == "merge_rw_new_walks_and_knn"
                         else [None] * (ht.num_levels - 1))
    if handling == "merge_data_new_walks":
        assert len(ht.merged_data_graphs) == ht.num_levels


@pytest.mark.parametrize("handling", ["merge_rw_only", "merge_rw_new_walks",
                                      "merge_data_new_walks"])
def test_top_k_walk_rows_equal(handling):
    """random_walk_pair_sims=False: each level's probdist from its k
    largest walk values (summed in numpy where the JAX package's rows are
    on the host, in XLA's order where they came from a walk simulation)."""
    jch = build(J, "neigh_walks", handling, pair_sims=False,
                shape=(20, 16, 8)).compute()
    tch = build(T, "neigh_walks", handling, pair_sims=False,
                shape=(20, 16, 8), device="cpu").compute()
    assert_same(jch, tch)


@pytest.mark.parametrize("single", [False, True],
                         ids=["bhattacharyya", "single_overlap"])
def test_approximate_walk_knn_equal(single, monkeypatch):
    """MERGE_RW_NEW_WALKS_AND_KNN with the approximate threshold at 20
    components and the JAX package's k-means replayed in the port: every
    level above it takes the approximate walk kNN, with the JAX package's
    candidates and ids; the distances within 1e-6 (Bhattacharyya) or equal
    (single overlap)."""
    cs = "neigh_walks_single_overlap" if single else "neigh_walks"
    monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "20")
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    jch = build(J, cs, "merge_rw_new_walks_and_knn",
                shape=(20, 16, 8)).compute()
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    tch = build(T, cs, "merge_rw_new_walks_and_knn", shape=(20, 16, 8),
                device="cpu").compute()
    assert tape.consumed() and tape.calls
    assert_same(jch, tch)
    levels = tch.image_hierarchy.hierarchy.num_components
    tiers = tch.level_similarities.knn_tiers
    for level in range(1, len(levels)):
        assert tiers[level] == ("approximate" if levels[level] > 20
                                else "exact")
    assert "approximate" in tiers
    if single:
        for level in range(1, len(levels)):
            assert np.array_equal(
                tch.level_similarities.distance_graphs[level][1],
                jch.level_similarities.distance_graphs[level][1])


def test_new_stages_need_a_device():
    """Without device= the new paths take the card, and raise the port's
    device error without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(T, "neigh_walks", "merge_data_new_walks")
