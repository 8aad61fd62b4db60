"""Faults of the PyTorch port against the JAX package, each held by a CPU
test (ROADMAP queue 3, items 17-20).

17. force_compute_distances on walk levels: the walks become the level's
    distance graph, as the JAX package's _use_walks_as_knn_distances makes
    it.
18. The grid tier's deposit sums in a fixed order (no atomic scatter):
    bit-equal from call to call, with a crowded cell summed in several
    pieces, equal to the scatter-add up to float32 reassociation and to
    the JAX package's dense Lagrange deposit within
    test_torch_grid_tsne.py's tolerance (1e-4 x max).
19. scene_overlap's levels: with the JAX package's k-means replayed, the
    port's stage-1 graph and every level equal the JAX package's (a small
    scene on IVF_FLAT with few clusters; scripts/scene_overlap_kmeans_tape.py
    runs the same comparison at 256 x 256).
20. The exact NEIGH_OVERLAP kNN builds no [C, N] membership matrix: its
    largest allocation stays within its block budget, and its ids and
    distances equal the JAX package's at every budget.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.ops import component_knn as jck
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import similarities as jsim
from sph_tpu.ops import tsne_grid as jgrid
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch.ops import component_knn as tck
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import similarities as tsim
from sph_tpu_torch.ops import tsne_grid as tgrid
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_checker_image

from test_torch_knn_ivf import KmeansTape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def quiet_one_thread():
    jset_level("WARNING")
    set_level("WARNING")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- 17 -------------------------------------------------------------------

def _walk_hierarchy(P, **kw):
    """The verify fingerprint's 8 x 8 checker on NEIGH_WALKS in both stages,
    with force_compute_distances."""
    img = create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    walks = P.ComponentSim.NEIGH_WALKS
    return P.ComputeHierarchy(**kw).init(
        data, 8, 8, ihs=P.ImageHierarchySettings(component_sim=walks),
        lss=P.LevelSimilaritiesSettings(component_sim=walks, ks=[8],
                                        force_compute_distances=True),
        rws=P.RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                                 random_seed=1),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=8)).compute()


def test_forced_distances_on_walk_levels_equal():
    jch = _walk_hierarchy(J)
    tch = _walk_hierarchy(T, device="cpu")
    levels = jch.image_hierarchy.hierarchy.num_components
    assert tch.image_hierarchy.hierarchy.num_components == levels
    assert len(levels) >= 3
    for level in range(1, len(levels)):
        ij, dj = jch.level_similarities.distance_graphs[level]
        it, dt = tch.level_similarities.distance_graphs[level]
        w = it.shape[1]
        # the JAX package's walk rows may be padded wider: only pads there
        assert w <= ij.shape[1] and np.all(ij[:, w:] == -1)
        assert np.all(np.isinf(dj[:, w:]))
        assert np.array_equal(it, ij[:, :w]) and np.array_equal(dt, dj[:, :w])
        assert it.dtype == np.int32 and dt.dtype == np.float32
        assert tch.level_similarities.knn_tiers[level] is None
    pj = jch.level_similarities.get_prob_dist(1).to_dense()
    assert np.array_equal(tch.level_similarities.get_prob_dist(1).to_dense(),
                          pj)


# ---- 18 -------------------------------------------------------------------

def _scatter_add_deposit(y, cells, wx, wy, grid):
    """The deposit as it was: one index_add_ of the 16 c weighted charges."""
    c = y.shape[0]
    q = torch.cat([torch.ones((c, 1), dtype=y.dtype), y], 1)
    src = wy[:, :, None, None] * (q[:, :, None] * wx[:, None, :])[:, None]
    src = src.permute(0, 1, 3, 2).reshape(c * 16, 3)
    charges = torch.zeros((grid * grid, 3), dtype=y.dtype)
    charges.index_add_(0, cells.reshape(-1), src)
    return charges.T.reshape(3, grid, grid)


@pytest.mark.parametrize("grid", [128, 256])
def test_grid_deposit_sums_in_a_fixed_order(grid, monkeypatch):
    n, npad = 3000, 3072
    rng = np.random.default_rng(grid)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 6
    y[:40] = y[40:80]                       # points sharing base cells
    y[80:480] = y[80] + 1e-3 * y[480:880]   # a crowded cell: many pieces
    yt = torch.from_numpy(y)
    lo, h = tgrid.grid_box(yt, n, grid)
    cells, wx, wy = tgrid.grid_taps(yt[:n], lo, h, grid)
    old = _scatter_add_deposit(yt[:n], cells, wx, wy, grid)

    def no_scatter(*args, **kwargs):
        raise AssertionError("the deposit took an atomic scatter-add")

    monkeypatch.setattr(torch.Tensor, "index_add_", no_scatter)
    assert int(torch.bincount(cells[:, 0]).max()) > 4 * tgrid._PIECE
    got = tgrid.deposit_charges(yt[:n], cells, wx, wy, grid)
    assert torch.equal(got, tgrid.deposit_charges(yt[:n], cells, wx, wy,
                                                  grid))
    scale = float(old.abs().max())
    assert float((got - old).abs().max()) <= 1e-6 * scale
    lo_, h_ = lo.numpy(), h.numpy()
    valid = jnp.arange(npad) < n
    tx, ty = jgrid.grid_coords(jnp.asarray(y), valid, lo_[0], lo_[1], h_[0],
                               h_[1], grid)
    want = np.asarray(jgrid.deposit_charges(jnp.asarray(y), tx, ty, valid,
                                            grid, 512))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    rep1, z1 = tgrid.grid_repulsion(yt, n, grid)
    rep2, z2 = tgrid.grid_repulsion(yt, n, grid)
    assert torch.equal(rep1, rep2) and torch.equal(z1, z2)


# ---- 19 -------------------------------------------------------------------

def _tape_script():
    spec = importlib.util.spec_from_file_location(
        "scene_overlap_kmeans_tape",
        os.path.join(REPO, "scripts", "scene_overlap_kmeans_tape.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replayed_kmeans_gives_the_jax_levels(monkeypatch):
    """scene_overlap's recipe at 32 x 32 on IVF_FLAT (8 clusters, 3
    probes): with the JAX package's clustering replayed, no step differs,
    down to the last level."""
    script = _tape_script()
    tape = KmeansTape()
    monkeypatch.setattr(jknn, "_kmeans", tape.recorder(jknn._kmeans))
    monkeypatch.setattr(jknn, "knn_ivf", functools.partial(
        jknn.knn_ivf, nlist=8, nprobe=3))
    jch, _ = script.hierarchy(J, 32, "ivf_flat")
    monkeypatch.setattr(tknn, "_kmeans", tape.replayer())
    monkeypatch.setattr(tknn, "knn_ivf", functools.partial(
        tknn.knn_ivf, nlist=8, nprobe=3))
    tch, _ = script.hierarchy(T, 32, "ivf_flat", device="cpu")
    assert tape.consumed() and len(tape.calls) == 1
    levels = jch.image_hierarchy.hierarchy.num_components
    assert len(levels) >= 4
    assert tch.image_hierarchy.hierarchy.num_components == levels
    assert script.first_difference(jch, tch) is None


# ---- 20 -------------------------------------------------------------------

def test_exact_overlap_knn_within_its_block_budget(monkeypatch):
    rng = np.random.default_rng(5)
    n, c = 3000, 700
    comp = np.concatenate([np.arange(c), rng.integers(0, c, n - c)])
    knn = (rng.integers(0, n, (40, 12))[comp % 40]
           + rng.integers(0, 30, (n, 12))) % n
    knn[comp == 3] = -1
    ij, dj = jck.knn_neighbor_overlap(jsim.build_union_neighborhoods(
        knn.astype(np.int32), comp, c), 20)
    unions = tsim.build_union_neighborhoods(knn, comp, c, device="cpu")
    largest = [0]
    zeros = torch.zeros

    def spy(*size, **kw):
        out = zeros(*size, **kw)
        largest[0] = max(largest[0], out.numel())
        return out

    monkeypatch.setattr(torch, "zeros", spy)
    for budget in (tck.OVERLAP_MEMORY_BUDGET, 400_000, 60_000):
        largest[0] = 0
        block = tck.overlap_block(c, n, budget)
        it, dt = tck.knn_neighbor_overlap(unions, 20, memory_budget=budget)
        assert np.array_equal(it, ij) and np.array_equal(dt, dj)
        assert largest[0] <= n * block
        if budget < tck.OVERLAP_MEMORY_BUDGET:
            assert block < c and 4 * n * block <= budget
