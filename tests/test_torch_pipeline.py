"""The Pines main path as a whole: sph_tpu on JAX-CPU against sph_tpu_torch
on device="cpu", at sizes that keep the tier-1 suite fast.  The full-size
run is under -m slow.

Both packages make the same numbers up to the float32 summation order of
the walks' visit sums (XLA sorts equal-id visits with an unstable sort) and
of the Bhattacharyya products; the perplexity search then converges within
its own 1e-6 entropy tolerance, which moves P values by up to ~1e-5.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import sph_tpu as J
import sph_tpu.ops.pallas.tsne_kernels as jax_kernels
import sph_tpu_torch as T
from sph_tpu_torch.models import tsne as ttsne
from sph_tpu_torch.ops.tsne_kernels import tsne_forces_dense_reference
from sph_tpu_torch.utils.testdata import (create_checker_image,
                                          create_hyperspectral_scene)
from test_torch_kernels import forces_z
from test_torch_reference_native import use_reference_native

use_reference_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 24          # a <= 32 x 32 scene
K = 91             # bench.py's k (90 + self)
KL_SETTLED_ITERS = 1000
KL_SETTLED_RTOL = 0.11   # twice the measured spread (the test's docstring)


def _pines_settings(P, k=K):
    """bench.py:99-121 in package P's settings classes."""
    return dict(
        ihs=P.ImageHierarchySettings(
            component_sim=P.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False, max_dist=0.0, min_num_comp=1,
            min_reduction=98.0, max_levels=10,
            rw_handling=P.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=P.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
            norm_knn_distances=P.NormalizationScheme.TSNE),
        lss=P.LevelSimilaritiesSettings(
            component_sim=P.ComponentSim.NEIGH_WALKS, ks=[k],
            random_walk_pair_sims=True,
            normalize_prob_dist=P.NormalizationScheme.TSNE,
            compute_symmetric_prob_dist=P.NormalizationScheme.TSNE),
        rws=P.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=P.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=P.NearestNeighborsSettings(
            num_nearest_neighbors=k, symmetric_neighbors=True,
            compute_connect_components=True,
            neighbor_connect_components=True))


def _hierarchy(P, img, rows, cols, **kw):
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.NONE)
    ch = P.ComputeHierarchy(**kw).init(data, rows, cols, **_pines_settings(P))
    return ch.compute()


@pytest.fixture(scope="module")
def scene():
    return create_hyperspectral_scene(SIDE, SIDE, 200, seed=7)


@pytest.fixture(scope="module")
def jax_run(scene):
    return _hierarchy(J, scene, SIDE, SIDE)


@pytest.fixture(scope="module")
def torch_run(scene):
    return _hierarchy(T, scene, SIDE, SIDE, device="cpu")


def test_levels_identical(jax_run, torch_run):
    levels = jax_run.image_hierarchy.hierarchy.num_components
    assert torch_run.image_hierarchy.hierarchy.num_components == levels
    assert len(levels) >= 3
    for a, b in zip(jax_run.image_hierarchy.hierarchy.parents,
                    torch_run.image_hierarchy.hierarchy.parents):
        assert np.array_equal(a, b)


def test_stage1_and_walks_identical(jax_run, torch_run):
    gj = jax_run.knn_stage.connected_graph
    gt = torch_run.knn_stage.connected_graph
    assert np.array_equal(gj.indices, gt.indices)
    assert np.array_equal(gj.distances, gt.distances)
    pj = jax_run.image_hierarchy.data_level_probdist
    pt = torch_run.image_hierarchy.data_level_probdist
    assert np.array_equal(pj.to_dense(), pt.to_dense())
    wj = jax_run.image_hierarchy.hierarchy.random_walks[0].to_dense()
    wt = torch_run.image_hierarchy.hierarchy.random_walks[0].to_dense()
    assert np.array_equal(wj != 0, wt != 0)
    assert np.abs(wj - wt).max() <= 1e-6


def test_level1_probdist(jax_run, torch_run):
    pj = jax_run.level_similarities.get_prob_dist(1).to_dense()
    pt = torch_run.level_similarities.get_prob_dist(1).to_dense()
    assert np.array_equal(pj != 0, pt != 0)
    assert np.abs(pj - pt).max() <= 1e-5
    assert np.abs(pt - pt.T).max() <= 1e-7


def twin_zrow(y: torch.Tensor, n: int, row_block: int = 1024):
    """The rows' z as tsne_forces_dense_reference sums them."""
    npad = y.shape[0]
    ids = torch.arange(npad)
    zrow = torch.zeros(npad)
    for r0 in range(0, npad, row_block):
        r1 = min(r0 + row_block, npad)
        rows = ids[r0:r1, None]
        dx = y[r0:r1, 0, None] - y[None, :, 0]
        dy = y[r0:r1, 1, None] - y[None, :, 1]
        w = 1.0 / (1.0 + dx * dx + dy * dy)
        valid = (rows != ids[None, :]) & (ids < n)[None, :] & (rows < n)
        zrow[r0:r1] = torch.where(valid, w, 0.0).sum(1)
    return zrow


def kernel_z_forces(y, p, n, out=None):
    """The dense tier's forces with Z summed in the CUDA kernel's order
    (forces_z over the twin's rows' z), as the card sums it."""
    attr, rep, _ = tsne_forces_dense_reference(y, p, n)
    return attr, rep, forces_z(twin_zrow(y, n))


def test_tsne_kl_within_one_percent(jax_run, monkeypatch):
    """1000 iterations from the JAX package's level-1 P (135 points) in
    both packages, the port once with Z as its CPU twin sums it and once
    in the CUDA kernel's order; each final KL within KL_SETTLED_RTOL of the
    JAX package's.  The reference is the JAX package's dense-P tier, the
    tier the port implements.

    Why 1000 iterations and that margin (scripts/pipeline_kl_spread.py,
    CPU, docs/torch_port_pipeline_kl_spread.json): at iteration 250, the
    end of early exaggeration, one ulp of Z moves the KL by up to 26 %
    (the kernel's Z order gave 0.4002 against the JAX package's 0.4612,
    the twin's 0.4617).  Once the exaggeration has decayed the KL settles:
    over ten faithful runs (the twin's Z, the kernel's order, Z moved by
    +-1 to +-4 ulps on every iteration) the KL after 1000 iterations lies
    0.03524-0.03763 against the JAX package's 0.03732, at most 5.6 % away;
    the margin is twice that.  A port that halves the normalized P in the
    optimizer ends at 0.656 (17 times the JAX KL) and fails; one that ends
    the exaggeration at iteration 200 instead of 250 ends at 0.03688, inside
    the spread, which a settled KL cannot tell apart."""
    monkeypatch.setenv("SPH_TSNE_USE_PALLAS", "1")
    monkeypatch.setattr(jax_kernels, "tsne_forces_dense", functools.partial(
        jax_kernels.tsne_forces_dense, interpret=True))
    es = J.ComputeEmbeddingSettings()
    es.tsne.num_iterations = KL_SETTLED_ITERS
    ce_j = J.ComputeEmbedding(es)
    ce_j.compute_tsne(jax_run.level_similarities.get_prob_dist(1),
                      track_kl=True)
    p1 = jax_run.level_similarities.get_prob_dist(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as the spread was measured
    try:
        kls = {z_order: _port_kl(p1, z_order, monkeypatch)
               for z_order in ("twin", "kernel")}
    finally:
        torch.set_num_threads(threads)
    for z_order, kl in kls.items():
        assert abs(kl - ce_j.last_kl) <= KL_SETTLED_RTOL * ce_j.last_kl, (
            z_order, kl, ce_j.last_kl)


def _port_kl(p1, z_order: str, monkeypatch) -> float:
    """The port's KL after KL_SETTLED_ITERS iterations from the JAX
    package's P on the CPU, Z in the twin's or the kernel's order."""
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = KL_SETTLED_ITERS
    ce = T.ComputeEmbedding(es, device="cpu")
    with monkeypatch.context() as mp:
        if z_order == "kernel":
            mp.setattr(ttsne, "tsne_forces_dense", kernel_z_forces)
        emb = ce.compute_tsne(T.SparseRows(p1.indices, p1.values,
                                           p1.num_cols, device="cpu"),
                              track_kl=True)
    assert np.all(np.isfinite(emb))
    return ce.last_kl


@pytest.mark.parametrize("sim,levels", [("neigh_overlap", [64, 19, 2, 1]),
                                        ("neigh_walks", [64, 18, 4, 1])])
def test_fingerprint_8x8(sim, levels):
    """The verify skill's 8x8 checker fingerprint in both packages (default
    settings use NEIGH_OVERLAP; the NEIGH_WALKS variant is the main path's
    metric)."""
    img = create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    out = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
        cs = P.ComponentSim(sim)
        ch = P.ComputeHierarchy(**kw).init(
            data, 8, 8, ihs=P.ImageHierarchySettings(component_sim=cs),
            lss=P.LevelSimilaritiesSettings(ks=[8], component_sim=cs),
            rws=P.RandomWalkSettings(num_random_walks=10,
                                     single_walk_length=5, random_seed=1),
            nns=P.NearestNeighborsSettings(num_nearest_neighbors=8))
        ch.compute()
        out.append(ch)
    assert out[0].image_hierarchy.hierarchy.num_components == levels
    assert out[1].image_hierarchy.hierarchy.num_components == levels
    for lvl in range(1, len(levels) - 1):
        pj = out[0].level_similarities.get_prob_dist(lvl).to_dense()
        pt = out[1].level_similarities.get_prob_dist(lvl).to_dense()
        assert np.array_equal(pj != 0, pt != 0)
        assert np.abs(pj - pt).max() <= 1e-5


@pytest.mark.slow
def test_full_pines_matches_jax_record():
    """The full 145x145x200 main path on the CPU against the JAX-on-CPU
    record in docs/torch_port_pines_reference.json."""
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_reference.json")) as f:
        ref = json.load(f)
    img = create_hyperspectral_scene(145, 145, 200, seed=7)
    ch = _hierarchy(T, img, 145, 145, device="cpu")
    assert ch.image_hierarchy.hierarchy.num_components == ref["levels"]
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 2000
    ce = T.ComputeEmbedding(es, device="cpu")
    ce.compute_tsne(ch.level_similarities.get_prob_dist(1), track_kl=True)
    with open(os.path.join(REPO, "docs", "anchors_pines.json")) as f:
        anchor = json.load(f)["kl_under_p_sklearn_bh"]
    assert ce.last_kl <= 1.01 * anchor
