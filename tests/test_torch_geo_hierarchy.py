"""GEO_CENTROID and GEO_WALKS end to end: ComputeHierarchy of the PyTorch
port against the JAX package's on the CPU, on the 8x8 checker of
tests/test_pipeline_variants.py and on a 32x32 RGB scene with
CONTRACT_THRESHOLD lowered so that the sketch (stage 2) and the contracted
component graph (stage 3) both run.

Tolerances: levels and components are equal.  P is held within 1e-6:
where a level's distances come from the euclidean Hausdorff (the contracted
graph's weights, the sketch's fallback), XLA-CPU sums its products in
another order than torch.
"""

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.ops import shortest_path as jsp
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch.ops import shortest_path as tsp
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import (create_checker_image,
                                          create_hyperspectral_scene)
from test_torch_reference_native import use_reference_native

use_reference_native()


@pytest.fixture(autouse=True)
def quiet_one_thread():
    jset_level("WARNING")
    set_level("WARNING")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _checker(P, cs, **kw):
    """tests/test_pipeline_variants.py's build(): the 8x8 checker with
    block 4, noise 0.03, symmetric connected k = 10 neighbours, 8 samples."""
    img = create_checker_image(8, 8, channels=4, block=4, noise=0.03)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    cs = P.ComponentSim(cs)
    return P.ComputeHierarchy(**kw).init(
        data, 8, 8,
        ihs=P.ImageHierarchySettings(component_sim=cs,
                                     merge_multiple=False,
                                     num_geodesic_samples=8),
        lss=P.LevelSimilaritiesSettings(component_sim=cs, ks=[10],
                                        force_compute_distances=False),
        rws=P.RandomWalkSettings(num_random_walks=15, single_walk_length=5,
                                 random_seed=4),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=10,
                                       symmetric_neighbors=True,
                                       compute_connect_components=True,
                                       neighbor_connect_components=True))


def _same_hierarchies(jch, tch, p_tol):
    hj = jch.image_hierarchy.hierarchy
    ht = tch.image_hierarchy.hierarchy
    assert ht.num_components == hj.num_components
    for a, b in zip(hj.pixel_components, ht.pixel_components):
        assert np.array_equal(a, b)
    for level in range(hj.num_levels):
        pj = jch.level_similarities.get_prob_dist(level).to_dense()
        pt = tch.level_similarities.get_prob_dist(level).to_dense()
        assert np.abs(pt - pj).max() <= p_tol


@pytest.mark.parametrize("cs", ["geo_centroid", "geo_walks"])
def test_checker_hierarchy_equal(cs):
    jch = _checker(J, cs).compute()
    tch = _checker(T, cs, device="cpu").compute()
    _same_hierarchies(jch, tch, 1e-6)
    assert len(tch.image_hierarchy.hierarchy.num_components) >= 3


def _rgb(P, cs, side=32, **kw):
    """The rgb_geo configuration (chip_smoke.rgb_geo_settings) at side x
    side x 3 with k = 16."""
    import chip_smoke
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.UNIFORM)
    ihs, lss, rws, nns = chip_smoke.rgb_geo_settings(P, P.ComponentSim(cs))
    nns.num_nearest_neighbors = 16
    lss.ks = [16]
    return P.ComputeHierarchy(**kw).init(data, side, side, ihs=ihs, lss=lss,
                                         rws=rws, nns=nns)


@pytest.mark.parametrize("cs", ["geo_centroid", "geo_walks"])
def test_rgb_scene_sketch_and_contraction_equal(cs, monkeypatch):
    """32x32x3 with CONTRACT_THRESHOLD at 100: level 1 takes the sketch in
    stage 2 and (GEO_CENTROID) the contracted graph in stage 3."""
    for mod in (tsp, jsp):
        monkeypatch.setattr(mod, "CONTRACT_THRESHOLD", 100)
    jch = _rgb(J, cs).compute()
    tsp.LOG.clear()
    tch = _rgb(T, cs, device="cpu").compute()
    levels = tch.image_hierarchy.hierarchy.num_components
    assert levels[1] > 100 and len(levels) >= 4
    assert any(e["what"] == "sketch_pairs" for e in tsp.LOG)
    if cs == "geo_centroid":
        assert tch.level_similarities.knn_tiers[1] == "contracted"
    _same_hierarchies(jch, tch, 1e-6)
