"""The geodesic sketch of the PyTorch port against the JAX package's on the
CPU: the build, the pair queries, the sketch Hausdorff and the large-C
stage-2 tier.

Tolerances: everything is bit-equal (every value is a min of one float32
add; the sorts are stable on keys that order as ``lax.sort`` does; the
euclidean fallback runs on integer data, where its products are exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sph_tpu.ops import geo_sketch as jgs
from sph_tpu.ops import graph as jgraph
from sph_tpu.ops import shortest_path as jsp
from sph_tpu.utils.logging import set_level as jset_level
from sph_tpu_torch.ops import geo_sketch as tgs
from sph_tpu_torch.ops import graph as tgraph
from sph_tpu_torch.ops import shortest_path as tsp
from sph_tpu_torch.utils.logging import set_level

from test_torch_geo import block_hierarchy, random_graph, scene_graph
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


@pytest.fixture(scope="module")
def graphs():
    return scene_graph(side=24, k=16)


@pytest.mark.parametrize("width,hops", [(64, 3), (8, 2)])
def test_build_geo_sketch_equal(graphs, width, hops):
    tg, jg = graphs
    si, sd = tgs.build_geo_sketch(tg, width, hops, device="cpu")
    ji, jd = jgs.build_geo_sketch(jg, width, hops)
    assert np.array_equal(si.numpy(), np.asarray(ji))
    assert np.array_equal(sd.numpy(), np.asarray(jd))
    # small row blocks give the same sketch
    bi, bd = tgs.build_geo_sketch(tg, width, hops, row_block=37,
                                  device="cpu")
    assert torch.equal(bi, si) and torch.equal(bd, sd)


def test_sketch_of_a_graph_with_ties_and_pads_equal():
    """Integer weights (tied candidates) and rows shorter than the
    width."""
    idx, dist = random_graph(n=200, integer=True, seed=6)
    counts = (idx >= 0).sum(1).astype(np.int32)
    tg = tgraph.symmetrize_graph(tgraph.PaddedGraph(idx, dist, counts))
    jg = jgraph.PaddedGraph(tg.indices, tg.distances, tg.counts)
    si, sd = tgs.build_geo_sketch(tg, 16, 3, device="cpu")
    ji, jd = jgs.build_geo_sketch(jg, 16, 3)
    assert np.array_equal(si.numpy(), np.asarray(ji))
    assert np.array_equal(sd.numpy(), np.asarray(jd))


def test_query_block_and_pair_distances_equal(graphs):
    tg, jg = graphs
    si, sd = tgs.build_geo_sketch(tg, device="cpu")
    ji, jd = jgs.build_geo_sketch(jg)
    n = si.shape[0]
    rng = np.random.default_rng(3)
    p = rng.integers(-1, n, 3000)
    q = rng.integers(-1, n, 3000)
    q[:100] = p[:100]
    got = tgs._query_block(si, sd, torch.as_tensor(p), torch.as_tensor(q))
    want = jgs._query_block(ji, jd, jnp.asarray(p, jnp.int32),
                            jnp.asarray(q, jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.isinf(got.numpy()).any() and np.isfinite(got.numpy()).any()
    pp, qq = np.maximum(p, 0), np.maximum(q, 0)
    got = tgs.sketch_pair_distances(si, sd, pp, qq, chunk=333)
    assert np.array_equal(got, jgs.sketch_pair_distances(ji, jd, pp, qq))


def test_sketch_hausdorff_pairs_equal_padded_and_chunked(graphs):
    """Sample rows with pads, drawn among one pixel's graph neighbours (the
    first 40 pairs: their sketches meet) or anywhere; chunk 1 and the
    default give the JAX package's values."""
    tg, jg = graphs
    si, sd = tgs.build_geo_sketch(tg, device="cpu")
    ji, jd = jgs.build_geo_sketch(jg)
    n = si.shape[0]
    rng = np.random.default_rng(4)
    ra = rng.integers(0, n, (60, 7))
    rb = rng.integers(0, n, (60, 7))
    for e in range(40):
        row = tg.indices[rng.integers(0, n)]
        row = row[row >= 0]
        ra[e], rb[e] = rng.choice(row, 7), rng.choice(row, 7)
    ra[rng.random((60, 7)) < 0.4] = -1
    rb[rng.random((60, 7)) < 0.4] = -1
    ra[:, 0] = np.maximum(ra[:, 0], 0)
    rb[:, 0] = np.maximum(rb[:, 0], 0)
    want = jgs.sketch_hausdorff_pairs(ji, jd, ra, rb)
    for chunk in (0, 1):
        got = tgs.sketch_hausdorff_pairs(si, sd, ra, rb, chunk=chunk)
        assert np.array_equal(got, want)
    assert np.isinf(want).any() and np.isfinite(want).any()


def test_sketch_geodesic_pairs_equal(graphs, monkeypatch):
    """The large-C stage-2 tier: sketch Hausdorff, the euclidean fallback
    where sketches do not meet, FLOAT_MAX across weak components; the sketch
    cache keeps one entry, pinned to its graph.  Integer data keeps the
    fallback's Hausdorff exact in both packages."""
    tg, jg = graphs
    h = block_hierarchy(24)
    data = np.random.default_rng(0).integers(0, 9, (576, 3)).astype(
        np.float32)
    labels = tgraph.weak_connected_components(tg)[1]
    adj = h.spatial_neighbors_of(1)
    a = np.repeat(np.arange(adj.shape[0]), adj.shape[1])
    b = adj.ravel()
    a, b = a[b >= 0], b[b >= 0]
    monkeypatch.setenv("SPH_GEO_SKETCH_WIDTH", "12")
    monkeypatch.setenv("SPH_GEO_SKETCH_HOPS", "2")
    tsp.LOG.clear()
    got = tsp.sketch_geodesic_pairs(tg, h, data, 1, a, b, 3, labels,
                                    device="cpu")
    want = jsp.sketch_geodesic_pairs(jg, h, data, 1, a, b, 3, labels)
    assert np.array_equal(got, want)
    assert tsp.LOG[-1]["fallback_pairs"] > 0
    assert len(tsp._SKETCH_CACHE) == 1
    assert next(iter(tsp._SKETCH_CACHE.values()))[3] is tg
    si, _ = tsp.get_geo_sketch(tg, device="cpu")
    assert si.shape == (576, 12)
