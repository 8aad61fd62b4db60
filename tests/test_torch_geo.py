"""The geodesic ops of the PyTorch port against the JAX package on the CPU:
the in-edge tables, the SSSP fields and their reducers, the geodesic
Hausdorff kNN and pair distances, the contracted component graph, the
distance cache and the single-pair API.

Tolerances: every field, distance and id is bit-equal.  A candidate is one
float32 add of a weight >= 0 and float32 rounding is monotone, so both
packages' Jacobi sweeps give the same values after every sweep (the port
gathers in-edge slots in chunks; min is exact) and the same least fixed
point; the port's pair values stop early, when each is final.  The kNN ids
are equal with ties included (integer weights make many).  The contracted
graph's weights are euclidean Hausdorff distances, whose products XLA-CPU
sums in another order than torch; on integer-valued data every product and
sum is exact, so they are bit-equal too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sph_tpu.ops import graph as jgraph
from sph_tpu.ops import shortest_path as jsp
from sph_tpu.utils import distance_cache as jdc
from sph_tpu.utils.logging import set_level as jset_level
from sph_tpu_torch.ops import graph as tgraph
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops import shortest_path as tsp
from sph_tpu_torch.settings import KnnIndex
from sph_tpu_torch.utils import distance_cache as tdc
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
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


def random_graph(n=300, k=9, blocks=3, isolated=5, integer=False, seed=0):
    """A directed kNN-like graph as padded numpy rows (self first at 0,
    rows ascending, -1 / +inf pads): neighbours drawn inside each of
    `blocks` node blocks, so other blocks are unreachable, the last
    `isolated` nodes with no edge at all, rows of uneven length.  Integer
    weights (1..4) make many ties."""
    rng = np.random.default_rng(seed)
    block = np.arange(n) * blocks // n
    idx = np.full((n, k), -1, np.int32)
    dist = np.full((n, k), np.inf, np.float32)
    for v in range(n):
        idx[v, 0], dist[v, 0] = v, 0.0
        if v >= n - isolated:
            continue
        pool = np.nonzero((block == block[v]) & (np.arange(n) != v)
                          & (np.arange(n) < n - isolated))[0]
        m = int(rng.integers(2, k))
        nb = rng.choice(pool, m - 1, replace=False)
        w = (rng.integers(1, 5, m - 1).astype(np.float32) if integer
             else rng.random(m - 1).astype(np.float32) * 3 + 0.01)
        order = np.argsort(w, kind="stable")
        idx[v, 1:m], dist[v, 1:m] = nb[order], w[order]
    return idx, dist


def scene_graph(side=24, k=16):
    """The symmetrized exact kNN graph of create_hyperspectral_scene(side,
    side, 3, seed=13) (UNIFORM scaling): (port PaddedGraph, JAX
    PaddedGraph)."""
    from sph_tpu_torch import Scaler, ImageStack, scale
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = scale(ImageStack.from_array(img).data, Scaler.UNIFORM)
    idx, dist = tknn.compute_knn(data, k, KnnIndex.FLAT, device="cpu")
    g = tgraph.symmetrize_graph(tgraph.KnnGraph(idx, dist))
    return g, jgraph.PaddedGraph(g.indices, g.distances, g.counts)


def padded(idx, dist):
    counts = (idx >= 0).sum(1).astype(np.int32)
    return (tgraph.PaddedGraph(idx, dist, counts),
            jgraph.PaddedGraph(idx, dist, counts))


GRAPHS = {"random": lambda: random_graph(),
          "ties": lambda: random_graph(integer=True, seed=3)}


@pytest.fixture(scope="module", params=["random", "ties", "scene"])
def tables(request):
    """(in_idx, in_w) of a graph, built by both packages (asserted equal)."""
    if request.param == "scene":
        tg, _ = scene_graph()
        idx, dist, mask = tg.indices, tg.distances, tg.mask
    else:
        idx, dist = GRAPHS[request.param]()
        mask = idx >= 0
    t = tsp.build_reverse_adjacency(idx, dist, mask)
    j = jsp.build_reverse_adjacency(idx, dist, mask)
    assert np.array_equal(t[0], j[0]) and np.array_equal(t[1], j[1])
    return t


def test_build_reverse_adjacency_and_edge_list_equal():
    idx, dist = random_graph(seed=5)
    for mask in (idx >= 0, (idx >= 0) & (np.arange(9) % 3 != 1)):
        t = tsp.build_reverse_adjacency(idx, dist, mask)
        j = jsp.build_reverse_adjacency(idx, dist, mask)
        assert np.array_equal(t[0], j[0]) and np.array_equal(t[1], j[1])
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 50, 200), rng.integers(0, 50, 200)
    w = rng.random(200).astype(np.float32)
    t = tsp._edge_list_reverse(50, src, dst, w)
    j = jsp._edge_list_reverse(50, src, dst, w)
    assert np.array_equal(t[0], j[0]) and np.array_equal(t[1], j[1])


def _sources(n, f, s, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, (f, s))
    src[rng.random((f, s)) < 0.3] = -1
    src[:, 0] = rng.integers(0, n, f)
    return src


@pytest.mark.parametrize("max_iter", [0, 2])
def test_sssp_fields_bit_equal(tables, max_iter):
    """Converged and after two sweeps; sources are padded multi-source
    sets; unreachable stays +inf."""
    in_idx, in_w = tables
    n = in_idx.shape[0]
    src = _sources(n, 12, 4, seed=max_iter)
    got = tsp.sssp_fields(in_idx, in_w, src, max_iter, device="cpu")
    want = jsp.sssp_fields(in_idx, in_w, src, max_iter)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if max_iter == 0:
        assert np.isinf(got).any() == np.isinf(want).any()


def test_relax_chunks_do_not_change_a_sweep(tables):
    """One sweep with one slot a chunk equals one with all slots at once,
    and the frontier is the least lowered value."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(_sources(g.n, 6, 3, seed=4))
    d1, f1 = tsp.relax(d, g)
    d2, f2 = tsp.relax(d, g, memory_budget=1)
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    want = torch.where(d1 < d, d1, torch.inf).amin(0)
    assert torch.equal(f1, want)


def _jax_tables(in_idx, in_w):
    return jnp.asarray(in_idx), jnp.asarray(in_w)


def test_fields_component_max_equal(tables):
    in_idx, in_w = tables
    n = in_idx.shape[0]
    fs = _sources(n, 8, 5, seed=7)
    ev = _sources(n, 20, 6, seed=8)
    ev[3, :] = -1                                     # an empty component
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    got = tsp._fields_component_max(g, fs, torch.as_tensor(ev), n,
                                    memory_budget=4 * 6 * 8 * 3)
    ji, jw = _jax_tables(in_idx, in_w)
    want = jsp._fields_component_max(ji, jw, jnp.asarray(fs, jnp.int32),
                                     jnp.asarray(ev, jnp.int32),
                                     jnp.asarray(ev >= 0), n)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("field_batch", [7, 256])
def test_pair_values_stop_early_and_stay_equal(tables, field_batch):
    """The port stops each batch when every evaluated value is final; the
    values equal the JAX package's converged ones, and the batches took no
    more sweeps than full convergence."""
    in_idx, in_w = tables
    n = in_idx.shape[0]
    rng = np.random.default_rng(field_batch)
    srcs = np.unique(rng.integers(0, n, 40))
    pos = rng.integers(0, len(srcs), 150)
    ev = rng.integers(0, n, 150)
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    tsp.LOG.clear()
    got = tsp._pair_values_batched(g, srcs, pos, ev, field_batch)
    early = [e["sweeps"] for e in tsp.LOG]
    ji, jw = _jax_tables(in_idx, in_w)
    want = jsp._pair_values_batched(ji, jw, srcs, pos, ev.astype(np.int32),
                                    field_batch)
    assert np.array_equal(got, want)
    full = tsp.sssp_fields(in_idx, in_w, srcs[:, None], device="cpu")
    assert np.array_equal(got, full[pos, ev])
    assert sum(early) <= tsp.LOG[-1]["sweeps"] * len(early)


def test_fields_topk_ties_toward_the_lower_id():
    idx, dist = random_graph(integer=True, seed=11)
    in_idx, in_w = jsp.build_reverse_adjacency(idx, dist, idx >= 0)
    n = in_idx.shape[0]
    fs = np.arange(0, n, 5)[:, None]
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    ti, td = tsp._fields_topk(g, fs, n, 12)
    ji, jw = _jax_tables(in_idx, in_w)
    wi, wd = jsp._fields_topk(ji, jw, jnp.asarray(fs, jnp.int32), n, 12)
    assert np.array_equal(ti.numpy(), np.asarray(wi))
    assert np.array_equal(td.numpy(), np.asarray(wd))
    # ties happen, and unreachable is FLOAT_MAX
    assert (np.diff(td.numpy(), axis=1) == 0).any()
    assert (td.numpy() == np.finfo(np.float32).max).any()


class _Hierarchy:
    """What the geodesic functions read of a hierarchy: levels of pixel
    labels on a rows x cols grid with FOUR spatial adjacency."""

    def __init__(self, labels, rows, cols):
        from sph_tpu_torch.models.hierarchy import pixel_neighbor_table
        from sph_tpu_torch.settings import NeighConnection
        self.pixel_components = labels
        self.num_components = [int(lab.max()) + 1 for lab in labels]
        self._pix = pixel_neighbor_table(rows, cols, NeighConnection.FOUR)

    def represented_points(self, level):
        labels = self.pixel_components[level]
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=self.num_components[level])
        return np.split(order, np.cumsum(counts)[:-1])

    def spatial_neighbors_of(self, level):
        if level == 0:
            return self._pix
        lab = self.pixel_components[level]
        a = np.repeat(lab, self._pix.shape[1])
        b = np.where(self._pix >= 0, lab[np.maximum(self._pix, 0)],
                     -1).ravel()
        ok = (b >= 0) & (a != b)
        pairs = np.unique(np.stack([a[ok], b[ok]], 1), axis=0)
        c = self.num_components[level]
        deg = np.bincount(pairs[:, 0], minlength=c)
        out = np.full((c, max(int(deg.max()), 1)), -1, np.int64)
        start = np.concatenate([[0], np.cumsum(deg)[:-1]])
        out[pairs[:, 0], np.arange(len(pairs)) - start[pairs[:, 0]]] = \
            pairs[:, 1]
        return out


def block_hierarchy(side, blocks=(2, 4, 8)):
    """Levels of square pixel blocks (block sizes `blocks`)."""
    rr, cc = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    labels = [np.arange(side * side)]
    for b in blocks:
        per_row = -(-side // b)
        labels.append(((rr // b) * per_row + cc // b).ravel())
    return _Hierarchy(labels, side, side)


def _edges(h, level):
    adj = h.spatial_neighbors_of(level)
    src = np.repeat(np.arange(adj.shape[0]), adj.shape[1])
    dst = adj.ravel()
    return src[dst >= 0], dst[dst >= 0]


@pytest.mark.parametrize("level,samples", [(0, 0), (1, 0), (2, 3), (3, 5)])
def test_geodesic_component_distances_equal(level, samples):
    """Level 0 (direct kNN edges, then pair fields) and levels > 0 (sampled
    fields, component maxima), with the graph's weak-CC labels (13 of them:
    cross-component pairs are FLOAT_MAX, and unreachable samples make
    more)."""
    tg, jg = scene_graph(side=20, k=10)
    h = block_hierarchy(20)
    a, b = _edges(h, level)
    labels = tgraph.weak_connected_components(tg)[1]
    data = np.zeros((400, 3), np.float32)
    tsp.LOG.clear()
    got = tsp.geodesic_component_distances(
        tg, data, h, level, a, b, num_samples=samples,
        component_labels=labels, field_batch=64, device="cpu")
    want = jsp.geodesic_component_distances(
        jg, data, h, level, a, b, num_samples=samples,
        component_labels=labels, field_batch=64)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    fmax = np.finfo(np.float32).max
    assert (got == fmax).any() and ((got < fmax).any() or level == 3)
    if level == 0:
        log = [e for e in tsp.LOG if e["what"] == "level0_pairs"]
        assert len(log) == 1 and log[0]["unresolved_pairs"] > 0


@pytest.mark.parametrize("level,samples", [(1, 0), (2, 4)])
def test_geodesic_hausdorff_knn_equal(level, samples):
    tg, jg = scene_graph(side=20, k=10)
    h = block_hierarchy(20)
    got = tsp.geodesic_hausdorff_knn(tg, h, level, 15, samples,
                                     field_batch=16, device="cpu")
    want = jsp.geodesic_hausdorff_knn(jg, h, level, 15, samples,
                                      field_batch=16)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert np.all(got[0][:, 0] == np.arange(h.num_components[level]))


def test_geodesic_hausdorff_knn_ties_equal():
    """Integer weights: many equal Hausdorff distances, broken toward the
    lower id in both packages."""
    idx, dist = random_graph(n=256, integer=True, blocks=1, isolated=0,
                             seed=2)
    tg, jg = padded(idx, dist)
    h = block_hierarchy(16)
    got = tsp.geodesic_hausdorff_knn(tg, h, 1, 20, 0, device="cpu")
    want = jsp.geodesic_hausdorff_knn(jg, h, 1, 20, 0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert (np.diff(got[1], axis=1) == 0).any()


def _integer_data(n, d=3, seed=0):
    return np.random.default_rng(seed).integers(0, 9, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("samples", [0, 3])
def test_contracted_geodesics_equal(samples):
    h = block_hierarchy(24, blocks=(2, 3))
    data = _integer_data(24 * 24)
    for level in (1, 2):
        got = tsp.contracted_geodesics(h, data, level, samples, batch=40,
                                       device="cpu")
        want = jsp.contracted_geodesics(h, data, level, samples, batch=40)
        assert np.array_equal(got, want)
        ti, td = tsp.contracted_geodesic_knn(h, data, level, 10, samples,
                                             batch=40, device="cpu")
        wi, wd = jsp.contracted_geodesic_knn(h, data, level, 10, samples,
                                             batch=40)
        assert np.array_equal(ti, wi) and np.array_equal(td, wd)
        a, b = _edges(h, level)
        got = tsp.contracted_geodesic_pairs(h, data, level, a, b, samples,
                                            batch=40, device="cpu")
        want = jsp.contracted_geodesic_pairs(h, data, level, a, b, samples,
                                             batch=40)
        assert np.array_equal(got, want)


def test_geodesic_hausdorff_knn_contracts_above_the_threshold(monkeypatch):
    h = block_hierarchy(24, blocks=(2, 3))
    data = _integer_data(24 * 24, seed=1)
    tg, jg = scene_graph(side=24, k=10)
    monkeypatch.setattr(tsp, "CONTRACT_THRESHOLD", 100)
    monkeypatch.setattr(jsp, "CONTRACT_THRESHOLD", 100)
    got = tsp.geodesic_hausdorff_knn(tg, h, 1, 12, 4, data=data,
                                     device="cpu")
    want = jsp.geodesic_hausdorff_knn(jg, h, 1, 12, 4, data=data)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert np.array_equal(got[0], tsp.contracted_geodesic_knn(
        h, data, 1, 12, 4, device="cpu")[0])


def test_compute_shortest_path_and_fields_equal():
    idx, dist = random_graph(seed=9)
    tg, jg = padded(idx, dist)
    src = np.array([0, 7, 150, 299])
    assert np.array_equal(tsp.shortest_path_fields(tg, src, device="cpu"),
                          jsp.shortest_path_fields(jg, src))
    pairs = [(3, 3), (0, int(idx[0, 1])), (0, 50), (0, 250), (0, 299),
             (120, 180)]
    for s, e in pairs:
        got = tsp.compute_shortest_path(tg, s, e, device="cpu")
        assert got == jsp.compute_shortest_path(jg, s, e)
    assert tsp.compute_shortest_path(tg, 0, 299, device="cpu") == -1.0


def test_distance_cache_counts_and_values_equal():
    """The same query sequence: the same values, hits, misses and
    evictions (LRU of 3 fields)."""
    idx, dist = random_graph(seed=4)
    tg, jg = padded(idx, dist)
    tc = tdc.DistanceCache(tg, max_fields=3, device="cpu")
    jc = jdc.DistanceCache(jg, max_fields=3)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, 60, (40, 2))
    queries[5] = (0, idx[0, 1])                       # a direct edge
    queries[6] = (9, 9)
    for s, e in queries:
        assert tc.query(s, e) == jc.query(s, e)
        assert tsp.compute_shortest_path(tg, s, e, cache=tc) == \
            jsp.compute_shortest_path(jg, s, e, cache=jc)
    tc.prefetch([1, 2, 3, 2])
    jc.prefetch([1, 2, 3, 2])
    assert np.array_equal(tc.field(2), jc.field(2))
    assert tc.stats() == jc.stats()
    assert tc.evictions > 0 and tc.hits > 0
