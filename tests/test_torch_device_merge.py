"""The port's device merges and device symmetrization (ops/device_merge.py)
against the port's host path and the JAX package's two paths, on the CPU.

The port's device path (``merge_by_parents_device`` and
``normalize_merged_device`` called on CPU tensors, where the kernel's twin
``merge_runs_reference`` runs) must give the port's host path (the merges
on CPU rows) and the JAX package's host path (SPH_DEVICE_RESTRUCT=0, both
through the C++ merge) bit for bit: indices, values and the exact row width, with and without
``weight_by_size``, ``norm`` and a width cap (one that is a power of two
and one that is not), on rows with empty and all-zero rows, and into a
single parent.  The JAX package's device path (SPH_DEVICE_RESTRUCT=1 on
JAX-CPU) pads its rows to a power-of-two width: with its pad columns
stripped, its layouts are equal where no cap bites, and so are its values
without ``norm`` (the runs summed in XLA-CPU's scatter order are the same
additions here); with ``norm`` its XLA row sums over the padded width part
from numpy's, so its values are held to tests/test_device_merge.py's own
rtol 2e-5 / atol 1e-7.  At a cap that is not a power of two the JAX
package's device path keeps fewer entries than its host path (it floors
the cap); the port follows the host.

The symmetrization equals ``native.symmetrize`` and both JAX paths bit for
bit.  Small hierarchies with the device path forced give the JAX package's
levels and parents.  The port picks its path by the rows' device only
(``device_merge.on_card``, which the tests patch to reach the device path
on the CPU).  The kernel itself runs only on a card (the test marked
``cuda`` holds it against the twin there).
"""

import os
import re

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.ops import device_merge as jdm
from sph_tpu.ops import graph as jgraph
from sph_tpu.ops import sparse as jsp
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch import native
from sph_tpu_torch.ops import device_merge as tdm
from sph_tpu_torch.ops import graph as tgraph
from sph_tpu_torch.ops import sparse as tsp
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
from test_torch_reference_native import use_reference_native
import test_torch_merge_rows as merge_rows

use_reference_native()

CPU = torch.device("cpu")
FLAG = "SPH_DEVICE_RESTRUCT"      # the JAX package's switch
RTOL, ATOL = 2e-5, 1e-7          # tests/test_device_merge.py's


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.delenv(FLAG, raising=False)
    monkeypatch.delenv("SPH_MERGE_LANE_BUDGET", raising=False)
    jset_level("WARNING")
    set_level("WARNING")


def with_flag(value, fn, *args, **kw):
    """fn(*args, **kw) with SPH_DEVICE_RESTRUCT=value (the JAX package
    reads it), the variable restored afterwards."""
    old = os.environ.get(FLAG)
    os.environ[FLAG] = value
    try:
        return fn(*args, **kw)
    finally:
        if old is None:
            os.environ.pop(FLAG, None)
        else:
            os.environ[FLAG] = old


def walk_rows(c: int, width: int, seed: int, num_cols: int = 0):
    """tests/test_torch_merge_rows.py's walk rows (row 3 all zeros, row 4
    empty; a few values repeat: ties under a cap) with int32 columns."""
    idx, val = merge_rows.walk_rows(c, width, seed, num_cols)
    return idx.astype(np.int32), val


def parents_of(n: int, m: int, seed: int) -> np.ndarray:
    par = np.random.default_rng(seed).integers(0, m, n)
    par[:m] = np.arange(m) if m <= n else par[:m]
    return par


def port_merge(path, idx, val, par, m, combine, norm=False,
               weight_by_size=True, max_width=None):
    """The port's merge of CPU rows on `path`: "host" as the merges
    dispatch CPU rows (the C++ merge), "device" through
    ``merge_by_parents_device`` and ``normalize_merged_device`` (the
    kernel's twin)."""
    sr = tsp.SparseRows(idx, val, idx.shape[0], device=CPU)
    if path == "device":
        out = tdm.merge_by_parents_device(
            sr, par, m, combine == "sum" and weight_by_size, combine,
            max_width)
        if norm:
            out = tsp.normalize_merged_device(out)
    elif combine == "sum":
        out = tsp.merge_rows_by_parents(sr, par, m, norm=norm,
                                        weight_by_size=weight_by_size,
                                        max_width=max_width)
    else:
        out = tsp.merge_rows_min_by_parents(sr, par, m, max_width=max_width)
    assert out.device == CPU
    return out.indices, out.values


def jax_merge(flag, idx, val, par, m, combine, **kw):
    sr = jsp.SparseRows(idx, val, idx.shape[0])
    fn = (jsp.merge_rows_by_parents if combine == "sum"
          else jsp.merge_rows_min_by_parents)
    out = with_flag(flag, fn, sr, par, m, **kw)
    return np.asarray(out.indices), np.asarray(out.values)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.int32) if a.dtype == np.float32 else a,
        b.view(np.int32) if b.dtype == np.float32 else b)


def assert_three_equal(combine, idx, val, par, m, **kw):
    got = port_merge("device", idx, val, par, m, combine, **kw)
    host = port_merge("host", idx, val, par, m, combine, **kw)
    jhost = jax_merge("0", idx, val, par, m, combine, **kw)
    for want in (host, jhost):
        assert got[0].shape == want[0].shape
        assert np.array_equal(got[0], want[0])
        assert same_bits(got[1], want[1])
    return got


@pytest.mark.parametrize("cap", [None, 11, 8], ids=["no_cap", "cap_11",
                                                    "cap_8"])
@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("weight_by_size", [False, True],
                         ids=["unweighted", "weighted"])
def test_sum_merge_bit_equal_to_both_host_paths(weight_by_size, norm, cap):
    """400 rows of up to 30 entries into 41 parents: equal bit for bit to
    both host paths; the caps 11 (not a power of two) and 8 bite."""
    idx, val = walk_rows(400, 30, seed=1)
    par = parents_of(400, 41, seed=2)
    got = assert_three_equal("sum", idx, val, par, 41,
                             weight_by_size=weight_by_size, norm=norm,
                             max_width=cap)
    if cap is not None:
        assert got[0].shape[1] == cap
    if norm:
        sums = got[1].sum(1)
        assert np.all(np.abs(sums[(got[0] >= 0).any(1)] - 1.0) <= 1e-5)


@pytest.mark.parametrize("cap", [None, 13, 16], ids=["no_cap", "cap_13",
                                                     "cap_16"])
def test_min_merge_bit_equal_to_both_host_paths(cap):
    """Distance rows min-merged into 53 parents, the caps 13 and 16 biting
    (rows keep their smallest values, ties to the lower column)."""
    idx, val = walk_rows(500, 40, seed=3)
    val = (val * 10.0).astype(np.float32)
    par = parents_of(500, 53, seed=4)
    got = assert_three_equal("min", idx, val, par, 53, max_width=cap)
    if cap is not None:
        assert got[0].shape[1] == cap


@pytest.mark.parametrize("combine", ["sum", "min"])
def test_single_parent_and_empty_input(combine):
    """Every row into one parent (one run a column, runs hundreds of
    entries long), and rows with no live entry at all."""
    idx, val = walk_rows(120, 16, seed=5)
    par = np.zeros(120, np.int64)
    kw = {"max_width": None}
    if combine == "sum":
        kw.update(weight_by_size=True, norm=True)
    assert_three_equal(combine, idx, val, par, 1, **kw)
    empty_i = np.full((6, 3), -1, np.int32)
    empty_v = np.zeros((6, 3), np.float32)
    got = assert_three_equal(combine, empty_i, empty_v,
                             np.array([0, 1, 2, 0, 1, 2]), 3)
    assert got[0].shape == (3, 1) and np.all(got[0] == -1)


@pytest.mark.parametrize("combine", ["sum", "min"])
@pytest.mark.parametrize("name", merge_rows.CASES)
def test_edge_cases_equal_the_host_and_both_jax_paths(name, combine):
    """tests/test_torch_merge_rows.py's cases (parents of one child, every
    row into one parent, half the rows into one parent whose columns span
    the others, a row whose columns map several times to one parent
    column, pads, zeros and -0.0 inside rows, more parent columns than a
    kernel window) through the port's device path (the kernel's twin):
    bit-equal to the port's host path, the JAX package's host path and its
    device path (its power-of-two pad columns stripped; no cap)."""
    idx, val, par, m = merge_rows.case(name)
    idx = idx.astype(np.int32)
    kw = {"weight_by_size": True} if combine == "sum" else {}
    got = assert_three_equal(combine, idx, val, par, m, **kw)
    dev_i, dev_v = jax_merge("1", idx, val, par, m, combine, **kw)
    w = got[0].shape[1]
    assert np.all(dev_i[:, w:] == -1) and np.all(dev_v[:, w:] == 0)
    assert np.array_equal(dev_i[:, :w], got[0])
    assert same_bits(dev_v[:, :w], got[1])


@pytest.mark.parametrize("combine,weight_by_size,norm", [
    ("sum", False, False), ("sum", True, False), ("sum", True, True),
    ("min", False, False)])
def test_against_the_jax_device_path(combine, weight_by_size, norm):
    """The JAX package's device path on JAX-CPU, its power-of-two pad
    columns stripped, no cap biting: the layout equal; the values equal
    without norm, and within rtol 2e-5 / atol 1e-7 with it (its row sums
    run over the padded width in XLA's order)."""
    idx, val = walk_rows(400, 30, seed=8)
    par = parents_of(400, 47, seed=9)
    kw = {} if combine == "min" else {"weight_by_size": weight_by_size,
                                      "norm": norm}
    got_i, got_v = port_merge("device", idx, val, par, 47, combine, **kw)
    dev_i, dev_v = jax_merge("1", idx, val, par, 47, combine, **kw)
    w = got_i.shape[1]
    assert dev_i.shape[1] >= w and dev_i.shape[1] & (dev_i.shape[1] - 1) == 0
    assert np.all(dev_i[:, w:] == -1) and np.all(dev_v[:, w:] == 0)
    assert np.array_equal(dev_i[:, :w], got_i)
    if norm:
        assert np.allclose(dev_v[:, :w], got_v, rtol=RTOL, atol=ATOL)
        assert not same_bits(dev_v[:, :w], got_v)
    else:
        assert same_bits(dev_v[:, :w], got_v)


def test_the_jax_paths_part_at_a_cap_not_a_power_of_two():
    """At cap 11 the JAX package's host path keeps each row's 11 largest
    sums and its device path 8 (the cap floored to a power of two); the
    port's device path keeps 11, the host's.  At cap 8 all agree."""
    idx, val = walk_rows(400, 30, seed=10)
    par = parents_of(400, 41, seed=11)
    host = jax_merge("0", idx, val, par, 41, "sum", max_width=11)
    dev = jax_merge("1", idx, val, par, 41, "sum", max_width=11)
    got = port_merge("device", idx, val, par, 41, "sum", max_width=11)
    assert host[0].shape[1] == 11 and dev[0].shape[1] == 8
    assert int((host[0] >= 0).sum()) > int((dev[0] >= 0).sum())
    assert np.array_equal(got[0], host[0]) and same_bits(got[1], host[1])
    host8 = jax_merge("0", idx, val, par, 41, "sum", max_width=8)
    dev8 = jax_merge("1", idx, val, par, 41, "sum", max_width=8)
    assert np.array_equal(host8[0], dev8[0])
    assert np.array_equal(dev8[0], dev[0])


def test_out_of_domain_ids_raise_on_the_device_path():
    """A parent or a live column outside the domain raises ValueError (the
    JAX package falls back to the host there; the port does not hide the
    device path)."""
    idx, val = walk_rows(50, 8, seed=12)
    sr = tsp.SparseRows(idx, val, 50, device=CPU)
    par = parents_of(50, 7, seed=13)
    bad = par.copy()
    bad[9] = 7
    with pytest.raises(ValueError, match="parent"):
        tdm.merge_by_parents_device(sr, bad, 7, True, "sum")
    bad[9] = -1
    with pytest.raises(ValueError, match="parent"):
        tdm.merge_by_parents_device(sr, bad, 7, False, "min")
    idx2 = idx.copy()
    idx2[10, 0], val[10, 0] = 50, 0.5
    with pytest.raises(ValueError, match="column"):
        tdm.merge_by_parents_device(tsp.SparseRows(idx2, val, 50, device=CPU),
                                    par, 7, False, "min")


def test_merge_runs_twin_folds_in_order():
    """The twin's sums are left-to-right float32 additions in ascending
    child, then slot (1e8 + 1 - 1e8 is 0 in that order, 1 in another), its
    minima the running ``(v < m) ? v : m``, and its merged weights the
    children's live counts summed, dividing the sums."""
    idx = torch.tensor([[0, -1, 3], [1, 0, -1], [2, -1, -1], [3, 2, -1]])
    val = torch.tensor([[1e8, 9.0, 1.0], [1.0, 0.0, 0.0], [-1e8, 0.0, 0.0],
                        [0.5, 3.0, 0.0]])
    sr = tsp.SparseRows(idx, val, 4)
    par = np.array([0, 0, 0, 1])      # parent 0 takes rows 0-2
    args = tdm.merge_kernel_inputs(sr, par, 2, False, "sum")
    assert args["order"].tolist() == [0, 1, 2, 3]
    assert args["child_start"].tolist() == [0, 3, 4]
    assert args["by_size"].tolist() == [0, 1]
    i, s, w = tdm.merge_runs(**args)
    assert i.tolist() == [[0, 1], [0, 1]] and w is None
    assert s.tolist() == [[0.0, 1.0], [3.0, 0.5]]   # 1e8 + 1 - 1e8 is 0
    _, m, _ = tdm.merge_runs(**{**args, "combine": "min"})
    assert m.tolist() == [[-1e8, 1.0], [3.0, 0.5]]
    _, s, w = tdm.merge_runs(**{**args, "weighted": True})
    assert w.tolist() == [4.0, 2.0]                  # live counts 2, 1, 1
    f = np.float32
    col0 = (f(f(1e8) * f(2)) + f(1.0)) + f(-1e8)
    assert s.tolist() == [[float(col0 / f(4)), 0.5], [3.0, 0.5]]
    with pytest.raises(ValueError, match="weights"):
        tdm.merge_runs(**{**args, "combine": "min", "weighted": True})
    with pytest.raises(TypeError):
        tdm.merge_runs(**{**args, "par": args["par"].long()})


def test_merged_weights_above_2_24_in_child_order():
    """Above 2^24 a float32 sum of child counts depends on its order: the
    weights are summed in ascending child order, as the host C++ does."""
    w = torch.tensor([2.0 ** 24, 1.0, 1.0, 1.0, 1.0], dtype=torch.float32)
    start = torch.tensor([0, 5], dtype=torch.int64)
    got = tdm._fold_segments(w, start, "sum")
    acc = np.float32(0.0)
    for x in w.numpy():
        acc = np.float32(acc + x)
    back = np.float32(0.0)
    for x in w.numpy()[::-1]:
        back = np.float32(back + x)
    assert got.tolist() == [float(acc)] and float(acc) == 2.0 ** 24
    assert float(back) == 2.0 ** 24 + 4


# ---------------------------------------------------------------------------
# the symmetrization
# ---------------------------------------------------------------------------

def knn_like(n: int, k: int, seed: int, hubs: int = 0):
    """A padded kNN graph: self first, -1 pads, distances on a grid of
    quarters (ties and duplicate edges with other distances); with `hubs`,
    a third of the edges point at the first `hubs` rows."""
    r = np.random.default_rng(seed)
    idx = r.integers(-1, n, (n, k)).astype(np.int32)
    if hubs:
        pick = r.random((n, k)) < 0.35
        idx = np.where(pick, r.integers(0, hubs, (n, k)), idx).astype(
            np.int32)
    idx[:, 0] = np.arange(n)
    dist = (r.integers(0, 40, (n, k)) / 4.0).astype(np.float32)
    dist[:, 0] = 0.0
    return idx, dist


@pytest.mark.parametrize("case", ["plain", "hub_cap"])
def test_symmetrize_bit_equal_to_native_and_both_jax_paths(case):
    """Min dedup of duplicate edges, rows by (distance, column) after the
    self edge; "hub_cap": rows past the cap keep their closest edges."""
    n, k = 300, 12
    idx, dist = knn_like(n, k, seed=14, hubs=6 if case == "hub_cap" else 0)
    cap = 24 if case == "hub_cap" else 0
    want = native.symmetrize(idx, dist, max_width=cap)
    got = [t.numpy() for t in tdm.symmetrize_graph_device(
        torch.from_numpy(idx), torch.from_numpy(dist), cap)]
    for a, b in zip(got, want):
        assert same_bits(a, b)
    if case == "hub_cap":
        assert got[0].shape[1] == cap and int(got[2].max()) == cap
    from sph_tpu import native as jnative
    jh = jnative.symmetrize(idx, dist, max_width=cap)
    jd = [np.asarray(x) for x in jdm.symmetrize_graph_device(idx, dist, cap)]
    w = got[0].shape[1]
    for a, b in zip(got, jh):
        assert same_bits(a, b)
    assert np.all(jd[0][:, w:] == -1) and np.all(np.isinf(jd[1][:, w:]))
    assert same_bits(jd[0][:, :w], got[0])
    assert same_bits(jd[1][:, :w], got[1])
    assert same_bits(jd[2], got[2])


def test_symmetrize_graph_dispatch_and_jax_host_graph(monkeypatch):
    """ops/graph.symmetrize_graph on the device path (a device named that
    ``on_card`` takes) gives the host path's PaddedGraph and the JAX
    package's."""
    idx, dist = knn_like(200, 10, seed=15)
    g = tgraph.KnnGraph(idx, dist)
    host = tgraph.symmetrize_graph(g, device="cpu")
    monkeypatch.setattr(tdm, "on_card", lambda device: True)
    dev = tgraph.symmetrize_graph(g, device="cpu")
    jg = with_flag("0", jgraph.symmetrize_graph, jgraph.KnnGraph(idx, dist))
    for got in (dev,):
        for want in (host, jg):
            assert same_bits(got.indices, np.asarray(want.indices))
            assert same_bits(got.distances, np.asarray(want.distances))
            assert same_bits(got.counts, np.asarray(want.counts))


def test_symmetrize_rejects_out_of_domain_ids():
    idx = np.array([[0, 9], [1, 0]], np.int32)
    dist = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="outside"):
        tdm.symmetrize_graph_device(torch.from_numpy(idx),
                                    torch.from_numpy(dist))
    with pytest.raises(ValueError):
        native.symmetrize(idx, dist)


# ---------------------------------------------------------------------------
# dispatch and whole hierarchies
# ---------------------------------------------------------------------------

def test_paths_follow_the_rows_device(monkeypatch):
    """Rows on a CUDA device take the device path, rows on the CPU the
    host C++ path, whatever SPH_DEVICE_RESTRUCT (the JAX package's switch)
    says: the merges, the normalization and symmetrize_graph (given a
    device) all ask ``device_merge.on_card``."""
    assert tdm.on_card(torch.device("cuda")) and tdm.on_card("cuda:0")
    assert not tdm.on_card(CPU) and not tdm.on_card("cpu")
    calls = []
    real, real_norm = tsp.merge_by_parents_device, tsp.normalize_merged_device
    real_sym = tdm.symmetrize_graph_device
    monkeypatch.setattr(tsp, "merge_by_parents_device",
                        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw))
    monkeypatch.setattr(tsp, "normalize_merged_device",
                        lambda *a: calls.append("norm") or real_norm(*a))
    monkeypatch.setattr(tdm, "symmetrize_graph_device",
                        lambda *a, **kw: calls.append("sym")
                        or real_sym(*a, **kw))
    idx, val = walk_rows(40, 6, seed=16)
    par = parents_of(40, 5, seed=17)
    g = tgraph.KnnGraph(*knn_like(30, 5, seed=18))

    def run_all():
        calls.clear()
        port_merge("host", idx, val, par, 5, "sum", norm=True)
        port_merge("host", idx, val, par, 5, "min")
        tgraph.symmetrize_graph(g, device="cpu")
        tgraph.symmetrize_graph(g)
        return list(calls)

    for flag in ("auto", "0", "1"):
        monkeypatch.setenv(FLAG, flag)
        assert run_all() == []
    monkeypatch.setattr(tdm, "on_card", lambda device: True)
    assert run_all() == ["sum", "norm", "min", "sym"]


def scene_hierarchy(P, handling, shape=(12, 10, 3), **kw):
    """NEIGH_WALKS on create_hyperspectral_scene(*shape, seed=3), min
    reduction 98, 20 walks of 8 steps, k = 16 (tests/test_torch_walk_
    variants.py's scene)."""
    img = create_hyperspectral_scene(*shape, seed=3)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    cs = P.ComponentSim.NEIGH_WALKS
    return P.ComputeHierarchy(**kw).init(
        data, shape[0], shape[1],
        ihs=P.ImageHierarchySettings(
            component_sim=cs, merge_multiple=False, use_percentile=False,
            max_dist=0.0, min_reduction=98.0,
            rw_handling=P.RandomWalkHandling(handling)),
        lss=P.LevelSimilaritiesSettings(component_sim=cs, ks=[16]),
        rws=P.RandomWalkSettings(num_random_walks=20, single_walk_length=8,
                                 random_seed=2),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=16,
                                       symmetric_neighbors=True,
                                       compute_connect_components=True,
                                       neighbor_connect_components=True))


@pytest.mark.parametrize("handling", ["merge_rw_only",
                                      "merge_data_new_walks"])
def test_hierarchy_with_the_device_path_forced(handling, monkeypatch):
    """The port's hierarchy with every merge and the symmetrization on the
    device path (forced on the CPU) gives the JAX package's levels and
    parents, and the port's host-path walk rows bit for bit; the device
    merges were taken."""
    jh = scene_hierarchy(J, handling).compute().image_hierarchy.hierarchy
    hh = scene_hierarchy(T, handling,
                         device="cpu").compute().image_hierarchy.hierarchy
    taken = []
    real = tsp.merge_by_parents_device
    monkeypatch.setattr(tsp, "merge_by_parents_device",
                        lambda *a, **kw: taken.append(a[4]) or real(*a, **kw))
    monkeypatch.setattr(tdm, "on_card", lambda device: True)
    th = scene_hierarchy(T, handling,
                         device="cpu").compute().image_hierarchy.hierarchy
    assert th.num_levels >= 3
    assert taken == ["min" if handling == "merge_data_new_walks" else "sum"
                     ] * (th.num_levels - 1)
    assert th.num_components == jh.num_components == hh.num_components
    for a, b in zip(th.parents, jh.parents):
        assert np.array_equal(a, b)
    for a, b in zip(th.random_walks, hh.random_walks):
        assert torch.equal(a.idx, b.idx)
        assert same_bits(a.values, b.values)
    if handling == "merge_data_new_walks":
        for a, b in zip(th.merged_data_graphs, hh.merged_data_graphs):
            assert torch.equal(a.idx, b.idx)
            assert same_bits(a.values, b.values)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def test_kernel_source_and_registry():
    """The source names what it replaces and what bounds it; the build
    registry holds its two C entry points (the merge and the layout)."""
    from sph_tpu_torch.ops import cuda_build
    with open(cuda_build.source("merge_runs")) as f:
        src = f.read()
    assert "sph_tpu/ops/device_merge.py::_merge_flatten" in src
    assert "Replaces no Pallas kernel" in src and "Bound: bytes" in src
    assert 'extern "C" int merge_runs_launch' in src
    assert 'extern "C" int merge_runs_pack_launch' in src
    for op in ("__fadd_rn", "__fmul_rn", "__fdiv_rn", "__match_any_sync"):
        assert op in src
    assert "merge_runs" in cuda_build.ALL_KERNELS
    # one argument type a parameter of each C prototype, the stream last
    protos = dict(re.findall(r'extern "C" int (\w+)_launch\(([^)]*)\)', src))
    assert set(protos) == {"merge_runs", "merge_runs_pack"}
    assert protos["merge_runs"].count(",") + 1 == len(
        cuda_build._SIGNATURES["merge_runs"]) == 21
    assert protos["merge_runs_pack"].count(",") + 1 == len(
        cuda_build._ENTRIES["merge_runs"]["merge_runs_pack"]) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_cuda_kernel_bit_equal_to_twin(combine):
    """merge_runs on the card against its twin on the same inputs, bit for
    bit, one launch; and a whole device merge on the card against the host
    C++ path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    idx, val = walk_rows(3000, 60, seed=18)
    par = parents_of(3000, 301, seed=19)
    sr = tsp.SparseRows(idx, val, 3000, device="cuda")
    before = tdm.merge_runs.launches
    weighted = combine == "sum"
    got = tdm.merge_by_parents_device(sr, par, 301, weighted, combine, 40)
    assert tdm.merge_runs.launches == before + 1
    want_i, want_v = port_merge("host", idx, val, par, 301, combine,
                                max_width=40)
    assert np.array_equal(got.indices, want_i)
    assert same_bits(got.values, want_v)
    args = tdm.merge_kernel_inputs(sr, par, 301, weighted, combine)
    k = tdm.merge_runs(**args)
    t = tdm.merge_runs_reference(**args)
    for a, b in zip(k, t):
        if a is None:
            assert b is None
        else:
            assert same_bits(a.cpu().numpy(), b.cpu().numpy())


# ---------------------------------------------------------------------------
# chip_smoke.py's merge checks, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEV", "cpu")
    keep = {}
    try:
        with mp.context() as on:
            on.setattr(tdm, "on_card", lambda device: True)
            with chip_smoke.merge_record(keep):
                scene_hierarchy(T, "merge_rw_new_walks",
                                device="cpu").compute()
        keep["summary"] = chip_smoke.merge_summary(keep, "widest")
        yield chip_smoke, keep
    finally:
        mp.undo()


def test_smoke_merge_record_lists_the_merges(smoke):
    chip_smoke, keep = smoke
    summary = keep["summary"]
    assert summary["merges"] == len(keep["calls"]) >= 2
    assert summary["sum_merges"] == summary["merges"]
    assert keep["entries"] == summary["most_entries"] > 0
    assert not summary["weight_above_2_24"]
    assert keep["knn"][0].shape == keep["knn"][1].shape
    assert keep["inputs"][4] == "sum" and keep["inputs"][3] is True


def test_smoke_check_merge_and_symmetrize_pass(smoke):
    chip_smoke, keep = smoke
    c = chip_smoke.check_merge(keep["inputs"], "rehearsal", calls=1,
                               twin_calls=1, path_calls=1)
    assert c["paths_bit_equal"] and c["kernel_outputs_differ"] == 0
    assert c["max_abs_err"] == 0.0 and not c["cap_bites"]
    assert c["entries"] == keep["entries"] and c["runs"] > 0
    assert c["bound_by"] == "bytes" and c["bound_ms"] > 0
    cut = int(c["untruncated_width"] * chip_smoke.MERGE_CAP_SHARE) | 1
    capped = chip_smoke.check_merge((*keep["inputs"][:5], cut), "cap",
                                    calls=1, twin_calls=1, path_calls=1)
    assert capped["cap_bites"] and capped["width_out"] == cut
    assert c["peak_bytes"] is None        # measured on the card only
    taken = []
    real = tdm.symmetrize_graph_device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdm, "on_card", lambda device: True)
        mp.setattr(tdm, "symmetrize_graph_device",
                   lambda *a, **kw: taken.append(1) or real(*a, **kw))
        s = chip_smoke.check_symmetrize(keep["knn"], "rehearsal", calls=1)
    assert s["bit_equal"] and s["n"] == keep["knn"][0].shape[0] and taken


def test_smoke_check_merge_catches_a_wrong_sum(smoke, monkeypatch):
    chip_smoke, keep = smoke
    real = tdm.merge_runs

    def off_by_one_ulp(*a, **kw):
        idx, val, w = real(*a, **kw)
        return idx, torch.nextafter(val, val + 1), w

    monkeypatch.setattr(tdm, "merge_runs", off_by_one_ulp)
    with pytest.raises(AssertionError, match="merge_runs"):
        chip_smoke.check_merge(keep["inputs"], "wrong", calls=1,
                               twin_calls=1, path_calls=1)


def test_merge_runs_bound_counts_each_byte_once():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    b = chip_smoke.merge_runs_bound(21025, 433, 5358, 610, True)
    nbytes = (12 * 21025 * 433 + 12 * 21025 + 16 * 5358 + 8
              + 12 * 5358 * 610 + 4 * 5358 + 4 * 5358)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    unweighted = chip_smoke.merge_runs_bound(21025, 433, 5358, 610, False)
    assert unweighted["bound_ms"] == pytest.approx(
        (nbytes - 4 * 5358) / 3.35e12 * 1e3)
