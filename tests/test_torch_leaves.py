"""The port's leaf modules against the JAX package's on the CPU: the data
generators, the math helpers, Hierarchy.children_of, the pipeline
counters and sparse-matrix statistics, CSR, the histogram, the printers,
the progress bar, the JavaScript checker, the profiling helpers and the
headless plots.

Tolerance: none.  Every output is equal (arrays bit for bit, strings and
logged lines character for character, PNG files byte for byte), except
the profiling helpers, whose torch meaning has no JAX twin to compare
with: they are checked for what they do.
"""

import io
import logging
import os

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.ops import csr as jcsr
from sph_tpu.ops import histogram as jhist
from sph_tpu.ops import math as jmath
from sph_tpu.utils import jscheck as jjs
from sph_tpu.utils import printers as jprint
from sph_tpu.utils import progress as jprog
from sph_tpu.utils import stats as jstats
from sph_tpu.utils import testdata as jdata
import sph_tpu_torch as T
from sph_tpu_torch.ops import csr as tcsr
from sph_tpu_torch.ops import histogram as thist
from sph_tpu_torch.ops import math as tmath
from sph_tpu_torch.utils import jscheck as tjs
from sph_tpu_torch.utils import printers as tprint
from sph_tpu_torch.utils import profiling as tprof
from sph_tpu_torch.utils import progress as tprog
from sph_tpu_torch.utils import stats as tstats
from sph_tpu_torch.utils import testdata as tdata
from test_torch_reference_native import use_reference_native

use_reference_native()

CPU = torch.device("cpu")


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name,kw", [
    ("create_random_data", dict(d=5, nb=40, seed=3)),
    ("create_swiss_roll", dict(n_samples=50, noise=0.1, random_state=2)),
    ("create_s_curve", dict(n_samples=50, noise=0.1, random_state=2)),
    ("create_3d_gaussians", dict(n_samples=51, noise=0.2, random_state=4,
                                 centers=np.array([[0, 0, 0], [5, 5, 5]]))),
    ("create_labeled_scene", dict(rows=12, cols=10, channels=7, seed=5)),
])
def test_generators_equal(name, kw):
    _equal(getattr(tdata, name)(**kw), getattr(jdata, name)(**kw))


def test_math_helpers_equal():
    rng = np.random.default_rng(0)
    x = rng.random(20).astype(np.float32) * 4 - 2
    _equal(tmath.invlin(np.abs(x)), jmath.invlin(np.abs(x)))
    _equal(tmath.sigmoid(x), jmath.sigmoid(x))
    d = rng.random((6, 9))
    assert tmath.symmetric_hausdorff(d) == jmath.symmetric_hausdorff(d)
    a, b = rng.random(30), rng.random(30)
    assert tmath.jaccard_coefficient(a, b) == jmath.jaccard_coefficient(a, b)
    assert tmath.jaccard_coefficient(np.zeros(3), np.zeros(3)) == 0.0


def _hierarchies():
    img = tdata.create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    kw = dict(ks=[8])
    out = []
    for pkg, dev in ((J, None), (T, "cpu")):
        data = pkg.scale(pkg.ImageStack.from_array(img).data,
                         pkg.Scaler.STANDARD)
        extra = {} if dev is None else {"device": dev}
        ch = pkg.ComputeHierarchy(**extra).init(
            data, 8, 8, ihs=pkg.ImageHierarchySettings(),
            lss=pkg.LevelSimilaritiesSettings(**kw),
            rws=pkg.RandomWalkSettings(num_random_walks=10,
                                       single_walk_length=5, random_seed=1),
            nns=pkg.NearestNeighborsSettings(num_nearest_neighbors=8))
        ch.compute_knn_graph()
        ch.compute_image_hierarchy()
        out.append(ch.image_hierarchy.hierarchy)
    return out


def test_children_of_equal():
    jh, th = _hierarchies()
    assert list(jh.num_components) == list(th.num_components)
    for level in range(1, th.num_levels):
        got, ref = th.children_of(level), jh.children_of(level)
        assert len(got) == len(ref) == th.num_components[level]
        for g, r in zip(got, ref):
            _equal(g, r)
    with pytest.raises(ValueError):
        th.children_of(0)


def _log_lines(logger_name, fn):
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger = logging.getLogger(logger_name)
    old = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        fn()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    return buf.getvalue()


def test_stats_and_counters_equal():
    from sph_tpu.utils.logging import get_logger as jget
    from sph_tpu_torch.utils.logging import get_logger as tget
    idx = np.array([[1, 2, -1], [0, -1, -1], [0, 1, 2]], np.int32)
    val = np.array([[0.5, 0.5, 0], [1, 0, 0], [0.2, 0.3, 0.5]], np.float32)
    jrows = J.SparseRows(idx, val, 3)
    trows = T.SparseRows(idx, val, 3, device="cpu")
    jline = _log_lines(jget().name, lambda: jstats.print_sparse_matrix_stats(
        jrows, "P"))
    tline = _log_lines(tget().name, lambda: tstats.print_sparse_matrix_stats(
        trows, "P"))
    assert tline == jline and "nnz 6 of 9" in tline
    assert (tstats.print_sparse_matrix_stats(trows)
            == tstats.SparseMatrixStats.of(trows))
    tc, jc = tstats.PipelineCounters(1, 2, 3, 4), jstats.PipelineCounters(
        1, 2, 3, 4)
    assert (_log_lines(tget().name, tc.report)
            == _log_lines(jget().name, jc.report))
    assert tstats.GLOBAL_COUNTERS == tstats.PipelineCounters()


def test_csr_equal():
    idx = np.array([[1, 3, -1], [0, -1, -1], [2, 3, 1]], np.int32)
    val = np.array([[0.5, 0.25, 0], [1, 0, 0], [0.2, 0.3, 0.5]], np.float32)
    jm = jcsr.MatrixCSR.from_sparse_rows(J.SparseRows(idx, val, 4))
    tm = tcsr.MatrixCSR.from_sparse_rows(T.SparseRows(idx, val, 4,
                                                      device="cpu"))
    for f in ("indptr", "indices", "data"):
        _equal(getattr(tm, f), getattr(jm, f))
    assert tm.shape == jm.shape and tm.nnz == jm.nnz
    back = tm.to_sparse_rows(device="cpu")
    _equal(back.indices, np.asarray(jm.to_sparse_rows().indices))
    _equal(back.values, np.asarray(jm.to_sparse_rows().values))
    tt, jt = tm.transpose(), jm.transpose()
    _equal(tt.indices, jt.indices)
    assert (tcsr.MatrixCSR.from_scipy(tm.to_scipy()).data == tm.data).all()


def test_histogram_equal():
    x = np.random.default_rng(1).standard_normal(500)
    for kw in ({}, {"lo": -1.0, "hi": 1.0}, {"lo": 2.0, "hi": 2.0}):
        h, r = thist.Histogram.create(x, 12, **kw), jhist.Histogram.create(
            x, 12, **kw)
        _equal(h.edges, r.edges)
        _equal(h.counts, r.counts)
        assert (h.underflow, h.overflow, h.total(), h.num_bins) == (
            r.underflow, r.overflow, r.total(), r.num_bins)
        _equal(h.bin_centers(), r.bin_centers())


def test_printers_equal(capsys):
    idx = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    dist = np.array([[0, 1.5], [0, 2.25], [0, 0.125]], np.float32)
    assert tprint.format_graph_dense(T.KnnGraph(idx, dist)) == (
        jprint.format_graph_dense(J.KnnGraph(idx, dist)))
    pg = T.KnnGraph(idx, dist).to_padded()
    assert tprint.format_graph_dense(pg) == jprint.format_graph_dense(
        J.KnnGraph(idx, dist).to_padded())
    rows = T.SparseRows(idx, dist, 3, device="cpu")
    assert tprint.format_sparse_dense(rows) == jprint.format_sparse_dense(
        J.SparseRows(idx, dist, 3))
    comps = np.array([0, 0, 1, 2, 2, 3, 10, 10, 3])
    assert tprint.format_image_components(comps, 3, 3) == (
        jprint.format_image_components(comps, 3, 3))
    _, th = _hierarchies()
    tprint.print_image_components(th, 1)
    out = capsys.readouterr().out
    jprint.print_image_components(th, 1)
    assert out == capsys.readouterr().out


def test_progress_bar_equal(monkeypatch):
    outs = []
    for mod in (tprog, jprog):
        buf = io.StringIO()
        monkeypatch.setattr(mod.sys, "stderr", buf)
        bar = mod.ProgressBar(4, width=10)
        bar.update(2)
        bar.update_by(1)
        bar.reset(8)
        bar.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "8/8" in outs[0]


def test_jscheck_equal():
    good = "const a = `x ${b + {c: 1}.c}`; if (/a\\/b/.test(s)) { f(); }"
    assert tjs.check_js_syntax(good) == jjs.check_js_syntax(good)
    for bad in ("function f() {", "let s = 'abc;", "a = (1 + 2]"):
        with pytest.raises(tjs.JsSyntaxError):
            tjs.check_js_syntax(bad)
        with pytest.raises(jjs.JsSyntaxError):
            jjs.check_js_syntax(bad)
    html = "<html><script>var a = 1;</script><script>f();</script></html>"
    assert tjs.extract_scripts(html) == jjs.extract_scripts(html)


def test_profiling_helpers(tmp_path):
    before = torch.are_deterministic_algorithms_enabled()
    with tprof.ground_truth_mode():
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == before
    with tprof.trace(str(tmp_path / "trace")) as d:
        with tprof.annotate("sph_region"):
            torch.ones(4).sum()
    files = os.listdir(d)
    assert files and any("sph_region" in open(os.path.join(d, f)).read()
                         for f in files)
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() is None


def test_vis_plots_equal(tmp_path):
    pytest.importorskip("matplotlib")
    from sph_tpu import vis as jvis
    from sph_tpu_torch import vis as tvis
    pos, col = tdata.create_swiss_roll(200, noise=0.02, random_state=0)
    idx, dist = T.ops.knn.knn_bruteforce(pos, 6, device="cpu")
    walks = T.ops.walks.do_random_walks(
        T.SparseRows(idx, np.where(idx >= 0, 1.0 / 6, 0).astype(np.float32),
                     200, device="cpu"),
        T.RandomWalkSettings(num_random_walks=5, single_walk_length=4))
    field = T.ops.shortest_path.shortest_path_fields(
        T.KnnGraph(idx, dist), np.array([0]), device="cpu")[0]
    _, th = _hierarchies()
    calls = [
        ("plot_embedding", (pos[:, :2], col), {}),
        ("plot_level_map", (np.arange(100) % 7, 10, 10), {}),
        ("plot_knn_edges", (pos, idx), {"colors": col}),
        ("plot_shortest_path", (pos, field, 0, 150,
                                np.array([], dtype=np.int64)), {}),
        ("plot_walk_mass", (pos, walks, 0), {}),
    ]
    for name, args, kw in calls:
        paths = [getattr(mod, name)(*args, path=str(tmp_path / f"{p}.png"),
                                    **kw)
                 for mod, p in ((tvis, "t_" + name), (jvis, "j_" + name))]
        data = [open(p, "rb").read() for p in paths]
        assert len(data[0]) > 1000 and data[0] == data[1], name
    tl = tvis.plot_hierarchy_levels(th, 8, 8, str(tmp_path / "tl"))
    jl = jvis.plot_hierarchy_levels(th, 8, 8, str(tmp_path / "jl"))
    assert [open(p, "rb").read() for p in tl] == [open(p, "rb").read()
                                                   for p in jl]
    out = tvis.demo(str(tmp_path / "demo"), n_samples=150, device="cpu")
    assert sorted(os.listdir(out)) == ["geodesic.png", "knn.png",
                                       "walks.png"]
