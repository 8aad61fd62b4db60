"""The checks of chip_smoke.py's 1M phase, rehearsed on the CPU at a small
size: the same helpers with their device switched to the CPU, where each
kernel's wrapper takes its twin.  They pass on a right result and raise on
a wrong one."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
import sph_tpu_torch as T  # noqa: E402
from sph_tpu_torch.ops import tsne_kernels  # noqa: E402
from test_torch_reference_native import use_reference_native  # noqa: E402

use_reference_native()

_spec = importlib.util.spec_from_file_location(
    "repulsion_readout", os.path.join(os.path.dirname(chip_smoke.__file__),
                                      "scripts", "repulsion_readout.py"))
readout = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(readout)


@pytest.fixture(scope="module")
def small_path():
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEV", "cpu")
    mp.setenv("SPH_TSNE_GRID", "0")
    mp.setenv("SPH_TSNE_DENSE_P", "0")
    mp.setenv("SPH_TSNE_P_WIDTH_CAP", "40")
    try:
        yield chip_smoke.large_path(tsne_kernels, 20, rows=30, cols=40)
    finally:
        mp.undo()


def test_large_path_runs_the_exact_tier_and_cuts_p(small_path):
    comp = small_path["ce"].last_computation
    assert comp.tier == "exact" and comp._p.width == 40
    assert set(small_path["seconds"]) == {"data", "knn", "p_and_set_up",
                                          "tsne", "kl"}
    assert small_path["launches"] == {"tsne_forces_dense": 0,
                                      "tsne_repulsion": 0,
                                      "tsne_attraction": 0,
                                      "grid_deposit": 0,
                                      "grid_interpolate": 0}  # CPU: twins
    assert small_path["emb"].shape == (1200, 2)
    assert np.all(np.isfinite(small_path["emb"]))


def test_p_checks_pass_and_catch_an_asymmetric_p(small_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    p = small_path["ce"].last_computation._p
    out = chip_smoke.p_checks(p, small_path["idx"], small_path["dist"], 5.0)
    assert out["p_rows_cut_to_width"] > 0 and out["p_asymmetry"] == 0
    assert 0.9 < out["p_mass_kept"] < 1.0
    bad = T.SparseRows(p.idx.clone(), p.val.clone(), p.num_cols)
    row = int(torch.nonzero(bad._live().sum(1) < bad.width)[0])
    bad.val[row, 0] *= 2.0
    with pytest.raises(AssertionError, match="symmetric"):
        chip_smoke.p_checks(bad, small_path["idx"], small_path["dist"], 5.0)


def test_knn_exactness_passes_and_catches_a_wrong_neighbour(small_path,
                                                             monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    data, idx = small_path["data"], small_path["idx"]
    rows = np.arange(0, 1200, 7)
    out = chip_smoke.knn_exactness(data, idx, 16, rows)
    assert out["rows"] == rows.size
    assert out["rows_outside_1e-6_rule"] <= out["rows_differing"]
    wrong = idx.copy()
    far = np.argmax(((data - data[0]) ** 2).sum(1))
    wrong[0, -1] = far
    with pytest.raises(AssertionError, match="float32 band"):
        chip_smoke.knn_exactness(data, wrong, 16, np.array([0]))


def test_repulsion_check_samples_rows_and_catches_a_wrong_result(
        monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    assert chip_smoke.sample_ranges(1_000_448) == [
        (0, 1024), (333141, 334165), (666282, 667306), (999424, 1000448)]
    y = torch.from_numpy(chip_smoke.repulsion_layout(3000, 4096, seed=1))
    out = chip_smoke.check_repulsion_kernel(y, 3000, sampled=True)
    assert out["rows_checked"] == 4096 and out["max_abs_err"] == 0
    assert out["bits_equal_across_calls"]
    assert out["plan"] == {"tile": 512, "splits": 24, "split_cols": 128,
                           "blocks": 144}
    real = tsne_kernels.tsne_repulsion_rows

    def off_by_a_bit(y, n):
        rep, zrow = real(y, n)
        return rep, zrow * (1 + 1e-4)

    monkeypatch.setattr(tsne_kernels, "tsne_repulsion_rows", off_by_a_bit)
    with pytest.raises(AssertionError, match="zrow"):
        chip_smoke.check_repulsion_kernel(y, 3000, sampled=True)


@pytest.fixture
def small_grid_default(monkeypatch):
    """The grid tier as the default from 100 points and no dense P, so the
    1M phases' helpers run their tiers at a small size; one torch thread
    for their many small ops."""
    from sph_tpu_torch.models import tsne as ttsne
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(ttsne, "GRID_MIN", 100)
    monkeypatch.setattr(ttsne, "DENSE_P_MAX", 100)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(threads)


def test_grid_path_takes_the_default_grid_tier_and_its_kls(
        small_grid_default):
    small_grid_default.setenv("SPH_TSNE_GRID", "0")     # unset by the path
    graph = chip_smoke.scene_graph(20, 30)
    out = chip_smoke.grid_path(tsne_kernels, graph, 60, kl_at=(0, 50),
                               keep_at=50)
    comp = out["ce"].last_computation
    assert comp.tier == "grid" and sorted(out["kls"]) == [0, 50, 60]
    # the KLs' launches counted apart (the twins launch nothing here)
    assert len(out["kl_launches"]) == 2
    assert out["iteration_launches"] == out["launches"]
    fullest = out["fullest_cell_by_grid"]
    assert [f[:2] for f in fullest] == [[50, 128], [60, 128]]
    assert all(1 <= f[2] <= 600 for f in fullest)
    assert out["kept_layout"]["grid"] == 128
    assert out["kept_layout"]["iteration"] == 50
    assert tuple(out["kept_layout"]["y"].shape) == tuple(comp._y.shape)
    assert comp.attr_packed                   # the default: the u16 table
    assert out["kls"][60] < out["kls"][0]
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0,
                               "tsne_attraction": 0, "grid_deposit": 0,
                               "grid_interpolate": 0}
    assert chip_smoke.grid_sizes(comp.grid_history) == [[0, 128]]
    gap = chip_smoke.z_gap(comp)
    assert gap["z_rel_gap"] <= chip_smoke.Z_GAP_MAX
    kl_exact_z = out["kls"][60] + gap["log_z_ratio"]
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    direct = float(tsne_kl_divergence(comp._y, comp._p_idx, comp._p_val,
                                      comp._n))
    assert abs(kl_exact_z - direct) <= 1e-5 * direct
    repeat = chip_smoke.scatter_repeatability(comp)
    assert repeat["bits_equal"] and repeat["z_rel_diff"] == 0


def test_grid_kernel_checks_pass_and_catch_a_wrong_result(monkeypatch):
    """check_grid_kernels on the CPU, where the wrappers take their twins:
    the lines pass; a deposit or an interpolation that moves one value, or
    writes a pad row, is caught."""
    from sph_tpu_torch.ops import tsne_grid as G
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    n, npad = 3000, 3072
    y = torch.from_numpy(chip_smoke.repulsion_layout(n, npad, seed=4))
    dep, interp = chip_smoke.check_grid_kernels(y, n, 128, "small", calls=0)
    assert dep["bits_equal_twin"] and interp["bits_equal_two_calls"]
    assert dep["max_abs_err"] == interp["max_abs_err"] == 0.0
    assert dep["points_in_fullest_cell"] == chip_smoke.fullest_cell(y, n,
                                                                    128)
    assert dep["bytes"] == chip_smoke.grid_deposit_bound(n, 128)["bytes"]
    assert interp["bytes"] == chip_smoke.grid_interpolate_bound(
        n, npad, 128)["bytes"]
    for line in (dep, interp):
        line.update(ms=2.0, plain_ms=4.0, share_of_bound=0.5)
    entry = chip_smoke.grid_kernel_line(
        "grid_interpolate", [(dep, interp)],
        [{"path": "large_grid", "launches": 7}])
    assert entry["launches"] == 7 and entry["ms"] == 2.0
    assert entry["source"] == "sph_tpu_torch/csrc/grid_interpolate.cu"
    assert entry["replaces"].startswith("sph_tpu/ops/tsne_grid.py:149")
    assert entry["library_ms"] is None and entry["shape"] == [n, 128]
    real_dep, real_interp = G.grid_deposit, G.grid_interpolate

    def moved_deposit(*a, **kw):
        out = real_dep(*a, **kw).clone()
        out[1, 64, 64] += 1e-3
        return out

    def pad_interpolate(*a, **kw):
        rep, z = real_interp(*a, **kw)
        rep = rep.clone()
        rep[-1] = 1.0
        return rep, z

    for name, fake, match in (("grid_deposit", moved_deposit, "twin"),
                              ("grid_interpolate", pad_interpolate,
                               "twin")):
        with monkeypatch.context() as m:
            m.setattr(G, name, fake)
            with pytest.raises(AssertionError, match=match):
                chip_smoke.check_grid_kernels(y, n, 128, "small", calls=0)


def test_grid_launch_gate_counts_the_kls_apart():
    kl = {"tsne_forces_dense": 0, "tsne_repulsion": 0, "tsne_attraction": 0,
          "grid_deposit": 1, "grid_interpolate": 1}
    total = {**kl, "tsne_attraction": 100, "grid_deposit": 104,
             "grid_interpolate": 104}
    it = chip_smoke.grid_iteration_launches(total, [kl] * 3)
    assert it == {**kl, "tsne_attraction": 100, "grid_deposit": 100,
                  "grid_interpolate": 100}
    chip_smoke.grid_launch_gate(it, [kl] * 3, 100)
    for bad in ({**it, "tsne_repulsion": 1}, {**it, "grid_deposit": 99},
                {**it, "grid_interpolate": 0}):
        with pytest.raises(AssertionError, match="iterations launched"):
            chip_smoke.grid_launch_gate(bad, [kl] * 3, 100)
    with pytest.raises(AssertionError, match="a KL launched"):
        chip_smoke.grid_launch_gate(it, [{**kl, "tsne_repulsion": 1}], 100)
    with pytest.raises(AssertionError, match="KLs launched differently"):
        chip_smoke.grid_iteration_launches(total, [kl, {**kl,
                                                        "grid_deposit": 2}])


def test_grid_kernel_bounds_count_each_input_and_output_once():
    dep = chip_smoke.grid_deposit_bound(10**6, 256)
    assert dep["bytes"] == 8 * 10**6 + 16 + 12 * 256**2
    assert dep["flops"] == 166 * 10**6 and dep["bound_by"] == "bytes"
    assert abs(dep["bound_ms"] - dep["bytes"] / 3.35e12 * 1e3) < 1e-12
    interp = chip_smoke.grid_interpolate_bound(10**6, 1_000_448, 256)
    assert interp["bytes"] == (16 * 256**2 + 8 * 10**6 + 16
                               + 8 * 1_000_448 + 4)
    assert interp["flops"] == 206 * 10**6 and interp["bound_by"] == "bytes"


def test_grid_vs_exact_scores_both_layouts_under_one_p(small_grid_default):
    out = chip_smoke.grid_vs_exact(tsne_kernels, rows=16, cols=20, iters=30)
    assert out["grid"]["tier"] == "grid" and out["exact"]["tier"] == "exact"
    assert out["n"] == 320 and out["exact"]["launches"]["tsne_repulsion"] == 0
    assert out["grid"]["p_width"] == out["exact"]["p_width"]
    assert out["kl_ratio"] == (out["grid"]["kl_scored"]
                               / out["exact"]["kl_scored"])
    # the exact tier's own KL is the one scored under its own P
    assert abs(out["exact"]["kl_scored"] - out["exact"]["kl_own"]) <= (
        1e-6 * out["exact"]["kl_own"])


def test_kernel_bounds_from_the_shapes():
    dense = chip_smoke.forces_bound(5358, 6144)
    assert dense["bound_by"] == "bytes"
    # P's 5358 x 5358 live block, not its 6144^2 pads included
    assert abs(dense["bound_ms"] - 4 * 5358 ** 2 / 3.35e12 * 1e3) < 1e-4
    assert dense["bound_ms"] < 0.8 * 4 * 6144 ** 2 / 3.35e12 * 1e3
    rep = chip_smoke.repulsion_bound(10 ** 6, 1_000_448)
    assert rep["bound_by"] == "operations"
    assert abs(rep["bound_ms"] - 14e12 / 67e12 * 1e3) < 1e-6


def test_repulsion_floors_at_1m():
    """The SFU floor (one reciprocal a pair, 16 a clock on each of 132 SMs
    at 1.98 GHz) and the issue floor at 9 slots a pair, as the kernel's
    source note states them: 0.239 s and 0.27 s; both scale with the
    card's SM count and clock."""
    assert abs(chip_smoke.sfu_floor_ms(10 ** 6, 132, 1.98e9) - 239.13) < 0.01
    assert abs(readout.issue_floor_ms(10 ** 6, 9.0, 132, 1.98e9)
               - 269.03) < 0.01
    assert abs(chip_smoke.sfu_floor_ms(10 ** 6, 66, 0.99e9)
               - 4 * 239.13) < 0.04


# the pair loop of a kernel as cuobjdump -sass prints it, cut short: an
# outer loop (0x0040-0x0110) around an inner one (0x0050-0x00e0)
SASS = """
		Function : _Z15repulsion_unitsILi4EEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   NOP ;
        /*0040*/                   LDS.128 R4, [R2] ;
        /*0050*/                   FADD R8, R5, -R6 ;
        /*0060*/                   FFMA R9, R8, R8, 1 ;
        /*0070*/                   MUFU.RCP R10, R9 ;
        /*0080*/                   FMUL R11, R10, R10 ;
        /*0090*/                   MUFU.RCP R12, R9 ;
        /*00a0*/                   NOP ;
        /*00b0*/                   FFMA R13, R11, R8, R13 ;
        /*00c0*/                   IADD3 R2, R2, 0x10, RZ ;
        /*00d0*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*00e0*/               @P0 BRA 0x50 ;
        /*00f0*/                   FADD R14, R14, R13 ;
        /*0100*/              @!P1 BRA 0x120 ;
        /*0110*/                   BRA 0x40 ;
        /*0120*/                   EXIT ;
        /*0130*/                   BRA 0x130;
		Function : _Z13reduce_splitsv
        /*0000*/                   FADD R1, R2, R3 ;
        /*0010*/                   BRA 0x0;
"""


def test_sass_loops_counts_the_innermost_reciprocal_loop():
    loops = readout.sass_loops(SASS)
    assert loops == {"_Z15repulsion_unitsILi4EEvv": [
        {"instructions": 9, "rcp": 2, "slots_per_pair": 4.5}]}


def test_resource_usage_reads_each_function():
    text = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z13reduce_splitsPKfiiiP6float2Pf:
  REG:16 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0
 Function _Z15repulsion_unitsPK6float2iiiiPfPS_S2_:
  REG:96 STACK:0 SHARED:16384 LOCAL:0 CONSTANT[0]:408 TEXTURE:0 SURFACE:0
"""
    assert readout.resource_usage(text) == {
        "_Z13reduce_splitsPKfiiiP6float2Pf": {
            "registers": 16, "stack": 0, "shared_bytes": 0,
            "local_bytes": 0},
        "_Z15repulsion_unitsPK6float2iiiiPfPS_S2_": {
            "registers": 96, "stack": 0, "shared_bytes": 16384,
            "local_bytes": 0}}


def test_trustworthiness_matches_sklearn():
    from sklearn.manifold import trustworthiness
    rng = np.random.default_rng(0)
    x = rng.standard_normal((700, 12))
    emb = x[:, :2] + 0.3 * rng.standard_normal((700, 2))
    for k in (5, 10):
        assert abs(chip_smoke.trustworthiness(x, emb, k, block=128)
                   - trustworthiness(x, emb, n_neighbors=k)) <= 1e-12


def test_pines_umap_phase_on_the_fingerprint(monkeypatch):
    """The UMAP phase's helper on the 8x8 fingerprint's level 1 (19
    components, the dense tier)."""
    from sph_tpu_torch.utils.testdata import create_checker_image
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    img = create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.STANDARD)
    ch = T.ComputeHierarchy(device="cpu").init(
        data, 8, 8, ihs=T.ImageHierarchySettings(),
        lss=T.LevelSimilaritiesSettings(ks=[8]),
        rws=T.RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                                 random_seed=1),
        nns=T.NearestNeighborsSettings(num_nearest_neighbors=8)).compute()
    out = chip_smoke.pines_umap(ch, data, epochs=50)
    assert out["n"] == 19 and out["tier"] == "dense" and out["epochs"] == 50
    assert set(out["seconds"]) == {"set_up", "epochs"}
    assert 0.5 < out["trustworthiness_k10"] <= 1.0
    means = chip_smoke.component_means(
        data, ch.image_hierarchy.hierarchy.pixel_components[1], 19)
    assert means.shape == (19, 4)


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(chip_smoke.__file__), *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recall_counts_as_bench_recall():
    """recall_at_k gives bench_recall.py's intersect1d count in blocks of
    rows; overlap_recall counts a neighbour by its distance against the
    exact k-th, so a swap among tied components costs nothing and a far
    neighbour does."""
    rng = np.random.default_rng(0)
    truth = np.stack([rng.choice(500, 16, replace=False) for _ in range(300)])
    idx = np.stack([np.concatenate([t[:8], rng.choice(
        np.setdiff1d(np.arange(500), t[:8]), 8, replace=False)])
        for t in truth])
    want = sum(len(np.intersect1d(a, b)) for a, b in zip(idx, truth))
    assert chip_smoke.recall_at_k(idx, truth, block=64) == want / truth.size
    ids = np.array([[0, 5, 7, -1], [1, 2, 9, 4]])
    dists = np.array([[0.0, 0.5, 0.5, np.inf], [0.0, 0.2, 0.6, 0.9]],
                     np.float32)
    kth = np.array([0.5, 0.6], np.float32)
    assert chip_smoke.overlap_recall(ids, dists, kth) == 6 / 8


def test_clustered_points_are_bench_recalls_data():
    bench = _load_script("bench_recall", ("benchmarks", "bench_recall.py"))
    from sph_tpu_torch.utils.testdata import create_clustered_points
    assert np.array_equal(create_clustered_points(5000, 24, seed=0),
                          bench.make_data("clustered", 5000, 24, seed=0))


def test_graph_invariants_catch_a_hole_and_a_disorder():
    idx = np.array([[0, 1, 2], [1, 0, 2]])
    dist = np.array([[0.0, 1.0, 2.0], [0.0, 1.0, 1.5]], np.float32)
    chip_smoke.graph_invariants(idx, dist, "ok")
    with pytest.raises(AssertionError, match="-1"):
        chip_smoke.graph_invariants(np.array([[0, -1, 2], [1, 0, 2]]), dist,
                                    "hole")
    with pytest.raises(AssertionError, match="ascending"):
        chip_smoke.graph_invariants(idx, dist[:, ::-1].copy(), "disorder")


def test_ivf_recall_phase_small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    out = chip_smoke.ivf_recall(n=3000, d=16, queries=64)
    for index in chip_smoke.IVF_RECALL_GATES:
        run = out[index]
        assert 0.9 <= run["recall"] <= 1.0
        assert run["nlist"] == 100 and run["nprobe"] == 10
        assert run["seg"] == 256 and run["refilled_rows"] == 0
        assert run["peak_memory_bytes"] == "not measured"
    assert out["hnsw_ivfpq"]["shortlist"] == 512


def test_large_ivf_phase_small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    graph = chip_smoke.scene_graph(30, 40)
    out = chip_smoke.large_ivf(graph)
    assert out["index"] == "brute_force" or out["bits_equal_across_runs"]
    assert out["bits_equal_across_runs"] and out["n"] == 1200
    assert 0.9 <= out["recall_all_rows"] <= 1.0


def test_scene_overlap_phase_small(monkeypatch):
    """The phase at 24 x 24 with the threshold at 60 components, so level
    1 takes the approximate component kNN: its recall against the exact
    one, P's checks, a falling KL; no kernel launches on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "60")
    out = chip_smoke.scene_overlap(tsne_kernels, side=24, iters=100,
                                   sampled=100)
    assert out["levels"][1] > 60 and out["knn_tiers"][1] == "approximate"
    assert 0.5 < out["level_1_component_knn_recall"] <= 1.0
    assert out["stage1_recall_all_rows"] == 1.0     # 576 points: exact
    assert out["p"]["conditional_row_sum_err"] <= 1e-3
    assert out["tsne_tier"] == "dense" and sorted(out["kl_at"]) == [
        "0", "100", "50"]
    assert out["kl_at"]["100"] < out["kl_at"]["0"]
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0,
                               "tsne_attraction": 0, "grid_deposit": 0,
                               "grid_interpolate": 0}


def test_reference_kth_distances_equal_the_exact_kernel():
    """scripts/scene_overlap_reference.py takes the exact NEIGH_OVERLAP
    k-th distances from a scipy sparse product; they equal the port's
    exact knn_neighbor_overlap's (itself equal to the JAX package's)."""
    ref = _load_script("scene_overlap_reference",
                       ("scripts", "scene_overlap_reference.py"))
    from sph_tpu_torch.ops.component_knn import knn_neighbor_overlap
    from sph_tpu_torch.ops.similarities import build_union_neighborhoods
    rng = np.random.default_rng(2)
    n, c = 2000, 500
    comp = np.concatenate([np.arange(c), rng.integers(0, c, n - c)])
    knn = (rng.integers(0, n, (40, 10))[comp % 40]
           + rng.integers(0, 25, (n, 10))) % n
    unions = build_union_neighborhoods(knn, comp, c, device="cpu")
    for k in (5, 40):
        _, d = knn_neighbor_overlap(unions, k)
        assert np.array_equal(ref.overlap_kth_distances(
            unions.indices, unions.num_cols, k), d[:, k - 1])


def test_reference_pair_metric_equals_the_jax_package():
    """The sparse-product pair metric that scripts/scene_overlap_reference.py
    swaps into the JAX package's stage 3 gives the JAX package's
    neighbor_overlap_distance bit for bit, on pairs with and without shared
    members and with an empty row."""
    from sph_tpu.ops.similarities import (build_union_neighborhoods,
                                          neighbor_overlap_distance)
    ref = _load_script("scene_overlap_reference",
                       ("scripts", "scene_overlap_reference.py"))
    rng = np.random.default_rng(3)
    n, c = 2000, 400
    comp = np.concatenate([np.arange(c), rng.integers(0, c, n - c)])
    knn = (rng.integers(0, n, (30, 10))[comp % 30]
           + rng.integers(0, 25, (n, 10))) % n
    knn[comp == 7] = -1
    unions = build_union_neighborhoods(knn, comp, c)
    a, b = rng.integers(0, c, 20000), rng.integers(0, c, 20000)
    a[:5] = 7
    assert np.array_equal(
        ref.overlap_distance_by_sparse_product(unions, a, b, chunk=4096),
        neighbor_overlap_distance(unions, a, b))


@pytest.fixture(scope="module")
def small_salinas():
    """The salinas_euclid phase at 24 x 20 x 16 with the approximate
    threshold at 60 components, so level 1 (118 components) takes the
    approximate Hausdorff kNN and the levels below it the exact one."""
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEV", "cpu")
    mp.setenv("SPH_APPROX_KNN_THRESHOLD", "60")
    try:
        yield chip_smoke.salinas_euclid(tsne_kernels, shape=(24, 20, 16),
                                        iters=100, umap_epochs=30,
                                        sampled=100, exact_rows=16)
    finally:
        mp.undo()


def test_salinas_euclid_phase_small(small_salinas):
    out = small_salinas
    levels = out["levels"]
    assert levels[0] == 480 and levels[1] > 60 and len(levels) >= 4
    assert out["knn_tiers"][1] == "approximate"
    assert all(out["knn_tiers"][lv] == "exact" for lv in range(2, len(levels)))
    assert out["level_1_samples"] == out["largest_set_by_level"][1]
    assert 0.5 < out["level_1_component_knn_recall"] <= 1.0
    assert out["level_2_exactness"]["rows"] == 16
    assert out["level_2_exactness"]["max_dist2_err_over_band"] <= 1.0
    assert sorted(out["tsne"]) == [1, 2, 3] and sorted(out["p"]) == [1, 2, 3]
    for level, run in out["tsne"].items():
        assert run["n"] == levels[level] and run["tier"] == "dense"
        assert run["init"] == ("random disk" if level == 1
                               else "average_position_of_children")
        assert run["embedding_finite"] and sorted(run["kl_at"]) == ["0", "100"]
        assert out["p"][level]["p_asymmetry"] == 0
        assert out["p"][level]["conditional_row_sum_err"] <= 1e-3
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0,
                               "tsne_attraction": 0, "grid_deposit": 0,
                               "grid_interpolate": 0}
    assert out["umap"]["n"] == levels[1] and out["umap"]["embedding_finite"]
    assert set(out["seconds"]) >= {"stage1_knn", "stage2_hierarchy",
                                   "stage3_level_similarities"}
    assert out["seconds_by_part"]["stage2_hierarchy"]
    assert out["peak_memory_bytes"]["stage1_knn"] == "not measured"


def test_salinas_gates_pass_and_catch_each_fault(small_salinas):
    """The gates on the small run, its kernel counts set as the card's
    would be and the record made from the run itself; each fault raises."""
    import copy
    ok = copy.deepcopy(small_salinas)
    for run in ok["tsne"].values():
        run["launches"] = {"tsne_forces_dense": 100, "tsne_repulsion": 1}
        run["kl_at"] = {"0": 2.0, "100": 1.0}
    ref = {"size": ok["size"], "levels": list(ok["levels"]),
           "approx_knn_threshold": 60,
           "level_1_component_knn_recall": ok["level_1_component_knn_recall"]}
    chip_smoke.salinas_gates(ok, ref)

    def broken(change):
        bad = copy.deepcopy(ok)
        change(bad)
        return bad

    faults = {
        "within 2 %": lambda s: s["levels"].__setitem__(1, 130),
        "levels vs": lambda s: s["levels"].extend([1, 1]),
        "took the exact": lambda s: s["knn_tiers"].__setitem__(1, "exact"),
        "recall": lambda s: s.__setitem__(
            "level_1_component_knn_recall",
            ref["level_1_component_knn_recall"] - 0.02),
        "float64": lambda s: s.__setitem__("level_2_exactness", None),
        "falling": lambda s: s["tsne"][2]["kl_at"].__setitem__("100", 3.0),
        "launched": lambda s: s["tsne"][1]["launches"].__setitem__(
            "tsne_forces_dense", 99),
        "Z did not": lambda s: s["tsne"][3]["launches"].__setitem__(
            "tsne_repulsion", 0),
    }
    for match, change in faults.items():
        with pytest.raises(AssertionError, match=match):
            chip_smoke.salinas_gates(broken(change), ref)


def test_hausdorff_exactness_passes_and_catches_a_wrong_neighbour(
        monkeypatch):
    from sph_tpu_torch.ops.component_knn import knn_hausdorff
    from sph_tpu_torch.ops.similarities import (component_hausdorff,
                                                sample_represented)
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    rng = np.random.default_rng(6)
    data = (rng.standard_normal((900, 24)) * 3).astype(np.float32)
    comp = np.concatenate([np.arange(80), rng.integers(0, 80, 820)])
    reps = [np.nonzero(comp == c)[0] for c in range(80)]
    rep = sample_represented(reps, np.arange(80), 9, seed=3)
    ids, dists = knn_hausdorff(data, rep, 10, device="cpu")
    rows = np.arange(0, 80, 3)
    out = chip_smoke.hausdorff_exactness(data, rep, ids, dists, rows)
    assert out["rows"] == rows.size and out["max_swap_over_band"] <= 1.0
    assert out["max_dist2_err_over_band"] <= 1.0
    kth = chip_smoke.hausdorff_kth(data, rep, rows, 10)
    assert np.allclose(kth, dists[rows, -1], rtol=1e-5)
    wrong = ids.copy()
    wrong[0, -1] = np.argmax(component_hausdorff(
        data, rep, np.zeros(80, np.int64), np.arange(80), device="cpu"))
    with pytest.raises(AssertionError, match="float32 band"):
        chip_smoke.hausdorff_exactness(data, rep, wrong, dists, [0])


def test_reference_chunked_pair_fn_equals_the_whole_call():
    """scripts/salinas_euclid_reference.py evaluates the JAX package's
    Hausdorff pair function on chunks of pairs: the same values as one
    call over all pairs, E not a multiple of the chunk."""
    from sph_tpu.ops.similarities import (hausdorff_point_set_distance,
                                          sample_represented)
    ref = _load_script("salinas_euclid_reference",
                       ("scripts", "salinas_euclid_reference.py"))
    rng = np.random.default_rng(4)
    data = (rng.standard_normal((600, 20)) * 2).astype(np.float32)
    comp = np.concatenate([np.arange(50), rng.integers(0, 12, 550)])
    reps = [np.nonzero(comp == c)[0] for c in range(50)]
    rep = sample_represented(reps, np.arange(50), 7, seed=2)
    a, b = rng.integers(0, 50, 1000), rng.integers(0, 50, 1000)

    def pair(a, b):
        return hausdorff_point_set_distance(data, rep[a], rep[b])

    got = ref.chunked_pair_fn(pair, threads=3, chunk=96)(a, b)
    assert np.array_equal(got, pair(a, b))
    assert ref.chunked_pair_fn(pair, 2, 96)(a[:0], b[:0]).shape == (0,)


def test_reference_stage1_knn_equals_the_jax_package():
    """scripts/salinas_euclid_reference.py gives the JAX package's
    NearestNeighbors the port's CPU exact kNN: the same ids and distances
    as the JAX package's own, on the record's band count and k."""
    from sph_tpu.ops.knn import compute_knn
    from sph_tpu.settings import KnnIndex
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    ref = _load_script("salinas_euclid_reference",
                       ("scripts", "salinas_euclid_reference.py"))
    data = create_hyperspectral_scene(24, 30, 224, seed=13).reshape(
        -1, 224).astype(np.float32)
    swapped = ref.port_exact_knn(compute_knn)
    for index in (KnnIndex.FLAT, KnnIndex.BRUTE_FORCE):
        ij, dj = compute_knn(data, 31, index)
        it, dt = swapped(data, 31, index)
        assert np.array_equal(it, ij) and np.array_equal(dt, dj)
        assert it.dtype == ij.dtype and dt.dtype == dj.dtype


def test_deep_levels_gate_holds_scene_overlaps_levels():
    """The card's levels (PERF.md) pass against the JAX-CPU record; a
    level 2 off by more than 10 % fails; levels below 100 components are
    not gated."""
    record = [65536, 16174, 2040, 197, 20, 5, 2, 1]
    chip_smoke.deep_levels_gate([65536, 16198, 1984, 182, 21, 5, 1], record,
                                "scene_overlap")
    chip_smoke.deep_levels_gate([65536, 16174, 2040, 197, 40, 9], record, "s")
    with pytest.raises(AssertionError, match="level 2"):
        chip_smoke.deep_levels_gate([65536, 16174, 1800, 197], record, "s")
    with pytest.raises(AssertionError, match="level 3"):
        chip_smoke.deep_levels_gate([65536, 16174, 2040, 220], record, "s")


def _geo_scene_graph():
    from test_torch_geo import scene_graph
    return scene_graph(side=20, k=10)[0]


def test_path_hops_counts_the_tree_edges():
    pred = np.array([[-9999, 0, 1, 1, -9999], [1, -9999, 1, 2, 3]])
    assert np.array_equal(chip_smoke.path_hops(pred),
                          [[0, 1, 2, 2, 0], [1, 0, 1, 2, 3]])


def test_geodesic_exactness_passes_and_catches_a_wrong_value():
    """The port's fields on a scene graph with 13 weak components pass
    against float64 Dijkstra; one value moved by 1e-5 relative, and one
    unreachable node given a distance, are caught."""
    from sph_tpu_torch.ops import shortest_path as tsp
    g = _geo_scene_graph()
    src = np.array([0, 57, 210, 399])
    fields = tsp.shortest_path_fields(g, src, device="cpu")
    out = chip_smoke.geodesic_exactness(g, src, fields)
    assert out["sources"] == 4 and 0 < out["reachable_fraction"] < 1
    assert out["max_err_over_bound"] <= 1.0 and out["max_hops"] >= 3
    far = np.nanargmax(np.where(np.isfinite(fields[1]), fields[1], np.nan))
    wrong = fields.copy()
    wrong[1, far] *= np.float32(1 + 1e-5)
    with pytest.raises(AssertionError, match="off float64 Dijkstra"):
        chip_smoke.geodesic_exactness(g, src, wrong)
    wrong = fields.copy()
    wrong[2, np.nonzero(~np.isfinite(fields[2]))[0][0]] = 1.0
    with pytest.raises(AssertionError, match="reachable in one"):
        chip_smoke.geodesic_exactness(g, src, wrong)


def test_sketch_fidelity_passes_and_catches_a_wrong_value():
    """Ten sources of five pairs each: a monotone distortion of the exact
    values passes both gates; one wrong value (a source's nearest pair made
    the farthest) drops the argmin agreement to 0.9 and is caught."""
    rng = np.random.default_rng(0)
    a = np.repeat(np.arange(10), 5)
    exact = rng.random(50).astype(np.float32) + 0.1
    exact[7] = np.finfo(np.float32).max                # one cross pair
    sketch = exact * np.float32(1.001)
    sketch[7] = np.finfo(np.float32).max
    fid = chip_smoke.sketch_fidelity(sketch, exact, a)
    assert fid["spearman"] > 1 - 1e-12 and fid["argmin_agreement"] == 1.0
    assert fid["finite_pairs"] == 49 and fid["argmin_sources"] == 10
    chip_smoke.sketch_fidelity_gate(fid)
    wrong = sketch.copy()
    first = 15 + int(np.argmin(exact[15:20]))
    wrong[first] = 5.0
    bad = chip_smoke.sketch_fidelity(wrong, exact, a)
    assert bad["argmin_agreement"] == 0.9
    with pytest.raises(AssertionError, match="sketch fidelity"):
        chip_smoke.sketch_fidelity_gate(bad)


def test_met_sketch_fidelity_bounds_and_fallback():
    """Pairs where the sketch meets: values at or a rounding below the
    exact ones pass; one a little further below the bound, and a met value
    the path changed, are each caught; pairs that do not meet are left
    out."""
    rng = np.random.default_rng(1)
    a = np.repeat(np.arange(40), 4)
    b = a + 1 + np.tile(np.arange(4), 40)
    exact = (rng.random(160) + 0.5).astype(np.float32)
    raw = exact * np.float32(1.01)
    raw[3] = exact[3] * np.float32(1 - 2.0 ** -23)     # one rounding below
    raw[10:30] = np.inf                                # no meet
    path = np.where(np.isfinite(raw), raw, np.float32(0.7))
    met = chip_smoke.met_sketch_fidelity(raw, path, exact, a, b)
    assert met["met_pairs"] == 140 and met["pairs"] == 160
    assert met["below_bound"] == 0 and met["path_equals_sketch"]
    assert met["spearman"] > 0.999 and met["argmin_agreement"] == 1.0
    assert met["min_ratio"] < 1.0
    chip_smoke.met_sketch_gate(met)
    low = raw.copy()
    low[5] = exact[5] * np.float32(1 - 2.0 ** -16)
    bad = chip_smoke.met_sketch_fidelity(low, np.where(
        np.isfinite(low), low, 0.7), exact, a, b)
    assert bad["below_bound"] == 1
    with pytest.raises(AssertionError, match="below the exact"):
        chip_smoke.met_sketch_gate(bad)
    changed = path.copy()
    changed[40] = 0.7
    bad = chip_smoke.met_sketch_fidelity(raw, changed, exact, a, b)
    with pytest.raises(AssertionError, match="changed a met"):
        chip_smoke.met_sketch_gate(bad)


def test_geo_log_summary_groups_batches_by_call():
    log = [{"what": "call", "fn": "geodesic_component_distances",
            "level": 0},
           {"what": "level0_pairs", "pairs": 9, "unresolved_pairs": 4,
            "unique_sources": 5},
           {"what": "pair_values", "fields": 3, "nodes": 16, "sweeps": 4},
           {"what": "pair_values", "fields": 2, "nodes": 16, "sweeps": 6},
           {"what": "call", "fn": "sketch_geodesic_pairs", "level": 1},
           {"what": "sketch_build", "shape": [16, 8], "seconds": 0.5}]
    out = chip_smoke.geo_log_summary(log)
    assert [c["fn"] for c in out] == ["geodesic_component_distances",
                                      "sketch_geodesic_pairs"]
    assert out[0]["batches"] == 2 and out[0]["fields"] == 5
    assert out[0]["sweeps_max"] == 6 and out[0]["sweeps_mean"] == 5.0
    assert out[0]["level0_pairs"]["unresolved_pairs"] == 4
    assert out[1]["sketch_build"]["shape"] == [16, 8]
    assert out[1]["batches"] == 0


def test_geo_log_summary_sums_batch_seconds():
    """Each call's batches' host seconds (converge's LOG entries) summed;
    a sketch build's seconds stay the build's."""
    log = [{"what": "call", "fn": "geodesic_component_distances",
            "level": 0},
           {"what": "pair_values", "fields": 3, "nodes": 16, "sweeps": 4,
            "seconds": 0.25},
           {"what": "pair_values", "fields": 2, "nodes": 16, "sweeps": 6,
            "seconds": 0.5},
           {"what": "call", "fn": "sketch_geodesic_pairs", "level": 1},
           {"what": "sketch_build", "shape": [16, 8], "seconds": 2.0}]
    out = chip_smoke.geo_log_summary(log)
    assert out[0]["seconds_in_batches"] == 0.75
    assert out[1]["seconds_in_batches"] == 0.0
    assert out[1]["sketch_build"]["seconds"] == 2.0


def test_padded_lists_share_one_width():
    """The record's sample lists of both sides come back at one width
    (the longest list of either), -1 padded."""
    a, b = chip_smoke.padded_lists([[1, 2], [3]], [[4, 5, 6], []])
    assert a.tolist() == [[1, 2, -1], [3, -1, -1]]
    assert b.tolist() == [[4, 5, 6], [-1, -1, -1]]


# ---------------------------------------------------------------------------
# tsne_forces_dense's kernel_vs_twin checks and the level-0 membership gate
# ---------------------------------------------------------------------------

def _forces_result(n: int, npad: int, seed: int):
    """A stand-in (attr, rep, Z) at the shape: pad rows 0."""
    g = torch.Generator().manual_seed(seed)
    attr = torch.zeros((npad, 2))
    rep = torch.zeros((npad, 2))
    attr[:n] = torch.randn((n, 2), generator=g)
    rep[:n] = torch.randn((n, 2), generator=g)
    return attr, rep, torch.tensor(float(n) * 3.5)


@pytest.mark.parametrize("n,npad", chip_smoke.FORCES_SHAPES)
@pytest.mark.parametrize("fault", ["none", "z", "pad_row", "second_call"])
def test_forces_checks_catch_a_wrong_z_a_pad_row_and_unequal_calls(
        n, npad, fault):
    """Each kernel_vs_twin shape's check: passes on the twin's own result,
    raises on a Z off by 1e-4 relative, on a pad row that is not 0 and on
    a second call that differs in one bit."""
    ref = _forces_result(n, npad, seed=npad)
    got = tuple(t.clone() for t in ref)
    again = tuple(t.clone() for t in ref)
    if fault == "z":
        got = (got[0], got[1], got[2] * (1 + 1e-4))
    elif fault == "pad_row":
        got[1][npad - 1, 0] = 1e-30
    elif fault == "second_call":
        again[0][0, 0] = torch.nextafter(again[0][0, 0], torch.tensor(1.0))
    if fault == "none":
        out = chip_smoke.forces_checks(got, again, ref, n, "forces")
        assert out["max_abs_err"] == 0 and out["bits_equal_two_calls"]
    else:
        with pytest.raises(AssertionError):
            chip_smoke.forces_checks(got, again, ref, n, "forces")


def test_forces_shapes_are_the_dense_tiers_own():
    """Each of FORCES_SHAPES is an (n, Npad) that the dense tier gives n
    points: Npad 512 to 28672, as the paths run them."""
    from sph_tpu_torch.models.tsne import dense_npad
    npads = [npad for _, npad in chip_smoke.FORCES_SHAPES]
    assert npads == [512, 2048, 4096, 6144, 21504, 28672]
    assert all(dense_npad(n) == npad for n, npad in chip_smoke.FORCES_SHAPES)


def test_random_joint_p_is_a_joint_p(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    y, p = chip_smoke.random_joint_p(300, 512, seed=3)
    again = chip_smoke.random_joint_p(300, 512, seed=3)
    assert torch.equal(p, again[1]) and torch.equal(y, again[0])
    assert torch.allclose(p, p.T, atol=1e-12)
    assert float(p.diagonal().abs().max()) == 0
    assert float(p[300:].abs().max()) == 0 == float(p[:, 300:].abs().max())
    assert abs(float(p.sum()) - 1.0) < 1e-5
    assert float(y[300:].abs().max()) == 0


@pytest.mark.parametrize("count,ok", [(2987706, True), (2988314, False)])
def test_umap_level0_gate_holds_the_record_count(count, ok):
    """eval_pines_umap's level-0 gate: the record's 2987706 passes, the
    host path's union (the port before its device path) is caught."""
    ref = {"umap_memberships": [2987706, 808858, 10178, 118, 0, None]}
    r = {"run": {"embeddings": [
        {"level": 0, "method": "umap", "memberships": count},
        {"level": 1, "method": "umap", "memberships": 808858}]}}
    if ok:
        out = chip_smoke.umap_level0_gate(r, ref, "eval_pines_umap")
        assert out["level_0_umap_memberships_equal_to_record"]
    else:
        with pytest.raises(AssertionError, match="2988314"):
            chip_smoke.umap_level0_gate(r, ref, "eval_pines_umap")


def test_grid_repulsion_bound_counts_each_stage_once():
    """At 10^6 points on the 1024 grid: 82.7 MB over the three stages and
    about 2.4 GFLOP, nine 2-D FFTs of 2048^2 most of it, so the operations
    bound it; on a 128 grid the bytes do."""
    big = chip_smoke.grid_repulsion_bound(1_000_000, 1_000_448, 1024)
    assert big["bytes"] == 8 * 10**6 + 56 * 1024**2 + 8 * 10**6 \
        + 8 * 1_000_448 + 4
    assert big["bound_by"] == "operations"
    assert 2.3e9 < big["flops"] < 2.5e9
    assert abs(big["bound_ms"] - big["flops"] / chip_smoke.FP32_FLOPS_PER_S
               * 1e3) < 1e-12
    assert chip_smoke.grid_repulsion_bound(
        1_000_000, 1_000_448, 128)["bound_by"] == "bytes"


def _hub_joint_p(n: int = 300, width: int = 5, hubs: int = 4, seed: int = 5):
    """Conditional rows with a few hub columns (their in-degree far past
    16), symmetrized on the device path with SPH_SYM_WREV_MAX 16 and on
    the host path, and the device path's shed entries as the smoke test
    works them out."""
    from sph_tpu_torch.ops import sparse as tsp
    r = np.random.default_rng(seed)
    idx = np.full((n, width), -1, np.int64)
    val = np.zeros((n, width), np.float32)
    for i in range(n):
        m = int(r.integers(2, width + 1))
        hub = np.setdiff1d(np.arange(hubs), [i])[:2]
        rest = r.choice(np.setdiff1d(np.arange(n), np.r_[hub, i]), m - 2,
                        replace=False)
        cols = np.sort(np.r_[hub, rest])
        idx[i, :m] = cols
        v = r.random(m).astype(np.float32)
        val[i, :m] = v / v.sum()
    cond = tsp.SparseRows(idx, val, n, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("SPH_SYM_WREV_MAX", "16")
    try:
        dev = tsp.symmetrize_tsne(cond, device_path=True)
        shed = chip_smoke.shed_reverse_keys(cond)
    finally:
        mp.undo()
    host = tsp.symmetrize_tsne(cond)
    return dev, host, shed


def _entries(p) -> dict:
    n = p.num_rows
    out = {}
    for i in range(n):
        for j, v in zip(p.indices[i], p.values[i]):
            if j >= 0 and v != 0:
                out[i * n + int(j)] = float(v)
    return out


def test_shed_reverse_keys_are_where_the_device_path_differs():
    """The entries that the smoke test works out as shed are exactly those
    where the device path's P lacks the host union's entry or holds
    another value."""
    dev, host, shed = _hub_joint_p()
    d, h = _entries(dev), _entries(host)
    differ = {k for k, v in h.items() if d.get(k) != v}
    assert set(d) <= set(h)
    assert differ and differ == set(shed.tolist())


def test_p_mirror_checks_allow_only_the_device_paths_hub_shedding():
    """The device path's P passes with its shed entries given and fails
    without them; the host path's P passes either way; an entry changed on
    a hub row, away from the shed entries, is still caught."""
    dev, host, shed = _hub_joint_p()
    out = chip_smoke.p_mirror_checks(dev, shed)
    assert out["p_reverse_entries_shed"] == shed.numel() >= 1
    assert out["p_asymmetry"] == 0
    with pytest.raises(AssertionError):
        chip_smoke.p_mirror_checks(dev)
    for keys in (None, shed):
        assert chip_smoke.p_mirror_checks(host, keys)["p_mirrors_cut"] == 0
    n = dev.num_rows
    shed_set = set(shed.tolist())
    bad = dev.copy()
    row, slot = next(
        (i, j) for i in range(4) for j in range(dev.width)
        if dev.indices[i, j] >= 0
        and i * n + int(dev.indices[i, j]) not in shed_set
        and int(dev.indices[i, j]) * n + i not in shed_set)
    bad.val[row, slot] *= 1.5
    with pytest.raises(AssertionError, match="symmetric"):
        chip_smoke.p_mirror_checks(bad, shed)
