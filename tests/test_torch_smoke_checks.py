"""The checks of chip_smoke.py's 1M phase, rehearsed on the CPU at a small
size: the same helpers with their device switched to the CPU, where each
kernel's wrapper takes its twin.  They pass on a right result and raise on
a wrong one."""

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
                                      "tsne_repulsion": 0}   # CPU: twins
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
    out = chip_smoke.grid_path(tsne_kernels, graph, 60, kl_at=(0, 50))
    comp = out["ce"].last_computation
    assert comp.tier == "grid" and sorted(out["kls"]) == [0, 50, 60]
    assert out["kls"][60] < out["kls"][0]
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0}
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
    assert abs(dense["bound_ms"] - 4 * 6144 ** 2 / 3.35e12 * 1e3) < 1e-4
    rep = chip_smoke.repulsion_bound(10 ** 6, 1_000_448)
    assert rep["bound_by"] == "operations"
    assert abs(rep["bound_ms"] - 14e12 / 67e12 * 1e3) < 1e-6


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
