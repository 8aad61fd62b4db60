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
