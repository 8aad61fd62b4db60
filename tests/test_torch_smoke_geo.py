"""chip_smoke.py's rgb_geo phase and its rgb_geo_record sub-phase, rehearsed
on the CPU at a small size (the helpers' device switched to the CPU, where
each kernel's wrapper takes its twin, and CONTRACT_THRESHOLD lowered so that
level 1 takes the sketch and the contracted graph): the phase runs, its
gates pass on a right result and raise on each injected fault, and the
record gates pass against a record the JAX package makes of the same small
scene."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from sph_tpu_torch.ops import shortest_path as tsp  # noqa: E402
from sph_tpu_torch.ops import tsne_kernels  # noqa: E402
from sph_tpu_torch.utils.logging import set_level  # noqa: E402
from test_torch_reference_native import use_reference_native  # noqa: E402

use_reference_native()

ITERS = 100


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counting_relax():
    """shortest_path.relax (the twin on the CPU) counting each sweep as the
    card's wrapper counts its launches."""
    twin = tsp.relax

    def relax(d, g, memory_budget=tsp.FIELD_MEMORY_BUDGET):
        relax.launches += 1
        return twin(d, g, memory_budget)

    relax.launches = 0
    return relax


@pytest.fixture(scope="module")
def small_geo():
    """rgb_geo at 24 x 24 (576 pixels) with the threshold at 100, each
    sweep counted as a launch."""
    set_level("WARNING")
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEV", "cpu")
    mp.setattr(tsp, "CONTRACT_THRESHOLD", 100)
    mp.setattr(tsp, "relax", counting_relax())
    try:
        yield chip_smoke.rgb_geo(tsne_kernels, side=24, iters=ITERS,
                                 sources=8, fidelity=40)
    finally:
        mp.undo()


def test_rgb_geo_phase_small(small_geo):
    out = small_geo
    levels = out["levels"]
    assert levels[0] == 576 and levels[1] > 100 and len(levels) >= 4
    assert out["knn_tiers"][1] == "contracted"
    assert all(t == "exact" for t in out["knn_tiers"][2:])
    stage2 = out["geodesic_log"]["stage2_hierarchy"]
    assert stage2[0]["fn"] == "geodesic_component_distances"
    assert stage2[0]["level"] == 0 and stage2[0]["batches"] >= 1
    assert stage2[0]["level0_pairs"]["unresolved_pairs"] > 0
    assert stage2[1]["fn"] == "sketch_geodesic_pairs"
    assert stage2[1]["sketch_build"]["shape"] == [576, 64]
    assert out["exact_geodesics"]["sources"] == 8
    assert out["exact_geodesics"]["max_err_over_bound"] <= 1.0
    assert out["sketch_fidelity"]["pairs"] == 40
    met = out["sketch_fidelity"]["met"]
    assert met["met_pairs"] >= chip_smoke.SKETCH_MET_MIN
    assert met["pairs"] == met["met_pairs"] <= met["neighbour_pairs"]
    assert met["path_equals_sketch"] and met["below_bound"] == 0
    assert sorted(out["tsne"]) == [1, 2, 3] and sorted(out["p"]) == [1, 2, 3]
    for level, run in out["tsne"].items():
        assert run["n"] == levels[level] and run["tier"] == "dense"
        assert run["embedding_finite"]
        assert sorted(run["kl_at"]) == ["0", str(ITERS)]
        assert out["p"][level]["conditional_row_sum_err"] <= 1e-3
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0,
                               "tsne_attraction": 0, "grid_deposit": 0,
                               "grid_interpolate": 0}
    assert out["relax_launches"]["stage1_knn"] == 0
    for name in ("stage2_hierarchy", "stage3_level_similarities"):
        assert out["relax_launches"][name] == sum(
            c["sweeps_total"] for c in out["geodesic_log"][name]) > 0
    assert out["peak_memory_bytes"]["stage1_knn"] == "not measured"


def test_rgb_geo_gates_pass_and_catch_each_fault(small_geo):
    """The gates on the small run, its kernel counts set as the card's
    would be; each fault raises."""
    ok = copy.deepcopy(small_geo)
    for run in ok["tsne"].values():
        run["launches"] = {"tsne_forces_dense": ITERS, "tsne_repulsion": 1}
        run["kl_at"] = {"0": 2.0, str(ITERS): 1.0}
    ok["launches"] = {"tsne_forces_dense": 3 * ITERS, "tsne_repulsion": 3}
    ok["sketch_fidelity"].update(spearman=1.0, argmin_agreement=1.0)
    chip_smoke.rgb_geo_gates(ok, ITERS)
    faults = {
        "strictly falling": lambda s: s["levels"].__setitem__(2, 900),
        "contracted": lambda s: s["knn_tiers"].__setitem__(1, "exact"),
        "sketch fidelity": lambda s: s["sketch_fidelity"].__setitem__(
            "spearman", 0.98),
        "met on": lambda s: s["sketch_fidelity"]["met"].__setitem__(
            "met_pairs", chip_smoke.SKETCH_MET_MIN - 1),
        "changed a met": lambda s: s["sketch_fidelity"]["met"].__setitem__(
            "path_equals_sketch", False),
        "below the exact": lambda s: s["sketch_fidelity"][
            "met"].__setitem__("below_bound", 1),
        "met sketch fidelity": lambda s: s["sketch_fidelity"][
            "met"].__setitem__("argmin_agreement", 0.9),
        "levels 1-3": lambda s: s["tsne"].pop(3),
        "falling": lambda s: s["tsne"][2]["kl_at"].__setitem__(
            str(ITERS), 3.0),
        "Z did not": lambda s: s["tsne"][1]["launches"].__setitem__(
            "tsne_repulsion", 0),
        "not 3 x": lambda s: s["launches"].__setitem__(
            "tsne_forces_dense", 3 * ITERS - 1),
        "launched 1 times for 0 sweeps": lambda s: s[
            "relax_launches"].__setitem__("stage1_knn", 1),
        "stage3_level_similarities: bellman_ford_relax launched": lambda s: s[
            "relax_launches"].__setitem__(
                "stage3_level_similarities",
                s["relax_launches"]["stage3_level_similarities"] - 1),
        "not launched in stages 2 and 3": lambda s: [
            s["relax_launches"].__setitem__("stage2_hierarchy", 0),
            [c.__setitem__("sweeps_total", 0)
             for c in s["geodesic_log"]["stage2_hierarchy"]]],
    }
    for match, change in faults.items():
        bad = copy.deepcopy(ok)
        change(bad)
        with pytest.raises(AssertionError, match=match):
            chip_smoke.rgb_geo_gates(bad, ITERS)


def test_relax_checks_pass_and_catch_each_fault(small_geo, monkeypatch):
    """chip_smoke's bellman_ford_relax rows on the small run's graphs (the
    twin on both sides on the CPU, each sweep counted as a launch): the
    comparisons at the level-0 graph (256 and 37 fields) and the contracted
    level-1 graph, and one level-0 pair batch both ways; a differing value
    or frontier, a start that lowers nothing, unequal sweeps, other values
    and a wrong launch count are each caught."""
    from sph_tpu_torch.ops import shortest_path as sp
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(tsp, "CONTRACT_THRESHOLD", 100)
    monkeypatch.setattr(tsp, "relax", counting_relax())
    objs = small_geo["objects"]
    g0 = sp.FieldGraph.from_graph(objs["graph"], "cpu")
    gc = sp._contracted_graph(objs["hierarchy"], objs["data"], 1,
                              objs["num_samples"], objs["seed"], "cpu")
    for g, f in ((g0, chip_smoke.RELAX_FIELDS),
                 (g0, chip_smoke.RELAX_ODD_FIELDS),
                 (gc, chip_smoke.RELAX_FIELDS)):
        c = chip_smoke.relax_compare(g, chip_smoke.relax_start(g, f, seed=f))
        assert c["fields"] == f and c["edges"] == int(g.csr_off[-1])
        chip_smoke.relax_gate(c, "small")
        assert c["max_abs_err"] == 0.0 and c["lowered_fields"] > 0
        for key, match in (("d_equal", "differs"),
                           ("frontier_equal", "differs"),
                           ("lowered_values", "lowered no")):
            bad = {**c, key: 0 if key == "lowered_values" else False}
            with pytest.raises(AssertionError, match=match):
                chip_smoke.relax_gate(bad, "small")
    batch = chip_smoke.pair_batch_both_ways(
        g0, objs["graph"], *chip_smoke.neighbour_pairs(objs["hierarchy"], 0))
    chip_smoke.pair_batch_gate(batch)
    assert batch["sweeps_kernel"] and batch["launches_twin"] == 0
    assert batch["launches_kernel"] == sum(batch["sweeps_kernel"])
    assert batch["fields"] == min(chip_smoke.RELAX_FIELDS,
                                  batch["unresolved_pairs"] * 2)
    faults = {
        "values differ": {"values_equal": False},
        "sweeps": {"sweeps_twin": [s + 1 for s in batch["sweeps_twin"]]},
        "launched": {"launches_kernel": batch["launches_kernel"] + 1},
    }
    for match, change in faults.items():
        with pytest.raises(AssertionError, match=match):
            chip_smoke.pair_batch_gate({**batch, **change})


def delta_rows_and_faults(objs, whole=True):
    """chip_smoke.relax_checks (or, not `whole`, its relax_batch_checks)
    on a small run's objects (the twins on both sides on the CPU), its two
    delta batch rows held to their shapes and gates, and each injected
    fault caught."""
    if whole:
        out = chip_smoke.relax_checks(objs)
        odd = chip_smoke.RELAX_ODD_FIELDS
        assert [c["path_shape"] for c in out["checks"]] == [
            "rgb_geo_level_0", f"rgb_geo_level_0_f{odd}",
            "rgb_geo_contracted_level_1"]
    else:
        out = chip_smoke.relax_batch_checks(objs, *chip_smoke.relax_graphs(
            objs))
    pair, comp = out["batches"]
    assert pair["path_shape"] == "rgb_geo_level_0_pair_batch"
    assert comp["path_shape"] == "rgb_geo_contracted_level_1_batch"
    assert out["pair_batch"]["sweeps_kernel"] == [pair["sweeps"]]
    assert out["component_batch"]["sweeps_kernel"] == [comp["sweeps"]]
    assert out["component_batch"]["values_equal"]
    for c in (pair, comp):
        assert c["sweeps_equal"] == c["sweeps"] == c["stopped_at"] > 1
        assert len(c["gathered_share"]) == len(c["written_share"]) == (
            c["sweeps"])
        assert 0 < c["mean_gathered_share"] < 1
        assert 0 < c["mean_written_share"] <= 1
        assert c["gathered_share"][-1] < max(c["gathered_share"])
        assert c["bytes"] > c["sweeps"] * 4 * c["edges"]
        assert c["gathered_bytes"] == 32 * c["gathered_sectors"]
        assert c["bound_ms"] > 0 and "ms" not in c    # no device time
        chip_smoke.delta_batch_gate(c, "small")
    assert pair["evaluated"] > 0 and comp["evaluated"] == 0
    faults = {
        "differ from the twins": {"sweeps_equal": pair["sweeps"] - 1,
                                  "first_unequal": {"sweep": 2}},
        "first held at None": {"stopped_at": None},
        "converge ran": {"sweeps": pair["sweeps"] + 1,
                         "sweeps_equal": pair["sweeps"] + 1},
    }
    for match, change in faults.items():
        with pytest.raises(AssertionError, match=match):
            chip_smoke.delta_batch_gate({**pair, **change}, "small")
    return out


def test_relax_delta_rows_small(small_geo, monkeypatch):
    """The delta rows (a level-0 pair batch and a contracted-graph batch,
    each sweep by sweep four ways and through converge both ways) on the
    24 x 24 run, each twin sweep counted as a launch."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(tsp, "relax", counting_relax())
    out = delta_rows_and_faults(small_geo["objects"])
    assert out["batches"][0]["n"] == 576


def test_relax_delta_rows_16x16(monkeypatch):
    """The same batch rows on a 16 x 16 run of the phase (threshold 40,
    no t-SNE; 10 sweeps converge its 256-node graph, so the stateless rows
    start from fields that no sweep lowers)."""
    set_level("WARNING")
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(tsp, "CONTRACT_THRESHOLD", 40)
    monkeypatch.setattr(tsp, "relax", counting_relax())
    run = chip_smoke.rgb_geo(tsne_kernels, side=16, iters=1, tsne_levels=(),
                             sources=4, fidelity=10)
    out = delta_rows_and_faults(run["objects"], whole=False)
    assert out["batches"][0]["n"] == 256


def test_rgb_geo_record_gates_against_the_jax_package(monkeypatch):
    """The record sub-phase at 16 x 16 against a record the JAX package
    makes there (scripts/rgb_geo_reference.py's function): the gates pass;
    a wrong kNN row, a wrong sketch value and a wrong level are caught."""
    import sph_tpu as J
    from sph_tpu.ops import shortest_path as jsp
    from sph_tpu.utils.logging import set_level as jset_level
    jset_level("WARNING")
    set_level("WARNING")
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(jsp, "CONTRACT_THRESHOLD", 40)
    shape = (16, 16)
    ref = {"size": [*shape, 3], "contract_threshold": 40}
    for cs in ("geo_centroid", "geo_walks"):
        ref[cs] = chip_smoke.geo_record_run(J, cs, shape)
    kept = tsp.CONTRACT_THRESHOLD
    run = chip_smoke.rgb_geo_record(ref)
    assert tsp.CONTRACT_THRESHOLD == kept              # restored
    out = chip_smoke.rgb_geo_record_gates(run, ref)
    cen = out["geo_centroid"]
    assert cen["levels"] == cen["jax_cpu_levels"]
    assert cen["knn_level_1_ids_equal"] == 1.0
    assert cen["sketch_max_rel_err"] == 0.0
    assert out["geo_walks"]["sketch_bit_equal_fraction"] == 1.0
    assert run["geo_walks"]["knn"] == {}

    def broken(change):
        bad = copy.deepcopy(run)
        change(bad)
        return bad

    faults = {
        "kNN ids": lambda r: r["geo_centroid"]["knn"]["1"]["ids"].__setitem__(
            slice(None), [[-5] * len(x) for x in
                          r["geo_centroid"]["knn"]["1"]["ids"]]),
        "sketch Hausdorff off": lambda r: r["geo_walks"][
            "replayed_sketch_hausdorff"].__setitem__(
                int(np.argmax(np.isfinite(
                    r["geo_walks"]["replayed_sketch_hausdorff"]))), 1e3),
        "within 2 %": lambda r: r["geo_centroid"]["levels"].__setitem__(
            1, r["geo_centroid"]["levels"][1] * 2),
    }
    for match, change in faults.items():
        with pytest.raises(AssertionError, match=match):
            chip_smoke.rgb_geo_record_gates(broken(change), ref)
