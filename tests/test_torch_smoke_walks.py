"""chip_smoke.py's walk phases (eval_pines_walks, salinas_walks,
explorer) rehearsed on the CPU at small shapes, against records that
scripts/pines_walks_reference.py and scripts/salinas_walks_reference.py
make of the same small scenes with the JAX package.  The helpers' device is
switched to the CPU, where each kernel's wrapper takes its twin; each twin
call is counted as the card's launch would be, so the launch gates run
too.  The Salinas rehearsal lowers the approximate threshold to 200
components, so that its level 1 takes the approximate walk kNN and its
level 2 the exact one, as at full size."""

import copy
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import sph_tpu.models.nearest_neighbors as jnn  # noqa: E402
import sph_tpu.ops.component_knn as jck  # noqa: E402
from sph_tpu.evaluation import run_evaluation as jre  # noqa: E402
from sph_tpu_torch.models import tsne as ttsne  # noqa: E402
from sph_tpu_torch.ops import tsne_kernels  # noqa: E402
from sph_tpu_torch.utils.logging import set_level  # noqa: E402
from test_torch_reference_native import use_reference_native

use_reference_native()

PINES = (14, 12, 8)
SALINAS = (48, 40, 16)
THRESHOLD = "200"


def run_script(name: str, out, *args) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name, *args, "--out", str(out)])
        with pytest.raises(SystemExit) as done:
            runpy.run_path(os.path.join(REPO, "scripts", name),
                           run_name="__main__")
        assert done.value.code == 0
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    set_level("WARNING")
    tmp = tmp_path_factory.mktemp("walks")
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setattr(chip_smoke, "DEV", "cpu")
        mp.setattr(chip_smoke, "EVAL_PINES_SHAPE", PINES)
        mp.setenv("SPH_TSNE_ATTR_PACKED", "0")
        mp.setenv("SPH_APPROX_KNN_THRESHOLD", THRESHOLD)
        # the record scripts swap these in the JAX package: undone
        mp.setattr(jre, "ComputeHierarchy", jre.ComputeHierarchy)
        mp.setattr(jnn, "compute_knn", jnn.compute_knn)
        mp.setattr(jck, "approx_pair_metric_knn", jck.approx_pair_metric_knn)
        pines_ref = run_script("pines_walks_reference.py",
                               tmp / "pines.json", "--shape",
                               *map(str, PINES))
        salinas_ref = run_script("salinas_walks_reference.py",
                                 tmp / "salinas.json", "--threads", "2",
                                 "--shape", *map(str, SALINAS))
        forces_twin = tsne_kernels.tsne_forces_dense_reference
        rep_twin = ttsne.repulsive_forces

        def forces(*a, **kw):
            tsne_kernels.tsne_forces_dense.launches += 1
            return forces_twin(*a, **kw)

        def repulsion(*a, **kw):
            tsne_kernels.tsne_repulsion.launches += 1
            return rep_twin(*a, **kw)

        mp.setattr(tsne_kernels, "tsne_forces_dense_reference", forces)
        mp.setattr(ttsne, "repulsive_forces", repulsion)
        sal = chip_smoke.salinas_walks(tsne_kernels, shape=SALINAS,
                                       iters=200, knn_iters=200)
        ch, emb = explorer_hierarchy()
        yield {"pines_ref": pines_ref, "salinas_ref": salinas_ref,
               "pines": chip_smoke.eval_pines_walks(tsne_kernels,
                                                    pines_ref),
               "salinas": sal, "salinas_gates":
                   chip_smoke.salinas_walks_gates(sal, salinas_ref),
               "explorer": chip_smoke.explorer(ch, emb)}
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def explorer_hierarchy():
    """A 24x20x16 NEIGH_WALKS hierarchy on the CPU (k = 31, 50 walks of 10
    NORMAL steps) and a layout of its level 1."""
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(24, 20, 16, seed=7)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.NONE)
    walks = T.ComponentSim.NEIGH_WALKS
    ch = T.ComputeHierarchy(device="cpu").init(
        data, 24, 20,
        ihs=T.ImageHierarchySettings(component_sim=walks,
                                     merge_multiple=False,
                                     use_percentile=False, max_dist=0.0,
                                     min_reduction=98.0),
        lss=T.LevelSimilaritiesSettings(component_sim=walks, ks=[31]),
        rws=T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL),
        nns=T.NearestNeighborsSettings(num_nearest_neighbors=31,
                                       symmetric_neighbors=True,
                                       compute_connect_components=True,
                                       neighbor_connect_components=True))
    ch.compute()
    n = ch.image_hierarchy.hierarchy.num_components[1]
    return ch, np.random.default_rng(0).standard_normal(
        (n, 2)).astype(np.float32)


def test_records_hold_every_run(small):
    ref = small["pines_ref"]
    assert ref["shape"] == list(PINES) and ref["platform"].startswith("cpu")
    assert sorted(ref["runs"]) == sorted(
        [f"{cs}+{h}" for cs in ("neigh_walks", "neigh_walks_single_overlap")
         for h in ("merge_rw_new_walks", "merge_rw_new_walks_and_knn",
                   "merge_data_new_walks")] + ["neigh_walks+merge_rw_only+topk"])
    for key, run in ref["runs"].items():
        assert len(run["walk_lengths"]) == (
            1 if "merge_rw_only" in key else len(run["levels"]))
    sref = small["salinas_ref"]
    assert sref["size"] == list(SALINAS)
    assert sref["runs"]["new_walks_and_knn"]["level_1_knn_tier"] == (
        "approximate")
    assert 0.0 < sref["runs"]["new_walks_and_knn"]["level_1_recall"] <= 1.0


def test_driver_maps_byte_equal_to_jax(small):
    """Every walk variant through the port's driver gives the JAX
    package's maps byte for byte, and its walk lengths."""
    runs = small["pines"]["runs"]
    assert len(runs) == 7
    for key, run in runs.items():
        assert run["maps_equal_to_record"], key
        assert run["walk_lengths"] == run["jax_cpu_walk_lengths"], key
        assert run["walk_lengths_compared"] == len(run["walk_lengths"])


def test_eval_pines_walks_grids_and_tiers(small):
    grids = small["pines"]["grids"]
    assert sorted(grids) == ["pines_walk_topk", "pines_walk_variants"]
    assert len(grids["pines_walk_variants"]["runs"]) == 6
    for key, run in small["pines"]["runs"].items():
        want = ("exact" if key.endswith("merge_rw_new_walks_and_knn")
                else None)
        assert run["knn_tiers"][1:] == [want] * (len(run["levels"]) - 1)
        assert run["files_read_back"] > 8


def test_walk_lengths_gate_refuses_another_schedule(small):
    run = {"levels": [100, 30, 9, 1], "walk_lengths": [10, 5, 5, 5]}
    want = copy.deepcopy(run)
    assert chip_smoke.walk_lengths_gate(run, want, True, "x") == 4
    want["walk_lengths"][2] = 6
    with pytest.raises(AssertionError, match="walk lengths"):
        chip_smoke.walk_lengths_gate(run, want, True, "x")
    # levels past the first that differs are not compared
    want["levels"][2] = 8
    assert chip_smoke.walk_lengths_gate(run, want, False, "x") == 2


def test_salinas_walks_phase(small):
    sal, ref = small["salinas"], small["salinas_ref"]["runs"]
    assert sal["rw_only"]["levels"] == ref["rw_only"]["levels"]
    knn = sal["new_walks_and_knn"]
    assert knn["levels"] == ref["new_walks_and_knn"]["levels"]
    assert knn["walk_lengths"] == ref["new_walks_and_knn"]["walk_lengths"]
    assert knn["knn_tiers"][1] == "approximate"
    assert knn["knn_tiers"][2] == "exact"
    assert knn["knn_loaded_from_cache"]
    assert not sal["rw_only"]["knn_loaded_from_cache"]
    for key in ("level_1_exact_equals_float64", "level_2_exactness"):
        assert knn[key]["max_value_err"] <= knn[key]["band"]
    assert small["salinas_gates"]["kl_gate"] == pytest.approx(
        1.01 * 4.19387)


def test_salinas_walks_gates_refuse_a_lower_recall(small):
    ref = copy.deepcopy(small["salinas_ref"])
    ref["runs"]["new_walks_and_knn"]["level_1_recall"] = (
        small["salinas"]["new_walks_and_knn"]["level_1_recall"] + 0.02)
    with pytest.raises(AssertionError, match="recall"):
        chip_smoke.salinas_walks_gates(small["salinas"], ref)


def test_explorer_phase(small):
    ex = small["explorer"]
    assert ex["above_cap"]["status"] == 400
    assert ex["knn_exactness"]["max_beyond_kth"] <= ex["knn_exactness"][
        "band"]
    for level, k in chip_smoke.EXPLORER_KNN:
        assert ex[f"knn_level_{level}_k{k}_edges"] > 0
        for attempt in ("first", "cached"):
            assert ex["ms"][f"/api/knn?level={level}&k={k} {attempt}"] > 0
    path = ex["path"]
    assert path["b"] != path["a"] and path["hops"] >= 1
    assert path["distance"] == round(path["scipy_distance"], 6)
