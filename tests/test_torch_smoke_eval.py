"""chip_smoke.py's eval phases (eval_pines_tsne, eval_pines_umap,
eval_record) rehearsed on the CPU at small shapes, against a record that
scripts/eval_pines_reference.py makes of the same small scenes with the
JAX package's run_evaluation.  The helpers' device is switched to the CPU, where
each kernel's wrapper takes its twin; each twin call the run makes is
counted as the card's launch would be, so the launch gates run too."""

import os
import runpy
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from sph_tpu.evaluation import run_evaluation as jre  # noqa: E402
from sph_tpu_torch.models import tsne as ttsne  # noqa: E402
from sph_tpu_torch.ops import tsne_kernels  # noqa: E402
from sph_tpu_torch.utils.logging import set_level  # noqa: E402
from test_torch_reference_native import use_reference_native

use_reference_native()

PINES = (20, 16, 8)
RECORD = (16, 12, 8)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    set_level("WARNING")
    out = tmp_path_factory.mktemp("eval") / "record.json"
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setattr(chip_smoke, "DEV", "cpu")
        mp.setattr(chip_smoke, "EVAL_PINES_SHAPE", PINES)
        mp.setattr(chip_smoke, "EVAL_RECORD_SHAPE", RECORD)
        mp.setenv("SPH_TSNE_ATTR_PACKED", "0")
        mp.setenv("SPH_UMAP_PACKED", "0")
        # the record script swaps run_evaluation's ComputeEmbedding: undone
        mp.setattr(jre, "ComputeEmbedding", jre.ComputeEmbedding)
        mp.setattr(sys, "argv", ["eval_pines_reference.py", "--out",
                                 str(out)])
        with pytest.raises(SystemExit) as done:
            runpy.run_path(os.path.join(REPO, "scripts",
                                        "eval_pines_reference.py"),
                           run_name="__main__")
        assert done.value.code == 0
        import json
        with open(out) as f:
            ref = json.load(f)
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
        yield {"ref": ref,
               "tsne": chip_smoke.eval_pines_tsne(
                   tsne_kernels, ref["runs"]["pines_tsne"]),
               "umap": chip_smoke.eval_pines_umap(
                   tsne_kernels, ref["runs"]["pines_umap"]),
               "record": chip_smoke.eval_record(tsne_kernels, ref)}
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def test_the_record_script_records_every_run(small):
    ref = small["ref"]
    assert sorted(ref["runs"]) == ["pines_tsne", "pines_umap",
                                   "record_tsne", "record_umap"]
    assert ref["runs"]["pines_tsne"]["shape"] == list(PINES)
    rec = ref["runs"]["record_tsne"]
    assert rec["shape"] == list(RECORD) and rec["levels"][0] == 192
    assert sorted(rec["tsne_kl"], key=int) == [
        str(i) for i in range(len(rec["levels"]))]
    assert "umap_level_1_trustworthiness_k10" in ref["runs"]["record_umap"]
    for name in ("pines_umap", "record_umap"):
        rec = ref["runs"][name]
        assert len(rec["umap_memberships"]) == len(rec["levels"])
        assert (rec["umap_memberships"][-1] is None) == (
            rec["levels"][-1] == 1)
    # the whole run raises at its first level without memberships
    rec = ref["runs"]["record_umap"]
    if rec["raised"] is not None:
        assert rec["umap_levels_embedded"][-1] + 1 == (
            rec["umap_memberships"].index(0))


def test_eval_pines_tsne_small(small):
    out = small["tsne"]
    first, second = out["first"], out["second"]
    assert first["levels"][0] == 320 and len(first["levels"]) >= 4
    assert not first["knn_loaded_from_cache"]
    assert second["knn_loaded_from_cache"]
    assert first["maps_sha256"] == second["maps_sha256"]
    assert first["maps_sha256"] == small["ref"]["runs"]["pines_tsne"][
        "maps_sha256"]
    iters = sum(e["iterations"] for e in first["embeddings"] if e["n"] > 1)
    assert first["launches"]["tsne_forces_dense"] == iters
    assert set(first["seconds_by_stage"]) == {
        "stage1_knn", "stage2_hierarchy", "stage3_level_similarities",
        "outputs"}
    assert "level_0.tiff" in first["files"]
    assert "emb_tsne_0.bin" in first["files"]


def test_eval_pines_umap_small(small):
    out = small["umap"]
    assert [e["level"] for e in out["embeddings"]] == list(
        range(len(out["levels"])))
    assert all(e["method"] == "umap" for e in out["embeddings"])
    assert 0.0 < out["level_1_trustworthiness_k10"] <= 1.0
    assert out["launches"] == {"tsne_forces_dense": 0, "tsne_repulsion": 0,
                               "tsne_attraction": 0, "grid_deposit": 0,
                               "grid_interpolate": 0}


def test_eval_record_small(small):
    rec = small["record"]
    assert rec["record_tsne"]["maps_equal_to_record"]
    assert rec["record_umap"]["maps_equal_to_record"]
    assert 0 in rec["record_tsne"]["kl_held"]
    umap = rec["record_umap"]
    assert umap["umap_empty_levels"] == umap["jax_cpu_umap_empty_levels"]


def test_eval_maps_and_empty_level_gates_catch_faults(small):
    """The maps gate falls back to the levels rule when a map moves; the
    empty-level gate raises on a UMAP level without memberships that the
    JAX record has, or lacks."""
    ref = small["ref"]["runs"]["pines_umap"]
    out = small["umap"]
    assert out["maps_equal_to_record"]
    assert out["umap_empty_levels"] == out["jax_cpu_umap_empty_levels"]
    r = {"run": {"levels": list(out["levels"]),
                 "embeddings": [dict(e) for e in out["embeddings"]]},
         "outputs": {"maps_sha256": dict(out["maps_sha256"])}}
    assert chip_smoke.eval_maps_gate(r, ref, "ok")
    chip_smoke.eval_umap_empty_gate(r, ref, True, "ok")
    r["outputs"]["maps_sha256"]["MapFromBottomToLevel"] = "0" * 64
    assert not chip_smoke.eval_maps_gate(r, ref, "moved")
    r["run"]["levels"][1] *= 2
    with pytest.raises(AssertionError, match="level 1"):
        chip_smoke.eval_maps_gate(r, ref, "far")
    r["run"]["levels"][1] //= 2
    r["run"]["embeddings"][0]["memberships"] = 0
    with pytest.raises(AssertionError, match="no memberships"):
        chip_smoke.eval_umap_empty_gate(r, ref, True, "new empty level")
    r["run"]["levels"][1] += 1
    with pytest.raises(AssertionError, match="no memberships"):
        chip_smoke.eval_umap_empty_gate(r, ref, False, "new large empty")


def test_eval_gates_catch_faults(small):
    """Each gate raises on the fault it is there for."""
    r = {"run": {"embeddings": [dict(e) for e in small["tsne"]["first"][
        "embeddings"]]}, "launches": dict(small["tsne"]["first"][
            "launches"])}
    chip_smoke.eval_tsne_gates(r, "ok")
    r["launches"]["tsne_forces_dense"] -= 1
    with pytest.raises(AssertionError, match="tsne_forces_dense"):
        chip_smoke.eval_tsne_gates(r, "short")
    r["launches"]["tsne_forces_dense"] += 1
    r["run"]["embeddings"][0]["kl"] = r["run"]["embeddings"][0]["kl_start"]
    with pytest.raises(AssertionError, match="KL"):
        chip_smoke.eval_tsne_gates(r, "flat")
    levels = small["tsne"]["first"]["levels"]
    with pytest.raises(AssertionError, match="level 1"):
        chip_smoke.eval_levels_gate(levels, [levels[0], levels[1] * 2],
                                    "far")
