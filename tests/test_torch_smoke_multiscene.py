"""chip_smoke.py's phases multi_scene, multi_scene_record and sharded
rehearsed on the CPU at small shapes, against a record that
scripts/multiscene_reference.py makes of the same small scenes with the
JAX package.  The helpers' device is switched to the CPU, where each
kernel's wrapper takes its twin; each twin call is counted as the card's
launch would be, so the launch gates run too.  The kernel rows
(check_repulsion_scenes, check_repulsion_window) time with CUDA events and
run on the card only.  The sharded phase runs on 1024 points and the
record phase on 256-point scenes, where the KLs part more than at the
card's sizes, so their KL bars are raised here (see the fixture)."""

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
from sph_tpu_torch.models import tsne as ttsne  # noqa: E402
from sph_tpu_torch.ops import tsne_kernels  # noqa: E402
from sph_tpu_torch.parallel import sharded  # noqa: E402
from sph_tpu_torch.utils.logging import set_level  # noqa: E402

FULL = (32, 32, 8)        # the rehearsal's "full" scenes (square)
SCENES = 4
K = 31
RECORD = (16, 16, 32)     # the record script's 32 bands


def run_script(out, *args) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["multiscene_reference.py", *args,
                                 "--out", str(out)])
        with pytest.raises(SystemExit) as done:
            runpy.run_path(os.path.join(REPO, "scripts",
                                        "multiscene_reference.py"),
                           run_name="__main__")
        assert done.value.code == 0
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    set_level("WARNING")
    tmp = tmp_path_factory.mktemp("multiscene")
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setattr(chip_smoke, "DEV", "cpu")
        ref = run_script(tmp / "ref.json", "--side", str(FULL[0]),
                         "--bands", str(FULL[2]), "--scenes", str(SCENES),
                         "--k", str(K), "--full-levels", "0",
                         str(SCENES - 1), "--record-side", str(RECORD[0]))
        rows_fn = sharded.tsne_repulsion_rows
        rep_twin = ttsne.repulsive_forces

        def rows(*a, **kw):
            tsne_kernels.tsne_repulsion.launches += 1
            return rows_fn(*a, **kw)

        def repulsion(*a, **kw):
            tsne_kernels.tsne_repulsion.launches += 1
            return rep_twin(*a, **kw)

        attraction_fn = sharded.attractive_forces

        def attraction(*a, **kw):
            tsne_kernels.tsne_attraction.launches += 1
            return attraction_fn(*a, **kw)

        def counted(fn, name):
            def call(*a, **kw):
                getattr(tsne_kernels, name).launches += 1
                return fn(*a, **kw)
            return call

        for name in ("grid_deposit", "grid_interpolate"):
            mp.setattr(sharded, name, counted(getattr(sharded, name), name))
        mp.setattr(sharded, "tsne_repulsion_rows", rows)
        mp.setattr(ttsne, "repulsive_forces", repulsion)
        mp.setattr(sharded, "attractive_forces", attraction)
        ms = chip_smoke.multi_scene(
            tsne_kernels, ref["full"], shape=FULL, scenes=SCENES, k=K,
            iters=100, serial=2)
        mid = chip_smoke.grid_vs_exact(tsne_kernels, rows=32, cols=32,
                                       iters=50)
        # 1024 points, not 65536: 1 and 2 shards' KLs part by rounding
        # (measured 1.1 % on the grid tier here), so the rehearsal's bar
        # is 2 %; the card's run keeps 0.5 %
        mp.setattr(chip_smoke, "SHARDED_KL_RTOL", 0.02)
        # 256-point scenes, not 2304: the record's KLs part by 1.06 % after
        # 1000 iterations (measured), and XLA-CPU's t-SNE varies from
        # process to process under load; the card's run keeps 1 %
        mp.setattr(chip_smoke, "EVAL_KL_RTOL", 0.05)
        msr = chip_smoke.multi_scene_record(
            tsne_kernels, ref["record"], shape=RECORD)
        ih, ls = ms["pines"]["ih"], ms["pines"]["ls"]
        pines = {"data": ms["pines"]["data"], "p1": ls.get_prob_dist(1),
                 "labels": ih.hierarchy.pixel_components[1],
                 "count": ih.hierarchy.num_components[1]}
        # the seed gate's scene is this one (chip_smoke.seed_scene)
        sh = chip_smoke.sharded_paths(tsne_kernels, mid, pines, pines,
                                      iters=100, epochs=100, k=K)
        yield {"ref": ref, "ms": ms, "msr": msr, "sh": sh}
    finally:
        mp.undo()
        torch.set_num_threads(threads)




def test_record_holds_both_sizes(small):
    ref = small["ref"]
    assert ref["platform"] == "cpu" and ref["devices"] == 8
    full = ref["full"]
    assert full["scenes"] == SCENES and len(full["stage1"]) == SCENES
    assert sorted(full["levels"]) == ["0", str(SCENES - 1)]
    assert len(full["sample_rows"]) == 64
    assert len(full["stage1"][0]["knn_ids"][0]) == K
    assert len(full["stage1"][0]["walk_ids_sha256"]) == 64
    assert len(full["stage1"][0]["walk_ids"]) == 16
    rec = ref["record"]
    assert len(rec["levels"]) == 4 and sorted(rec["kl"]) == ["1000", "250"]


def test_multi_scene_phase(small):
    ms, ref = small["ms"], small["ref"]["full"]
    chip_smoke.multi_scene_gates(ms, ref)
    # on the CPU the port's stage 1 is the JAX package's: hashes equal,
    # walk rows equal in ids and within 1e-6
    for fp in ms["fingerprints"]:
        assert fp["knn_ids_hash_equal"]
        assert fp["walk_id_hashes_equal"] == 64
        assert fp["walk_rows_ids_equal"] == fp["walk_rows_compared"] == 16
    for i, levels in ref["levels"].items():
        assert ms["levels"][int(i)] == levels
    assert ms["launches_tsne"]["tsne_repulsion"] == 100
    assert all(ms["scene_equals_one_scene_call"].values())
    for ex in ms["knn_exactness"].values():
        assert ex["max_swap_over_band"] <= 1.0


def test_multi_scene_gates_refuse(small):
    ref = copy.deepcopy(small["ref"]["full"])
    ref["levels"]["0"][1] = int(ref["levels"]["0"][1] * 1.1) + 2
    with pytest.raises(AssertionError, match="level 1"):
        chip_smoke.multi_scene_gates(small["ms"], ref)
    run = copy.deepcopy({k: v for k, v in small["ms"].items()
                         if k != "pines"})
    run["kl"]["final"][1] = run["kl"]["start"][1] + 1.0
    with pytest.raises(AssertionError, match="KL"):
        chip_smoke.multi_scene_gates(run, small["ref"]["full"])


def test_fingerprint_gate_refuses_other_walks(small):
    ms = small["ms"]
    want = copy.deepcopy(small["ref"]["full"]["stage1"][0])
    want["walk_vals"][0][0] += 1e-3
    ih = ms["pines"]["ih"]
    rows = np.asarray(small["ref"]["full"]["sample_rows"])
    got = chip_smoke.stage1_fingerprint(ih, rows)
    with pytest.raises(AssertionError, match="walk rows differ"):
        chip_smoke.fingerprint_gate(ms["pines"]["data"], got, want, rows, K,
                                    exact_walks=True)
    # on the card the walk rows are compared, not gated
    out = chip_smoke.fingerprint_gate(ms["pines"]["data"], got, want, rows,
                                      K, exact_walks=False)
    assert 0.0 < out["walk_total_variation_max"] < 1e-2
    # another kNN hash: both row sets are held to float64 instead
    want = copy.deepcopy(small["ref"]["full"]["stage1"][0])
    want["knn_ids_sha256"] = "0" * 64
    out = chip_smoke.fingerprint_gate(ms["pines"]["data"], got, want, rows,
                                      K, exact_walks=True)
    assert out["card_exactness"]["max_swap_over_band"] <= 1.0
    assert out["record_exactness"]["rows_differing"] == (
        out["card_exactness"]["rows_differing"])


def test_multi_scene_record_phase(small):
    msr, ref = small["msr"], small["ref"]["record"]
    chip_smoke.multi_scene_record_gates(msr, ref)
    assert msr["levels"] == ref["levels"]
    assert {k: v["tsne_repulsion"] for k, v in msr["launches"].items()} == {
        "250": 250, "1000": 1000}


def test_sharded_phase(small):
    sh = small["sh"]
    chip_smoke.sharded_gates(sh)
    assert sh["tsne"]["2"]["launches"]["tsne_repulsion"] == 200
    assert sh["grid_tsne"]["2"]["launches"]["grid_deposit"] == 200
    assert sh["grid_tsne"]["2"]["launches"]["grid_interpolate"] == 200
    assert sh["umap"]["edge_tier"]["bits_equal_across_runs"]
    bad = copy.deepcopy(sh)
    bad["tsne"]["kl_rel_gap_1_2"] = 0.05
    with pytest.raises(AssertionError, match="KL"):
        chip_smoke.sharded_gates(bad)


def test_sharded_edge_oracle_gate(small):
    """The edge tier against the sequential oracle over the seeds: each
    seed's ratio printed, the gate passes here; a mean below 0.99, one seed
    below the measured floor, or fewer than 8 seeds are each caught."""
    r = small["sh"]["umap"]["edge_vs_oracle"]
    assert r["seeds"] == list(chip_smoke.SHARDED_SEEDS)
    assert r["epochs"] == chip_smoke.SHARDED_SEED_EPOCHS
    assert len(r["ratios"]) == len(r["edge_tier"]) == len(r["sequential"])
    assert r["ratios"] == [a / b for a, b in zip(r["edge_tier"],
                                                 r["sequential"])]
    chip_smoke.edge_oracle_gate(r)
    floor = chip_smoke.EDGE_ORACLE_SEED_MIN
    low_mean = {**r, "ratios": [0.985] * len(r["ratios"]),
                "mean_ratio": 0.985}
    one_low = {**r, "ratios": [*r["ratios"][:-1], floor - 1e-4]}
    few = {**r, "seeds": r["seeds"][:7]}
    for bad, match in ((low_mean, "mean ratio"), (one_low, "seed ratios"),
                       (few, "fewer than 8")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.edge_oracle_gate(bad)
        bad_run = copy.deepcopy(small["sh"])
        bad_run["umap"]["edge_vs_oracle"] = bad
        with pytest.raises(AssertionError, match=match):
            chip_smoke.sharded_gates(bad_run)
