#!/usr/bin/env python3
"""The JAX package's NEIGH_WALKS hierarchies on the Salinas-shaped scene,
on JAX-CPU: the record chip_smoke.py's phase salinas_walks holds the port
to.

    JAX_PLATFORMS=cpu python3 scripts/salinas_walks_reference.py
        [--threads T] [--shape ROWS COLS BANDS] [--out FILE]

The scene and settings are chip_smoke.salinas_walks_settings's
(benchmarks/bench_salinas.py:41-75): create_hyperspectral_scene(512, 217,
224, seed=13), Scaler.NONE; stage 1 the exact kNN, k = 31, symmetric and
connected, computed once and shared through a kNN cache; stage 2
NEIGH_WALKS, 50 walks of 10 steps, NORMAL weighting, min_reduction 98,
max_levels 10, with two walk handlings:

- rw_only: MERGE_RW_ONLY (the hierarchy bench_salinas.py times): levels
  and walk lengths;
- new_walks_and_knn: MERGE_RW_NEW_WALKS_AND_KNN, with stage 3 for level 1
  only: levels, walk lengths, level 1's kNN tier (approximate above
  SPH_APPROX_KNN_THRESHOLD, 8192, components) and its recall on 256
  sampled rows (default_rng(1)) against the exact Bhattacharyya kNN of
  those rows, taken in float64 over all components (chip_smoke.
  bhattacharyya_f64): a neighbour counts when its distance is at most the
  row's exact k-th distance plus the float32 band (chip_smoke.
  overlap_recall, chip_smoke.walks_band).

Two swaps make the run fit in minutes; both are set in this process only,
and nothing in sph_tpu is edited (scripts/salinas_euclid_reference.py has
both):
- stage 1's exact kNN is the port's CPU knn_bruteforce, which gives the
  JAX package's ids and distances bit for bit;
- the approximate kNN's pair function (the JAX package's own walk
  Bhattacharyya) is called on chunks of the candidate pairs in `threads`
  threads; each pair's value is independent of its chunk.
It is a full-size run: take it to a machine with the memory for it.  The
JSON records the seconds each part took and the platform: 2495 s in all
on the 8 cores of an H100 host with --threads 4 and
scripts/pines_walks_reference.py beside it (stage 2 608 s and 267 s,
the approximate walk kNN's stage 3 1526 s).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="another scene size, for a rehearsal")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_salinas_walks_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    import numpy as np
    import chip_smoke
    import sph_tpu as J
    from salinas_euclid_reference import chunked_pair_fn, port_exact_knn
    from sph_tpu.models.level_similarities import _approx_knn_threshold
    import sph_tpu.models.nearest_neighbors as nearest_neighbors
    import sph_tpu.ops.component_knn as component_knn
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")

    shape = tuple(args.shape or chip_smoke.SALINAS_SHAPE)
    t = time.perf_counter()
    img = create_hyperspectral_scene(*shape, seed=13)
    data = J.scale(J.ImageStack.from_array(img, name="salinas_walks").data,
                   J.Scaler.NONE)
    seconds = {"data": time.perf_counter() - t}
    nearest_neighbors.compute_knn = port_exact_knn(
        nearest_neighbors.compute_knn)
    original = component_knn.approx_pair_metric_knn
    calls = []

    def approx_in_chunks(pair_fn, features, k, **kw):
        calls.append(features.shape[0])
        return original(chunked_pair_fn(pair_fn, args.threads), features,
                        k, **kw)

    component_knn.approx_pair_metric_knn = approx_in_chunks
    cache = J.CacheSettings(path=os.path.join(
        tempfile.mkdtemp(prefix="salinas_walks_"), "knn"),
        file_name="salinas_walks", cache_active=True)
    runs = {}
    for key, handling, level_to_compute in (
            ("rw_only", "merge_rw_only", None),
            ("new_walks_and_knn", "merge_rw_new_walks_and_knn", 1)):
        ihs, lss, rws, nns = chip_smoke.salinas_walks_settings(
            J, handling, level_to_compute or -1)
        ch = J.ComputeHierarchy().init(data, shape[0], shape[1], ihs=ihs,
                                       lss=lss, rws=rws, nns=nns,
                                       knn_cache=cache)
        stages = [("stage1_knn", ch.compute_knn_graph),
                  ("stage2_hierarchy", ch.compute_image_hierarchy)]
        if level_to_compute is not None:
            stages.append(("stage3_level_1", ch.compute_level_similarities))
        for name, stage in stages:
            t = time.perf_counter()
            stage()
            seconds[f"{key} {name}"] = time.perf_counter() - t
            print(key, name, seconds[f"{key} {name}"], flush=True)
        h = ch.image_hierarchy.hierarchy
        run = {"handling": handling,
               "levels": [int(c) for c in h.num_components],
               "walk_lengths": [int(x) for x in
                                ch.image_hierarchy._rw_lengths]}
        print(key, run, flush=True)
        if level_to_compute is not None:
            ids, dists = ch.level_similarities.distance_graphs[1]
            walks = h.random_walks[1]
            levels = run["levels"]
            pick = np.sort(np.random.default_rng(1).choice(
                levels[1], min(chip_smoke.SALINAS_WALKS_RECALL_ROWS,
                               levels[1]), replace=False))
            t = time.perf_counter()
            d64 = chip_smoke.bhattacharyya_f64(walks, pick)
            k = ids.shape[1]
            kth = np.partition(d64, k - 1, axis=1)[:, k - 1]
            seconds[f"{key} exact_kth_sampled_rows"] = (
                time.perf_counter() - t)
            run.update(
                level_1_k=int(k),
                level_1_knn_tier="approximate" if calls else "exact",
                level_1_recall=chip_smoke.overlap_recall(
                    ids[pick], dists[pick],
                    kth + chip_smoke.walks_band(walks)),
                recall_rows=f"{len(pick)} sampled, "
                            "np.random.default_rng(1)")
            print(key, "level-1 recall", run["level_1_recall"], flush=True)
        runs[key] = run
    record = {
        "what": "JAX package (sph_tpu) on the CPU: chip_smoke."
                "salinas_walks_settings (bench_salinas.py:41-75), "
                "NEIGH_WALKS on create_hyperspectral_scene("
                f"{', '.join(map(str, shape))}, seed=13), Scaler.NONE, "
                "exact kNN k=31 symmetric + connected, 50 x 10 NORMAL "
                "walks; MERGE_RW_ONLY (stages 1-2) and "
                "MERGE_RW_NEW_WALKS_AND_KNN (stages 1-3, stage 3 for "
                "level 1 only)",
        "script": "scripts/salinas_walks_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__, "size": list(shape),
        "approx_knn_threshold": _approx_knn_threshold(),
        "runs": runs, "cpu_seconds": seconds, "threads": args.threads}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
