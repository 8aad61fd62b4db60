#!/usr/bin/env python3
"""The JAX package's EUCLID_CENTROID hierarchy on the Salinas-shaped scene,
on JAX-CPU: the record chip_smoke.py's phase salinas_euclid holds the port
to.

    JAX_PLATFORMS=cpu python3 scripts/salinas_euclid_reference.py
        [--threads T] [--shape ROWS COLS BANDS] [--out FILE]

The scene and settings are chip_smoke.salinas_settings's, shared with the
phase: create_hyperspectral_scene(512, 217, 224, seed=13), Scaler.NONE;
stage 1 the exact kNN (KnnIndex.FLAT), k = 31, symmetric and connected;
stage 2 run_evaluation.py's ImageHierarchySettings
(sph_tpu/evaluation/run_evaluation.py:150-159) with EUCLID_CENTROID,
num_geodesic_samples 100, FOUR connectivity, random_seed 1; stage 3
EUCLID_CENTROID with ks = [31], TSNE normalisation and symmetrisation, for
level 1 only (level_to_compute = 1).  Level 1 lies above
SPH_APPROX_KNN_THRESHOLD (8192) components, so it takes the approximate
component kNN.  Records the levels, each level's largest set, level 1's
kNN tier, and the recall of its approximate kNN on 1024 sampled rows
(default_rng(1)) against the exact Hausdorff to every component
(chip_smoke.overlap_recall: a neighbour counts when its distance is at most
the row's exact k-th).  Writes docs/torch_port_salinas_euclid_reference.json
by default.

Two equal-valued swaps make the run fit in minutes; both are set in this
process only, and nothing in sph_tpu is edited:
- Stage 1's exact kNN: the JAX package's blocked kNN sorts every
  [256, 2079] tile on XLA-CPU and had not finished 111104 points after 45
  minutes on 8 cores.  Its NearestNeighbors gets the port's CPU
  knn_bruteforce instead (torch CPU matmul and top-k with tie-free keys),
  which gives the JAX package's ids and distances bit for bit
  (tests/test_torch_ops.py and tests/test_torch_smoke_checks.py hold them
  equal); symmetrizing and connecting stay the JAX package's.
- Stage 3's pair metric: the JAX package's approximate EUCLID branch hands
  approx_pair_metric_knn a pair function that gathers every candidate
  pair's sample rows at once (about 6e7 pairs x 25 int64 here); the same
  pair function is called on chunks of pairs, in `threads` threads.  Each
  pair's distance is independent of its chunk, so the values are the JAX
  package's own (tests/test_torch_smoke_checks.py holds the chunked and
  the whole call equal).
It is a full-size run: take it to a machine with the memory for it (about
15 GB of host arrays in stage 3).  On the 8 cores of an H100 host it takes
the minutes that docs/torch_port_salinas_euclid_reference.json records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLED_ROWS = 1024
PAIR_CHUNK = 1 << 18


def chunked_pair_fn(pair_fn, threads: int, chunk: int = PAIR_CHUNK):
    """`pair_fn(a, b)` evaluated on chunks of the pairs, `threads` chunks
    at a time; the results concatenated in pair order."""
    import concurrent.futures as cf
    import numpy as np

    def fn(a, b):
        starts = range(0, len(a), chunk)
        with cf.ThreadPoolExecutor(threads) as ex:
            parts = list(ex.map(
                lambda i0: pair_fn(a[i0:i0 + chunk], b[i0:i0 + chunk]),
                starts))
        return (np.concatenate(parts) if parts
                else np.empty(0, np.float32))
    return fn


def port_exact_knn(jax_compute_knn):
    """The JAX package's compute_knn with the exact engines (BRUTE_FORCE,
    FLAT) taken by the port's CPU knn_bruteforce; numpy results, as the JAX
    package returns them on the CPU."""
    def compute_knn(data, k, index=None, metric=None, l2_squared=False,
                    seed=0, keep_on_device=False, data_dev=None):
        from sph_tpu.settings import KnnIndex, KnnMetric
        import sph_tpu_torch as T
        from sph_tpu_torch.ops.knn import knn_bruteforce
        index = KnnIndex.FLAT if index is None else index
        metric = KnnMetric.L2 if metric is None else metric
        if keep_on_device or index not in (KnnIndex.BRUTE_FORCE,
                                           KnnIndex.FLAT):
            return jax_compute_knn(data, k, index, metric, l2_squared, seed,
                                   keep_on_device, data_dev)
        return knn_bruteforce(data, k, T.KnnMetric(metric.value),
                              l2_squared, device="cpu")
    return compute_knn


def exact_kth(pair_fn, rows, c: int, k: int):
    """The exact kNN's k-th distance of each of `rows` over all c
    components (self at 0 included), from `pair_fn`."""
    import numpy as np
    rows = np.asarray(rows, np.int64)
    d = pair_fn(np.repeat(rows, c), np.tile(np.arange(c), len(rows)))
    d = d.reshape(len(rows), c)
    d[np.arange(len(rows)), rows] = 0.0
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="another scene size, for a rehearsal")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_salinas_euclid_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    import chip_smoke
    import sph_tpu as J
    from sph_tpu.models.level_similarities import _approx_knn_threshold
    import sph_tpu.models.nearest_neighbors as nearest_neighbors
    import sph_tpu.ops.component_knn as component_knn
    from sph_tpu.ops.similarities import hausdorff_point_set_distance
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    from sph_tpu.utils.timer import phase_report
    set_level("WARNING")
    os.environ["SPH_PHASE_TIMERS"] = "1"

    rows_, cols_, bands = args.shape or chip_smoke.SALINAS_SHAPE
    img = create_hyperspectral_scene(rows_, cols_, bands, seed=13)
    data = J.scale(J.ImageStack.from_array(img, name="salinas_euclid").data,
                   J.Scaler.NONE)
    ihs, lss, rws, nns = chip_smoke.salinas_settings(J, level_to_compute=1)
    ch = J.ComputeHierarchy().init(data, rows_, cols_, ihs=ihs, lss=lss,
                                   rws=rws, nns=nns)
    original = component_knn.approx_pair_metric_knn
    calls = []

    def approx_in_chunks(pair_fn, features, k, **kw):
        calls.append(features.shape[0])
        return original(chunked_pair_fn(pair_fn, args.threads), features,
                        k, **kw)

    component_knn.approx_pair_metric_knn = approx_in_chunks
    nearest_neighbors.compute_knn = port_exact_knn(
        nearest_neighbors.compute_knn)
    seconds = {}
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_1", ch.compute_level_similarities)):
        t = time.perf_counter()
        stage()
        seconds[name] = time.perf_counter() - t
        print(name, seconds[name], flush=True)
        print(phase_report(), flush=True)
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    print("levels", levels, flush=True)
    largest = [int(np.bincount(h.pixel_components[lv]).max())
               for lv in range(len(levels))]

    ls = ch.level_similarities
    ids, dists = ls.distance_graphs[1]
    rep = ls._rep_samples(1)
    k1 = ids.shape[1]
    sampled = np.sort(np.random.default_rng(1).choice(
        levels[1], min(SAMPLED_ROWS, levels[1]), replace=False))
    t = time.perf_counter()
    pair = chunked_pair_fn(lambda a, b: hausdorff_point_set_distance(
        np.asarray(data, np.float32), rep[a], rep[b]), args.threads)
    kth = exact_kth(pair, sampled, levels[1], k1)
    seconds["exact_kth_sampled_rows"] = time.perf_counter() - t
    recall = chip_smoke.overlap_recall(ids[sampled], dists[sampled], kth)
    print("level-1 component kNN recall", recall, flush=True)

    record = {
        "what": "JAX package (sph_tpu) on the CPU: chip_smoke."
                "salinas_settings, EUCLID_CENTROID in both stages on "
                f"create_hyperspectral_scene({rows_}, {cols_}, {bands}, "
                "seed=13), Scaler.NONE, exact kNN k=31 symmetric + "
                "connected, run_evaluation.py's ImageHierarchySettings "
                "with num_geodesic_samples=100, random_seed=1; stage 3 for "
                "level 1 only",
        "script": "scripts/salinas_euclid_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__,
        "size": [rows_, cols_, bands],
        "approx_knn_threshold": _approx_knn_threshold(),
        "levels": levels,
        "largest_set_by_level": largest,
        "level_1_k": int(k1),
        "level_1_samples": int(rep.shape[1]),
        "level_1_knn_tier": "approximate" if calls else "exact",
        "level_1_component_knn_recall": recall,
        "recall_rows": f"{len(sampled)} sampled, "
                       "np.random.default_rng(1)",
        "cpu_seconds": seconds,
        "threads": args.threads,
        "pair_metric": "the JAX package's hausdorff_point_set_distance, "
                       f"called on chunks of {PAIR_CHUNK} pairs",
        "stage1_exact_knn": "the port's CPU knn_bruteforce (bit-equal to "
                            "the JAX package's)",
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
