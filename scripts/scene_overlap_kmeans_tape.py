#!/usr/bin/env python3
"""Do the k-means' float32 sums explain why the port's scene_overlap levels
past level 1 part from the JAX-CPU record?

    JAX_PLATFORMS=cpu python3 scripts/scene_overlap_kmeans_tape.py
        [--size S] [--knn-index INDEX] [--out FILE]

Runs stages 1 and 2 of chip_smoke.py's scene_overlap configuration (the
bench.py:89-136 Pines recipe at S x S x 200 on default level settings,
stage 1 on index_heuristic(S * S), IVF_FLAT at 65536 points, or on
--knn-index) twice on the
CPU: the JAX package's, with its k-means results recorded, then the
port's (device="cpu") with those results replayed into its k-means
(tests/test_torch_knn_ivf.py's KmeansTape).  With the same clustering,
every later step is the JAX package's arithmetic, so the two runs should
give the same stage-1 graph and the same levels; where they do not, the
script names the first step that differs.  Writes one JSON object to
--out (default out/scene_overlap_kmeans_tape.json).  At 256 it takes
about 11 minutes on 8 cores (JAX package: stage 1 283 s, stage 2 89 s;
the port: 11 s and 248 s).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tape():
    spec = importlib.util.spec_from_file_location(
        "test_torch_knn_ivf", os.path.join(REPO, "tests",
                                           "test_torch_knn_ivf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KmeansTape()


def hierarchy(P, side: int, index: str, **kw):
    """chip_smoke.scene_hierarchy's configuration for package P with stage
    1 on `index`, stages 1 and 2 run; returns the ComputeHierarchy and the
    stages' seconds."""
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    k = 91
    img = create_hyperspectral_scene(side, side, 200, seed=7)
    data = P.scale(P.ImageStack.from_array(img, name="scene_overlap").data,
                   P.Scaler.NONE)
    ch = P.ComputeHierarchy(**kw).init(
        data, side, side, ihs=P.ImageHierarchySettings(),
        lss=P.LevelSimilaritiesSettings(ks=[k]),
        rws=P.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=P.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=P.NearestNeighborsSettings(
            num_nearest_neighbors=k,
            knn_index=P.KnnIndex(index),
            symmetric_neighbors=True, compute_connect_components=True,
            neighbor_connect_components=True))
    seconds = {}
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy)):
        t = time.perf_counter()
        stage()
        seconds[name] = time.perf_counter() - t
        print(P.__name__, name, seconds[name], flush=True)
    return ch, seconds


def first_difference(jch, tch) -> str | None:
    """The first step at which the two hierarchies differ, or None."""
    import numpy as np
    jg, tg = jch.knn_stage.knn_graph, tch.knn_stage.knn_graph
    if not (np.array_equal(jg.indices, tg.indices)
            and np.array_equal(jg.distances, tg.distances)):
        return "stage 1: the kNN graph"
    jc, tc = jch.knn_stage.connected_graph, tch.knn_stage.connected_graph
    if not (np.array_equal(np.where(jc.mask, jc.indices, -1),
                           np.where(tc.mask, tc.indices, -1))):
        return "stage 1: the connected graph"
    jh, th = jch.image_hierarchy.hierarchy, tch.image_hierarchy.hierarchy
    for level, (a, b) in enumerate(zip(jh.pixel_components,
                                       th.pixel_components)):
        if not np.array_equal(a, b):
            return f"stage 2: the components of level {level}"
    if jh.num_components != th.num_components:
        return "stage 2: the number of levels"
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--knn-index", default=None)
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "scene_overlap_kmeans_tape.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import torch
    import sph_tpu as J
    import sph_tpu_torch as T
    from sph_tpu.ops import knn as jknn
    from sph_tpu.utils.logging import set_level as jset_level
    from sph_tpu_torch.ops import knn as tknn
    from sph_tpu_torch.utils.logging import set_level
    index = args.knn_index or tknn.index_heuristic(args.size ** 2).value
    jset_level("WARNING")
    set_level("WARNING")

    tape = _tape()
    jknn._kmeans = tape.recorder(jknn._kmeans)
    jch, jsec = hierarchy(J, args.size, index)
    tknn._kmeans = tape.replayer()
    tch, tsec = hierarchy(T, args.size, index, device="cpu")
    jl = [int(c) for c in jch.image_hierarchy.hierarchy.num_components]
    tl = [int(c) for c in tch.image_hierarchy.hierarchy.num_components]
    out = {"size": [args.size, args.size, 200], "knn_index": index,
           "jax": jax.__version__,
           "torch": torch.__version__, "kmeans_calls": len(tape.calls),
           "kmeans_replayed_all": tape.consumed(),
           "jax_levels": jl, "port_levels_kmeans_replayed": tl,
           "levels_equal": jl == tl,
           "first_difference": first_difference(jch, tch),
           "jax_cpu_seconds": jsec, "port_cpu_seconds": tsec}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
