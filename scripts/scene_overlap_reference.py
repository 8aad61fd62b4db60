#!/usr/bin/env python3
"""The JAX package's hierarchy on default level settings, on JAX-CPU: the
record chip_smoke.py's phase scene_overlap holds the port to.

    JAX_PLATFORMS=cpu python3 scripts/scene_overlap_reference.py [--size S]
        [--out FILE]

The bench.py:89-136 Pines recipe at S x S x 200 (default 256:
create_hyperspectral_scene(S, S, 200, seed=7), Scaler.NONE; k = 91 with
symmetric_neighbors, compute_connect_components and
neighbor_connect_components; 50 walks x 10 steps, seed 1), with
knn_index = index_heuristic(S * S) (IVF_FLAT at 65536 points),
ImageHierarchySettings() and LevelSimilaritiesSettings(ks=[91]) at their
defaults: NEIGH_OVERLAP, exact_knn False, TSNE normalisation.  Levels above
SPH_APPROX_KNN_THRESHOLD (8192) components take the approximate component
kNN.  Records the levels; the stage-1 kNN's recall@91 against the exact kNN
(knn_exact_rows) on 2048 sampled rows (default_rng(1)); and level 1's
approximate component kNN's recall (chip_smoke.overlap_recall) against the
exact NEIGH_OVERLAP k-th distances.  Writes
docs/torch_port_scene_overlap_reference.json by default.

Two pieces of the NEIGH_OVERLAP arithmetic come from a scipy sparse
product of the membership rows instead of the JAX package's own code, with
its float32 arithmetic and the same values (tests/test_torch_smoke_checks.py
holds both equal): the pair metric of the approximate component kNN during
stage 3 (the JAX package's sorted merge of both rows for every candidate
pair did not finish level 1 in 30 minutes on a CPU), and the exact k-th
distances (its dense knn_neighbor_overlap is a 16k x 16k x 65536
product).  Nothing in sph_tpu is edited: the pair metric
is swapped in this process only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLED_ROWS = 2048


def _intersections(indices, num_cols: int):
    """|A ^ B| for every pair of components sharing a member, as the CSR
    product of the 0/1 membership rows (`indices` [C, W], -1 padded), and
    each row's member count."""
    import numpy as np
    import scipy.sparse as sp
    c = indices.shape[0]
    mask = indices >= 0
    m = sp.csr_matrix((np.ones(int(mask.sum()), np.float32),
                       indices[mask].astype(np.int64),
                       np.concatenate([[0], np.cumsum(mask.sum(1))])),
                      shape=(c, num_cols))
    inter = (m @ m.T).tocsr()
    inter.sort_indices()
    return inter, mask.sum(1).astype(np.int32)


def overlap_distance_by_sparse_product(unions, pairs_a, pairs_b,
                                       chunk: int = 1 << 24):
    """sph_tpu.ops.similarities.neighbor_overlap_distance's values,
    1 - |A ^ B| / min(|A|, |B|) in float32 (0 similarity where a row is
    empty), from `_intersections`, looked up in chunks of pairs."""
    import numpy as np
    inter, counts = _intersections(unions.indices, unions.num_cols)
    c = inter.shape[0]
    keys = (np.repeat(np.arange(c, dtype=np.int64), np.diff(inter.indptr))
            * c + inter.indices)
    out = np.empty(len(pairs_a), np.float32)
    for i0 in range(0, len(pairs_a), chunk):
        a = np.asarray(pairs_a[i0:i0 + chunk], np.int64)
        b = np.asarray(pairs_b[i0:i0 + chunk], np.int64)
        want = a * c + b
        pos = np.minimum(np.searchsorted(keys, want), keys.size - 1)
        hit = np.where(keys[pos] == want, inter.data[pos], 0.0)
        msize = np.minimum(counts[a], counts[b])
        sim = np.where(msize > 0, hit.astype(np.float32)
                       / np.maximum(msize, 1).astype(np.float32),
                       np.float32(0.0))
        out[i0:i0 + chunk] = np.float32(1.0) - sim
    return out


def overlap_kth_distances(indices, num_cols: int, k: int):
    """Each component's k-th smallest NEIGH_OVERLAP distance, 1 - |A^B| /
    min(|A|, |B|), self (0) included, in float32 as the JAX package's
    knn_neighbor_overlap computes it, from `_intersections`.  Components
    sharing no member are at distance 1."""
    import numpy as np
    c = indices.shape[0]
    inter, counts = _intersections(indices, num_cols)
    counts = counts.astype(np.float32)
    kth = np.empty(c, np.float32)
    for r in range(c):
        lo, hi = inter.indptr[r], inter.indptr[r + 1]
        cols = inter.indices[lo:hi]
        mn = np.minimum(counts[r], counts[cols])
        sim = np.where(mn > 0, inter.data[lo:hi].astype(np.float32)
                       / np.maximum(mn, np.float32(1.0)), np.float32(0.0))
        d = (np.float32(1.0) - sim).astype(np.float32)
        d[cols == r] = 0.0
        if d.size < k:      # components sharing nothing sit at 1
            d = np.concatenate([d, np.ones(min(k, c) - d.size, np.float32)])
        kth[r] = np.partition(d, k - 1)[k - 1]
    return kth


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_scene_overlap_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    import chip_smoke
    import sph_tpu as J
    from sph_tpu.models.level_similarities import _approx_knn_threshold
    import sph_tpu.ops.similarities as similarities
    from sph_tpu.ops.knn import index_heuristic, knn_exact_rows
    from sph_tpu.ops.similarities import build_union_neighborhoods
    from sph_tpu.utils.testdata import create_hyperspectral_scene

    side, k = args.size, 91
    img = create_hyperspectral_scene(side, side, 200, seed=7)
    data = J.scale(J.ImageStack.from_array(img, name="scene_overlap").data,
                   J.Scaler.NONE)
    index = index_heuristic(side * side)
    ch = J.ComputeHierarchy().init(
        data, side, side, ihs=J.ImageHierarchySettings(),
        lss=J.LevelSimilaritiesSettings(ks=[k]),
        rws=J.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=J.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=J.NearestNeighborsSettings(
            num_nearest_neighbors=k, knn_index=index,
            symmetric_neighbors=True, compute_connect_components=True,
            neighbor_connect_components=True))
    seconds = {}
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_similarities",
                         ch.compute_level_similarities)):
        if name.startswith("stage3"):
            similarities.neighbor_overlap_distance = (
                overlap_distance_by_sparse_product)
        t = time.perf_counter()
        stage()
        seconds[name] = time.perf_counter() - t
        print(name, seconds[name], flush=True)
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    print("levels", levels, flush=True)

    rows = np.sort(np.random.default_rng(1).choice(
        side * side, SAMPLED_ROWS, replace=False))
    exact_rows, _ = knn_exact_rows(np.asarray(data, np.float32), rows, k)
    stage1_recall = chip_smoke.recall_at_k(
        ch.knn_stage.knn_graph.indices[rows], exact_rows)
    print("stage-1 recall", stage1_recall, flush=True)

    ls = ch.level_similarities
    ids, dists = ls.distance_graphs[1]
    graph = ch.knn_stage.connected_graph
    unions = build_union_neighborhoods(
        np.where(graph.mask, graph.indices, -1), h.pixel_components[1],
        levels[1])
    k1 = ids.shape[1]
    kth = overlap_kth_distances(unions.indices, unions.num_cols, k1)
    comp_recall = chip_smoke.overlap_recall(ids, dists, kth)
    print("level-1 component kNN recall", comp_recall, flush=True)

    record = {
        "what": "JAX package (sph_tpu) on the CPU: the bench.py:89-136 Pines "
                f"recipe at {side}x{side}x200 (create_hyperspectral_scene("
                f"{side}, {side}, 200, seed=7), Scaler.NONE, k=91 "
                "symmetric + connected, 50 walks x 10 steps, seed 1) with "
                f"knn_index={index.value} (index_heuristic), "
                "ImageHierarchySettings() and LevelSimilaritiesSettings("
                "ks=[91]) defaults (NEIGH_OVERLAP, exact_knn False)",
        "script": "scripts/scene_overlap_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__,
        "size": [side, side, 200],
        "knn_index": index.value,
        "approx_knn_threshold": _approx_knn_threshold(),
        "levels": levels,
        "level_1_components": levels[1],
        "level_1_k": int(k1),
        "level_1_approximate": bool(levels[1] > _approx_knn_threshold()),
        "stage1_recall_at_91": stage1_recall,
        "stage1_recall_rows": f"{SAMPLED_ROWS} sampled, "
                              "np.random.default_rng(1)",
        "level_1_component_knn_recall": comp_recall,
        "cpu_seconds": seconds,
        "pair_metric": "stage 3's NEIGH_OVERLAP pair metric and the exact "
                       "k-th distances from a scipy sparse product, equal "
                       "in value to the JAX package's",
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
