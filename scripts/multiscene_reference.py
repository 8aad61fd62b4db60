#!/usr/bin/env python3
"""The JAX package's batched multi-scene path on JAX-CPU: the record
chip_smoke.py's phases multi_scene and multi_scene_record hold the port to.

    JAX_PLATFORMS=cpu python3 scripts/multiscene_reference.py
        [--full-levels 0 15] [--side 145] [--bands 200] [--scenes 16]
        [--k 91] [--record-side 48] [--skip-full] [--out FILE]

It runs on eight host devices (the XLA flag is set here, before jax is
imported), as tests/conftest.py's mesh does.  Two sizes:

- full: BASELINE config 5, 16 scenes create_hyperspectral_scene(145, 145,
  200, seed=7 + i) (scene 0 is the Pines image), bench.py:97-122's
  flagship settings (k = 91, NEIGH_WALKS, MERGE_RW_ONLY, 50 x 10 NORMAL
  walks, seed 1, merge_multiple off) through
  sph_tpu.parallel.sharded.multi_scene_stage1: per scene the sha256 of its
  kNN ids (int32, C order) and, on 64 rows (default_rng(0)), the kNN ids
  and the sha256 of each walk row's nonzero ids, with the walk rows' ids
  and values on the first 16 of them; then the levels of the scenes
  named by --full-levels, each through multi_scene_hierarchy's per-scene
  loop over that stage 1 (ImageHierarchy.set_preparations, then the level
  similarities);
- record: benchmarks/bench_multiscene.py's defaults at 4 scenes, 48 x 48
  x 32 (seed i), k = 16, 20 x 6 walks (CONSTANT weights, the settings'
  default): multi_scene_hierarchy's levels, then
  multi_scene_tsne of every scene's level-0 P on a 4-device mesh for 250
  iterations (the bench's default) and for 1000, each scene's KL (the JAX
  package's tsne_kl_divergence under its normalised P).

It imports nothing of the port.  A full-size run: take it to a machine with
the memory for it.  The JSON records the seconds of each part and the
platform.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_ROWS = 64
WALK_ROWS = 16             # sampled rows whose walk rows are kept whole


def settings(J, k: int, walks: int, length: int, flagship: bool):
    """bench.py:97-122's flagship hierarchy settings (NORMAL walk weights),
    or benchmarks/bench_multiscene.py's (the settings' own defaults)."""
    if flagship:
        ihs = J.ImageHierarchySettings(
            component_sim=J.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False, max_dist=0.0, min_num_comp=1,
            min_reduction=98.0, max_levels=10,
            rw_handling=J.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=(
                J.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION),
            norm_knn_distances=J.NormalizationScheme.TSNE)
        rws = J.RandomWalkSettings(
            num_random_walks=walks, single_walk_length=length,
            random_seed=1, importance_weighting=J.ImportanceWeighting.NORMAL)
    else:
        ihs = J.ImageHierarchySettings(
            component_sim=J.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False)
        rws = J.RandomWalkSettings(num_random_walks=walks,
                                   single_walk_length=length, random_seed=1)
    lss = J.LevelSimilaritiesSettings(
        component_sim=J.ComponentSim.NEIGH_WALKS, ks=[k],
        random_walk_pair_sims=True,
        normalize_prob_dist=J.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=J.NormalizationScheme.TSNE)
    return ihs, rws, lss


def scene_levels(J, datas, stage1, i, rows, cols, ihs, rws, lss):
    """multi_scene_hierarchy's loop body for scene i over a given stage 1
    (sph_tpu/parallel/sharded.py:731-750)."""
    import dataclasses

    import numpy as np
    from sph_tpu.models.image_hierarchy import ImageHierarchy
    from sph_tpu.models.level_similarities import LevelSimilarities
    from sph_tpu.ops.graph import KnnGraph
    from sph_tpu.ops.sparse import SparseRows
    n = rows * cols
    g = KnnGraph(stage1["idx"][i], stage1["dist"][i])
    ih = ImageHierarchy(g, datas[i], rows, cols)
    ih.set_settings(ihs, rws)
    pd = SparseRows(np.where(stage1["probs"][i] > 0, stage1["idx"][i], -1
                             ).astype(np.int32), stage1["probs"][i], n)
    ih.set_preparations(pd, SparseRows(stage1["walks_idx"][i],
                                       stage1["walks_val"][i], n))
    ih.compute()
    ls = LevelSimilarities(ih.hierarchy, g, datas[i],
                           dataclasses.replace(lss))
    ls.set_image_hierarchy(ih)
    ls.compute()
    return [int(c) for c in ih.hierarchy.num_components]


def walk_ids_sha256(ids) -> str:
    """The sha256 of a walk row's nonzero ids as int32 bytes."""
    import numpy as np
    return hashlib.sha256(np.asarray(ids, np.int32).tobytes()).hexdigest()


def fingerprint(stage1, i, sample):
    """Scene i's stage 1: its kNN ids' sha256 and, on the sampled rows,
    the kNN ids and each walk row's id hash; the walk rows' nonzero ids and
    values on the first WALK_ROWS of them (all 64 would take megabytes)."""
    import numpy as np
    idx = np.ascontiguousarray(stage1["idx"][i], dtype=np.int32)
    widx, wval = stage1["walks_idx"][i], stage1["walks_val"][i]
    walk_ids, walk_vals = [], []
    for r in sample:
        ok = (widx[r] >= 0) & (wval[r] != 0)
        walk_ids.append([int(v) for v in widx[r][ok]])
        walk_vals.append([float(v) for v in wval[r][ok]])
    return {"knn_ids_sha256": hashlib.sha256(idx.tobytes()).hexdigest(),
            "knn_ids": idx[sample].tolist(),
            "walk_ids_sha256": [walk_ids_sha256(w) for w in walk_ids],
            "walk_ids": walk_ids[:WALK_ROWS],
            "walk_vals": walk_vals[:WALK_ROWS]}


def kl_per_scene(embs, pi, pv):
    """Each scene's KL under its P, normalised as multi_scene_tsne
    normalises it (sph_tpu/parallel/sharded.py:417-421)."""
    import jax.numpy as jnp
    import numpy as np
    from sph_tpu.models.tsne import tsne_kl_divergence
    s, n, _ = embs.shape
    out = []
    for i in range(s):
        p = pv[i] / max(float(pv[i].sum()), 1e-12)
        out.append(float(tsne_kl_divergence(
            jnp.asarray(embs[i]), jnp.asarray(pi[i]),
            jnp.asarray(p.astype(np.float32)), jnp.int32(n), n)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-levels", type=int, nargs="*", default=[0, 15])
    ap.add_argument("--side", type=int, default=145)
    ap.add_argument("--bands", type=int, default=200)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--k", type=int, default=91)
    ap.add_argument("--record-side", type=int, default=48)
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_multiscene_reference.json"))
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import sph_tpu as J
    from sph_tpu.parallel.mesh import make_mesh
    from sph_tpu.parallel.sharded import (multi_scene_hierarchy,
                                          multi_scene_stage1,
                                          multi_scene_tsne)
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")

    out = {"what": "the JAX package's multi-scene path on JAX-CPU, eight "
                   "host devices",
           "script": "scripts/multiscene_reference.py",
           "platform": jax.devices()[0].platform, "jax": jax.__version__,
           "devices": len(jax.devices())}
    seconds = {}

    if not args.skip_full:
        side, bands, s, k = args.side, args.bands, args.scenes, args.k
        n = side * side
        datas = np.stack([create_hyperspectral_scene(
            side, side, bands, seed=7 + i).reshape(n, bands)
            for i in range(s)]).astype(np.float32)
        ihs, rws, lss = settings(J, k, 50, 10, flagship=True)
        t = time.perf_counter()
        stage1 = multi_scene_stage1(datas, k, rws=rws,
                                    norm=ihs.norm_knn_distances)
        seconds["full_stage1"] = time.perf_counter() - t
        sample = np.sort(np.random.default_rng(0).choice(
            n, SAMPLE_ROWS, replace=False))
        full = {"shape": [side, side, bands], "scenes": s,
                "seeds": [7 + i for i in range(s)], "k": k,
                "walks": [50, 10, "normal", 1],
                "walk_width": int(stage1["walks_idx"].shape[2]),
                "sample_rows": [int(r) for r in sample],
                "stage1": [fingerprint(stage1, i, sample)
                           for i in range(s)],
                "levels": {}}
        for i in args.full_levels:
            t = time.perf_counter()
            full["levels"][str(i)] = scene_levels(
                J, datas, stage1, i, side, side, ihs, rws, lss)
            seconds[f"full_levels_scene_{i}"] = time.perf_counter() - t
            print(f"scene {i}: {full['levels'][str(i)]}", flush=True)
        out["full"] = full
        del stage1, datas

    side, s, k = args.record_side, 4, 16
    n = side * side
    datas = np.stack([create_hyperspectral_scene(side, side, 32, seed=i
                                                 ).reshape(n, 32)
                      for i in range(s)]).astype(np.float32)
    ihs, rws, lss = settings(J, k, 20, 6, flagship=False)
    t = time.perf_counter()
    results = multi_scene_hierarchy(datas, side, side, k=k, ihs=ihs,
                                    rws=rws, lss=lss)
    seconds["record_hierarchy"] = time.perf_counter() - t
    width = max(ls.get_prob_dist(0).width for _, ls in results)
    pi = np.full((s, n, width), -1, np.int32)
    pv = np.zeros((s, n, width), np.float32)
    for i, (_, ls) in enumerate(results):
        m = ls.get_prob_dist(0)
        pi[i, :, :m.width] = np.asarray(m.indices)
        pv[i, :, :m.width] = np.asarray(m.values)
    record = {"shape": [side, side, 32], "scenes": s, "seeds": list(range(s)),
              "k": k, "walks": [20, 6, rws.importance_weighting.value, 1],
              "levels": [[int(c) for c in ih.hierarchy.num_components]
                         for ih, _ in results],
              "p_width": width, "kl": {}}
    for iters in (250, 1000):
        t = time.perf_counter()
        embs = multi_scene_tsne(pi, pv, iters, make_mesh(4))
        seconds[f"record_tsne_{iters}"] = time.perf_counter() - t
        record["kl"][str(iters)] = kl_per_scene(embs, pi, pv)
    out["record"] = record
    out["seconds"] = seconds
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(json.dumps({"seconds": seconds,
                      "record_levels": record["levels"],
                      "record_kl": record["kl"],
                      "full_levels": out.get("full", {}).get("levels")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
