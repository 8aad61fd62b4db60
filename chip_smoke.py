#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sph_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, and each raising on failure:

1. device  — CUDA and exactly one visible card; its name and the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build   — compile every CUDA kernel of the main path from csrc/, and the
   host graph ops from sph_tpu/native/graphops.cpp.
3. kernels — each kernel against its plain PyTorch twin on the card at the
   main path's shapes, with the time per call of both (CUDA events).
4. main    — the Pines configuration of bench.py:89-136 at 145x145x200
   through ComputeHierarchy(device="cuda") and 2000 level-1 t-SNE
   iterations through ComputeEmbedding(device="cuda"), counting kernel
   launches; then the kernel against its twin once more at the level-1
   size the main path produced.
5. checks  — monotone levels, a symmetric level-1 P whose conditional rows
   each sum to 1, a finite embedding,
   the kernel on the main path, the KL gate of bench.py:344-360 against
   docs/anchors_pines.json, and the levels against the JAX-on-CPU record in
   docs/torch_port_pines_reference.json.

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero before that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KL_SLACK = 1.01            # bench.py:344-360: KL <= 1.01 x sklearn anchor
LEVEL1_TOLERANCE = 0.02    # level-1 count within 2 % of the JAX record


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int, warmup: int = 10) -> float:
    """Mean milliseconds per call from CUDA events around `calls` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def random_joint_p(n: int, npad: int, seed: int):
    """A seeded sparse symmetric joint P (about 90 neighbors a row), zero
    diagonal and pads, summing to 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 45)
    cols = rng.integers(0, n, rows.size)
    vals = rng.random(rows.size).astype(np.float32)
    p = np.zeros((npad, npad), np.float32)
    np.add.at(p, (rows, cols), vals)
    p[:n, :n] += p[:n, :n].T.copy()
    np.fill_diagonal(p, 0.0)
    p /= p.sum()
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5.0
    return y, p


def check_forces_kernel(n: int, npad: int, seed: int) -> dict:
    """tsne_forces_dense against its twin; raises on disagreement."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (tsne_forces_dense,
                                                tsne_forces_dense_reference)
    y_np, p_np = random_joint_p(n, npad, seed)
    y = torch.from_numpy(y_np).cuda()
    p = torch.from_numpy(p_np).cuda()
    attr, rep, z = tsne_forces_dense(y, p, n)
    attr_r, rep_r, z_r = tsne_forces_dense_reference(y, p, n)
    torch.cuda.synchronize()
    z, z_r = float(z), float(z_r)
    if not abs(z - z_r) <= 1e-5 * abs(z_r):
        raise AssertionError(f"tsne_forces_dense n={n}: Z {z} vs twin {z_r}")
    err = 0.0
    for name, got, ref in (("attr", attr, attr_r), ("rep", rep, rep_r)):
        scale = float(ref.abs().max())
        e = float((got - ref).abs().max())
        if not e <= 1e-5 * scale:
            raise AssertionError(f"tsne_forces_dense n={n}: {name} max "
                                 f"error {e} > 1e-5 x {scale}")
        if bool((got[n:] != 0).any()):
            raise AssertionError(f"tsne_forces_dense n={n}: {name} pad rows "
                                 "are not 0")
        err = max(err, e)
    calls = 200
    ms = cuda_ms(lambda: tsne_forces_dense(y, p, n), calls)
    plain_ms = cuda_ms(lambda: tsne_forces_dense_reference(y, p, n), calls)
    return {"n": n, "npad": npad, "max_abs_err": err,
            "z_rel_err": abs(z - z_r) / abs(z_r), "ms": ms,
            "plain_ms": plain_ms, "calls_timed": calls}


def pines_hierarchy(device: str):
    """The bench.py:89-136 configuration at 145x145x200 as an initialised
    (not yet computed) ComputeHierarchy; returns it with its level settings
    and the data matrix."""
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows = cols = 145
    img = create_hyperspectral_scene(rows, cols, 200, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="pines_synth").data,
                   T.Scaler.NONE)
    k = 91
    lss_main = T.LevelSimilaritiesSettings(
        component_sim=T.ComponentSim.NEIGH_WALKS, ks=[k],
        random_walk_pair_sims=True,
        normalize_prob_dist=T.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=T.NormalizationScheme.TSNE)
    ch = T.ComputeHierarchy(device=device).init(
        data, rows, cols,
        ihs=T.ImageHierarchySettings(
            component_sim=T.ComponentSim.NEIGH_WALKS,
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_num_comp=1, min_reduction=98.0, max_levels=10,
            rw_handling=T.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=T.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
            norm_knn_distances=T.NormalizationScheme.TSNE),
        lss=lss_main,
        rws=T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=T.NearestNeighborsSettings(
            num_nearest_neighbors=k, symmetric_neighbors=True,
            compute_connect_components=True,
            neighbor_connect_components=True))
    return ch, lss_main, data


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    if count != 1:
        print(f"chip_smoke: needs exactly one visible card, found {count}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import sph_tpu_torch as T
    from sph_tpu_torch import native
    from sph_tpu_torch.ops import tsne_kernels
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    so = tsne_kernels.build()
    emit({"phase": "build", "kernel": "tsne_forces_dense",
          "seconds": time.perf_counter() - t0, "library": os.path.basename(so)})
    # the host graph ops (g++), built here so no stage below times the build
    t0 = time.perf_counter()
    native.get_lib()
    emit({"phase": "build", "library": "graphops (host, g++)",
          "seconds": time.perf_counter() - t0})

    checks = [check_forces_kernel(5284, 6144, seed=11),
              check_forces_kernel(1000, 1024, seed=12)]
    for c in checks:
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense", **c})

    # ---- the main path: bench.py:89-136 at full size --------------------
    ch, lss_main, data = pines_hierarchy("cuda")
    tsne_kernels.tsne_forces_dense.launches = 0
    seconds = {}
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_similarities",
                         ch.compute_level_similarities)):
        t = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
    levels = list(ch.image_hierarchy.hierarchy.num_components)
    p1 = ch.level_similarities.get_prob_dist(1)
    iters = 2000
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    ce = T.ComputeEmbedding(es, device="cuda")
    t = time.perf_counter()
    emb = ce.compute_tsne(p1, track_kl=True)
    torch.cuda.synchronize()
    seconds["tsne"] = time.perf_counter() - t
    launches = tsne_kernels.tsne_forces_dense.launches
    kl = float(ce.last_kl)
    emit({"phase": "main", "levels": levels, "level_1_kl": kl,
          "seconds": seconds, "tsne_iterations": iters,
          "tsne_iters_per_s": iters / seconds["tsne"],
          "tsne_forces_dense_launches": launches})

    # the kernel once more at the level-1 size the main path just gave it
    from sph_tpu_torch.models.tsne import dense_npad
    checks.append(check_forces_kernel(levels[1], dense_npad(levels[1]),
                                      seed=13))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "main_path_shape": True, **checks[-1]})

    # ---- checks ----------------------------------------------------------
    if not all(a > b for a, b in zip(levels, levels[1:])):
        raise AssertionError(f"component counts do not decrease: {levels}")
    if len(levels) < 2 or levels[1] <= 1:
        raise AssertionError(f"level 1 has no structure: {levels}")
    # the t-SNE input is the symmetrized (P + P^T) / 2: symmetric, with the
    # total mass of the conditional rows, each of which sums to 1
    dense = torch.from_numpy(p1.to_dense())
    asym = float((dense - dense.T).abs().max())
    if not asym <= 1e-6:
        raise AssertionError(f"level-1 P is not symmetric: {asym}")
    mean_sum = float(dense.sum()) / levels[1]
    if not abs(mean_sum - 1.0) <= 1e-3:
        raise AssertionError(f"level-1 P mass {mean_sum} per row, not 1")
    lss = T.LevelSimilaritiesSettings(
        component_sim=T.ComponentSim.NEIGH_WALKS,
        ks=list(lss_main.ks), level_to_compute=1,
        random_walk_pair_sims=True,
        normalize_prob_dist=T.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=T.NormalizationScheme.NONE)
    cond = T.LevelSimilarities(ch.image_hierarchy.hierarchy,
                               ch.knn_stage.connected_graph, data, lss,
                               device="cuda")
    cond.set_image_hierarchy(ch.image_hierarchy)
    cond.compute(lss)
    sums = cond.get_prob_dist(1).row_sums()
    if not np.all(np.abs(sums - 1.0) <= 1e-3):
        raise AssertionError("level-1 conditional P rows do not sum to 1: "
                             f"worst {float(np.abs(sums - 1.0).max())}")
    if not np.all(np.isfinite(emb)):
        raise AssertionError("the embedding is not finite")
    if launches < iters:
        raise AssertionError(f"tsne_forces_dense launched {launches} times "
                             f"in {iters} iterations")
    with open(os.path.join(REPO, "docs", "anchors_pines.json")) as f:
        anchor = json.load(f)["kl_under_p_sklearn_bh"]
    if not kl <= KL_SLACK * anchor:
        raise AssertionError(f"level-1 KL {kl} > {KL_SLACK} x anchor {anchor}")
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_reference.json")) as f:
        ref = json.load(f)
    ref_levels = ref["levels"]
    if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
        raise AssertionError(f"level-1 count {levels[1]} not within 2 % of "
                             f"the JAX record {ref_levels[1]}")
    if abs(len(levels) - len(ref_levels)) > 1:
        raise AssertionError(f"{len(levels)} levels vs {len(ref_levels)} in "
                             "the JAX record")
    emit({"phase": "checks", "passed": True, "kl_gate": KL_SLACK * anchor,
          "jax_cpu_levels": ref_levels, "jax_cpu_level_1_kl":
              ref["level_1_kl"]})

    main_shape = checks[-1]
    emit({"kernels": [{
        "name": "tsne_forces_dense", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_forces_dense.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:167",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
