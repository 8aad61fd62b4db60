#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sph_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, and each raising on failure:

1. device  — CUDA and exactly one visible card; its name and the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build   — compile every CUDA kernel from csrc/ (one nvcc each, started
   together), and the host graph ops from sph_tpu/native/graphops.cpp.
3. kernel_vs_twin — each kernel against its plain PyTorch twin on the card
   at the paths' shapes, with the time per call of both (CUDA events):
   tsne_forces_dense at the Pines level-1 shapes, tsne_repulsion at
   (n, Npad) = (1000, 1024) and (65536, 65536) in full and at
   (1000000, 1000448) on 4096 sampled rows.
4. main    — the Pines configuration of bench.py:89-136 at 145x145x200
   through ComputeHierarchy(device="cuda") and 2000 level-1 t-SNE
   iterations through ComputeEmbedding(device="cuda"), counting kernel
   launches; then tsne_forces_dense against its twin once more at the
   level-1 size the path produced.
5. checks  — monotone levels, a symmetric level-1 P whose conditional rows
   each sum to 1, a finite embedding,
   the kernel on the main path, the KL gate of bench.py:344-360 against
   docs/anchors_pines.json, and the levels against the JAX-on-CPU record in
   docs/torch_port_pines_reference.json.
6. large   — BASELINE config 4 (benchmarks/bench_1m.py): a 1000x1000x100
   synthetic stack, exact kNN with k = 16 through compute_knn(BRUTE_FORCE),
   then ComputeEmbedding.compute_tsne((indices, distances)) at perplexity 5
   on the exact sparse-P tier (SPH_TSNE_GRID=0 for this phase only), cut to
   50 iterations; seconds per part, the kNN's peak memory, the KL before
   and after, the launches.
7. large_checks — kNN invariants, kNN exactness against float64 distances
   on 1024 sampled rows, a symmetric P whose conditional rows sum to 1, the
   exact tier (tsne_repulsion on every iteration, tsne_forces_dense never),
   a falling KL, a finite embedding with zero pad rows, and tsne_repulsion
   against its twin at the embedding the path produced.

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
LARGE_ITERS = 50           # 1M path: one ComputeEmbedding chunk (depth cut)
DEV = "cuda"               # the helpers' device; "cpu" rehearses them small


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


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


def repulsion_layout(n: int, npad: int, seed: int):
    """A seeded layout of n points (normal, scale 5) with garbage in the pad
    rows, which the kernel must not read."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((npad, 2), dtype=np.float32) * 50.0
    y[:n] = rng.standard_normal((n, 2), dtype=np.float32) * 5.0
    return y


def sample_ranges(npad: int, count: int = 4, width: int = 1024):
    """`count` row ranges of `width` rows spread evenly over [0, npad): the
    first starts at 0, the last ends at npad (the last real rows and the
    pad rows)."""
    width = min(width, npad // count)
    return [(s, s + width) for s in
            (i * (npad - width) // (count - 1) for i in range(count))]


def check_repulsion_kernel(y, n: int, calls: int = 0, twin_calls: int = 0,
                           sampled: bool = False) -> dict:
    """tsne_repulsion against its twin on the card, in full or on sampled
    rows; raises on disagreement.  calls > 0 also times the kernel (and
    twin_calls > 0 the full twin) with CUDA events."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (tsne_repulsion_reference,
                                                tsne_repulsion_rows)
    npad = y.shape[0]
    rep, zrow = tsne_repulsion_rows(y, n)
    if sampled:
        ranges = sample_ranges(npad)
    else:
        ranges = [(0, npad)]
    refs = [tsne_repulsion_reference(y, n, rows=r) for r in ranges]
    sync()
    got_rep = torch.cat([rep[a:b] for a, b in ranges])
    got_z = torch.cat([zrow[a:b] for a, b in ranges])
    ref_rep = torch.cat([r for r, _ in refs])
    ref_z = torch.cat([z for _, z in refs])
    name = f"tsne_repulsion n={n} npad={npad}"
    scale = float(ref_rep.abs().max())
    err = float((got_rep - ref_rep).abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{name}: rep max error {err} > 1e-5 x {scale}")
    live = ref_z > 0
    z_rel = float(((got_z - ref_z).abs()[live] / ref_z[live]).max())
    if not z_rel <= 1e-5:
        raise AssertionError(f"{name}: zrow relative error {z_rel} > 1e-5")
    if bool((rep[n:] != 0).any()) or bool((zrow[n:] != 0).any()):
        raise AssertionError(f"{name}: pad rows are not 0")
    out = {"n": n, "npad": npad, "max_abs_err": err,
           "rows_checked": sum(b - a for a, b in ranges)}
    if sampled:
        out["zrow_rel_err"] = z_rel
    else:
        z, z_ref = float(zrow.sum()), float(ref_z.double().sum())
        out["z_rel_err"] = abs(z - z_ref) / z_ref
        if not out["z_rel_err"] <= 1e-5:
            raise AssertionError(f"{name}: Z {z} vs twin {z_ref}")
    if calls:
        out["ms"] = cuda_ms(lambda: tsne_repulsion_rows(y, n), calls,
                            warmup=min(10, calls // 10))
        out["calls_timed"] = calls
    if twin_calls:
        out["plain_ms"] = cuda_ms(lambda: tsne_repulsion_reference(y, n),
                                  twin_calls, warmup=1)
        out["plain_calls_timed"] = twin_calls
    return out


def knn_exactness(data, idx, k: int, rows) -> dict:
    """The kNN's neighbour sets on `rows` against float64 distances on the
    card; raises unless a row differs from the float64 top-k only by
    swapping a point e in for a point m with d(e) - d(m) <= b(e) + b(m).
    b is an a-priori bound on the float32 rounding of the kNN's
    |x|^2 + |y|^2 - 2 x.y: sqrt(D) eps (|x|^2 + |y|^2) for D channels, as
    each of its three float32 sums of D terms gathers about sqrt(D)
    roundings of its size.  Also counts the rows outside the rule "k-th and
    (k+1)-th float64 distances within 1e-6 relative", and measures the
    float32 expansion's error on the card against eps (|x|^2 + |y|^2)."""
    import numpy as np
    import torch
    x32 = torch.as_tensor(data, device=DEV)
    x64 = x32.double()
    sq32, sq64 = (x32 * x32).sum(1), (x64 * x64).sum(1)
    eps = float(np.finfo(np.float32).eps)
    c = float(np.sqrt(x32.shape[1]))
    idx_t = torch.as_tensor(idx, device=DEV).long()
    differ = beyond_1e6 = 0
    worst_swap = worst_err = 0.0
    for c0 in range(0, len(rows), 128):
        q = torch.as_tensor(rows[c0:c0 + 128], device=DEV).long()
        ar = torch.arange(q.numel(), device=DEV)
        d64 = (sq64[q, None] + sq64[None, :] - 2.0 * (x64[q] @ x64.T))
        d64.clamp_(min=0.0)[ar, q] = 0.0
        d32 = (sq32[q, None] + sq32[None, :] - 2.0 * (x32[q] @ x32.T))
        d32.clamp_(min=0.0)[ar, q] = 0.0
        top = torch.topk(d64, k + 1, dim=1, largest=False, sorted=True)
        for r in range(q.numel()):
            got = set(idx_t[q[r]].tolist())
            want = set(top.indices[r, :k].tolist())
            cand = torch.tensor(sorted(got | want), device=DEV)
            norm = sq64[q[r]] + sq64[cand]
            worst_err = max(worst_err, float(
                ((d32[r, cand].double() - d64[r, cand]).abs()
                 / (eps * norm)).max()))
            if got == want:
                continue
            differ += 1
            dk, dk1 = float(top.values[r, k - 1]), float(top.values[r, k])
            if dk1 - dk >= 1e-6 * dk1:
                beyond_1e6 += 1
            extra = torch.tensor(sorted(got - want), device=DEV)
            missed = torch.tensor(sorted(want - got), device=DEV)
            b_e = c * eps * (sq64[q[r]] + sq64[extra])
            b_m = c * eps * (sq64[q[r]] + sq64[missed])
            swap = float(((d64[r, extra][:, None] - d64[r, missed][None, :])
                          / (b_e[:, None] + b_m[None, :])).max())
            worst_swap = max(worst_swap, swap)
            if swap > 1.0:
                raise AssertionError(
                    f"kNN row {int(q[r])}: neighbours differ from the "
                    f"float64 top-{k} by {swap} x the float32 band")
        del d64, d32
    return {"rows": len(rows), "rows_differing": differ,
            "rows_outside_1e-6_rule": beyond_1e6,
            "band_eps_factor": c, "max_swap_over_band": worst_swap,
            "max_f32_err_over_eps_norm": worst_err}


def p_checks(p, idx, dist, perplexity: float) -> dict:
    """The kNN path's P as t-SNE holds it: (P + P^T) / 2 with rows cut to
    the width cap.  Every entry's mirror is there with the same value,
    unless the mirror's row is a full (capped) row; and the conditional
    Gaussian rows it came from each sum to 1."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops.distributions import gaussian_row_distributions
    n = p.num_rows
    live = p._live()
    nnz = live.sum(1)
    rows = torch.arange(n, device=p.device)[:, None].expand_as(p.idx)[live]
    cols, vals = p.idx[live], p.val[live]
    keys, order = torch.sort(rows * n + cols)
    vals = vals[order]
    rows, cols = keys // n, keys % n
    pos = torch.searchsorted(keys, cols * n + rows)
    pos.clamp_(max=keys.numel() - 1)
    found = keys[pos] == cols * n + rows
    if not bool((found | (nnz[cols] == p.width)).all()):
        raise AssertionError("P: an entry's mirror is missing from a row "
                             "that was not cut")
    asym = float((vals[found] - vals[pos[found]]).abs().max())
    if not asym <= 1e-6 * float(vals.abs().max()):
        raise AssertionError(f"P is not symmetric: {asym}")
    mask = idx >= 0
    cond = gaussian_row_distributions(
        torch.as_tensor(np.where(mask, dist, 0.0).astype(np.float32),
                        device=DEV),
        torch.as_tensor(mask, device=DEV), perplexity, ignore_first=True)
    worst = float((cond.sum(1) - 1.0).abs().max())
    if not worst <= 1e-3:
        raise AssertionError(f"conditional P rows do not sum to 1: {worst}")
    return {"p_nnz": int(live.sum()), "p_width": p.width,
            "p_rows_cut_to_width": int((nnz == p.width).sum()),
            "p_mirrors_cut": int((~found).sum()),
            "p_mass_kept": float(vals.sum()) / n, "p_asymmetry": asym,
            "conditional_row_sum_err": worst}


def large_path(tsne_kernels, iters: int, k: int = 16, rows: int = 1000,
               cols: int = 1000) -> dict:
    """BASELINE config 4 at full width (benchmarks/bench_1m.py): returns its
    timings, results and what its checks need.  Kernel counts are set to 0
    just before it and read just after."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    for kern in (tsne_kernels.tsne_forces_dense, tsne_kernels.tsne_repulsion):
        kern.launches = 0
    seconds = {}
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, 100, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="synthetic_1m").data,
                   T.Scaler.NONE)
    seconds["data"] = time.perf_counter() - t
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    idx, dist = compute_knn(data, k, T.KnnIndex.BRUTE_FORCE, device=DEV)
    seconds["knn"] = time.perf_counter() - t
    knn_peak = (torch.cuda.max_memory_allocated() if DEV == "cuda"
                else "not measured")
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    es.tsne.perplexity = (k - 1) / 3.0       # HDILib's perplexity multiplier
    ce = T.ComputeEmbedding(es, device=DEV)
    emb = ce.compute_tsne((idx, dist), track_kl=True)
    launches = {"tsne_forces_dense": tsne_kernels.tsne_forces_dense.launches,
                "tsne_repulsion": tsne_kernels.tsne_repulsion.launches}
    seconds["p_and_set_up"] = ce.seconds["set_up"]
    seconds["tsne"] = ce.seconds["iterations"]
    seconds["kl"] = ce.seconds["kl"]
    return {"data": data, "idx": idx, "dist": dist, "emb": emb, "ce": ce,
            "es": es, "seconds": seconds, "knn_peak": knn_peak,
            "launches": launches, "kl": float(ce.last_kl)}


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
    libs = tsne_kernels.build()      # one nvcc per kernel, all at once
    build_s = time.perf_counter() - t0
    for name, so in libs.items():
        emit({"phase": "build", "kernel": name, "seconds": build_s,
              "built_together": sorted(libs), "library": os.path.basename(so)})
    # the host graph ops (g++), built here so no stage below times the build
    t0 = time.perf_counter()
    native.get_lib()
    emit({"phase": "build", "library": "graphops (host, g++)",
          "seconds": time.perf_counter() - t0})

    checks = [check_forces_kernel(5284, 6144, seed=11),
              check_forces_kernel(1000, 1024, seed=12)]
    for c in checks:
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense", **c})

    rep_checks = []
    for n, npad, calls, twin_calls, sampled in (
            (1000, 1024, 200, 100, False),
            (65536, 65536, 100, 5, False),
            (1_000_000, 1_000_448, 20, 0, True)):
        y = torch.from_numpy(repulsion_layout(n, npad, seed=n)).cuda()
        rep_checks.append(check_repulsion_kernel(y, n, calls, twin_calls,
                                                 sampled))
        del y
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
              **rep_checks[-1], **({} if twin_calls else {
                  "plain_ms": "not measured: a full twin call at this size "
                              "takes tens of seconds"})})

    # ---- the main path: bench.py:89-136 at full size --------------------
    ch, lss_main, data = pines_hierarchy("cuda")
    tsne_kernels.tsne_forces_dense.launches = 0
    tsne_kernels.tsne_repulsion.launches = 0
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
          "tsne_tier": ce.last_computation.tier,
          "tsne_forces_dense_launches": launches,
          "tsne_repulsion_launches": tsne_kernels.tsne_repulsion.launches})

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
    if ce.last_computation.tier != "dense":
        raise AssertionError("the Pines level 1 did not take the dense tier")
    emit({"phase": "checks", "passed": True, "kl_gate": KL_SLACK * anchor,
          "jax_cpu_levels": ref_levels, "jax_cpu_level_1_kl":
              ref["level_1_kl"]})
    del ch, cond, dense, emb, ce

    # ---- the 1M path: BASELINE config 4 ---------------------------------
    grid_env = os.environ.get("SPH_TSNE_GRID")
    os.environ["SPH_TSNE_GRID"] = "0"     # the exact tier above 32768
    try:
        large = large_path(tsne_kernels, LARGE_ITERS)
        n_large = large["idx"].shape[0]
        comp = large["ce"].last_computation
        # the KL at iteration 0, computed the same way: the path's P at the
        # initial layout
        t = time.perf_counter()
        t0_tsne = T.TsneComputation(large["es"].tsne, device="cuda")
        t0_tsne.set_probability_distribution(comp._p)
        from sph_tpu_torch.ops.math import random_disk_init
        t0_tsne.set_initial_embedding(random_disk_init(n_large, 0.1, 0))
        t0_tsne._init_gradient_descent()
        kl0 = t0_tsne.kl_divergence()
        kl0_s = time.perf_counter() - t
        t0_tier = t0_tsne.tier
        del t0_tsne
    finally:
        if grid_env is None:
            os.environ.pop("SPH_TSNE_GRID")
        else:
            os.environ["SPH_TSNE_GRID"] = grid_env
    sec = large["seconds"]
    large_launches = large["launches"]
    emit({"phase": "large", "n": n_large, "d": large["data"].shape[1],
          "k": large["idx"].shape[1],
          "perplexity": large["es"].tsne.perplexity,
          "tsne_tier": large["ce"].last_computation.tier,
          "tsne_iterations": LARGE_ITERS, "seconds": sec,
          "seconds_total": sum(sec.values()),
          "tsne_iters_per_s": LARGE_ITERS / sec["tsne"],
          "knn_peak_memory_bytes": large["knn_peak"],
          "kl_iteration_0": kl0, "kl_iteration_0_seconds": kl0_s,
          "kl_final": large["kl"],
          "embedding_max_abs": float(np.abs(large["emb"]).max()),
          "launches": large_launches})

    # ---- checks of the 1M path -------------------------------------------
    idx, dist, emb = large["idx"], large["dist"], large["emb"]
    if not np.array_equal(idx[:, 0], np.arange(n_large)):
        raise AssertionError("kNN: slot 0 is not the point itself")
    if not (np.all(dist[:, 0] == 0) and np.all(np.isfinite(dist))
            and np.all(np.diff(dist, axis=1) >= 0)):
        raise AssertionError("kNN: distances not 0-first, finite, ascending")
    sample = np.sort(np.random.default_rng(3).choice(n_large, 1024,
                                                     replace=False))
    exact = knn_exactness(large["data"], idx, idx.shape[1], sample)
    pc = p_checks(comp._p, idx, dist, large["es"].tsne.perplexity)
    if comp.tier != "exact" or t0_tier != "exact":
        raise AssertionError(f"the 1M path took the {comp.tier} tier")
    if large_launches["tsne_forces_dense"] != 0:
        raise AssertionError("tsne_forces_dense launched on the 1M path")
    if large_launches["tsne_repulsion"] < LARGE_ITERS:
        raise AssertionError(
            f"tsne_repulsion launched {large_launches['tsne_repulsion']} "
            f"times in {LARGE_ITERS} iterations")
    if not large["kl"] < kl0:
        raise AssertionError(f"KL {large['kl']} not below iteration 0's "
                             f"{kl0}")
    if not np.all(np.isfinite(emb)) or emb.shape != (n_large, 2):
        raise AssertionError("the 1M embedding is not finite [N, 2]")
    if bool((comp._y[n_large:] != 0).any()):
        raise AssertionError("the 1M embedding's pad rows are not 0")
    # the kernel once more, at the embedding the path produced
    rep_checks.append(check_repulsion_kernel(comp._y.contiguous(), n_large,
                                             sampled=True))
    emit({"phase": "large_checks", "passed": True, "knn_exactness": exact,
          **pc, "npad": comp._npad,
          "kernel_vs_twin_at_final_embedding": rep_checks[-1]})

    main_shape = checks[-1]
    rep_full = rep_checks[1]            # the largest shape timed in full
    emit({"kernels": [{
        "name": "tsne_forces_dense", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_forces_dense.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:167",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}, {
        "name": "tsne_repulsion", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_repulsion.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:80",
        "launches": large_launches["tsne_repulsion"],
        "max_abs_err": max(c["max_abs_err"] for c in rep_checks),
        "ms": rep_full["ms"], "plain_ms": rep_full["plain_ms"],
        "shape": [rep_full["n"], rep_full["npad"]],
        "ms_at_1m": rep_checks[2]["ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
