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
   (n, Npad) = (1000, 1024), (5358, 6144) (the Pines KL's) and
   (65536, 65536) in full and at (1000000, 1000448) on 4096 sampled rows,
   two calls bit-equal, its launch plan and its SFU floor.
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
6. umap    — the same level 1 through ComputeEmbedding.compute_umap for
   the reference's 500 epochs (rows tier): seconds, epochs/s, and the
   trustworthiness at k = 10 against the components' mean spectra, at
   least 0.99 x the JAX-on-CPU record in
   docs/torch_port_pines_umap_reference.json.
7. scene_overlap — the same recipe at 256x256x200 on default level
   settings (NEIGH_OVERLAP, exact_knn False) with knn_index =
   index_heuristic(65536), IVF_FLAT: the levels against the JAX-on-CPU
   record in docs/torch_port_scene_overlap_reference.json (level 1 within
   2 %, later levels of at least 100 components within 10 %), level 1 above
   SPH_APPROX_KNN_THRESHOLD on the approximate component kNN, its recall
   against the exact knn_neighbor_overlap (at least the record's - 0.01),
   stage 1's recall against the exact kNN, P's checks, and 2000 dense-tier
   t-SNE iterations of level 1 with a falling KL; seconds by stage; the
   exact knn_neighbor_overlap's own peak memory (at most 2 GiB); then
   tsne_forces_dense against its twin at level 1's shape.
8. salinas_euclid — EUCLID_CENTROID in both stages on the Salinas-shaped
   scene (512x217x224, bench_salinas.py:41-75; run_evaluation.py's
   ImageHierarchySettings with 100 samples): the levels against the
   JAX-on-CPU record in docs/torch_port_salinas_euclid_reference.json,
   level 1 on the approximate Hausdorff kNN and its recall against the
   exact Hausdorff (at least the record's - 0.01), level 2's exact kNN
   against float64 on 64 rows, P's checks, 2000 dense-tier t-SNE
   iterations of levels 1, 2 and 3 (each after the first from the level
   below's layout) with falling KLs, UMAP of level 1 for 500 epochs;
   seconds and peak memory by stage and part; tsne_forces_dense against
   its twin at level 1's shape.
9. large_graph — BASELINE config 4 (benchmarks/bench_1m.py): a
   1000x1000x100 synthetic stack and its exact kNN graph (k = 16, once for
   both tiers below); kNN invariants and exactness against float64
   distances on 1024 sampled rows.
10. large_ivf — the same stack through compute_knn on its size tier
   (HNSW, flat IVF) twice: seconds and peak memory beside the exact kNN's,
   recall@16 over all rows against the exact graph, a complete graph, the
   two results bit-equal.
11. large_grid — t-SNE from that graph at perplexity 5 on the default tier,
   the grid, for the reference's 4000 iterations: seconds, iterations/s,
   the grid sizes, the KL at iterations 0, 250, 1000 and 4000, the grid's
   Z against tsne_repulsion's (at most 1e-3 apart) and the final KL with
   the exact Z, milliseconds an iteration by part, two calls of the
   grid's repulsion bit-equal (the deposit sums in a fixed order), peak
   memory; no kernel launches on this tier.
12. large  — the same graph on the exact sparse-P tier (SPH_TSNE_GRID=0),
   cut to 10 iterations; the KL before and after, the launches.
13. large_checks — a symmetric P whose conditional rows sum to 1, the
   exact tier (tsne_repulsion on every iteration, tsne_forces_dense never),
   a falling KL, a finite embedding with zero pad rows, and tsne_repulsion
   against its twin at the embedding the path produced.
14. grid_vs_exact — the 1M recipe at 256x256 (65536 points), 1000
   iterations on the grid and the exact tier from the same P and initial
   layout, both scored under that P with the exact Z: KL_grid <= 1.001 x
   KL_exact.
15. ivf_recall — benchmarks/bench_recall.py's clustered data at 10^6 x
   100 (seed 0), a full self-kNN on HNSW, HNSWSQ and HNSW_IVFPQ, recall@16
   on 1024 sampled rows against float64 distances, each at least the JAX
   package's record less 0.01; seconds, peak memory and the IVF layout.

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero before that line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KL_SLACK = 1.01            # bench.py:344-360: KL <= 1.01 x sklearn anchor
LEVEL1_TOLERANCE = 0.02    # level-1 count within 2 % of the JAX record
# scene_overlap's levels past 1 with at least DEEP_LEVEL_MIN components in
# the record: within 10 % of it (the card's k-means sums part from XLA-CPU's
# by ulps, which moves the stage-1 IVF graph and so the later merges; with
# the JAX clustering replayed the levels are equal, PERF.md)
DEEP_LEVEL_TOLERANCE = 0.10
DEEP_LEVEL_MIN = 100
LARGE_ITERS = 10           # 1M exact tier: a depth cut (0.6 s an iteration)
GRID_ITERS = 4000          # 1M grid tier: the reference's schedule above 200k
GRID_KL_AT = (0, 250, 1000)
MID_ITERS = 1000           # 65536 points: the reference's schedule below 100k
GRID_STEP_MS_INDEX_ADD = (7.37, 7.43)   # 1M grid step, index_add_ deposit
Z_GAP_MAX = 1e-3           # grid Z against the exact Z at 1M, relative
KL_RATIO_MAX = 1.001       # 65536 points: KL_grid / KL_exact
# tsne_repulsion against its twin: (n, Npad, calls timed, twin calls timed,
# sampled rows); the Pines KL's shape, grid_vs_exact's, the 1M path's
REPULSION_SHAPES = ((1000, 1024, 200, 100, False),
                    (5358, 6144, 200, 20, False),
                    (65536, 65536, 100, 5, False),
                    (1_000_000, 1_000_448, 20, 0, True))
UMAP_TRUST_SLACK = 0.99    # Pines UMAP trustworthiness vs the JAX-CPU record
IVF_N = 1_000_000          # ivf_recall: bench_recall.py's clustered data
# recall@16 gates of the approximate tiers on that data: the JAX package's
# records (BASELINE.md:129-136, 263-267, on a TPU) less 0.01
IVF_RECALL_GATES = {"hnsw": 0.9899, "hnswsq": 0.9238, "hnsw_ivfpq": 0.9679}
SCENE_SIDE = 256           # scene_overlap: 65536 points, level 1 above 8192
RECALL_SLACK = 0.01        # component kNN recall vs the JAX-CPU record
SALINAS_SHAPE = (512, 217, 224)    # bench_salinas.py:42, 111104 pixels
SALINAS_K = 31                     # bench_salinas.py:44
SALINAS_TSNE_LEVELS = (1, 2, 3)    # each from the level below's layout
SALINAS_SAMPLED_ROWS = 1024        # level-1 component kNN recall rows
SALINAS_EXACT_ROWS = 64            # level-2 exact kNN rows vs float64
EXACT_OVERLAP_PEAK_MAX = 2 << 30   # exact NEIGH_OVERLAP kNN's own peak bytes
# the switches of the t-SNE tier choice, all unset for the default path
TSNE_SWITCHES = ("SPH_TSNE_DENSE_P", "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_GRID",
                 "SPH_TSNE_GRID_MIN", "SPH_TSNE_GRID_MAX",
                 "SPH_TSNE_P_WIDTH_CAP", "SPH_TSNE_GRID_P_WIDTH",
                 "SPH_TSNE_ATTR_PACKED")
DEV = "cuda"               # the helpers' device; "cpu" rehearses them small


# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float32 operations a pair (a fused multiply-add counts two, the
# reciprocal one), counted on the TPU kernel's s2 form, which is the
# yardstick kept for comparing versions: dx, dy 2; d^2 3; 1 + d^2 1; 1/d 1;
# w^2 1; the sums z, s2 2 and ax, ay 4 -> 14 (the CUDA kernel's direct form
# needs 13); the dense pass adds p w 1, its sum 1 and two more
# multiply-adds 4 -> 20
REPULSION_FLOPS_PER_PAIR = 14
FORCES_FLOPS_PER_PAIR = 20


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def forces_bound(n: int, npad: int) -> dict:
    """tsne_forces_dense: P [npad, npad] and y read once, attr, rep and the
    row Z written once; n^2 pairs."""
    return bound(4 * npad * npad + 8 * npad + 4 * 5 * npad,
                 FORCES_FLOPS_PER_PAIR * n * n)


def repulsion_bound(n: int, npad: int) -> dict:
    """tsne_repulsion: y read once, rep and the row Z written once; n^2
    pairs."""
    return bound(8 * npad + 12 * npad, REPULSION_FLOPS_PER_PAIR * n * n)


def sfu_floor_ms(n: int, sms: int, clock_hz: float) -> float:
    """tsne_repulsion's floor beside its operations bound: its reciprocals,
    one a pair, at 16 a clock on each of `sms` SMs at `clock_hz`."""
    return float(n) * n / (16 * sms * clock_hz) * 1e3


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    return float(nvidia_smi("clocks.max.sm", units=False)) * 1e6


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


def check_forces_kernel(n: int, npad: int, seed: int, calls: int = 200
                        ) -> dict:
    """tsne_forces_dense against its twin, each timed over `calls` calls,
    with the bound of the shape; raises on disagreement."""
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
    ms = cuda_ms(lambda: tsne_forces_dense(y, p, n), calls)
    plain_ms = cuda_ms(lambda: tsne_forces_dense_reference(y, p, n), calls)
    return {"n": n, "npad": npad, "max_abs_err": err,
            "z_rel_err": abs(z - z_r) / abs(z_r), "ms": ms,
            "plain_ms": plain_ms, "calls_timed": calls,
            **forces_bound(n, npad)}


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
                           sampled: bool = False,
                           clock_hz: float | None = None) -> dict:
    """tsne_repulsion against its twin on the card, in full or on sampled
    rows, and two calls bit-equal; raises on disagreement.  calls > 0 also
    times the kernel with CUDA events and gives its SFU floor at the card's
    SM count and `clock_hz` (twin_calls > 0 times the full twin)."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (REPULSION_TILE,
                                                repulsion_plan,
                                                tsne_repulsion_reference,
                                                tsne_repulsion_rows)
    npad = y.shape[0]
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if DEV == "cuda" else 132)
    plan = repulsion_plan(n, sms)
    rep, zrow = tsne_repulsion_rows(y, n)
    rep2, zrow2 = tsne_repulsion_rows(y, n)
    if sampled:
        ranges = sample_ranges(npad)
    else:
        ranges = [(0, npad)]
    refs = [tsne_repulsion_reference(y, n, rows=r) for r in ranges]
    sync()
    name = f"tsne_repulsion n={n} npad={npad}"
    if not (torch.equal(rep, rep2) and torch.equal(zrow, zrow2)):
        raise AssertionError(f"{name}: two calls differ")
    got_rep = torch.cat([rep[a:b] for a, b in ranges])
    got_z = torch.cat([zrow[a:b] for a, b in ranges])
    ref_rep = torch.cat([r for r, _ in refs])
    ref_z = torch.cat([z for _, z in refs])
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
           "rep_err_over_max": err / scale, "zrow_rel_err": z_rel,
           "rows_checked": sum(b - a for a, b in ranges),
           "bits_equal_across_calls": True,
           "plan": {"tile": REPULSION_TILE, "splits": plan.splits,
                    "split_cols": plan.split_cols, "blocks": plan.blocks}}
    if not sampled:
        z, z_ref = float(zrow.sum()), float(ref_z.double().sum())
        out["z_rel_err"] = abs(z - z_ref) / z_ref
        if not out["z_rel_err"] <= 1e-5:
            raise AssertionError(f"{name}: Z {z} vs twin {z_ref}")
    if calls:
        out["ms"] = cuda_ms(lambda: tsne_repulsion_rows(y, n), calls,
                            warmup=min(10, calls // 10))
        out["calls_timed"] = calls
        out["sfu_floor_ms"] = sfu_floor_ms(n, sms, clock_hz)
        out["sms"], out["sm_clock_hz"] = sms, clock_hz
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


def recall_at_k(idx, truth, block: int = 65536) -> float:
    """benchmarks/bench_recall.py:116-119's count: the ids each row of
    `idx` shares with the same row of `truth`, over rows x k.  A kNN row
    holds distinct ids, so the shared ids are the entries of `idx` found in
    `truth`'s row; counted in blocks of rows."""
    hits = 0
    for r0 in range(0, truth.shape[0], block):
        a, b = idx[r0:r0 + block], truth[r0:r0 + block]
        hits += int((a[:, :, None] == b[:, None, :]).any(2).sum())
    return hits / truth.size


def overlap_recall(ids, dists, kth) -> float:
    """An approximate component kNN's recall against the exact one, counted
    by distance: a neighbour counts when its distance (the exact pair
    metric) is at most the exact kNN's k-th distance on its row, `kth`; over
    rows x k.  NEIGH_OVERLAP distances tie in runs (1 - |A^B| / min), so
    which of the tied components the exact kNN keeps is arbitrary."""
    import numpy as np
    hits = ((ids >= 0) & (dists <= np.asarray(kth)[:, None])).sum()
    return float(hits) / ids.size


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


@contextlib.contextmanager
def env(**values):
    """Set (a string) or unset (None) environment variables for the block,
    then restore them."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def zero_launches(tsne_kernels) -> None:
    for kern in (tsne_kernels.tsne_forces_dense, tsne_kernels.tsne_repulsion):
        kern.launches = 0


def read_launches(tsne_kernels) -> dict:
    return {"tsne_forces_dense": tsne_kernels.tsne_forces_dense.launches,
            "tsne_repulsion": tsne_kernels.tsne_repulsion.launches}


def scene_graph(rows: int, cols: int, k: int = 16) -> dict:
    """A synthetic rows x cols x 100 stack (Scaler.NONE) and its exact kNN
    graph (BASELINE config 4's recipe); seconds of both and the kNN's peak
    memory."""
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    seconds = {}
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, 100, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="synthetic").data,
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
    return {"data": data, "idx": idx, "dist": dist, "seconds": seconds,
            "knn_peak": knn_peak}


def tsne_settings(iters: int, k: int):
    import sph_tpu_torch as T
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    es.tsne.perplexity = (k - 1) / 3.0       # HDILib's perplexity multiplier
    return es


def large_path(tsne_kernels, iters: int, k: int = 16, rows: int = 1000,
               cols: int = 1000, graph: dict = None) -> dict:
    """BASELINE config 4 at full width (benchmarks/bench_1m.py) on the tier
    the environment selects, from `graph` (made here when None): returns
    its timings, results and what its checks need.  Kernel counts are set
    to 0 just before the t-SNE and read just after."""
    import sph_tpu_torch as T
    graph = graph or scene_graph(rows, cols, k)
    seconds = dict(graph["seconds"])
    zero_launches(tsne_kernels)
    es = tsne_settings(iters, k)
    ce = T.ComputeEmbedding(es, device=DEV)
    emb = ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True)
    launches = read_launches(tsne_kernels)
    seconds["p_and_set_up"] = ce.seconds["set_up"]
    seconds["tsne"] = ce.seconds["iterations"]
    seconds["kl"] = ce.seconds["kl"]
    return {"data": graph["data"], "idx": graph["idx"],
            "dist": graph["dist"], "emb": emb, "ce": ce, "es": es,
            "seconds": seconds, "knn_peak": graph["knn_peak"],
            "launches": launches, "kl": float(ce.last_kl)}


def grid_path(tsne_kernels, graph: dict, iters: int,
              kl_at=(0, 250, 1000)) -> dict:
    """t-SNE from `graph` on the default tier (the grid above 32768 points)
    through ComputeEmbedding, with the KL at the iterations `kl_at` (chunk
    ends) and at the end.  Kernel counts are set to 0 just before and read
    just after; the seconds of the KLs taken on the way are kept apart
    from the iterations'."""
    import torch
    import sph_tpu_torch as T
    k = graph["idx"].shape[1]
    zero_launches(tsne_kernels)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ce = T.ComputeEmbedding(tsne_settings(iters, k), device=DEV)
    kls, kl_seconds = {}, [0.0]

    def progress(comp):
        if comp.current_iteration in kl_at:
            t = time.perf_counter()
            kls[comp.current_iteration] = comp.kl_divergence()
            kl_seconds[0] += time.perf_counter() - t

    with env(**{name: None for name in TSNE_SWITCHES}):
        emb = ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True,
                              progress=progress)
    launches = read_launches(tsne_kernels)
    peak = (torch.cuda.max_memory_allocated() if DEV == "cuda"
            else "not measured")
    kls[iters] = float(ce.last_kl)
    seconds = {"p_and_set_up": ce.seconds["set_up"],
               "tsne": ce.seconds["iterations"] - kl_seconds[0],
               "kl_on_the_way": kl_seconds[0], "kl": ce.seconds["kl"]}
    return {"emb": emb, "ce": ce, "kls": kls, "seconds": seconds,
            "launches": launches, "peak_memory_bytes": peak}


def grid_sizes(history) -> list:
    """[first iteration, G] for each change of the grid size."""
    out = []
    for it, g in history:
        if not out or out[-1][1] != g:
            out.append([it, g])
    return out


def z_gap(comp) -> dict:
    """Z of the layout from the grid (the size the KL used) and from the
    exact tsne_repulsion kernel, and the final KL with the exact Z: with
    P renormalized over its support, KL(Z') = KL(Z) + log(Z' / Z)."""
    import math
    from sph_tpu_torch.ops.tsne_grid import grid_repulsion
    from sph_tpu_torch.ops.tsne_kernels import tsne_repulsion
    g = comp._current_grid()
    _, z_grid = grid_repulsion(comp._y, comp._n, g)
    _, z_exact = tsne_repulsion(comp._y, comp._n)
    z_grid, z_exact = float(z_grid), float(z_exact)
    return {"grid": g, "z_grid": z_grid, "z_exact": z_exact,
            "z_rel_gap": abs(z_grid - z_exact) / z_exact,
            "log_z_ratio": math.log(z_exact / z_grid)}


def grid_split(comp, calls: int = 10) -> dict:
    """Milliseconds of one grid-tier iteration by part at the computation's
    layout, CUDA events: the attraction, the box and taps, the deposit
    (sorted segment sums), the FFT convolution, the interpolation (gather),
    the update, and the whole step; and the points in the fullest base
    cell.  The state is put back afterwards."""
    import torch
    from sph_tpu_torch.models.tsne import attractive_forces
    from sph_tpu_torch.ops import tsne_grid as G
    y, n, g = comp._y, comp._n, comp._grid
    lo, h = G.grid_box(y, n, g)
    yv = y[:n]
    cells, wx, wy = G.grid_taps(yv, lo, h, g)
    charges = G.deposit_charges(yv, cells, wx, wy, g)
    fields = G.field_grids(charges, h, g)
    state = (comp._y, comp._vel, comp._gain, comp._iteration)
    forces = comp._forces()

    def update():
        comp._update(*forces)
        comp._y, comp._vel, comp._gain, comp._iteration = state

    ms = {"grid": g, "attraction": cuda_ms(lambda: attractive_forces(
        y, comp._p_idx, comp._p_val), calls, 2),
        "box_and_taps": cuda_ms(lambda: G.grid_taps(
            yv, *G.grid_box(y, n, g), g), calls, 2),
        "deposit": cuda_ms(lambda: G.deposit_charges(yv, cells, wx, wy, g),
                           calls, 2),
        "fft": cuda_ms(lambda: G.field_grids(charges, h, g), calls, 2),
        "interpolation": cuda_ms(lambda: G.interpolate_fields(
            fields, cells, wx, wy), calls, 2),
        "update": cuda_ms(update, calls, 2)}
    ms["step"] = cuda_ms(comp._step, calls, 2)
    comp._y, comp._vel, comp._gain, comp._iteration = state
    # the deposit sums each base cell's points in sequence
    ms["points_in_fullest_cell"] = int(torch.bincount(cells[:, 0]).max())
    return ms


def scatter_repeatability(comp) -> dict:
    """Two grid_repulsion calls on the same layout: whether they give the
    same bits (the deposit sums in a fixed order), and how far apart they
    are if not."""
    from sph_tpu_torch.ops.tsne_grid import grid_repulsion
    g = comp._current_grid()
    r1, z1 = grid_repulsion(comp._y, comp._n, g)
    r2, z2 = grid_repulsion(comp._y, comp._n, g)
    return {"grid": g, "bits_equal": bool((r1 == r2).all() and z1 == z2),
            "rep_max_rel_diff": float((r1 - r2).abs().max()
                                      / r1.abs().max()),
            "z_rel_diff": abs(float(z1) - float(z2)) / float(z1)}


def grid_vs_exact(tsne_kernels, rows: int = 256, cols: int = 256,
                  iters: int = 1000, k: int = 16) -> dict:
    """The 1M recipe at rows x cols: `iters` iterations on the grid tier
    (the default above 32768 points) and on the exact tier
    (SPH_TSNE_GRID=0), from the same P and initial layout: the grid tier's
    cut of P to 64 entries a row is switched off (SPH_TSNE_GRID_P_WIDTH=0),
    so the grid's repulsion is the one difference.  Both layouts are scored
    under that P with the exact Z."""
    import sph_tpu_torch as T
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    graph = scene_graph(rows, cols, k)
    out = {"n": graph["idx"].shape[0], "k": k, "iterations": iters,
           "seconds": dict(graph["seconds"])}
    runs = {}
    for tier, switches in (("grid", {"SPH_TSNE_GRID_P_WIDTH": "0"}),
                           ("exact", {"SPH_TSNE_GRID": "0"})):
        zero_launches(tsne_kernels)
        ce = T.ComputeEmbedding(tsne_settings(iters, k), device=DEV)
        with env(**{**{name: None for name in TSNE_SWITCHES}, **switches}):
            ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True)
        runs[tier] = ce.last_computation
        out[tier] = {"tier": ce.last_computation.tier,
                     "p_width": ce.last_computation._p_val.shape[1],
                     "seconds": ce.seconds["iterations"],
                     "iters_per_s": iters / ce.seconds["iterations"],
                     "kl_own": float(ce.last_kl),
                     "launches": read_launches(tsne_kernels)}
    exact = runs["exact"]
    for tier, comp in runs.items():
        out[tier]["kl_scored"] = float(tsne_kl_divergence(
            comp._y, exact._p_idx, exact._p_val, exact._n))
    out["kl_ratio"] = out["grid"]["kl_scored"] / out["exact"]["kl_scored"]
    out["grid"]["grid_sizes"] = grid_sizes(runs["grid"].grid_history)
    return out


def exact_rows64(data, rows, k: int):
    """The float64 top-k ids of `rows` against all of `data`, on DEV, 128
    rows at a time: the ground truth of the recall phases."""
    import numpy as np
    import torch
    x = torch.as_tensor(data, device=DEV).double()
    sq = (x * x).sum(1)
    out = []
    for r0 in range(0, len(rows), 128):
        q = torch.as_tensor(np.asarray(rows[r0:r0 + 128]), device=DEV).long()
        d = sq[q, None] + sq[None, :] - 2.0 * (x[q] @ x.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


def graph_invariants(idx, dist, name: str) -> None:
    """A complete kNN graph: the point itself in slot 0, no -1 left,
    finite distances ascending along each row; raises otherwise."""
    import numpy as np
    if not np.array_equal(idx[:, 0], np.arange(idx.shape[0])):
        raise AssertionError(f"{name}: slot 0 is not the point itself")
    if np.any(idx < 0):
        raise AssertionError(f"{name}: {int((idx < 0).sum())} slots are -1")
    if not (np.all(np.isfinite(dist)) and np.all(np.diff(dist, axis=1) >= 0)):
        raise AssertionError(f"{name}: distances not finite and ascending")


def timed_knn(data, k: int, index, **kw):
    """compute_knn on DEV with its seconds, peak memory and IVF layout."""
    import torch
    from sph_tpu_torch.ops.knn import compute_knn
    stats = {}
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    idx, dist = compute_knn(data, k, index, device=DEV, stats=stats, **kw)
    sync()
    stats["seconds"] = time.perf_counter() - t
    stats["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                  if DEV == "cuda" else "not measured")
    return idx, dist, stats


def ivf_recall(n: int = IVF_N, d: int = 100, k: int = 16,
               queries: int = 1024, tiers=IVF_RECALL_GATES) -> dict:
    """benchmarks/bench_recall.py's clustered data at n x d (seed 0), a full
    self-kNN on each approximate tier in `tiers`, and recall@k on `queries`
    rows (default_rng(1)) against float64 distances on DEV."""
    import numpy as np
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_clustered_points
    t = time.perf_counter()
    data = create_clustered_points(n, d, seed=0)
    rows = np.random.default_rng(1).choice(n, queries, replace=False)
    out = {"n": n, "d": d, "k": k, "queries": queries,
           "data_seconds": time.perf_counter() - t}
    t = time.perf_counter()
    truth = exact_rows64(data, rows, k)
    out["truth_seconds"] = time.perf_counter() - t
    for index in tiers:
        idx, dist, stats = timed_knn(data, k, T.KnnIndex(index))
        graph_invariants(idx, dist, f"ivf_recall {index}")
        out[index] = {**stats, "recall": recall_at_k(idx[rows], truth)}
    return out


def large_ivf(graph: dict, runs: int = 2) -> dict:
    """The 1M scene of `graph` through compute_knn on its size tier
    (index_heuristic: HNSW, flat IVF) `runs` times: seconds and peak memory
    of each, recall@k over all rows against the exact graph, two results
    bit-equal."""
    import numpy as np
    from sph_tpu_torch.ops.knn import index_heuristic
    data, exact = graph["data"], graph["idx"]
    index = index_heuristic(data.shape[0])
    results, out = [], {"n": data.shape[0], "index": index.value,
                        "exact_knn_seconds": graph["seconds"]["knn"],
                        "exact_knn_peak_memory_bytes": graph["knn_peak"]}
    for run in range(runs):
        idx, dist, stats = timed_knn(data, exact.shape[1], index)
        graph_invariants(idx, dist, f"large_ivf run {run}")
        results.append((idx, dist))
        out[f"run_{run}"] = stats
    out["bits_equal_across_runs"] = all(
        np.array_equal(i, results[0][0]) and np.array_equal(d, results[0][1])
        for i, d in results[1:])
    out["recall_all_rows"] = recall_at_k(results[0][0], exact)
    return out


def scene_hierarchy(side: int, device: str, k: int = 91):
    """The bench.py:89-136 Pines recipe at side x side x 200 on default
    level settings, as an initialised (not yet computed) ComputeHierarchy:
    create_hyperspectral_scene(seed=7), Scaler.NONE, k neighbours
    symmetrized and connected with knn_index = index_heuristic(side^2),
    50 walks x 10 steps, ImageHierarchySettings() and
    LevelSimilaritiesSettings(ks=[k]) (NEIGH_OVERLAP, exact_knn False).
    Returns it and the data matrix."""
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import index_heuristic
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(side, side, 200, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="scene_overlap").data,
                   T.Scaler.NONE)
    ch = T.ComputeHierarchy(device=device).init(
        data, side, side, ihs=T.ImageHierarchySettings(),
        lss=T.LevelSimilaritiesSettings(ks=[k]),
        rws=T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=T.NearestNeighborsSettings(
            num_nearest_neighbors=k, knn_index=index_heuristic(side * side),
            symmetric_neighbors=True, compute_connect_components=True,
            neighbor_connect_components=True))
    return ch, data


def scene_overlap(tsne_kernels, side: int = SCENE_SIDE, iters: int = 2000,
                  k: int = 91, sampled: int = 2048) -> dict:
    """The user path on default level settings: `scene_hierarchy` through
    ComputeHierarchy(device=DEV), then `iters` t-SNE iterations of level 1
    through ComputeEmbedding.  Kernel counts are set to 0 before the
    hierarchy and read after the t-SNE.  Also: stage 1's recall against the exact kNN (all rows, and the
    `sampled` rows of the JAX record), level 1's component kNN recall
    against the exact knn_neighbor_overlap, P's checks, the KL at
    iterations 0, iters / 2 and iters."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.component_knn import knn_neighbor_overlap
    from sph_tpu_torch.ops.knn import compute_knn, index_heuristic
    from sph_tpu_torch.ops.similarities import build_union_neighborhoods
    seconds = {}
    t = time.perf_counter()
    ch, data = scene_hierarchy(side, DEV, k)
    seconds["data"] = time.perf_counter() - t
    zero_launches(tsne_kernels)
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_similarities",
                         ch.compute_level_similarities)):
        t = time.perf_counter()
        stage()
        sync()
        seconds[name] = time.perf_counter() - t
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities
    p1 = ls.get_prob_dist(1)
    kls = {}

    def progress(comp):
        if comp.current_iteration in (0, iters // 2):
            kls[comp.current_iteration] = comp.kl_divergence()

    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    ce = T.ComputeEmbedding(es, device=DEV)
    t = time.perf_counter()
    with env(**{name: None for name in TSNE_SWITCHES}):
        emb = ce.compute_tsne(p1, track_kl=True, progress=progress)
    sync()
    seconds["tsne"] = time.perf_counter() - t
    launches = read_launches(tsne_kernels)
    kls[iters] = float(ce.last_kl)

    t = time.perf_counter()
    exact_idx, _ = compute_knn(data, k, T.KnnIndex.BRUTE_FORCE, device=DEV)
    seconds["exact_knn"] = time.perf_counter() - t
    ivf_idx = ch.knn_stage.knn_graph.indices
    rows = np.sort(np.random.default_rng(1).choice(side * side, sampled,
                                                   replace=False))
    ids, dists = ls.distance_graphs[1]
    graph = ch.knn_stage.connected_graph
    unions = build_union_neighborhoods(
        np.where(graph.mask, graph.indices, -1), h.pixel_components[1],
        levels[1], device=DEV)
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    _, exact_d = knn_neighbor_overlap(unions, ids.shape[1])
    seconds["exact_component_knn"] = time.perf_counter() - t
    exact_peak = (torch.cuda.max_memory_allocated() - held
                  if DEV == "cuda" else "not measured")
    return {"n": side * side, "size": [side, side, 200],
            "knn_index": index_heuristic(side * side).value,
            "levels": levels,
            "knn_tiers": ls.knn_tiers, "level_1_k": int(ids.shape[1]),
            "stage1_recall_all_rows": recall_at_k(ivf_idx, exact_idx),
            "stage1_recall_sampled_rows": recall_at_k(ivf_idx[rows],
                                                      exact_idx[rows]),
            "level_1_component_knn_recall": overlap_recall(
                ids, dists, exact_d[:, -1]),
            "exact_component_knn_peak_bytes": exact_peak,
            "p": p_checks(p1, ids, dists, ls.perplexity_on_level[1]),
            "tsne_tier": ce.last_computation.tier, "tsne_iterations": iters,
            "kl_at": {str(i): v for i, v in sorted(kls.items())},
            "launches": launches, "seconds": seconds,
            "embedding_finite": bool(np.all(np.isfinite(emb))),
            "embedding_shape": list(emb.shape)}


def deep_levels_gate(levels, ref_levels, name: str) -> None:
    """Levels 2 and up whose record has at least DEEP_LEVEL_MIN components
    within DEEP_LEVEL_TOLERANCE of the record; raises otherwise."""
    for level in range(2, min(len(levels), len(ref_levels))):
        want = ref_levels[level]
        if want >= DEEP_LEVEL_MIN and (
                abs(levels[level] - want) > DEEP_LEVEL_TOLERANCE * want):
            raise AssertionError(
                f"{name} level {level}: {levels[level]} components, not "
                f"within {DEEP_LEVEL_TOLERANCE:.0%} of the JAX record {want}")


def salinas_settings(P, level_to_compute: int = -1):
    """The salinas_euclid configuration for package P (sph_tpu_torch here;
    the JAX package in scripts/salinas_euclid_reference.py): stage 1 the
    exact kNN (FLAT), k = 31, symmetric and connected (bench_salinas.py:44,
    70-73); stage 2 run_evaluation.py's ImageHierarchySettings
    (sph_tpu/evaluation/run_evaluation.py:150-159) with EUCLID_CENTROID and
    num_geodesic_samples 100, FOUR connectivity, random_seed 1; stage 3
    EUCLID_CENTROID, ks = [31], TSNE normalisation and symmetrisation
    (bench_salinas.py:61-65).  Returns (ihs, lss, rws, nns)."""
    euclid = P.ComponentSim.EUCLID_CENTROID
    ihs = P.ImageHierarchySettings(
        component_sim=euclid, neighbor_connection=P.NeighConnection.FOUR,
        merge_multiple=False, use_percentile=False, max_dist=0.0,
        min_num_comp=1, min_reduction=98.0, num_geodesic_samples=100,
        max_levels=10)
    lss = P.LevelSimilaritiesSettings(
        component_sim=euclid, ks=[SALINAS_K],
        normalize_prob_dist=P.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=P.NormalizationScheme.TSNE,
        level_to_compute=level_to_compute)
    rws = P.RandomWalkSettings(random_seed=1)
    nns = P.NearestNeighborsSettings(
        num_nearest_neighbors=SALINAS_K, knn_index=P.KnnIndex.FLAT,
        symmetric_neighbors=True, compute_connect_components=True,
        neighbor_connect_components=True)
    return ihs, lss, rws, nns


def hausdorff_kth(data, rep, rows, k: int):
    """The exact Hausdorff kNN's k-th distance of each of `rows` over every
    component (self at 0 included), from the port's pair metric on DEV;
    rep [C, S] holds the components' sampled points."""
    import numpy as np
    from sph_tpu_torch.ops.similarities import component_hausdorff
    c = rep.shape[0]
    rows = np.asarray(rows, np.int64)
    d = component_hausdorff(data, rep, np.repeat(rows, c),
                            np.tile(np.arange(c), len(rows)), device=DEV)
    d = d.reshape(len(rows), c)
    d[np.arange(len(rows)), rows] = 0.0
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def hausdorff_exactness(data, rep, ids, dists, rows) -> dict:
    """An exact Hausdorff kNN's `rows` against float64 on DEV; raises unless
    each row differs from the float64 top k only by swapping a component e
    in for a component m with h(e)^2 - h(m)^2 <= b(e) + b(m), and each
    squared distance lies within b of its float64 value.  b is the float32
    band sqrt(D) eps (|x|^2 + |y|^2) of the expansion (knn_exactness) at the
    largest squared norms among the two sets' samples, plus the float32
    root's own rounding."""
    import numpy as np
    import torch
    eps = float(np.finfo(np.float32).eps)
    x = torch.as_tensor(np.asarray(data, np.float32), device=DEV).double()
    rep_t = torch.as_tensor(np.asarray(rep, np.int64), device=DEV)
    ok = rep_t >= 0
    pts = x[rep_t.clamp(min=0)]                         # [C, S, D]
    c, s, d = pts.shape
    sq = (pts * pts).sum(2)
    top = torch.where(ok, sq, 0.0).amax(1)              # [C]
    sq = torch.where(ok, sq, torch.inf)
    flat = pts.reshape(c * s, d)
    root_d = float(np.sqrt(d))
    differ, worst_swap, worst_dist = 0, 0.0, 0.0
    k = ids.shape[1]
    for r in np.asarray(rows, np.int64):
        d2 = (sq[r][:, None] + sq.reshape(1, -1)
              - 2.0 * (pts[r] @ flat.T)).view(s, c, s)
        h1 = torch.where(ok[r][:, None], d2.amin(2), -torch.inf).amax(0)
        h2 = torch.where(ok, d2.amin(0), -torch.inf).amax(1)
        h = torch.maximum(h1, h2).clamp(min=0.0)
        h[r] = 0.0
        band = root_d * eps * (top[r] + top) + 2.0 * eps * h
        got = torch.as_tensor(np.asarray(ids[r], np.int64), device=DEV)
        got_d2 = torch.as_tensor(np.asarray(dists[r], np.float64),
                                 device=DEV) ** 2
        worst_dist = max(worst_dist, float(
            ((got_d2 - h[got]).abs() / band[got]).max()))
        want = torch.sort(h, stable=True).indices[:k]
        extra = sorted(set(got.tolist()) - set(want.tolist()))
        missed = sorted(set(want.tolist()) - set(got.tolist()))
        if not extra:
            continue
        differ += 1
        e = torch.tensor(extra, device=DEV)
        m = torch.tensor(missed, device=DEV)
        swap = float(((h[e][:, None] - h[m][None, :])
                      / (band[e][:, None] + band[m][None, :])).max())
        worst_swap = max(worst_swap, swap)
        if swap > 1.0:
            raise AssertionError(
                f"Hausdorff kNN row {int(r)}: neighbours differ from the "
                f"float64 top-{k} by {swap} x the float32 band")
    if worst_dist > 1.0:
        raise AssertionError(f"Hausdorff kNN distances off float64 by "
                             f"{worst_dist} x the float32 band")
    return {"rows": len(rows), "rows_differing": differ,
            "max_swap_over_band": worst_swap,
            "max_dist2_err_over_band": worst_dist}


def salinas_euclid(tsne_kernels, shape=SALINAS_SHAPE, iters: int = 2000,
                   tsne_levels=SALINAS_TSNE_LEVELS, umap_epochs: int = 500,
                   sampled: int = SALINAS_SAMPLED_ROWS,
                   exact_rows: int = SALINAS_EXACT_ROWS) -> dict:
    """EUCLID_CENTROID in both stages on the Salinas-shaped scene
    (create_hyperspectral_scene(*shape, seed=13), Scaler.NONE,
    ``salinas_settings``) through ComputeHierarchy(device=DEV); then `iters`
    t-SNE iterations of each level in `tsne_levels`, each after the first
    starting from average_position_of_children of the level below scaled
    to a largest coordinate of 1 (run_evaluation.py's
    init_level_emb_with_previous), and UMAP
    of level 1 for `umap_epochs` epochs.  Kernel counts are set to 0 before
    the hierarchy and read after each embedding.  Also: seconds and peak
    memory by stage and part (the SPH_PHASE_TIMERS phases), level 1's
    component kNN recall on `sampled` rows against the exact Hausdorff over
    all components, level 2's exact kNN against float64 on `exact_rows`
    rows, P's checks on the embedded levels."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    from sph_tpu_torch.utils.timer import phase_totals
    rows, cols, bands = shape
    seconds, parts, peaks = {}, {}, {}
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, bands, seed=13)
    data = T.scale(T.ImageStack.from_array(img, name="salinas_euclid").data,
                   T.Scaler.NONE)
    seconds["data"] = time.perf_counter() - t
    ihs, lss, rws, nns = salinas_settings(T)
    ch = T.ComputeHierarchy(device=DEV).init(data, rows, cols, ihs=ihs,
                                             lss=lss, rws=rws, nns=nns)
    zero_launches(tsne_kernels)
    with env(SPH_PHASE_TIMERS="1"):
        phase_totals()
        for name, stage in (("stage1_knn", ch.compute_knn_graph),
                            ("stage2_hierarchy", ch.compute_image_hierarchy),
                            ("stage3_level_similarities",
                             ch.compute_level_similarities)):
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            stage()
            sync()
            seconds[name] = time.perf_counter() - t
            parts[name] = phase_totals()
            peaks[name] = (torch.cuda.max_memory_allocated()
                           if DEV == "cuda" else "not measured")
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities

    tsne, prev = {}, None
    for level in tsne_levels:
        if level >= len(levels):
            break
        n = levels[level]
        es = T.ComputeEmbeddingSettings()
        es.tsne.num_iterations = iters
        ce = T.ComputeEmbedding(es, device=DEV)
        if prev is not None:     # run_evaluation.py:253-261
            ce.init_embedding(n, T.scale_embedding_to_one(
                T.average_position_of_children(prev, h.parents[level - 1],
                                               n)))
        kls = {}

        def progress(comp, kls=kls):
            if comp.current_iteration == 0:
                kls[0] = comp.kl_divergence()

        before = read_launches(tsne_kernels)
        t = time.perf_counter()
        with env(**{name: None for name in TSNE_SWITCHES}):
            emb = ce.compute_tsne(ls.get_prob_dist(level), track_kl=True,
                                  progress=progress)
        sync()
        wall = time.perf_counter() - t
        kls[iters] = float(ce.last_kl)
        after = read_launches(tsne_kernels)
        comp = ce.last_computation
        tsne[level] = {
            "n": n, "npad": int(comp._y.shape[0]), "tier": comp.tier,
            "init": ("random disk" if prev is None
                     else "average_position_of_children"),
            "seconds": wall, "iterations_seconds": ce.seconds["iterations"],
            "iters_per_s": iters / ce.seconds["iterations"],
            "kl_at": {str(i): v for i, v in sorted(kls.items())},
            "launches": {kk: after[kk] - before[kk] for kk in after},
            "embedding_finite": bool(np.all(np.isfinite(emb))),
            "embedding_shape": list(emb.shape)}
        prev = emb
    before = read_launches(tsne_kernels)
    umap = pines_umap(ch, data, umap_epochs)
    after = read_launches(tsne_kernels)
    umap_out = {kk: v for kk, v in umap.items() if kk != "emb"}
    umap_out["embedding_finite"] = bool(np.all(np.isfinite(umap["emb"])))
    umap_out["launches"] = {kk: after[kk] - before[kk] for kk in after}
    launches = read_launches(tsne_kernels)

    ids1, d1 = ls.distance_graphs[1]
    rep1 = ls._rep_samples(1)
    pick = np.sort(np.random.default_rng(1).choice(
        levels[1], min(sampled, levels[1]), replace=False))
    t = time.perf_counter()
    kth = hausdorff_kth(data, rep1, pick, ids1.shape[1])
    seconds["exact_kth_sampled_rows"] = time.perf_counter() - t
    exact2 = None
    if len(levels) > 2 and ls.knn_tiers[2] == "exact":
        pick2 = np.sort(np.random.default_rng(2).choice(
            levels[2], min(exact_rows, levels[2]), replace=False))
        t = time.perf_counter()
        exact2 = hausdorff_exactness(data, ls._rep_samples(2),
                                     *ls.distance_graphs[2], pick2)
        seconds["level_2_exactness"] = time.perf_counter() - t
    p = {level: p_checks(ls.get_prob_dist(level),
                         *ls.distance_graphs[level],
                         ls.perplexity_on_level[level])
         for level in tsne}
    return {"n": rows * cols, "size": list(shape), "levels": levels,
            "largest_set_by_level": [
                int(np.bincount(h.pixel_components[lv]).max())
                for lv in range(len(levels))],
            "knn_tiers": ls.knn_tiers, "level_1_k": int(ids1.shape[1]),
            "level_1_samples": int(rep1.shape[1]),
            "level_1_component_knn_recall": overlap_recall(
                ids1[pick], d1[pick], kth),
            "level_2_exactness": exact2, "p": p, "tsne": tsne,
            "umap": umap_out, "launches": launches, "seconds": seconds,
            "seconds_by_part": parts, "peak_memory_bytes": peaks}


def salinas_gates(sal: dict, ref: dict) -> None:
    """salinas_euclid's gates against the JAX-CPU record `ref`; raises on
    the first that fails."""
    import numpy as np
    levels, ref_levels = sal["levels"], ref["levels"]
    if sal["size"] != ref["size"]:
        raise AssertionError(f"salinas_euclid at {sal['size']}, the JAX "
                             f"record at {ref['size']}")
    if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
        raise AssertionError(f"salinas_euclid level 1 {levels[1]} not "
                             f"within 2 % of the JAX record {ref_levels[1]}")
    if abs(len(levels) - len(ref_levels)) > 1:
        raise AssertionError(f"salinas_euclid: {len(levels)} levels vs "
                             f"{len(ref_levels)} in the JAX record")
    threshold = ref["approx_knn_threshold"]
    for level in range(1, len(levels)):
        want = "approximate" if levels[level] > threshold else "exact"
        if sal["knn_tiers"][level] != want:
            raise AssertionError(f"salinas_euclid level {level} "
                                 f"({levels[level]} components) took the "
                                 f"{sal['knn_tiers'][level]} kNN")
    if not levels[1] > threshold:
        raise AssertionError("salinas_euclid level 1 is not above the "
                             "approximate threshold")
    recall = sal["level_1_component_knn_recall"]
    if not recall >= ref["level_1_component_knn_recall"] - RECALL_SLACK:
        raise AssertionError(
            f"salinas_euclid level-1 component kNN recall {recall} < the "
            f"JAX record's {ref['level_1_component_knn_recall']} - "
            f"{RECALL_SLACK}")
    if len(levels) > 2 and sal["level_2_exactness"] is None:
        raise AssertionError("salinas_euclid level 2 was not checked "
                             "against float64")
    for level, run in sal["tsne"].items():
        kl = run["kl_at"]
        if not (np.all(np.isfinite(list(kl.values())))
                and kl[max(kl, key=int)] < kl["0"]):
            raise AssertionError(f"salinas_euclid level {level}: KL not "
                                 f"finite and falling: {kl}")
        if not run["embedding_finite"]:
            raise AssertionError(f"salinas_euclid level {level}: the "
                                 "embedding is not finite")
        iters = int(max(kl, key=int))
        if run["tier"] == "dense" and (
                run["launches"]["tsne_forces_dense"] < iters):
            raise AssertionError(
                f"salinas_euclid level {level}: tsne_forces_dense "
                f"launched {run['launches']['tsne_forces_dense']} times in "
                f"{iters} iterations")
        if run["launches"]["tsne_repulsion"] < 1:
            raise AssertionError(f"salinas_euclid level {level}: the KL's "
                                 "Z did not come from tsne_repulsion")
    if sal["tsne"][1]["tier"] != "dense":
        raise AssertionError("salinas_euclid level 1 did not take the "
                             "dense t-SNE tier")
    if not sal["umap"]["embedding_finite"]:
        raise AssertionError("the salinas_euclid UMAP embedding is not "
                             "finite")


def trustworthiness(x, emb, k: int = 10, block: int = 512) -> float:
    """sklearn.manifold.trustworthiness in numpy (the card's machine has no
    sklearn): 1 - 2 / (n k (2n - 3k - 1)) times the sum, over each point's
    k nearest neighbours in `emb`, of how far past k their ranks by
    distance in `x` go.  Distances in float64, rows in blocks."""
    import numpy as np
    x = np.asarray(x, np.float64)
    e = np.asarray(emb, np.float64)
    n = x.shape[0]
    sqx, sqe = (x * x).sum(1), (e * e).sum(1)
    total = 0
    for r0 in range(0, n, block):
        rows = np.arange(r0, min(r0 + block, n))
        ar = np.arange(rows.size)
        dx = sqx[rows, None] + sqx[None, :] - 2.0 * (x[rows] @ x.T)
        de = sqe[rows, None] + sqe[None, :] - 2.0 * (e[rows] @ e.T)
        dx[ar, rows] = np.inf
        de[ar, rows] = np.inf
        near = np.argpartition(de, k, axis=1)[:, :k]
        at = np.take_along_axis(dx, near, 1)
        ranks = (dx[:, None, :] < at[:, :, None]).sum(2) + 1 - k
        total += int(ranks[ranks > 0].sum())
    return 1.0 - total * 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))


def component_means(data, labels, count: int):
    """The mean spectrum of each component: [count, channels] float64."""
    import numpy as np
    sums = np.zeros((count, data.shape[1]))
    np.add.at(sums, labels, data)
    return sums / np.bincount(labels, minlength=count)[:, None]


def pines_umap(ch, data, epochs: int = 500) -> dict:
    """UMAP of the Pines hierarchy's level 1 through
    ComputeEmbedding.compute_umap (the fuzzy union of the level's P, the
    reference's 500 epochs); its seconds and the trustworthiness at k = 10
    of the layout against the components' mean spectra."""
    import sph_tpu_torch as T
    es = T.ComputeEmbeddingSettings()
    es.umap.num_epochs = epochs
    ce = T.ComputeEmbedding(es, device=DEV)
    emb = ce.compute_umap(ch.level_similarities.get_prob_dist(1))
    comp = ce.last_computation
    h = ch.image_hierarchy.hierarchy
    t = time.perf_counter()
    trust = trustworthiness(component_means(
        data, h.pixel_components[1], h.num_components[1]), emb, 10)
    return {"n": emb.shape[0], "tier": comp.tier, "epochs": comp.n_epochs,
            "width": tuple(comp._eps.shape)[1], "seconds": ce.seconds,
            "epochs_per_s": comp.n_epochs / ce.seconds["epochs"],
            "trustworthiness_k10": trust,
            "trustworthiness_seconds": time.perf_counter() - t, "emb": emb}


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

    clock_hz = sm_clock_hz()
    rep_checks = []
    for n, npad, calls, twin_calls, sampled in REPULSION_SHAPES:
        y = torch.from_numpy(repulsion_layout(n, npad, seed=n)).cuda()
        rep_checks.append(check_repulsion_kernel(
            y, n, calls, twin_calls, sampled, clock_hz))
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
    main_rep_launches = tsne_kernels.tsne_repulsion.launches
    kl = float(ce.last_kl)
    emit({"phase": "main", "levels": levels, "level_1_kl": kl,
          "seconds": seconds, "tsne_iterations": iters,
          "tsne_iters_per_s": iters / seconds["tsne"],
          "tsne_tier": ce.last_computation.tier,
          "tsne_forces_dense_launches": launches,
          "tsne_repulsion_launches": main_rep_launches})

    # the kernel once more at the level-1 size the main path just gave it
    from sph_tpu_torch.models.tsne import dense_npad
    checks.append(check_forces_kernel(levels[1], dense_npad(levels[1]),
                                      seed=13))
    main_shape = checks[-1]
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
    if main_rep_launches < 1:
        raise AssertionError("tsne_repulsion did not give the level-1 KL "
                             "its Z")
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

    # ---- UMAP of the same level 1 ----------------------------------------
    zero_launches(tsne_kernels)
    umap = pines_umap(ch, data)
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_umap_reference.json")) as f:
        umap_ref = json.load(f)
    emit({"phase": "umap", **{k: v for k, v in umap.items() if k != "emb"},
          "jax_cpu_trustworthiness_k10": umap_ref["trustworthiness_k10"],
          "launches": read_launches(tsne_kernels)})
    if umap["tier"] != "rows" or umap["n"] != levels[1]:
        raise AssertionError(f"UMAP of level 1 took the {umap['tier']} tier")
    if not np.all(np.isfinite(umap["emb"])):
        raise AssertionError("the UMAP embedding is not finite")
    if not umap["trustworthiness_k10"] >= (
            UMAP_TRUST_SLACK * umap_ref["trustworthiness_k10"]):
        raise AssertionError(
            f"UMAP trustworthiness {umap['trustworthiness_k10']} < "
            f"{UMAP_TRUST_SLACK} x the JAX package's "
            f"{umap_ref['trustworthiness_k10']}")
    del ch, cond, dense, emb, ce, umap

    # ---- default level settings: the approximate kNN tiers on the path ---
    scene = scene_overlap(tsne_kernels)
    with open(os.path.join(REPO, "docs",
                           "torch_port_scene_overlap_reference.json")) as f:
        scene_ref = json.load(f)
    emit({"phase": "scene_overlap", **scene,
          "jax_cpu_levels": scene_ref["levels"],
          "jax_cpu_stage1_recall_sampled_rows":
              scene_ref["stage1_recall_at_91"],
          "jax_cpu_level_1_component_knn_recall":
              scene_ref["level_1_component_knn_recall"],
          "approx_knn_threshold": scene_ref["approx_knn_threshold"]})
    s_levels, s_ref = scene["levels"], scene_ref["levels"]
    if scene["size"] != scene_ref["size"]:
        raise AssertionError(f"scene_overlap at {scene['size']}, the JAX "
                             f"record at {scene_ref['size']}")
    if abs(s_levels[1] - s_ref[1]) > LEVEL1_TOLERANCE * s_ref[1]:
        raise AssertionError(f"scene_overlap level 1 {s_levels[1]} not "
                             f"within 2 % of the JAX record {s_ref[1]}")
    if abs(len(s_levels) - len(s_ref)) > 1:
        raise AssertionError(f"scene_overlap: {len(s_levels)} levels vs "
                             f"{len(s_ref)} in the JAX record")
    deep_levels_gate(s_levels, s_ref, "scene_overlap")
    if not (s_levels[1] > scene_ref["approx_knn_threshold"]
            and scene["knn_tiers"][1] == "approximate"):
        raise AssertionError("scene_overlap level 1 did not take the "
                             "approximate component kNN: "
                             f"{scene['knn_tiers']}")
    if not scene["level_1_component_knn_recall"] >= (
            scene_ref["level_1_component_knn_recall"] - RECALL_SLACK):
        raise AssertionError(
            f"level-1 component kNN recall "
            f"{scene['level_1_component_knn_recall']} < the JAX record's "
            f"{scene_ref['level_1_component_knn_recall']} - {RECALL_SLACK}")
    s_kl = scene["kl_at"]
    if scene["tsne_tier"] != "dense":
        raise AssertionError(f"scene_overlap level 1 took the "
                             f"{scene['tsne_tier']} t-SNE tier")
    if scene["launches"]["tsne_forces_dense"] < scene["tsne_iterations"]:
        raise AssertionError("tsne_forces_dense launched "
                             f"{scene['launches']['tsne_forces_dense']} "
                             f"times in {scene['tsne_iterations']} iterations")
    if not (np.all(np.isfinite(list(s_kl.values())))
            and s_kl[str(scene["tsne_iterations"])] < s_kl["0"]):
        raise AssertionError(f"scene_overlap KL not finite and falling: "
                             f"{s_kl}")
    if not scene["embedding_finite"]:
        raise AssertionError("the scene_overlap embedding is not finite")
    if not scene["exact_component_knn_peak_bytes"] <= EXACT_OVERLAP_PEAK_MAX:
        raise AssertionError(
            "the exact NEIGH_OVERLAP kNN of level 1 held "
            f"{scene['exact_component_knn_peak_bytes']} bytes above what "
            f"was allocated before it, over {EXACT_OVERLAP_PEAK_MAX}")

    # tsne_forces_dense at the level-1 shape scene_overlap gave it
    checks.append(check_forces_kernel(s_levels[1], dense_npad(s_levels[1]),
                                      seed=14, calls=50))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "path_shape": "scene_overlap", **checks[-1]})

    # ---- EUCLID_CENTROID in both stages, Salinas-shaped -----------------
    sal = salinas_euclid(tsne_kernels)
    with open(os.path.join(REPO, "docs",
                           "torch_port_salinas_euclid_reference.json")) as f:
        sal_ref = json.load(f)
    emit({"phase": "salinas_euclid", **sal,
          "jax_cpu_levels": sal_ref["levels"],
          "jax_cpu_level_1_component_knn_recall":
              sal_ref["level_1_component_knn_recall"],
          "approx_knn_threshold": sal_ref["approx_knn_threshold"]})
    sal_levels = sal["levels"]
    checks.append(check_forces_kernel(sal_levels[1],
                                      dense_npad(sal_levels[1]), seed=15,
                                      calls=50))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "path_shape": "salinas_euclid", **checks[-1]})
    salinas_gates(sal, sal_ref)

    # ---- the 1M path: BASELINE config 4, one kNN graph for both tiers ----
    graph = scene_graph(1000, 1000)
    n_large = graph["idx"].shape[0]
    emit({"phase": "large_graph", "n": n_large, "d": graph["data"].shape[1],
          "k": graph["idx"].shape[1], "seconds": graph["seconds"],
          "knn_peak_memory_bytes": graph["knn_peak"]})
    idx, dist = graph["idx"], graph["dist"]
    graph_invariants(idx, dist, "kNN")
    if not np.all(dist[:, 0] == 0):
        raise AssertionError("kNN: the self distance is not 0")
    sample = np.sort(np.random.default_rng(3).choice(n_large, 1024,
                                                     replace=False))
    exact = knn_exactness(graph["data"], idx, idx.shape[1], sample)
    emit({"phase": "large_graph_checks", "passed": True,
          "knn_exactness": exact})

    # the same scene on its size tier, the approximate kNN (flat IVF)
    livf = large_ivf(graph)
    emit({"phase": "large_ivf", **livf})
    if not livf["bits_equal_across_runs"]:
        raise AssertionError("large_ivf: two runs differ")

    # the default tier (grid) at the reference's depth
    grid = grid_path(tsne_kernels, graph, GRID_ITERS, GRID_KL_AT)
    gcomp = grid["ce"].last_computation
    zero_launches(tsne_kernels)
    gap = z_gap(gcomp)
    gap["launches"] = read_launches(tsne_kernels)
    split = grid_split(gcomp)
    repeat = scatter_repeatability(gcomp)
    kls = grid["kls"]
    emit({"phase": "large_grid", "n": n_large, "tsne_tier": gcomp.tier,
          "tsne_iterations": GRID_ITERS, "seconds": grid["seconds"],
          "tsne_iters_per_s": GRID_ITERS / grid["seconds"]["tsne"],
          "p_width": gcomp._p_val.shape[1],
          "grid_sizes": grid_sizes(gcomp.grid_history),
          "grid_picks": len(gcomp.grid_history),
          "kl_at": {str(i): v for i, v in sorted(kls.items())},
          "kl_final_exact_z": kls[GRID_ITERS] + gap["log_z_ratio"],
          "z": gap, "ms_per_iteration_by_part": split,
          "step_ms_with_index_add_deposit": GRID_STEP_MS_INDEX_ADD,
          "scatter_repeatability": repeat,
          "peak_memory_bytes": grid["peak_memory_bytes"],
          "embedding_max_abs": float(np.abs(grid["emb"]).max()),
          "launches": grid["launches"]})
    if not repeat["bits_equal"]:
        raise AssertionError(f"the grid tier's repulsion differs from call "
                             f"to call: {repeat}")
    if gcomp.tier != "grid":
        raise AssertionError(f"the 1M default took the {gcomp.tier} tier")
    if any(grid["launches"].values()):
        raise AssertionError(f"a kernel launched on the grid tier: "
                             f"{grid['launches']}")
    if not kls[GRID_ITERS] < kls[0]:
        raise AssertionError(f"grid tier: KL {kls[GRID_ITERS]} not below "
                             f"iteration 0's {kls[0]}")
    if gap["launches"]["tsne_repulsion"] != 1:
        raise AssertionError("the exact Z at 1M did not come from "
                             "tsne_repulsion")
    if not gap["z_rel_gap"] <= Z_GAP_MAX:
        raise AssertionError(f"grid Z {gap['z_grid']} vs exact "
                             f"{gap['z_exact']}: gap {gap['z_rel_gap']}")
    if not (np.all(np.isfinite(grid["emb"]))
            and grid["emb"].shape == (n_large, 2)):
        raise AssertionError("the 1M grid embedding is not finite [N, 2]")
    if bool((gcomp._y[n_large:] != 0).any()):
        raise AssertionError("the 1M grid embedding's pad rows are not 0")
    del grid, gcomp

    # the exact tier, cut in depth
    with env(SPH_TSNE_GRID="0"):          # the exact tier above 32768
        large = large_path(tsne_kernels, LARGE_ITERS, graph=graph)
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
    sec = large["seconds"]
    large_launches = large["launches"]
    emit({"phase": "large", "n": n_large, "d": large["data"].shape[1],
          "k": large["idx"].shape[1],
          "perplexity": large["es"].tsne.perplexity,
          "tsne_tier": comp.tier,
          "tsne_iterations": LARGE_ITERS, "seconds": sec,
          "seconds_total": sum(sec.values()),
          "tsne_iters_per_s": LARGE_ITERS / sec["tsne"],
          "kl_iteration_0": kl0, "kl_iteration_0_seconds": kl0_s,
          "kl_final": large["kl"],
          "embedding_max_abs": float(np.abs(large["emb"]).max()),
          "launches": large_launches})

    # ---- checks of the exact tier at 1M ----------------------------------
    emb = large["emb"]
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
    emit({"phase": "large_checks", "passed": True, **pc,
          "npad": comp._npad,
          "kernel_vs_twin_at_final_embedding": rep_checks[-1]})
    del large, comp, graph, emb

    # ---- the grid against the exact tier at 65536 points -----------------
    mid = grid_vs_exact(tsne_kernels, iters=MID_ITERS)
    emit({"phase": "grid_vs_exact", **mid})
    if mid["grid"]["tier"] != "grid" or mid["exact"]["tier"] != "exact":
        raise AssertionError(f"65536 points took the {mid['grid']['tier']} "
                             f"and {mid['exact']['tier']} tiers")
    if mid["grid"]["p_width"] != mid["exact"]["p_width"]:
        raise AssertionError("65536 points: the tiers ran on different P")
    if mid["exact"]["launches"]["tsne_repulsion"] < MID_ITERS:
        raise AssertionError("tsne_repulsion did not run every exact "
                             "iteration at 65536 points")
    if not mid["kl_ratio"] <= KL_RATIO_MAX:
        raise AssertionError(f"KL_grid / KL_exact = {mid['kl_ratio']} > "
                             f"{KL_RATIO_MAX} at 65536 points")

    # ---- the approximate tiers' recall at 10^6 points --------------------
    recall = ivf_recall()
    emit({"phase": "ivf_recall", **recall})
    for index, gate in IVF_RECALL_GATES.items():
        if not recall[index]["recall"] >= gate:
            raise AssertionError(f"ivf_recall {index}: recall@16 "
                                 f"{recall[index]['recall']} < {gate}")

    rep_main = rep_checks[1]            # the Pines KL's shape
    rep_timed = rep_checks[:len(REPULSION_SHAPES)]
    emit({"kernels": [{
        "name": "tsne_forces_dense", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_forces_dense.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:167",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        **forces_bound(main_shape["n"], main_shape["npad"]),
        "library_ms": None,
        "shape": [main_shape["n"], main_shape["npad"]],
        "launches_by_path": [
            {"path": "pines", "launches": launches, "n": levels[1]},
            {"path": "scene_overlap", "n": s_levels[1],
             "launches": scene["launches"]["tsne_forces_dense"]},
            *({"path": f"salinas_euclid_level_{level}", "n": run["n"],
               "launches": run["launches"]["tsne_forces_dense"]}
              for level, run in sal["tsne"].items())],
        "at_shapes": [{
            "shape": [c["n"], c["npad"]], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"]} for c in checks]}, {
        "name": "tsne_repulsion", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_repulsion.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:80",
        "launches": main_rep_launches,
        "max_abs_err": max(c["max_abs_err"] for c in rep_checks),
        "ms": rep_main["ms"], "plain_ms": rep_main["plain_ms"],
        **repulsion_bound(rep_main["n"], rep_main["npad"]),
        "library_ms": None,
        "shape": [rep_main["n"], rep_main["npad"]],
        # the paths' launches, each with its point count (the top-level
        # launches, ms and bound are the main path's, at the Pines KL's)
        "launches_by_path": [
            {"path": "pines_kl", "launches": main_rep_launches,
             "n": rep_main["n"]},
            {"path": "scene_overlap_kl", "n": s_levels[1],
             "launches": scene["launches"]["tsne_repulsion"]},
            *({"path": f"salinas_euclid_level_{level}_kl", "n": run["n"],
               "launches": run["launches"]["tsne_repulsion"]}
              for level, run in sal["tsne"].items()),
            {"path": "large_grid_z_gap", "n": n_large,
             "launches": gap["launches"]["tsne_repulsion"]},
            {"path": "large_exact", "n": n_large,
             "launches": large_launches["tsne_repulsion"]},
            {"path": "grid_vs_exact", "n": mid["n"],
             "launches": mid["exact"]["launches"]["tsne_repulsion"]}],
        "at_shapes": [{
            "shape": [c["n"], c["npad"]], "plan": c["plan"], "ms": c["ms"],
            "plain_ms": c.get("plain_ms", "not measured"),
            "bound_ms": repulsion_bound(c["n"], c["npad"])["bound_ms"],
            "sfu_floor_ms": c["sfu_floor_ms"]} for c in rep_timed]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
