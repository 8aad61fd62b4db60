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
6. umap    — the same level 1 through ComputeEmbedding.compute_umap for
   the reference's 500 epochs (rows tier): seconds, epochs/s, and the
   trustworthiness at k = 10 against the components' mean spectra, at
   least 0.99 x the JAX-on-CPU record in
   docs/torch_port_pines_umap_reference.json.
7. large_graph — BASELINE config 4 (benchmarks/bench_1m.py): a
   1000x1000x100 synthetic stack and its exact kNN graph (k = 16, once for
   both tiers below); kNN invariants and exactness against float64
   distances on 1024 sampled rows.
8. large_grid — t-SNE from that graph at perplexity 5 on the default tier,
   the grid, for the reference's 4000 iterations: seconds, iterations/s,
   the grid sizes, the KL at iterations 0, 250, 1000 and 4000, the grid's
   Z against tsne_repulsion's (at most 1e-3 apart) and the final KL with
   the exact Z, milliseconds an iteration by part, the scatter-add's
   run-to-run difference, peak memory; no kernel launches on this tier.
9. large   — the same graph on the exact sparse-P tier (SPH_TSNE_GRID=0),
   cut to 10 iterations; the KL before and after, the launches.
10. large_checks — a symmetric P whose conditional rows sum to 1, the
   exact tier (tsne_repulsion on every iteration, tsne_forces_dense never),
   a falling KL, a finite embedding with zero pad rows, and tsne_repulsion
   against its twin at the embedding the path produced.
11. grid_vs_exact — the 1M recipe at 256x256 (65536 points), 1000
   iterations on the grid and the exact tier from the same P and initial
   layout, both scored under that P with the exact Z: KL_grid <= 1.001 x
   KL_exact.

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
LARGE_ITERS = 10           # 1M exact tier: a depth cut (0.6 s an iteration)
GRID_ITERS = 4000          # 1M grid tier: the reference's schedule above 200k
GRID_KL_AT = (0, 250, 1000)
MID_ITERS = 1000           # 65536 points: the reference's schedule below 100k
Z_GAP_MAX = 1e-3           # grid Z against the exact Z at 1M, relative
KL_RATIO_MAX = 1.001       # 65536 points: KL_grid / KL_exact
UMAP_TRUST_SLACK = 0.99    # Pines UMAP trustworthiness vs the JAX-CPU record
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
# reciprocal one): dx, dy 2; d^2 3; 1 + d^2 1; 1/d 1; w^2 1; the sums
# z, s2 2 and ax, ay 4 -> 14; the dense pass adds p w 1, its sum 1 and
# two more multiply-adds 4 -> 20
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
    (scatter-add), the FFT convolution, the interpolation (gather), the
    update, and the whole step.  The state is put back afterwards."""
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
    return ms


def scatter_repeatability(comp) -> dict:
    """Two grid_repulsion calls on the same layout: how far the unordered
    scatter-add moves the result from one call to the next."""
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

    # ---- the 1M path: BASELINE config 4, one kNN graph for both tiers ----
    graph = scene_graph(1000, 1000)
    n_large = graph["idx"].shape[0]
    emit({"phase": "large_graph", "n": n_large, "d": graph["data"].shape[1],
          "k": graph["idx"].shape[1], "seconds": graph["seconds"],
          "knn_peak_memory_bytes": graph["knn_peak"]})
    idx, dist = graph["idx"], graph["dist"]
    if not np.array_equal(idx[:, 0], np.arange(n_large)):
        raise AssertionError("kNN: slot 0 is not the point itself")
    if not (np.all(dist[:, 0] == 0) and np.all(np.isfinite(dist))
            and np.all(np.diff(dist, axis=1) >= 0)):
        raise AssertionError("kNN: distances not 0-first, finite, ascending")
    sample = np.sort(np.random.default_rng(3).choice(n_large, 1024,
                                                     replace=False))
    exact = knn_exactness(graph["data"], idx, idx.shape[1], sample)
    emit({"phase": "large_graph_checks", "passed": True,
          "knn_exactness": exact})

    # the default tier (grid) at the reference's depth
    grid = grid_path(tsne_kernels, graph, GRID_ITERS, GRID_KL_AT)
    gcomp = grid["ce"].last_computation
    gap = z_gap(gcomp)
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
          "scatter_repeatability": repeat,
          "peak_memory_bytes": grid["peak_memory_bytes"],
          "embedding_max_abs": float(np.abs(grid["emb"]).max()),
          "launches": grid["launches"]})
    if gcomp.tier != "grid":
        raise AssertionError(f"the 1M default took the {gcomp.tier} tier")
    if any(grid["launches"].values()):
        raise AssertionError(f"a kernel launched on the grid tier: "
                             f"{grid['launches']}")
    if not kls[GRID_ITERS] < kls[0]:
        raise AssertionError(f"grid tier: KL {kls[GRID_ITERS]} not below "
                             f"iteration 0's {kls[0]}")
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

    main_shape = checks[-1]
    rep_full = rep_checks[1]            # the largest shape timed in full
    rep_1m = rep_checks[2]
    emit({"kernels": [{
        "name": "tsne_forces_dense", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_forces_dense.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:167",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        **forces_bound(main_shape["n"], main_shape["npad"]),
        "library_ms": None,
        "shape": [main_shape["n"], main_shape["npad"]]}, {
        "name": "tsne_repulsion", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_repulsion.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:80",
        "launches": large_launches["tsne_repulsion"],
        "max_abs_err": max(c["max_abs_err"] for c in rep_checks),
        "ms": rep_full["ms"], "plain_ms": rep_full["plain_ms"],
        **repulsion_bound(rep_full["n"], rep_full["npad"]),
        "library_ms": None,
        "shape": [rep_full["n"], rep_full["npad"]],
        "ms_at_1m": rep_1m["ms"],
        "bound_ms_at_1m": repulsion_bound(rep_1m["n"],
                                          rep_1m["npad"])["bound_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
