#!/usr/bin/env python3
"""Profile one of the PyTorch port's paths on one CUDA card.

    python3 scripts/profile_torch_port.py
        [--path pines|large|grid|scene|ivf|salinas|geo] [--out FILE]

--path pines (the default) runs chip_smoke.py's Pines configuration
(bench.py:89-136 at 145x145x200, then 2000 level-1 t-SNE iterations) once
to warm up, then once more with each stage under its own torch.profiler
window.  --path large runs chip_smoke.py's 1M path (BASELINE config 4: a
1000x1000x100 stack, exact kNN with k = 16, P from the kNN graph at
perplexity 5, the exact sparse-P t-SNE tier with SPH_TSNE_GRID=0 and
SPH_TSNE_DENSE_P=0) once,
after a warm-up at 64x64, with the kNN, the P and set-up, 10 t-SNE
iterations and the KL each under its own window.  --path grid runs the
same 1M path on its default tier, the grid (no SPH_TSNE_* switch set),
with 50 iterations in the t-SNE window.  --path scene runs chip_smoke.py's
scene_overlap configuration (the Pines recipe at 256x256x200 on default
level settings: IVF_FLAT stage 1, level 1 on the approximate component
kNN, 2000 level-1 t-SNE iterations), after a warm-up at 48x48, each stage
under its own window.  --path ivf runs the flat (HNSW) and the PQ
(HNSW_IVFPQ) tier on chip_smoke.py's ivf_recall data (10^6 x 100
clustered points, k = 16), after a warm-up at 20000 points.  --path
salinas runs chip_smoke.py's salinas_euclid configuration (EUCLID_CENTROID
in both stages on the Salinas-shaped 512x217x224 scene: level 1 on the
approximate Hausdorff kNN, the levels below on the exact one), then 2000
t-SNE iterations and 500 UMAP epochs of level 1, after a warm-up at
64x54x224, each stage under its own window.  --path geo runs
chip_smoke.py's rgb_geo configuration (GEO_CENTROID in both stages on the
240x240 RGB scene), then 2000 t-SNE iterations of levels 1, 2 and 3, after
a warm-up at 48x48, each stage under its own window, and also gives each
stage's Bellman-Ford relax sweeps (ops/shortest_path.relax, under a
record_function span): the device time of the operations launched inside
the spans, as their host trees list them, in seconds and as a share of
the stage's device time, and the number of spans; and the device time of
the kernel bellman_ford_relax (``relax_kernel``) by its name, with its
launch count (a launch through ctypes may be missing from the span's
host tree).

Prints, per stage, the wall seconds, the device seconds (the sum of its
kernels and copies, counted as torch.profiler counts its "Self CUDA time
total"), the device's busy share of the wall and the number of device
operations, then each stage's top operations by device time.  The
profiler's own host cost lengthens the walls, so the busy shares read low
against an unprofiled run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the __global__ names of csrc/: tsne_forces_dense, tsne_repulsion's unit
# and split-sum kernels, its earlier single kernel (older checkouts),
# tsne_attraction and bellman_ford_relax
KERNEL_NAMES = ("forces_dense_kernel", "repulsion_units", "reduce_splits",
                "repulsion_kernel", "attraction_kernel", "relax_kernel")
RELAX_KERNEL = "relax_kernel"
RELAX_SPAN = "shortest_path.relax"


def run_main_path(stage_context):
    """The main path with each stage inside `stage_context(name)`; returns
    the stages' wall seconds."""
    import torch
    import chip_smoke
    import sph_tpu_torch as T
    ch, _, _ = chip_smoke.pines_hierarchy("cuda")
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 2000
    stages = (
        ("stage1_knn", ch.compute_knn_graph),
        ("stage2_hierarchy", ch.compute_image_hierarchy),
        ("stage3_level_similarities", ch.compute_level_similarities),
        ("tsne", lambda: T.ComputeEmbedding(es, device="cuda").compute_tsne(
            ch.level_similarities.get_prob_dist(1), track_kl=True)))
    walls = {}
    for name, stage in stages:
        t = time.perf_counter()
        with stage_context(name):
            stage()
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    return walls


def run_large_path(stage_context, rows: int = 1000, cols: int = 1000,
                   iters: int = 10, tier: str = "exact"):
    """chip_smoke.py's 1M path, driven through TsneComputation so that the
    set-up, the iterations and the KL are separate stages, on the exact
    tier or the grid tier (forced at sizes where it is not the default);
    returns the stages' wall seconds."""
    import torch
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(rows, cols, 100, seed=7)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.NONE)
    params = T.TsneParameters()
    params.perplexity = 5.0
    tsne = T.TsneComputation(params, device="cuda")
    graph = []
    stages = (
        ("knn", lambda: graph.extend(compute_knn(
            data, 16, T.KnnIndex.BRUTE_FORCE, device="cuda"))),
        ("p_and_set_up", lambda: (tsne.set_neighbor_graph(*graph),
                                  tsne.compute(0))),
        (f"tsne_{iters}_iterations",
         lambda: tsne.continue_gradient_descent(iters)),
        ("kl", tsne.kl_divergence))
    walls = {}
    # the exact tier: no grid above 32768 points, no dense P below (the
    # small warm-up); the grid tier is the default at 1M
    switches = ({"SPH_TSNE_GRID": "0", "SPH_TSNE_DENSE_P": "0"}
                if tier == "exact" else
                {} if rows * cols > 32768 else {"SPH_TSNE_GRID": "1"})
    with chip_smoke.env(**switches):
        for name, stage in stages:
            t = time.perf_counter()
            with stage_context(name):
                stage()
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
    if tsne.tier != tier:
        raise RuntimeError(f"the 1M path took the {tsne.tier} tier")
    return walls


def run_scene_path(stage_context, side: int = 256):
    """chip_smoke.py's scene_overlap configuration, stage by stage; returns
    the stages' wall seconds."""
    import torch
    import chip_smoke
    import sph_tpu_torch as T
    ch, _ = chip_smoke.scene_hierarchy(side, "cuda")
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 2000
    stages = (
        ("stage1_knn", ch.compute_knn_graph),
        ("stage2_hierarchy", ch.compute_image_hierarchy),
        ("stage3_level_similarities", ch.compute_level_similarities),
        ("tsne", lambda: T.ComputeEmbedding(es, device="cuda").compute_tsne(
            ch.level_similarities.get_prob_dist(1), track_kl=True)))
    walls = {}
    for name, stage in stages:
        t = time.perf_counter()
        with stage_context(name):
            stage()
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    return walls


def run_salinas_path(stage_context, shape=None):
    """chip_smoke.py's salinas_euclid configuration, stage by stage, then
    level 1's t-SNE and UMAP; returns the stages' wall seconds."""
    import torch
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = shape or chip_smoke.SALINAS_SHAPE
    img = create_hyperspectral_scene(rows, cols, bands, seed=13)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.NONE)
    ihs, lss, rws, nns = chip_smoke.salinas_settings(T)
    ch = T.ComputeHierarchy(device="cuda").init(data, rows, cols, ihs=ihs,
                                                lss=lss, rws=rws, nns=nns)
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 2000
    es.umap.num_epochs = 500
    stages = (
        ("stage1_knn", ch.compute_knn_graph),
        ("stage2_hierarchy", ch.compute_image_hierarchy),
        ("stage3_level_similarities", ch.compute_level_similarities),
        ("tsne_level_1", lambda: T.ComputeEmbedding(
            es, device="cuda").compute_tsne(
                ch.level_similarities.get_prob_dist(1), track_kl=True)),
        ("umap_level_1", lambda: T.ComputeEmbedding(
            es, device="cuda").compute_umap(
                ch.level_similarities.get_prob_dist(1))))
    walls = {}
    for name, stage in stages:
        t = time.perf_counter()
        with stage_context(name):
            stage()
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    return walls


def run_geo_path(stage_context, side: int = 240):
    """chip_smoke.py's rgb_geo configuration, stage by stage, then t-SNE of
    levels 1-3; returns the stages' wall seconds."""
    import torch
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.UNIFORM)
    ihs, lss, rws, nns = chip_smoke.rgb_geo_settings(T)
    ch = T.ComputeHierarchy(device="cuda").init(data, side, side, ihs=ihs,
                                                lss=lss, rws=rws, nns=nns)
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = 2000
    stages = [
        ("stage1_knn", ch.compute_knn_graph),
        ("stage2_hierarchy", ch.compute_image_hierarchy),
        ("stage3_level_similarities", ch.compute_level_similarities)]
    for level in (1, 2, 3):
        stages.append((f"tsne_level_{level}", lambda level=level: (
            T.ComputeEmbedding(es, device="cuda").compute_tsne(
                ch.level_similarities.get_prob_dist(level), track_kl=True)
            if level < ch.image_hierarchy.hierarchy.num_levels else None)))
    walls = {}
    for name, stage in stages:
        t = time.perf_counter()
        with stage_context(name):
            stage()
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    return walls


def run_ivf_path(stage_context, n: int = 1_000_000):
    """The flat and the PQ IVF tier on chip_smoke.py's ivf_recall data;
    returns each one's wall seconds."""
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.utils.testdata import create_clustered_points
    data = create_clustered_points(n, 100, seed=0)
    walls = {}
    for index in (T.KnnIndex.HNSW, T.KnnIndex.HNSW_IVFPQ):
        t = time.perf_counter()
        with stage_context(index.value):
            compute_knn(data, 16, index, device="cuda")
            torch.cuda.synchronize()
        walls[index.value] = time.perf_counter() - t
    return walls


def relax_device_seconds(events) -> tuple:
    """(spans, seconds): the relax spans among the profiler's `events`, and
    the device time of the kernels and copies launched inside them, as
    the spans' host trees list them (the span's own device-side
    annotation, a separate event over the kernels' whole range, is left
    out, so nothing is counted twice)."""
    from torch.autograd import DeviceType
    spans = [e for e in events if e.device_type == DeviceType.CPU
             and e.name == RELAX_SPAN]
    return len(spans), sum(e.device_time_total for e in spans) / 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("pines", "large", "grid", "scene",
                                       "ivf", "salinas", "geo"),
                    default="pines")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    args.out = args.out or os.path.join(
        REPO, "out", f"torch_port_profile_{args.path}.txt")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")

    if args.path == "pines":
        run = run_main_path
        run(lambda name: contextlib.nullcontext())
    elif args.path == "scene":
        run = run_scene_path
        run(lambda name: contextlib.nullcontext(), 48)
    elif args.path == "salinas":
        run = run_salinas_path
        run(lambda name: contextlib.nullcontext(), (64, 54, 224))
    elif args.path == "geo":
        run = run_geo_path
        from sph_tpu_torch.ops import shortest_path
        relax = shortest_path.relax

        def spanned_relax(*a, **kw):
            with torch.profiler.record_function(RELAX_SPAN):
                return relax(*a, **kw)

        # the wrapper counts its launches on the module's `relax`: this span
        spanned_relax.launches = relax.launches
        shortest_path.relax = spanned_relax
        run(lambda name: contextlib.nullcontext(), 48)
    elif args.path == "ivf":
        run = run_ivf_path
        run(lambda name: contextlib.nullcontext(), 20000)
    else:
        tier = "exact" if args.path == "large" else "grid"
        iters = 10 if tier == "exact" else 50

        def run(ctx, rows=1000, cols=1000, iters=iters):
            return run_large_path(ctx, rows, cols, iters, tier)

        run(lambda name: contextlib.nullcontext(), 64, 64, 2)
    profs = {}

    @contextlib.contextmanager
    def stage_profile(name):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
        profs[name] = prof

    walls = run(stage_profile)

    import chip_smoke
    lines = [chip_smoke.nvidia_smi_line(), f"path: {args.path}", "",
             f"{'stage':28s} {'wall s':>10s} {'device s':>10s} {'busy':>7s} "
             f"{'device ops':>11s} {'kernels s':>10s} {'of device':>9s}"]
    tables = []
    for name, wall in walls.items():
        prof = profs[name]
        ops = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        dev_s = sum(e.self_device_time_total for e in ops) / 1e6
        # the hand-written kernels of csrc/ (their __global__ names)
        ours = sum(e.self_device_time_total for e in ops
                   if any(k in e.name for k in KERNEL_NAMES)) / 1e6
        lines.append(f"{name:28s} {wall:10.4f} {dev_s:10.4f} "
                     f"{dev_s / wall:7.1%} {len(ops):11d} {ours:10.4f} "
                     f"{ours / max(dev_s, 1e-12):9.1%}")
        if args.path == "geo":
            spans, relax_s = relax_device_seconds(prof.events())
            lines.append(f"{'  of which relax sweeps':28s} {'':10s} "
                         f"{relax_s:10.4f} {relax_s / max(dev_s, 1e-12):7.1%}"
                         f" {spans:11d}")
            kern = [e for e in ops if RELAX_KERNEL in e.name]
            kern_s = sum(e.self_device_time_total for e in kern) / 1e6
            lines.append(f"{'  of which relax_kernel':28s} {'':10s} "
                         f"{kern_s:10.4f} {kern_s / max(dev_s, 1e-12):7.1%}"
                         f" {len(kern):11d}")
        tables += ["", f"{name}: top operations by self device time",
                   prof.key_averages().table(
                       sort_by="self_device_time_total", row_limit=12)]
    text = "\n".join(lines + tables)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
