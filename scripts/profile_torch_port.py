#!/usr/bin/env python3
"""Profile the PyTorch port's Pines main path on one CUDA card.

    python3 scripts/profile_torch_port.py [--out out/torch_port_profile.txt]

Runs chip_smoke.py's configuration (bench.py:89-136 at 145x145x200, then
2000 level-1 t-SNE iterations) once to warm up, then once more with each
stage under its own torch.profiler window.  Prints, per stage, the wall
seconds, the device seconds (the sum of its kernels and copies, counted as
torch.profiler counts its "Self CUDA time total"), the device's busy share
of the wall and the number of device operations, then each stage's top
operations by device time.  The profiler's own host cost lengthens the
walls, so the busy shares read low against an unprofiled run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "torch_port_profile.txt"))
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")

    run_main_path(lambda name: contextlib.nullcontext())
    profs = {}

    @contextlib.contextmanager
    def stage_profile(name):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
        profs[name] = prof

    walls = run_main_path(stage_profile)

    lines = [torch.cuda.get_device_name(0), "",
             f"{'stage':28s} {'wall s':>10s} {'device s':>10s} {'busy':>7s} "
             f"{'device ops':>11s}"]
    tables = []
    for name, wall in walls.items():
        prof = profs[name]
        ops = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        dev_s = sum(e.self_device_time_total for e in ops) / 1e6
        lines.append(f"{name:28s} {wall:10.4f} {dev_s:10.4f} "
                     f"{dev_s / wall:7.1%} {len(ops):11d}")
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
