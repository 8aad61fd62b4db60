#!/usr/bin/env python3
"""bellman_ford_relax from other sources and node orders, timed in turns.

    python3 scripts/relax_variants.py [--variants repo,NAME=FILE,...]
        [--orders rcm,rows] [--rounds 3] [--side 240] [--out FILE]

Each variant is a source of the kernel's C entry point: `repo` is
csrc/bellman_ford_relax.cu, NAME=FILE another (an earlier design, say;
FILE relative to the repository).  One nvcc each, all started together,
into out/relax_variants/.  Each variant runs under each of --orders: the
warps take the nodes in FieldGraph's order (rcm) or in row order
(rows).  On chip_smoke's rgb_geo scene (stages 1-2 on the card, with the
default build) it takes the first level-0 pair batch and stage 3's first
contracted-graph batch
(chip_smoke.pair_batch_inputs, relax_graphs), checks each variant's delta
sweeps against the twins sweep by sweep over the level-0 batch
(chip_smoke.delta_lockstep), then times, in turns over `--rounds` rounds,
each variant's delta sweeps over both batches (the path's sweeps, CUDA
events, summed), its stateless sweep at level 0 with F = 256 and 37, and
the full-sweep loop over the level-0 batch; and each variant's device time
of every sweep of the level-0 batch (torch.profiler, the kernel's own
duration, free of the host's launch gaps).  Prints one JSON line a
variant (registers and spills from cuobjdump, the least time of each
measurement and all rounds) and the card's nvidia-smi line, and writes
them to --out (default out/relax_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(variants) -> dict:
    from sph_tpu_torch.ops import cuda_build
    out_dir = os.path.join(REPO, "out", "relax_variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for v in variants:
        name, src = (v.split("=", 1) if "=" in v else
                     (v, cuda_build.source("bellman_ford_relax")))
        path = os.path.join(out_dir, f"librelax_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", path,
             os.path.join(REPO, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        paths[key] = path
    return paths


def load(path: str):
    from sph_tpu_torch.ops import cuda_build
    lib = ctypes.CDLL(path)
    fn = lib.bellman_ford_relax_launch
    fn.restype = ctypes.c_int
    fn.argtypes = cuda_build._SIGNATURES["bellman_ford_relax"]
    return lib


def device_ms_by_sweep(sp, b, sweeps: int) -> list:
    """The kernel's device milliseconds in each of `sweeps` delta sweeps of
    the batch `b`, in launch order, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(sweeps):
            sp.relax_delta(b)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "relax_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in kern]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="repo")
    ap.add_argument("--orders", default="rcm,rows")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--side", type=int, default=240)
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "relax_variants.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("relax_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.ops import cuda_build
    from sph_tpu_torch.ops import shortest_path as sp
    from sph_tpu_torch.utils.logging import set_level
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")
    variants = args.variants.split(",")
    t = time.perf_counter()
    paths = build(variants)
    head = {"nvidia_smi": chip_smoke.nvidia_smi_line(),
            "build_seconds": time.perf_counter() - t}
    side = args.side
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.UNIFORM)
    ihs, lss, rws, nns = chip_smoke.rgb_geo_settings(T)
    ch = T.ComputeHierarchy(device="cuda").init(data, side, side, ihs=ihs,
                                                lss=lss, rws=rws, nns=nns)
    ch.compute_knn_graph()
    ch.compute_image_hierarchy()
    objects = {"graph": ch.image_hierarchy._graph,
               "hierarchy": ch.image_hierarchy.hierarchy, "data": data,
               "num_samples": ihs.num_geodesic_samples,
               "seed": rws.random_seed}
    g0, gc = chip_smoke.relax_graphs(objects)
    a, b = chip_smoke.neighbour_pairs(objects["hierarchy"], 0)
    _, samples, evaluate, _ = chip_smoke.pair_batch_inputs(
        g0, objects["graph"], a, b)
    batches = {"level_0_pair_batch": (g0, g0.init(samples), evaluate),
               "contracted_batch": (gc, gc.init(
                   np.arange(min(256, gc.n))[:, None]), None)}
    sweeps = {}
    for name, (g, d0, ev) in batches.items():
        bt = sp.RelaxBatch(g, d0.clone(), ev)
        sweeps[name] = bt.run(g.n)
    head["sweeps"] = sweeps
    starts = {f: chip_smoke.relax_start(g0, f, seed=1 + i)
              for i, f in enumerate((256, 37))}
    orders = {g: (g.order, torch.arange(g.n, dtype=torch.int32,
                                         device=g.order.device))
              for g in (g0, gc)}

    def use(path, order):
        cuda_build._libs["bellman_ford_relax"] = load(path)
        for g, (rcm, rows) in orders.items():
            g.order = rcm if order == "rcm" else rows

    head["order_seconds"] = {}
    for name, g in (("level_0", g0), ("contracted", gc)):
        deg = g.csr_off[1:] - g.csr_off[:-1]
        t = time.perf_counter()
        sp._locality_order(g.n, g.csr_src.cpu().numpy(),
                           g.csr_off.cpu().numpy())
        head["order_seconds"][name] = time.perf_counter() - t
        head[f"{name}_in_degree_max"] = int(deg.max())
    runs = [(v, o) for v in paths for o in args.orders.split(",")]
    rows = {}
    for key in runs:
        path = paths[key[0]]
        usage = subprocess.run(["cuobjdump", "--dump-resource-usage", path],
                               capture_output=True, text=True)
        use(path, key[1])
        g, d0, ev = batches["level_0_pair_batch"]
        c = chip_smoke.delta_lockstep(g, d0, ev, sweeps["level_0_pair_batch"])
        rows[key] = {"variant": key[0], "order": key[1],
                     "resource_usage": [line.strip() for line in
                                        usage.stdout.splitlines()
                                        if "REG" in line],
                     "sweeps_equal": c["sweeps_equal"],
                     "sweeps": c["sweeps"], "rounds": []}
        if c["sweeps_equal"] != c["sweeps"]:
            raise AssertionError(f"variant {key}: {c['first_unequal']}")
        rows[key]["device_ms_by_sweep"] = device_ms_by_sweep(
            sp, sp.RelaxBatch(g, d0.clone(), ev), sweeps["level_0_pair_batch"])
        rows[key]["device_ms"] = sum(rows[key]["device_ms_by_sweep"])
    for _ in range(args.rounds):
        for key in runs:
            use(paths[key[0]], key[1])
            r = {}
            for name, (g, d0, ev) in batches.items():
                ms = chip_smoke.delta_batch_ms(g, d0, ev, sweeps[name],
                                               rounds=1, twin=False)
                r[name] = ms["delta_ms"][0]
                if name == "level_0_pair_batch":
                    r["full_loop_ms"] = ms["full_loop_ms"][0]
            for f, d in starts.items():
                r[f"stateless_f{f}"] = chip_smoke.cuda_ms(
                    lambda d=d: sp.relax(d, g0), 10, warmup=2)
            rows[key]["rounds"].append(r)
    out = {"head": head, "variants": []}
    print(json.dumps(head), flush=True)
    for key, row in rows.items():
        row["least"] = {m: min(r[m] for r in row["rounds"])
                        for m in row["rounds"][0]}
        out["variants"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
