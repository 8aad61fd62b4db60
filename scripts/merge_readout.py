#!/usr/bin/env python3
"""The hierarchy's merges and stage 1's symmetrization on both paths, in
turns, with the phase timers on.

    python3 scripts/merge_readout.py [--device cuda|cpu] [--turns 4]
        [--pines-shape 145 145 200] [--salinas-shape 512 217 224]
        [--no-salinas] [--out FILE]
    python3 scripts/merge_readout.py --split [--repo DIR] [--calls 5]
        [--windows 4096 8192 16384 32768] ...

Runs stages 1 and 2 of the Pines configuration (chip_smoke.pines_hierarchy:
bench.py:89-136, NEIGH_WALKS with MERGE_RW_ONLY) --turns times, the host
path (rows downloaded, the C++ merge, numpy's normalization, the upload;
native.symmetrize: the port's path before its merges moved to the card)
and the device path (ops/device_merge.py, the kernel merge_runs) in turns
(host, device, device, host, ...); a turn picks its path by setting the
port's one switch between them, ``device_merge.on_card``, to answer False
(host) or True (device) for its run.  Then the Salinas-shaped NEIGH_WALKS
scene of chip_smoke.salinas_walks (MERGE_RW_ONLY) once on each path (device,
host).  Each turn prints the stage walls, the seconds of the phases
nn.symmetrize, h.merge_walks, h.merge_walks.merge and h.merge_walks.norm
(SPH_PHASE_TIMERS=1; the merge and norm phases synchronise the card at
both ends), merge_runs' launches and the levels.  Every turn's levels and
walk rows must equal the first turn's bit for bit.  Prints one JSON line
per turn and the card's nvidia-smi line, and writes them to --out (default
out/merge_readout.json).  --device cpu rehearses it (the device path's
twins) at a small shape.

--split times one merge by part instead: the Pines level-0 -> 1 walk-row
merge and the Salinas scene's widest (stages 1 and 2 run once on the
device path, their merges recorded with chip_smoke.merge_record), each
part between CUDA events over --calls merges (``cuda_ms``: the device
timeline between the part's ends, no synchronisation added) and again
with the card synchronised at every part's end (``host_ms``, the host
clock; chip_smoke.merge_split).  --repo DIR imports the port from another
tree (a ``git archive`` of an older commit): the split follows the merge
that tree has, chip_smoke.merge_by_part (the kernel over the children's
rows) or ``split_sorted`` (the parent ranges, the sort of the entries and
the kernel over their runs).  With --windows the kernel is timed at each
width of its column window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("nn.symmetrize", "h.merge_walks", "h.merge_walks.merge",
          "h.merge_walks.norm")


def turn(cs, build, path: str, device: str) -> tuple:
    """Stages 1 and 2 of build() on `path` ("host" or "device") with the
    phase timers on: (the turn's line, its walk rows on the CPU)."""
    import torch
    from sph_tpu_torch.ops import device_merge
    from sph_tpu_torch.utils.timer import phase_totals
    on_card = device_merge.on_card
    device_merge.on_card = lambda _device: path == "device"
    try:
        with cs.env(SPH_PHASE_TIMERS="1"):
            phase_totals(reset=True)
            device_merge.merge_runs.launches = 0
            ch = build()
            seconds = {}
            for name, stage in (
                    ("stage1_knn", ch.compute_knn_graph),
                    ("stage2_hierarchy", ch.compute_image_hierarchy)):
                t = time.perf_counter()
                stage()
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t
            totals = phase_totals(reset=True)
    finally:
        device_merge.on_card = on_card
    h = ch.image_hierarchy.hierarchy
    walks = [(w.idx.cpu(), w.val.cpu()) for w in h.random_walks]
    line = {"path": path, "seconds": seconds,
            "phases": {name: totals.get(name, 0.0) for name in PHASES},
            "merge_runs_launches": device_merge.merge_runs.launches,
            "levels": [int(c) for c in h.num_components]}
    return line, walks


def split_sorted(inputs, mark):
    """The device merge of parent ranges and sorted entries, step by step
    as an older tree's merge_kernel_inputs,
    merge_by_parents_device and normalize_merged_device take it, with
    mark(part) at each part's end; returns the merged (and normalized)
    rows."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops import device_merge as dm
    from sph_tpu_torch.ops import sparse as sp
    sr, parents, num_merged, wbs, combine, cap = inputs
    mark(None)
    dev, n = sr.device, sr.num_rows
    parents = np.asarray(parents, dtype=np.int64)
    live = (sr.idx >= 0) & (sr.val != 0)
    if n and bool((live & (sr.idx >= n)).any()):
        raise ValueError("a column outside the domain")
    par = torch.as_tensor(parents, device=dev)
    weighted = combine == "sum" and wbs
    nnz = live.sum(1)
    weight = nnz.to(torch.float32)
    order = torch.sort(par, stable=True).indices
    child_start = torch.zeros(num_merged + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(par, minlength=num_merged), 0,
                 out=child_start[1:])
    mark("live_weights_order")
    par_cost = torch.zeros(num_merged, dtype=torch.int64, device=dev)
    par_cost.index_add_(0, par, nnz * dm._BYTES_PER_ENTRY
                        + sr.width * dm._BYTES_PER_SLOT)
    cs = child_start.cpu().numpy()
    ranges = dm._parent_ranges(par_cost, dm.MERGE_MEMORY_BUDGET)
    mark("ranges_syncs")
    got = []
    for p0, p1 in ranges:
        rows = order[int(cs[p0]):int(cs[p1])]
        idx_c, live_c = sr.idx[rows], live[rows]
        child = rows[:, None].expand_as(idx_c)[live_c]
        v = sr.val[rows][live_c]
        if weighted:
            v = v * weight[child]
        key = par[child] * num_merged + par[idx_c[live_c]]
        del idx_c, live_c
        mark("gathers_keys")
        key, perm = torch.sort(key, stable=True)
        v = v[perm]
        del perm, child
        mark("sort_perm")
        first = torch.ones(key.numel(), dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        run_start = torch.cat([
            torch.nonzero(first).flatten(),
            torch.tensor([key.numel()], dtype=torch.int64, device=dev)])
        del first
        mark("flags_nonzero")
        extra = {}
        if weighted:
            extra = {"child_w": weight[rows],
                     "parent_start": (child_start[p0:p1 + 1]
                                      - child_start[p0]),
                     "parent0": p0}
        got.append(dm.merge_runs(key, v, run_start, num_merged, combine,
                                 **extra)[:3])
        mark("merge_runs")
    out = sp.pack_coo(torch.cat([g[0] for g in got]),
                      torch.cat([g[1] for g in got]),
                      torch.cat([g[2] for g in got]), num_merged,
                      num_merged, cap, largest=combine == "sum")
    mark("pack_coo")
    if combine == "sum":
        out = sp.normalize_merged_device(out)
        mark("normalize")
    return out


def kernel_ms(fn, calls: int) -> dict:
    """Device milliseconds a call of each CUDA kernel `fn` launches
    (torch.profiler over `calls` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0.0)
        if total:
            out[e.key[:60]] = total / calls / 1e3
    return out or {"all": "not measured"}


def windows(cs, dm, inputs, args) -> list:
    """merge_runs at each --windows width (columns a block holds): its ms
    (CUDA events, the wrapper), the fold launch's ms, its kernels' device
    ms (torch.profiler) and the windows its blocks took, in turns (the
    list, then the list reversed)."""
    sr, parents, num_merged, wbs, combine, _ = inputs
    kw = dm.merge_kernel_inputs(sr, parents, num_merged, wbs, combine)
    out = []
    for w in args.windows + args.windows[::-1]:
        dm.merge_runs(**kw, window=w)
        out.append({"window": w, "windows_taken": dm.merge_runs.windows,
                    "ms": cs.cuda_ms(lambda: dm.merge_runs(**kw, window=w),
                                     args.calls * 4, warmup=2),
                    "fold_ms": cs.cuda_ms(lambda: dm._merge_fold(
                        **kw, window=w), args.calls * 4, warmup=2),
                    "kernels_ms": kernel_ms(lambda: dm.merge_runs(
                        **kw, window=w), args.calls)})
    return out


def split_scenes(cs, args, pines, salinas) -> list:
    """Stages 1 and 2 of each scene on the device path, its merges
    recorded; the split of its picked merge."""
    import torch
    from sph_tpu_torch.ops import device_merge as dm
    out = []
    scenes = [("pines_level_0_to_1", pines, "first")]
    if not args.no_salinas:
        scenes.append(("salinas_walks_widest", salinas, "widest"))
    on_card = dm.on_card
    for name, build, pick in scenes:
        keep = {}
        # the CPU rehearsal takes the device path on CPU tensors
        dm.on_card = lambda _device: True
        try:
            with cs.merge_record(keep):
                ch = build()
                ch.compute_knn_graph()
                ch.compute_image_hierarchy()
        finally:
            dm.on_card = on_card
        cs.sync()
        cs.merge_summary(keep, pick)
        inputs = keep.pop("inputs")
        sr = inputs[0]
        line = {"row": "split", "scene": name, "rows": sr.num_rows,
                "width": sr.width, "num_merged": inputs[2],
                "combine": inputs[4], "entries": keep["entries"]}
        del ch, keep
        older = hasattr(dm, "_parent_ranges")    # a tree of sorted entries
        line.update(cs.merge_split(inputs, name, args.calls,
                                   split_sorted if older else None))
        if args.device == "cuda" and not older:
            line["by_window"] = windows(cs, dm, inputs, args)
        out.append(line)
        del inputs, sr
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return out


def same_walks(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        torch.equal(ia, ib) and torch.equal(va.view(torch.int32),
                                            vb.view(torch.int32))
        for (ia, va), (ib, vb) in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--pines-shape", type=int, nargs=3, default=[145, 145,
                                                                 200])
    ap.add_argument("--salinas-shape", type=int, nargs=3,
                    default=[512, 217, 224])
    ap.add_argument("--no-salinas", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="time one merge of each scene by part")
    ap.add_argument("--repo", default=REPO,
                    help="the tree whose port and chip_smoke.py to import")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--windows", type=int, nargs="*", default=[],
                    help="with --split on the card: merge_runs' ms at each "
                         "window of columns")
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "merge_readout.json"))
    args = ap.parse_args()

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("merge_readout: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 2
    import sph_tpu_torch as T
    from sph_tpu_torch.ops import cuda_build
    from sph_tpu_torch.utils.logging import set_level
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")
    cs.DEV = args.device
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    if args.device == "cuda":
        t = time.perf_counter()
        cuda_build.build("merge_runs", "walk_row_sort")
        emit({"row": "build", "seconds": time.perf_counter() - t})

    def pines():
        return cs.pines_hierarchy(args.device, tuple(args.pines_shape))[0]

    def salinas():
        rows, cols, bands = args.salinas_shape
        img = create_hyperspectral_scene(rows, cols, bands, seed=13)
        data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.NONE)
        ihs, lss, rws, nns = cs.salinas_walks_settings(T, "merge_rw_only")
        return T.ComputeHierarchy(device=args.device).init(
            data, rows, cols, ihs=ihs, lss=lss, rws=rws, nns=nns)

    if args.split:
        for line in split_scenes(cs, args, pines, salinas):
            emit({**line, "repo": args.repo})
        if args.device == "cuda":
            emit({"row": "device", "name": torch.cuda.get_device_name(0),
                  "nvidia_smi": cs.nvidia_smi_line()})
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
        return 0 if all(x.get("equal_to_the_merge", True)
                        for x in lines) else 1

    paths = [("host", "device")[(i + 1) // 2 % 2] for i in range(args.turns)]
    scenes = [("pines", pines, paths)]
    if not args.no_salinas:
        scenes.append(("salinas_walks_rw_only", salinas, ["device", "host"]))
    ok = True
    for name, build, order in scenes:
        first = None
        for i, path in enumerate(order):
            line, walks = turn(cs, build, path, args.device)
            if first is None:
                first = (line["levels"], walks)
            line["equal_to_first_turn"] = (line["levels"] == first[0]
                                           and same_walks(walks, first[1]))
            ok &= line["equal_to_first_turn"]
            emit({"row": "turn", "scene": name, "turn": i, **line})
            del walks
    if args.device == "cuda":
        emit({"row": "device", "name": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi_line()})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    if not ok:
        print("merge_readout: a turn's levels or walk rows differ from the "
              "first turn's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
