#!/usr/bin/env python3
"""Time the grid tier's deposit and interpolation at the 1M t-SNE's layouts
on one CUDA card, host and device apart.

    python3 scripts/grid_interpolate_readout.py [--repo DIR] [--layout FILE]
        [--calls 200] [--out FILE]

The layouts are those of BASELINE config 4 (the 1000 x 1000 synthetic
scene's exact kNN graph, t-SNE on the default grid tier through
chip_smoke.grid_path at chip_smoke.GRID_ITERS): the final one on its grid
and the one after iteration GRID_LAYOUT_AT on its grid.  They are made and
saved to --layout (default out/grid_layouts_1m.npz) when that file is
missing, else loaded, so that several trees are timed on the same points.

--repo DIR imports the port from another tree (a ``git archive`` of an
older commit unpacked there); this checkout's chip_smoke gives the
helpers.  At each layout, for that tree's grid_deposit and
grid_interpolate:

- ``wrapper_ms``: CUDA events around --calls back-to-back calls of the
  wrapper as the step calls it (its host work included: where the host is
  slower than the card, this is the host's time): the deposit, its order
  passes alone where the tree has them, the interpolation in index order
  and, where the tree's wrapper takes one, in the deposit's order;
- ``device_ms``: the card's time a call of each kernel that the wrapper
  launches (the deposit's passes, the interpolation's node-major copy where
  there is one, interpolate_points, phi_z's sum), from torch.profiler over
  --calls calls.  The profiler runs after every event timing of the run,
  since a profiler session can slow the launches that follow it.

Every interpolation is first checked bit-equal to
grid_interpolate_reference, and the deposit to grid_deposit_reference.
Prints one JSON line a layout and the card's nvidia-smi line; appends them
to --out (default out/grid_interpolate_readout.jsonl).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (this checkout's; the port comes later)


def make_layouts(path: str) -> None:
    """The 1M run's final layout and its iteration-GRID_LAYOUT_AT layout,
    each with its n and grid, saved to `path`."""
    import numpy as np
    from sph_tpu_torch.ops import tsne_kernels
    graph = chip_smoke.scene_graph(1000, 1000)
    run = chip_smoke.grid_path(tsne_kernels, graph, chip_smoke.GRID_ITERS,
                               chip_smoke.GRID_KL_AT)
    comp, kept = run["ce"].last_computation, run["kept_layout"]
    np.savez(path, final=comp._y.cpu().numpy(), final_grid=comp._grid,
             kept=kept["y"].cpu().numpy(), kept_grid=kept["grid"],
             n=comp._n)


def kernel_device_ms(prof, calls: int) -> dict:
    """Device milliseconds a call of each CUDA kernel the profiler saw."""
    out = {}
    for event in prof.key_averages():
        if event.device_type.name != "CUDA":
            continue
        us = (getattr(event, "device_time_total", None)
              or getattr(event, "cuda_time_total", 0.0))
        out[event.key[:80]] = out.get(event.key[:80], 0.0) + us / calls / 1e3
    return out


def time_layout(y, n: int, grid: int, calls: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sph_tpu_torch.ops import tsne_grid as G
    lo, h = G.grid_box(y, n, grid)
    yv = y[:n]
    has_ws = hasattr(G, "GridWorkspace")
    ws = G.GridWorkspace(y.device) if has_ws else None
    deposit_args = (yv, lo, h, grid) + ((ws,) if has_ws else ())
    charges = G.grid_deposit(*deposit_args)
    if not torch.equal(charges, G.grid_deposit_reference(yv, lo, h, grid)):
        raise AssertionError("grid_deposit differs from its twin")
    fields = G.field_grids(charges, h, grid)
    ref = G.grid_interpolate_reference(fields, y, n, lo, h)
    calls_of = {"deposit": lambda: G.grid_deposit(*deposit_args),
                "interpolation_index_order": lambda: G.grid_interpolate(
                    fields, y, n, lo, h)}
    if has_ws and hasattr(ws, "order_passes"):
        calls_of["deposit_order_passes"] = lambda: ws.order_passes(
            yv, lo, h, grid)
    if "order" in inspect.signature(G.grid_interpolate).parameters:
        G.grid_deposit(*deposit_args)
        order = ws.order.clone()
        calls_of["interpolation_deposit_order"] = lambda: G.grid_interpolate(
            fields, y, n, lo, h, order)
    for name, fn in calls_of.items():
        if name.startswith("interpolation") and not all(
                torch.equal(a, b) for a, b in zip(fn(), ref)):
            raise AssertionError(f"{name} differs from its twin")
    row = {"n": n, "grid": grid,
           "points_in_fullest_cell": chip_smoke.fullest_cell(y, n, grid),
           "wrapper_ms": {name: chip_smoke.cuda_ms(fn, calls, 10)
                          for name, fn in calls_of.items()},
           "device_ms": {}}
    for name, fn in calls_of.items():        # the profiler last
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = kernel_device_ms(prof, calls)
        row["device_ms"][name] = {"total": sum(kernels.values()),
                                  "kernels": kernels}
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--layout", default=os.path.join(
        REPO, "out", "grid_layouts_1m.npz"))
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "grid_interpolate_readout.jsonl"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("grid_interpolate_readout: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    os.makedirs(os.path.dirname(os.path.abspath(args.layout)), exist_ok=True)
    if not os.path.exists(args.layout):
        make_layouts(args.layout)
    saved = np.load(args.layout)
    lines = [json.dumps({"nvidia_smi": chip_smoke.nvidia_smi_line(),
                         "repo": args.repo, "calls": args.calls})]
    print(lines[-1], flush=True)
    n = int(saved["n"])
    for label in ("final", "kept"):
        y = torch.from_numpy(saved[label]).cuda()
        row = {"layout": label, "repo": args.repo,
               **time_layout(y, n, int(saved[f"{label}_grid"]), args.calls)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
