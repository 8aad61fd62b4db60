#!/usr/bin/env python3
"""walk_row_sort on the card against its twin, and the walk rows it feeds.

    python3 scripts/walk_sort_readout.py [--rows 21025] [--cols 500]
        [--repeats 5] [--out FILE]

Builds the kernel (csrc/walk_row_sort.cu) and the twin (native/
xla_sort.cpp), then holds the kernel's order and sorted keys against the
twin (chip_smoke.check_walk_sort: every row equal; the kernel's mean ms over
--repeats calls by CUDA events, the twin's ms on the host, the
16-byte-an-entry bound, torch.sort(stable=True)'s ms on the same keys) on:
the synthetic rows of each kernel path at its limits and one key past
(all equal, sorted, reverse-sorted, McIlroy's median-of-3 adversary; 500,
2048, 2049, 4096, 16384 and 16385 keys), walk-like rows of --rows x --cols
keys (each row's ids near its own, heavy repeats), 64 explorer-wide rows
of 50000 keys and the explorer's widest answer at the Pines level 1 (5358
rows of 50000 keys, 256 sampled rows held against the twin).  Then ops.walks.accumulate on
the card against the CPU (ids and values bit-equal) for LINEAR and NORMAL
on a walk-like visit record of 2000 start points, 50 walks of 10 steps,
full and top-k rows.  Prints one JSON line per row and the card's
nvidia-smi line, and writes them to --out (default
out/walk_sort_readout.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=21025)
    ap.add_argument("--cols", type=int, default=500)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "walk_sort_readout.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("walk_sort_readout: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sph_tpu_torch import native
    from sph_tpu_torch.ops import cuda_build, walk_sort, walks

    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    t = time.perf_counter()
    cuda_build.build("walk_row_sort")
    native.xla_sort_order(np.zeros((1, 1), np.int32))
    emit({"row": "build", "seconds": time.perf_counter() - t})
    cases = [(cs.walk_sort_synthetic(walk_sort, c), f"synthetic_{c}", 0)
             for c in (500, walk_sort.WARP_COLS, walk_sort.WARP_COLS + 1,
                       4096, walk_sort.STAGE_COLS, walk_sort.STAGE_COLS + 1)]
    cases += [
        (cs.walk_like_rows(args.rows, args.cols),
         f"walk_like_{args.rows}x{args.cols}", 0),
        (cs.walk_like_rows(*cs.WALK_SORT_WIDE), "explorer_wide", 0),
        (cs.walk_like_rows(*cs.WALK_SORT_EXPLORER), "explorer_widest",
         cs.WALK_SORT_SAMPLED)]
    for keys, label, sample in cases:
        reps = 2 if keys.shape[1] > 10000 else args.repeats
        emit({"row": "kernel_vs_twin",
              **cs.check_walk_sort(walk_sort, native, keys, label, reps,
                                   sample)})
        del keys

    rng = np.random.default_rng(7)
    c, w, length = 2000, 50, 10
    start = np.repeat(np.arange(c), w)
    steps = rng.integers(-3, 4, (length, c * w)).cumsum(0)
    visited = torch.from_numpy(np.clip(start[None, :] + steps, 0, c - 1))
    for weighting in ("linear", "normal"):
        for width in (w * length, 200):
            before = walk_sort.xla_sort_order.launches
            ig, vg = walks.accumulate(visited.cuda(), w, length, weighting,
                                      width)
            launches = walk_sort.xla_sort_order.launches - before
            ic, vc = walks.accumulate(visited, w, length, weighting, width)
            same = (torch.equal(ig.cpu(), ic) and torch.equal(
                vg.cpu().view(torch.int32), vc.view(torch.int32)))
            emit({"row": "accumulate_card_vs_cpu", "weighting": weighting,
                  "shape": [c, w, length], "out_width": width,
                  "bit_equal": same, "launches": launches})
            if not same or launches != 1:
                raise AssertionError(f"accumulate {weighting} {width}: "
                                     f"equal {same}, launches {launches}")
    smi = cs.nvidia_smi_line()
    emit({"row": "device", "nvidia_smi": smi})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
