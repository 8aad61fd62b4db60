#!/usr/bin/env python3
"""The hierarchy's merges and stage 1's symmetrization on both paths, in
turns, with the phase timers on.

    python3 scripts/merge_readout.py [--device cuda|cpu] [--turns 4]
        [--pines-shape 145 145 200] [--salinas-shape 512 217 224]
        [--no-salinas] [--out FILE]

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
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "merge_readout.json"))
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("merge_readout: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
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
