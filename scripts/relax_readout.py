#!/usr/bin/env python3
"""bellman_ford_relax on the card at rgb_geo's level-0 field graph.

    python3 scripts/relax_readout.py [--side 240] [--fields 256,37]
        [--calls 50] [--out FILE]

Builds the kernel (csrc/bellman_ford_relax.cu), runs stage 1 of chip_smoke's
rgb_geo recipe (create_hyperspectral_scene(side, side, 3, seed=13),
configs/rgb_bus_geo.json's kNN graph) on the card, and at its level-0
FieldGraph, for each field count, holds the kernel against the twin from a
start relaxed 10 sweeps (chip_smoke.check_relax_kernel: d' and the frontier
equal, ms a call of both from CUDA events, the bytes bound, the gathered
bytes' rate); prints one JSON line per field count, the nvcc resource
usage (registers, spills) and the card's nvidia-smi line, and writes them
to --out (default chiprun_out/relax_readout.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=240)
    ap.add_argument("--fields", default="256,37")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "relax_readout.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("relax_readout: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.ops import cuda_build
    from sph_tpu_torch.ops import shortest_path as sp
    from sph_tpu_torch.utils.logging import set_level
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")
    out = {"nvidia_smi": chip_smoke.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0)}
    t = time.perf_counter()
    so = cuda_build.build("bellman_ford_relax")["bellman_ford_relax"]
    out["build_seconds"] = time.perf_counter() - t
    usage = subprocess.run(["cuobjdump", "--dump-resource-usage", so],
                           capture_output=True, text=True)
    out["resource_usage"] = [line.strip() for line in usage.stdout.splitlines()
                             if "REG" in line]
    side = args.side
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.UNIFORM)
    ihs, lss, rws, nns = chip_smoke.rgb_geo_settings(T)
    ch = T.ComputeHierarchy(device="cuda").init(data, side, side, ihs=ihs,
                                                lss=lss, rws=rws, nns=nns)
    t = time.perf_counter()
    ch.compute_knn_graph()
    out["stage1_seconds"] = time.perf_counter() - t
    st = ch.knn_stage          # the data graph, as stage 2 selects it
    graph = (st.connected_graph if nns.neighbor_connect_components
             else st.sym_graph if nns.symmetric_neighbors else st.knn_graph)
    g = sp.FieldGraph.from_graph(graph, "cuda")
    deg = (g.csr_off[1:] - g.csr_off[:-1]).cpu()
    out["graph"] = {"n": g.n, "edges": int(g.csr_src.numel()),
                    "in_degree_mean": float(deg.float().mean()),
                    "in_degree_max": int(deg.max())}
    out["checks"] = []
    for i, f in enumerate(int(v) for v in args.fields.split(",")):
        c = chip_smoke.check_relax_kernel(
            g, chip_smoke.relax_start(g, f, seed=1 + i),
            f"rgb_geo_level_0_f{f}", calls=args.calls)
        out["checks"].append(c)
        print(json.dumps(c), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "checks"}),
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
