#!/usr/bin/env python3
"""The spread of the UMAP edge tier's trustworthiness against its
sequential oracle, seed by seed: what chip_smoke.py's ``sharded`` gate
(``edge_oracle_gate``) is set from.

    python3 scripts/umap_edge_spread.py [--seeds 32] [--epochs 100]
        [--device cpu] [--out FILE]

On the gate's scene (chip_smoke.seed_scene: create_hyperspectral_scene(32,
32, 8, seed=7), the Pines recipe at k = 31) it takes level 1's memberships
by both fuzzy unions (the host union, which the phase uses, and the JAX
package's device path) and, for seeds 0 .. --seeds - 1, runs the edge-list
tier and native.umap_sequential from the same layout
(chip_smoke.edge_oracle_ratios).  Writes one JSON object (default
docs/torch_port_umap_edge_spread.json): each union's ratios, their mean,
least and greatest, and how many fall below 0.99.
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
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_umap_edge_spread.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")
    chip_smoke.DEV = args.device
    if args.device == "cpu":
        torch.set_num_threads(min(torch.get_num_threads(), 4))
    t0 = time.perf_counter()
    scene = chip_smoke.seed_scene(args.device)
    x = chip_smoke.scene_means(scene)
    out = {"device": args.device, "scene": list(chip_smoke.SEED_SCENE),
           "k": chip_smoke.SEED_SCENE_K, "epochs": args.epochs,
           "n": int(scene["count"]), "unions": {}}
    for union, device_path in (("host", False), ("device", True)):
        t = time.perf_counter()
        m = chip_smoke.scene_memberships(scene, device_path=device_path)
        r = chip_smoke.edge_oracle_ratios(m, x, range(args.seeds),
                                          args.epochs)
        q = np.asarray(r["ratios"])
        r.update(max_ratio=float(q.max()),
                 below_0_99=int((q < 0.99).sum()),
                 memberships=int((m.indices >= 0).sum()),
                 seconds=time.perf_counter() - t)
        out["unions"][union] = r
        print(union, json.dumps({k: r[k] for k in (
            "mean_ratio", "min_ratio", "max_ratio", "below_0_99",
            "seconds")}), flush=True)
    out["seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
