#!/usr/bin/env python3
"""Quality of the port's grid t-SNE tier against its exact tier, on one card.

    python3 scripts/grid_quality_torch.py [--rows 256] [--cols 256]
                                          [--iters 1000] [--out FILE]

chip_smoke.py's phase grid_vs_exact with its parts taken apart: the 1M
recipe at rows x cols x 100 (exact kNN, k = 16, perplexity 5), then
`iters` iterations through ComputeEmbedding in these variants, each scored
under the exact tier's P with the exact Z (tsne_repulsion):

- exact: the exact tier (SPH_TSNE_GRID=0);
- exact_init_1e-6: the same from the initial layout scaled by 1 + 1e-6,
  the run-to-run spread of the objective under a tiny change;
- grid: the grid tier on its defaults (P cut to 64 entries a row);
- grid_init_1e-6: the same from the scaled layout;
- grid_p_uncut: the grid tier on the exact tier's P (SPH_TSNE_GRID_P_WIDTH=0);
- grid_h_half: the grid tier with half the node spacing (twice the nodes,
  up to 2048), P uncut.

Prints one JSON line per variant and a summary line; --out writes them too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=256)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grid_quality_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import sph_tpu_torch as T
    from sph_tpu_torch.models import tsne as ttsne
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    from sph_tpu_torch.ops.math import random_disk_init
    from sph_tpu_torch.ops.tsne_grid import pick_grid_size
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")

    graph = chip_smoke.scene_graph(args.rows, args.cols)
    n = graph["idx"].shape[0]
    init = random_disk_init(n, 0.1, 0)
    unset = {name: None for name in chip_smoke.TSNE_SWITCHES}
    variants = (
        ("exact", {"SPH_TSNE_GRID": "0", "SPH_TSNE_DENSE_P": "0"}, 1.0, None),
        ("exact_init_1e-6", {"SPH_TSNE_GRID": "0", "SPH_TSNE_DENSE_P": "0"},
         1.0 + 1e-6, None),
        ("grid", {"SPH_TSNE_GRID": "1"}, 1.0, None),
        ("grid_init_1e-6", {"SPH_TSNE_GRID": "1"}, 1.0 + 1e-6, None),
        ("grid_p_uncut", {"SPH_TSNE_GRID": "1",
                          "SPH_TSNE_GRID_P_WIDTH": "0"}, 1.0, None),
        ("grid_h_half", {"SPH_TSNE_GRID": "1", "SPH_TSNE_GRID_P_WIDTH": "0",
                         "SPH_TSNE_GRID_MAX": "2048"}, 1.0, 0.175))
    runs, lines = {}, [chip_smoke.nvidia_smi_line()]
    picker = ttsne.pick_grid_size
    for name, switches, scale, target_h in variants:
        if target_h is not None:
            ttsne.pick_grid_size = (lambda span, max_g=1024: pick_grid_size(
                span, target_h=target_h, max_g=max_g))
        ce = T.ComputeEmbedding(chip_smoke.tsne_settings(args.iters, 16),
                                device="cuda")
        ce.init_embedding(n, init * scale)
        t = time.perf_counter()
        with chip_smoke.env(**{**unset, **switches}):
            ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ttsne.pick_grid_size = picker
        comp = ce.last_computation
        row = {"variant": name, "n": n, "iterations": args.iters,
               "tier": comp.tier, "p_width": comp._p_val.shape[1],
               "seconds": wall, "kl_own": float(ce.last_kl)}
        if comp.tier == "grid":
            row["grid_sizes"] = chip_smoke.grid_sizes(comp.grid_history)
        runs[name] = (comp, row)
    exact = runs["exact"][0]
    for name, (comp, row) in runs.items():
        row["kl_scored"] = float(tsne_kl_divergence(
            comp._y, exact._p_idx, exact._p_val, exact._n))
    base = runs["exact"][1]["kl_scored"]
    for name, (comp, row) in runs.items():
        row["ratio_to_exact"] = row["kl_scored"] / base
        lines.append(json.dumps(row))
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
