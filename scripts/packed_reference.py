#!/usr/bin/env python3
"""The JAX package's UMAP of the Pines level 1 on its defaults, on JAX-CPU.

    JAX_PLATFORMS=cpu python3 scripts/packed_reference.py [--out FILE]

The JAX package's defaults read UMAP's rows-tier positions from a u16
fixed-point table (SPH_UMAP_PACKED "1"), as the port now does by default.
This builds the Pines configuration of bench.py:89-136 with sph_tpu
(scripts/pines_umap_reference.py's pines_level1), embeds level 1 with
ComputeEmbedding.compute_umap for 500 epochs with every SPH_UMAP_* switch
unset, and scores the layout with chip_smoke.trustworthiness (k = 10,
against the components' mean spectra): the figure chip_smoke.py's phase
umap holds the port's packed default to.  Writes the record (default
docs/torch_port_packed_reference.json).  The full configuration: run it
where there are cores to spare (about 5 minutes on 8).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UMAP_SWITCHES = ("SPH_UMAP_PACKED", "SPH_UMAP_DENSE_MAX",
                 "SPH_UMAP_ROWS_WIDTH", "SPH_UMAP_NEG_BUDGET",
                 "SPH_UMAP_EDGE_PATH", "SPH_UMAP_DISPATCH_BUDGET")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_packed_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    import numpy as np
    import chip_smoke
    import sph_tpu as J
    from pines_umap_reference import pines_level1

    started = time.perf_counter()
    levels, p1, means = pines_level1()
    hierarchy_s = time.perf_counter() - started
    t = time.perf_counter()
    with chip_smoke.env(**{name: None for name in UMAP_SWITCHES}):
        es = J.ComputeEmbeddingSettings()
        es.umap.num_epochs = 500
        ce = J.ComputeEmbedding(es)
        emb = ce.compute_umap(p1)
    umap_s = time.perf_counter() - t
    record = {
        "what": "JAX package (sph_tpu) on the CPU on its defaults: the "
                "bench.py:89-136 Pines configuration "
                "(create_hyperspectral_scene(145, 145, 200, seed=7), "
                "Scaler.NONE, k=91, NEIGH_WALKS + MERGE_RW_ONLY, 50 walks x "
                "10 steps, seed 1), then ComputeEmbedding.compute_umap of "
                "level 1's P for 500 epochs with every SPH_UMAP_* switch "
                "unset (rows tier, u16-packed gathers, rows cut to 128 "
                "edges, 64 budgeted negatives a row); trustworthiness at "
                "k=10 of the layout against the level-1 components' mean "
                "spectra (chip_smoke.trustworthiness)",
        "script": "scripts/packed_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__,
        "levels": levels,
        "level_1_components": levels[1],
        "umap_epochs": 500,
        # above SPH_UMAP_DENSE_MAX (4096) points: the rows tier
        "umap_tier": "rows" if levels[1] > 4096 else "dense",
        "packed": True,
        "trustworthiness_k10": chip_smoke.trustworthiness(means, emb, 10),
        "finite": bool(np.all(np.isfinite(emb))),
        "seconds": {"hierarchy": hierarchy_s, "umap": umap_s},
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
