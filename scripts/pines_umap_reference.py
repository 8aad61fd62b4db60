#!/usr/bin/env python3
"""The JAX package's UMAP of the Pines hierarchy's level 1, on JAX-CPU.

    JAX_PLATFORMS=cpu python3 scripts/pines_umap_reference.py [--out FILE]

Builds the Pines configuration of bench.py:89-136 (145x145x200,
create_hyperspectral_scene(seed=7), Scaler.NONE, k = 91, NEIGH_WALKS with
MERGE_RW_ONLY, 50 walks x 10 steps) with sph_tpu, embeds level 1 with
ComputeEmbedding.compute_umap for 500 epochs, and scores the layout with
chip_smoke.trustworthiness (k = 10, against the components' mean spectra),
the figure chip_smoke.py's phase umap holds the port to.  Three runs of the
rows tier: the JAX defaults (u16-packed gathers, rows cut to 128 edges, 64
budgeted negatives a row); float32 gathers (SPH_UMAP_PACKED=0, what the
port does); and float32 gathers with neither the cut nor the budget
(SPH_UMAP_ROWS_WIDTH=0, SPH_UMAP_NEG_BUDGET=0).  Writes the record
(default docs/torch_port_pines_umap_reference.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_pines_umap_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    import chip_smoke
    import sph_tpu as J
    from sph_tpu.utils.testdata import create_hyperspectral_scene

    img = create_hyperspectral_scene(145, 145, 200, seed=7)
    data = J.scale(J.ImageStack.from_array(img, name="pines_synth").data,
                   J.Scaler.NONE)
    k = 91
    ch = J.ComputeHierarchy().init(
        data, 145, 145,
        ihs=J.ImageHierarchySettings(
            component_sim=J.ComponentSim.NEIGH_WALKS,
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_num_comp=1, min_reduction=98.0, max_levels=10,
            rw_handling=J.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=J.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
            norm_knn_distances=J.NormalizationScheme.TSNE),
        lss=J.LevelSimilaritiesSettings(
            component_sim=J.ComponentSim.NEIGH_WALKS, ks=[k],
            random_walk_pair_sims=True,
            normalize_prob_dist=J.NormalizationScheme.TSNE,
            compute_symmetric_prob_dist=J.NormalizationScheme.TSNE),
        rws=J.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=J.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=J.NearestNeighborsSettings(
            num_nearest_neighbors=k, symmetric_neighbors=True,
            compute_connect_components=True,
            neighbor_connect_components=True)).compute()
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    means = chip_smoke.component_means(np.asarray(data), h.pixel_components[1],
                                       levels[1])
    p1 = ch.level_similarities.get_prob_dist(1)

    runs = {}
    for name, env in (("defaults", {}),
                      ("unpacked", {"SPH_UMAP_PACKED": "0"}),
                      ("unpacked_uncut_per_slot", {
                          "SPH_UMAP_PACKED": "0", "SPH_UMAP_ROWS_WIDTH": "0",
                          "SPH_UMAP_NEG_BUDGET": "0"})):
        with chip_smoke.env(**env):
            es = J.ComputeEmbeddingSettings()
            es.umap.num_epochs = 500
            emb = J.ComputeEmbedding(es).compute_umap(p1)
        runs[name] = {"trustworthiness_k10": chip_smoke.trustworthiness(
            means, emb, 10), "finite": bool(np.all(np.isfinite(emb)))}
        print(name, json.dumps(runs[name]), flush=True)

    record = {
        "what": "JAX package (sph_tpu) on the CPU: the bench.py:89-136 Pines "
                "configuration (create_hyperspectral_scene(145, 145, 200, "
                "seed=7), Scaler.NONE, k=91, NEIGH_WALKS + MERGE_RW_ONLY, "
                "50 walks x 10 steps, seed 1), then "
                "ComputeEmbedding.compute_umap of level 1's P for 500 epochs "
                "(rows tier); trustworthiness at k=10 of the layout against "
                "the level-1 components' mean spectra "
                "(chip_smoke.trustworthiness)",
        "script": "scripts/pines_umap_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__,
        "levels": levels,
        "level_1_components": levels[1],
        "umap_epochs": 500,
        "trustworthiness_k10": runs["defaults"]["trustworthiness_k10"],
        "runs": runs,
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
