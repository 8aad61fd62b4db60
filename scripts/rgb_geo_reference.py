#!/usr/bin/env python3
"""The JAX package's GEO_CENTROID and GEO_WALKS hierarchies on a 96x80 RGB
scene, on JAX-CPU: the record chip_smoke.py's sub-phase rgb_geo_record
holds the port to.

    JAX_PLATFORMS=cpu python3 scripts/rgb_geo_reference.py
        [--shape ROWS COLS] [--out FILE]

The scene is create_hyperspectral_scene(96, 80, 3, seed=13) (the shape of
the JAX package's own geodesic validation scene, docs/
geo_salinas_validation.json, at 3 channels), Scaler.UNIFORM; the settings
are chip_smoke.rgb_geo_settings's (configs/rgb_bus_geo.json through
run_evaluation.py's wiring), shared with the card's phase.
SPH_CONTRACT_THRESHOLD is 512 here (set before the JAX package is
imported; the card sets the port's to the same), so level 1, with about
1900 components, takes the sketch in stage 2 and, for GEO_CENTROID, the
contracted component graph in stage 3: every GEO branch of the full-size
run is in the record.

Records, for each similarity (chip_smoke.geo_record_run): the levels; for
levels 1 and 2 of GEO_CENTROID, stage 3's kNN ids on 64 rows drawn with
np.random.default_rng(1) (GEO_WALKS levels take their P from the walks
and have no kNN); for level 1, the sketch Hausdorff of 200
spatial-neighbour component pairs drawn with np.random.default_rng(2),
with the sampled pixels of both sides, so the card can query its own
sketch with the same pixels; and the seconds of each stage.  Writes
docs/torch_port_rgb_geo_reference.json by default.
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
    ap.add_argument("--shape", type=int, nargs=2, default=None,
                    help="another scene size, for a rehearsal")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_rgb_geo_reference.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["SPH_CONTRACT_THRESHOLD"] = str(
        chip_smoke.RGB_GEO_RECORD_THRESHOLD)
    import jax
    import sph_tpu as J
    from sph_tpu.ops import shortest_path
    from sph_tpu.utils.logging import set_level
    set_level("WARNING")
    assert shortest_path.CONTRACT_THRESHOLD == (
        chip_smoke.RGB_GEO_RECORD_THRESHOLD)
    shape = tuple(args.shape or chip_smoke.RGB_GEO_RECORD_SHAPE)

    record = {
        "what": "JAX package (sph_tpu) on the CPU: chip_smoke.rgb_geo_"
                "settings (configs/rgb_bus_geo.json through run_evaluation."
                "py's wiring) on create_hyperspectral_scene("
                f"{shape[0]}, {shape[1]}, 3, seed=13), Scaler.UNIFORM, "
                "exact L2 kNN k=51 symmetric + connected, "
                "num_geodesic_samples=100, random_seed=1, "
                "SPH_CONTRACT_THRESHOLD="
                f"{chip_smoke.RGB_GEO_RECORD_THRESHOLD}",
        "script": "scripts/rgb_geo_reference.py",
        "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
        "jax": jax.__version__,
        "size": [*shape, 3],
        "contract_threshold": chip_smoke.RGB_GEO_RECORD_THRESHOLD,
        "knn_rows": f"{chip_smoke.RGB_GEO_KNN_ROWS} sampled, "
                    "np.random.default_rng(1)",
        "sketch_pairs": f"{chip_smoke.RGB_GEO_SKETCH_PAIRS} level-1 "
                        "spatial-neighbour pairs (a < b), "
                        "np.random.default_rng(2)",
    }
    for cs in ("geo_centroid", "geo_walks"):
        t = time.perf_counter()
        record[cs] = chip_smoke.geo_record_run(J, cs, shape)
        record[cs]["seconds"]["total"] = time.perf_counter() - t
        print(cs, record[cs]["levels"], record[cs]["seconds"], flush=True)
    with open(args.out, "w") as f:
        json.dump(record, f)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
