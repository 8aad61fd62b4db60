#!/usr/bin/env python3
"""The JAX package's run_evaluation on the two walk-variant grids, on
JAX-CPU: the record chip_smoke.py's phase eval_pines_walks holds the port
to.

    JAX_PLATFORMS=cpu python3 scripts/pines_walks_reference.py
        [--shape ROWS COLS BANDS] [--out FILE]

Writes create_hyperspectral_scene(145, 145, 200, seed=7) (scripts/
make_data.py's pines_synth) as a float32 TIFF stack and runs
``sph_tpu.evaluation.run_evaluation`` on configs/pines_walk_variants.json
(NEIGH_WALKS and NEIGH_WALKS_SINGLE_OVERLAP, each with MERGE_RW_NEW_WALKS,
MERGE_RW_NEW_WALKS_AND_KNN and MERGE_DATA_NEW_WALKS: six runs) and
configs/pines_walk_topk.json (NEIGH_WALKS, MERGE_RW_ONLY, top-k walk rows
as the level probdist: one run), with their paths moved to a temporary
directory (chip_smoke.eval_grid) and skipEmbeddingTSNE set: JAX-CPU's
dense t-SNE of the 21025-point level 0 would take most of an hour a run,
and the phase's KL gates need no record (each level's KL must fall below
its own start).  Both grids share one base, so the second loads the kNN
stage from the first's cache, as on the card.

Each run's record, keyed by chip_smoke.walk_run_name: the levels, the
sha256 of MapFromBottomToLevel.bin and MapFromLevelToBottom.bin, and the
walk length of each level (ImageHierarchy._rw_lengths).  The JSON names
the platform and the seconds each grid took: 541 s and 56 s on the 8
cores of an H100 host, with scripts/salinas_walks_reference.py running
beside it.  Default output: docs/torch_port_pines_walks_reference.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="another scene size, for a rehearsal")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_pines_walks_reference.json"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    import chip_smoke
    from eval_pines_reference import write_stack
    from sph_tpu.evaluation import run_evaluation as jre
    from sph_tpu.evaluation.settings import expand_runs, load_eval_settings
    from sph_tpu.utils import io as jio
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")

    hierarchies = []

    class RecordingHierarchy(jre.ComputeHierarchy):
        """run_evaluation's ComputeHierarchy, kept after each run."""

        def compute(self):
            out = super().compute()
            hierarchies.append(self)
            return out

    jre.ComputeHierarchy = RecordingHierarchy
    shape = tuple(args.shape or chip_smoke.EVAL_PINES_SHAPE)
    img = create_hyperspectral_scene(*shape, seed=chip_smoke.EVAL_SEED)
    root = tempfile.mkdtemp(prefix="pines_walks_")
    out = {"what": "the JAX package's evaluation CLI (sph_tpu.evaluation."
                   "run_evaluation) on the walk-variant grids with their "
                   "paths moved and skipEmbeddingTSNE, on "
                   f"create_hyperspectral_scene({', '.join(map(str, shape))}"
                   f", seed={chip_smoke.EVAL_SEED})",
           "script": "scripts/pines_walks_reference.py",
           "platform": f"cpu (JAX_PLATFORMS={os.environ['JAX_PLATFORMS']})",
           "jax": jax.__version__, "shape": list(shape),
           "grids": {}, "runs": {}}
    for grid_file in chip_smoke.EVAL_WALK_GRIDS:
        name = os.path.splitext(os.path.basename(grid_file))[0]
        grid = chip_smoke.eval_grid(root, img, write_stack, name,
                                    grid_file=grid_file,
                                    skipEmbeddingTSNE=True)
        settings = load_eval_settings(grid)
        hierarchies.clear()
        base = os.path.join(root, "out", "pines_synth")
        before = set(glob.glob(os.path.join(base, "*")))
        t = time.perf_counter()
        jre.run_evaluation(settings)
        seconds = time.perf_counter() - t
        runs = list(expand_runs(settings))
        if len(runs) != len(hierarchies):
            raise AssertionError(f"{name}: {len(runs)} runs, "
                                 f"{len(hierarchies)} hierarchies")
        new = set(glob.glob(os.path.join(base, "*"))) - before
        names = []
        for run_id, (run, ch) in enumerate(zip(runs, hierarchies), 1):
            key = chip_smoke.walk_run_name({
                "component_sim": run["component_sim"].value,
                "rw_handling": run["rw_handling"].value,
                "rw_pair_sims": run["rw_pair_sims"]})
            indicator = (f"{run['component_sim'].value}_"
                         f"{run['rw_handling'].value}_")
            (out_dir,) = [d for d in new if d.endswith(f"_{run_id}")
                          and os.path.basename(d).startswith(indicator)]
            got = chip_smoke.eval_outputs(out_dir, jio.read_vec_of_vec,
                                          jio.read_embedding)
            out["runs"][key] = {
                "grid": name, "levels": got["levels"],
                "maps_sha256": got["maps_sha256"],
                "walk_lengths": [int(x) for x in
                                 ch.image_hierarchy._rw_lengths]}
            names.append(key)
            print(json.dumps({key: out["runs"][key]}), flush=True)
        out["grids"][name] = {"runs": names, "cpu_seconds": seconds}
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
