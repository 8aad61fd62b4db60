#!/usr/bin/env python3
"""The JAX package's run_evaluation on configs/pines_embed.json, on
JAX-CPU: the records chip_smoke.py's eval phases hold the port to.

    JAX_PLATFORMS=cpu python3 scripts/eval_pines_reference.py [--out FILE]

Writes create_hyperspectral_scene(rows, cols, 200, seed=7) as a float32
TIFF stack (scripts/make_data.py's writer) and runs
``sph_tpu.evaluation.run_evaluation`` on the grid with its input and output
paths moved to a temporary directory, four times:

- pines_tsne: 145x145x200 (make_data.py's pines_synth.tiff), the grid as
  it is but with skipEmbeddingTSNE, so it ends after the hierarchy;
- pines_umap: the same with dataDistNorm UMAP, t-SNE skipped and UMAP
  counted only (below);
- record_tsne: 64x64x200, the grid whole: PCA init of level 0, t-SNE of
  every level from the level below's layout (the KL of each level's final
  layout is taken with the JAX package's own kl_divergence);
- record_umap: 64x64x200 with dataDistNorm UMAP, skipEmbeddingTSNE and
  UMAP of every level; level 1's trustworthiness at k = 10 against the
  components' mean spectra (chip_smoke.trustworthiness).

Each record holds the levels, the sha256 of MapFromBottomToLevel.bin and
MapFromLevelToBottom.bin, the seconds and, where run_evaluation raised, the
error.  The UMAP records also hold ``umap_memberships``: for each level, the
count of memberships UMAP would sample (its fuzzy union's positive
entries; null for a single point, which UMAP skips), taken from a pass of
the driver in which compute_umap counts them and returns a zero layout
instead of optimising.  A level with 0 is one where the JAX package's UMAP
raises.  For pines_umap that pass is the run; record_umap is run whole
first (it raises at its first empty level), then counted in a second
pass, whose maps must equal the first's.  The JAX side runs its float32 gathers (SPH_TSNE_ATTR_PACKED=0,
SPH_UMAP_PACKED=0), the only ones the port has.  Default output:
docs/torch_port_eval_pines_reference.json.
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

# (name, shape, grid changes (None: chip_smoke.EVAL_UMAP), how UMAP runs:
# None not at all, "count" counted only, "whole" optimised, then counted)
RUNS = (("pines_tsne", "EVAL_PINES_SHAPE", {"skipEmbeddingTSNE": True}, None),
        ("pines_umap", "EVAL_PINES_SHAPE", None, "count"),
        ("record_tsne", "EVAL_RECORD_SHAPE", {}, None),
        ("record_umap", "EVAL_RECORD_SHAPE", None, "whole"))


def write_stack(path: str, img) -> None:
    """scripts/make_data.py's multi-page float32 TIFF writer."""
    from PIL import Image
    pages = [Image.fromarray(img[:, :, c], mode="F")
             for c in range(img.shape[2])]
    pages[0].save(path, save_all=True, append_images=pages[1:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_eval_pines_reference.json"))
    ap.add_argument("--only", default="",
                    help="comma-separated run names (default: all)")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("SPH_TSNE_ATTR_PACKED", "0")
    os.environ.setdefault("SPH_UMAP_PACKED", "0")
    sys.path.insert(0, REPO)
    import jax
    import numpy as np
    import chip_smoke
    from sph_tpu.evaluation import run_evaluation as jre
    from sph_tpu.evaluation.settings import load_eval_settings
    from sph_tpu.ops.sparse import symmetrize_umap
    from sph_tpu.utils import io as jio
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    set_level("WARNING")

    kls: list[dict] = []
    members: list = []
    counting = [False]

    class KlEmbedding(jre.ComputeEmbedding):
        """run_evaluation's ComputeEmbedding, keeping each t-SNE's final KL
        and, while counting, each UMAP level's memberships in place of its
        layout."""

        def compute_tsne(self, inp, track_kl=False):
            emb = super().compute_tsne(inp, track_kl=True)
            kls.append({"n": int(inp.num_rows), "kl": float(self.last_kl)})
            return emb

        def compute_umap(self, inp):
            if not counting[0]:
                return super().compute_umap(inp)
            n = int(inp.num_rows)
            m = None if n == 1 else symmetrize_umap(inp)
            members.append(None if m is None else int(np.sum(
                np.asarray(m.mask) & (np.asarray(m.values) > 0))))
            self.current_embedding = np.zeros((n, 2), np.float32)
            return self.current_embedding

    jre.ComputeEmbedding = KlEmbedding

    def run(name: str, shape, changes: dict) -> tuple:
        """The driver once on the grid with `changes`: its output read
        back, its seconds, the image and the error it raised (or None)."""
        root = tempfile.mkdtemp(prefix=f"eval_{name}_")
        img = create_hyperspectral_scene(*shape, seed=chip_smoke.EVAL_SEED)
        grid = chip_smoke.eval_grid(root, img, write_stack, name, **changes)
        raised = None
        t = time.perf_counter()
        try:
            jre.run_evaluation(load_eval_settings(grid))
        except ValueError as exc:
            raised = f"{type(exc).__name__}: {exc}"
        seconds = time.perf_counter() - t
        (out_dir,) = glob.glob(os.path.join(root, "out", "pines_synth",
                                            "neigh_walks_*"))
        got = chip_smoke.eval_outputs(out_dir, jio.read_vec_of_vec,
                                      jio.read_embedding)
        return got, seconds, img, raised

    only = set(filter(None, args.only.split(",")))
    out = {"what": "the JAX package's evaluation CLI "
                   "(sph_tpu.evaluation.run_evaluation) on "
                   "configs/pines_embed.json with its paths moved, on "
                   "create_hyperspectral_scene(rows, cols, 200, seed=7)",
           "script": "scripts/eval_pines_reference.py",
           "platform": "cpu (JAX_PLATFORMS=cpu)", "jax": jax.__version__,
           "grid": chip_smoke.EVAL_GRID, "runs": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out["runs"] = json.load(f).get("runs", {})
    for name, shape_name, changes, umap_mode in RUNS:
        if only and name not in only:
            continue
        shape = getattr(chip_smoke, shape_name)
        changes = chip_smoke.EVAL_UMAP if changes is None else changes
        kls.clear()
        members.clear()
        counting[0] = umap_mode == "count"
        got, seconds, img, raised = run(name, shape, changes)
        rec = {"shape": list(shape), "changes": changes,
               "levels": got["levels"], "maps_sha256": got["maps_sha256"],
               "seconds": seconds, "raised": raised}
        if kls:
            rec["tsne_kl"] = {str(lv): kl for lv, kl in enumerate(kls)}
        umap = got["embeddings"].get("umap", {})
        if umap_mode == "whole" and 1 in umap:
            data = img.reshape(-1, img.shape[2]).astype(np.float64)
            means = chip_smoke.component_means(
                data, got["pixel_components"][1], got["levels"][1])
            rec["umap_level_1_trustworthiness_k10"] = (
                chip_smoke.trustworthiness(means, umap[1], 10))
            rec["umap_levels_embedded"] = sorted(umap)
        if umap_mode == "whole":
            members.clear()
            counting[0] = True
            counted, rec["count_seconds"], _, _ = run(name + "_count", shape,
                                                     changes)
            if counted["maps_sha256"] != got["maps_sha256"]:
                raise AssertionError(f"{name}: the counting pass's maps "
                                     "differ from the run's")
        if umap_mode is not None:
            rec["umap_memberships"] = list(members)
        out["runs"][name] = rec
        print(json.dumps({name: rec}), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
