"""Batch evaluation over a grid of settings — the de-facto CLI.

Port of sph_tpu/evaluation/run_evaluation.py (reference:
evaluation/Evaluation.cpp:12-30, ``SPHEvaluation <settings.json>``, and
RunEvaluation.cpp — the cartesian grid of settings, the per-run memory guard
(rwNum*rwLen*k <= 2e7, :192-197), hash-named output folders with settings
snapshots (:205-216), TIFF level dumps and the connected-component image
(:340-381), per-level t-SNE or UMAP with size-dependent schedules
(:458-531) and RANDOM, PCA, SPECTRAL or previous-level-average init
(:415-456)).  Every stage and embedding runs on one device, the
card unless the caller names another; the kNN stage is cached under the
grid's base folder and shared by the runs that agree on its settings.

Usage: python -m sph_tpu_torch.evaluation.run_evaluation <settings.json>
       [--device cpu|cuda]
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..data import scale
from ..device import DeviceLike, resolve_device
from ..models.compute_embedding import (ComputeEmbedding,
                                        ComputeEmbeddingSettings,
                                        average_position_of_children,
                                        scale_embedding_to_one)
from ..models.compute_hierarchy import ComputeHierarchy
from ..ops.graph import KnnGraph
from ..ops.math import pca, spectral_embedding
from ..ops.sparse import symmetrize_tsne
from ..settings import (CacheSettings, EmbeddingInit, ImageHierarchySettings,
                        KnnMetric, LevelSimilaritiesSettings,
                        NearestNeighborsSettings, NormalizationScheme,
                        RandomWalkSettings, Scaler)
from ..utils import io as evalio
from ..utils.logging import Log, set_log_path
from .settings import (EvalSettings, expand_runs, load_eval_settings,
                       only_geodesic_settings, settings_string)

MEM_LIMIT = 200 * 500 * 200  # reference: RunEvaluation.cpp:192
USAGE = ("usage: python -m sph_tpu_torch.evaluation.run_evaluation "
         "<settings.json> [--device cpu|cuda]")


def tsne_iterations_for(num_comp: int) -> int:
    """Reference: RunEvaluation.cpp:497-509."""
    if num_comp < 100:
        return 500
    if num_comp < 100_000:
        return 1000
    if num_comp < 200_000:
        return 2000
    return 4000


def umap_epochs_for(num_comp: int, from_previous: bool) -> int:
    """Reference: RunEvaluation.cpp:462-468."""
    if from_previous:
        return 175
    return 250 if num_comp < 100 else 500


def default_k(num_points: int) -> int:
    """Reference: RunEvaluation.cpp:241-248 — perplexity = clamp(n/100,
    10, 100), k = perp * 3 + 1 (self)."""
    perp = float(np.clip(num_points / 100.0, 10.0, 100.0))
    return int(perp) * 3 + 1


def _timed(fn, device: torch.device) -> float:
    """Run fn; its wall seconds once the device is done."""
    t = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t


def run_evaluation(settings: EvalSettings, max_runs: Optional[int] = None,
                   device: DeviceLike = None,
                   report: Optional[list] = None) -> list[str]:
    """Execute the grid on `device` (the card when None); returns the run
    output folders.  With `report`, each finished run appends a summary:
    its folder, its similarity, walk handling and pair-similarity axis,
    levels, whether the kNN stage loaded from the shared
    cache, each level's walk length and component kNN tier (None where
    none), the seconds of each stage, and for each level embedding its
    method, size, schedule and seconds, with the t-SNE KL of its starting
    and of its final layout (one more repulsion pass each) and the UMAP
    memberships' count and range."""
    dev = resolve_device(device)
    t_stamp = time.strftime("%Y%m%d%H%M%S")
    os.makedirs(settings.cache_path_base, exist_ok=True)
    set_log_path(os.path.join(settings.cache_path_base,
                              f"Log_{t_stamp}.txt"))
    Log.info("Starting evaluation on %s", dev)

    run_dirs = []
    setting_hashes: list[tuple[str, str]] = []
    run_id = 0
    for run in expand_runs(settings):
        run_id += 1
        if max_runs is not None and run_id > max_runs:
            break
        Log.info("### NEW RUN ### (%d)", run_id)

        # memory guard (reference: :192-197)
        if run["rw_num"] * run["rw_len"] * run["n_knn"] > MEM_LIMIT:
            Log.info("rwNum*rwLen*k exceeds the memory guard, skipping")
            continue
        if (run["data_input_norm"] != Scaler.NONE
                and run["knn_metric"] == KnnMetric.COSINE):
            Log.info("scaler + COSINE combination skipped (reference "
                     ":199-203)")
            continue

        img_name = run["image_name"]
        base = os.path.join(settings.cache_path_base,
                            settings.save_sub_folder
                            or os.path.splitext(img_name)[0])
        # the grid-settings file beside the hash registry (reference:
        # RunEvaluation.cpp:324-326)
        if settings.settings_path and os.path.isfile(settings.settings_path):
            os.makedirs(base, exist_ok=True)
            ext = os.path.splitext(settings.settings_path)[1]
            dst = os.path.join(base, f"{t_stamp}_settings{ext}")
            if not os.path.exists(dst):
                shutil.copyfile(settings.settings_path, dst)

        sstr = settings_string(run)
        shash = evalio.create_short_hash(sstr)
        indicator = run["component_sim"].value
        if not only_geodesic_settings(run["component_sim"]):
            indicator += "_" + run["rw_handling"].value
        out_dir = os.path.join(
            base, f"{indicator}_{shash}_{t_stamp}_{run_id}")
        os.makedirs(out_dir, exist_ok=True)
        if settings.skip_existing_settings and os.listdir(out_dir):
            Log.info("Save folder not empty, skipping this setting")
            continue

        # a missing or corrupt image skips the run, like the reference's
        # 0-point check (RunEvaluation.cpp:234-238)
        img_path = os.path.join(settings.input_path, img_name)
        try:
            stack = evalio.load_image(
                img_path, "tiffstack" if settings.img_format.upper()
                == "TIFFSTACK" else "rgb")
        except (OSError, ValueError) as exc:
            Log.warn("Could not load image %s (%s), skipping this one...",
                     img_path, exc)
            continue
        if stack.num_points == 0:
            Log.warn("Image has 0 points, skipping this one...")
            continue
        data = scale(stack.data, run["data_input_norm"])

        k = run["n_knn"]
        k = default_k(stack.num_points) if k == 0 else k + 1  # self

        # settings wiring (reference: :250-280)
        rws = RandomWalkSettings(
            num_random_walks=run["rw_num"],
            single_walk_length=run["rw_len"],
            importance_weighting=run["rw_weight"])
        ihs = ImageHierarchySettings(
            component_sim=run["component_sim"],
            neighbor_connection=run["neighbor_connection"],
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_num_comp=1, min_reduction=98.0, num_geodesic_samples=100,
            max_levels=10,
            rw_handling=run["rw_handling"],
            rw_weight_merge_by_size=run["rw_weight_by_size"],
            rw_reduction=run["rw_reduction"],
            norm_knn_distances=run["data_dist_norm"])
        nns = NearestNeighborsSettings(
            num_nearest_neighbors=k,
            symmetric_neighbors=run["neighbor_symmetric"],
            compute_connect_components=True,
            neighbor_connect_components=run["neighbor_connect_components"],
            knn_metric=run["knn_metric"])
        lss = LevelSimilaritiesSettings(
            component_sim=run["component_sim"], ks=[k],
            random_walk_pair_sims=run["rw_pair_sims"],
            weight_transition_by_size=run["weight_transition_by_size"],
            normalize_prob_dist=run["data_dist_norm"],
            compute_symmetric_prob_dist=NormalizationScheme.NONE)

        # the kNN cache, shared across grid runs and keyed by the
        # kNN-relevant axes (reference: cc_suffix_knn, :278-295)
        knn_suffix = (f"{k}_{run['knn_metric'].value}_"
                      f"{run['data_input_norm'].value}_"
                      f"{int(run['neighbor_symmetric'])}_"
                      f"{int(run['neighbor_connect_components'])}")
        knn_cache = CacheSettings(
            path=os.path.join(base, "knn", knn_suffix),
            file_name=os.path.splitext(img_name)[0], cache_active=True)

        setting_hashes.append((shash, sstr))
        evalio.save_setting_hashes(
            os.path.join(base, f"{t_stamp}_hashes.json"), setting_hashes)

        ch = ComputeHierarchy(device=dev).init(
            data, stack.rows, stack.cols, ihs, lss, rws, nns,
            knn_cache=knn_cache)
        ch.skip_level_similarities = settings.skip_level_similarities
        seconds = {
            "stage1_knn": _timed(ch.compute_knn_graph, dev),
            "stage2_hierarchy": _timed(ch.compute_image_hierarchy, dev),
            "stage3_level_similarities": _timed(
                ch.compute_level_similarities, dev)}
        Log.info("Stage seconds: %s", seconds)

        # outputs (reference: :340-381)
        t = time.perf_counter()
        evalio.save_settings_snapshot(
            os.path.join(out_dir, "sph_settings.txt"), nns, ihs, rws, lss)
        ch.image_hierarchy.write_stats(
            os.path.join(out_dir, "sph_stats_imh.txt"))
        if not settings.skip_level_similarities:
            ch.level_similarities.write_stats(
                os.path.join(out_dir, "sph_stats_ls.txt"))
        h = ch.image_hierarchy.hierarchy
        evalio.save_level_images(h, stack.rows, stack.cols, out_dir)
        if ch.knn_stage.connected_components is not None:
            evalio.save_label_image(
                ch.knn_stage.connected_components, stack.rows, stack.cols,
                os.path.join(out_dir, "component.tiff"))
        evalio.write_vec_of_vec(
            os.path.join(out_dir, "MapFromLevelToBottom.bin"),
            [np.concatenate(h.represented_points(lev))
             for lev in range(h.num_levels)])
        # pixel -> component id per level (reference: mapFromPixelToLevel,
        # RunEvaluation.cpp:381)
        evalio.write_vec_of_vec(
            os.path.join(out_dir, "MapFromBottomToLevel.bin"),
            [h.pixel_components[lev] for lev in range(h.num_levels)])
        seconds["outputs"] = time.perf_counter() - t

        embeddings: list[dict] = []
        if not settings.skip_level_similarities:
            embeddings = _run_embeddings(settings, run, ch, out_dir, dev,
                                         detail=report is not None)
        if report is not None:
            report.append({
                "out_dir": out_dir, "run_id": run_id,
                "component_sim": run["component_sim"].value,
                "rw_handling": run["rw_handling"].value,
                "rw_pair_sims": bool(run["rw_pair_sims"]),
                "levels": list(h.num_components),
                "knn_loaded_from_cache": ch.knn_loaded_from_cache,
                "walk_lengths": list(ch.image_hierarchy._rw_lengths),
                "knn_tiers": (None if settings.skip_level_similarities
                              else list(ch.level_similarities.knn_tiers)),
                "seconds": seconds, "embeddings": embeddings})
        run_dirs.append(out_dir)
        Log.info("Finished run %d", run_id)

    Log.info("Finished evaluation")
    return run_dirs


def _init_embedding(settings: EvalSettings, ch, level: int, num_comp: int,
                    ce: ComputeEmbedding, out_dir: str, emb_type: str):
    """Reference: the initEmbedding lambda, RunEvaluation.cpp:415-456."""
    h = ch.image_hierarchy.hierarchy
    if level == 0:
        init, ok = None, False
        if settings.init_embedding_data_level == EmbeddingInit.PCA:
            init, ok = pca(ch.image_hierarchy._data, 2)
        elif settings.init_embedding_data_level == EmbeddingInit.SPECTRAL:
            g = ch.image_hierarchy._graph
            if isinstance(g, KnnGraph):
                init, ok = spectral_embedding(g.indices, g.distances, 2)
            else:
                init, ok = spectral_embedding(
                    np.where(g.mask, g.indices, -1),
                    np.where(g.mask, g.distances, 0.0), 2)
        if ok and init is not None:
            ce.init_embedding(num_comp, scale_embedding_to_one(init))
        elif settings.init_embedding_data_level != EmbeddingInit.RANDOM:
            Log.warn("Init could not be computed, falling back to random")
    elif settings.init_level_emb_with_previous:
        prev_path = os.path.join(out_dir, f"emb_{emb_type}_{level - 1}.bin")
        if os.path.exists(prev_path):
            # level L starts from the mean of its level-(L-1) children's
            # positions (reference: RunEvaluation.cpp:448-455)
            init = average_position_of_children(
                evalio.read_embedding(prev_path), h.parents[level - 1],
                num_comp)
            ce.init_embedding(num_comp, scale_embedding_to_one(init))


def _run_embeddings(settings: EvalSettings, run: dict, ch, out_dir: str,
                    device: torch.device, detail: bool = False
                    ) -> list[dict]:
    """t-SNE or UMAP of every level, as the level's normalization says;
    returns one summary for each embedding (with `detail`, the KLs and
    the memberships' range too)."""
    h = ch.image_hierarchy.hierarchy
    norm = run["data_dist_norm"]
    out = []
    for level in range(h.num_levels):
        if settings.skip_embedding_tsne and settings.skip_embedding_umap:
            break
        num_comp = h.num_components[level]
        pd = ch.level_similarities.get_prob_dist(level)

        if (norm == NormalizationScheme.UMAP
                and not settings.skip_embedding_umap):
            ces = ComputeEmbeddingSettings()
            ces.umap.num_epochs = umap_epochs_for(
                num_comp, level > 0 and settings.init_level_emb_with_previous)
            ce = ComputeEmbedding(ces, device=device)
            _init_embedding(settings, ch, level, num_comp, ce, out_dir,
                            "umap")
            t = time.perf_counter()
            # applies the fuzzy union itself, on the level's path
            emb = ce.compute_umap(
                pd, device_path=ch.level_similarities.device_path(level))
            rec = {"level": level, "method": "umap", "n": num_comp,
                   "epochs": ces.umap.num_epochs,
                   "seconds": time.perf_counter() - t}
            # the memberships UMAP samples: None where it did not run (a
            # single point), 0 where the layout stayed at its start
            m = ce.last_computation.memberships
            live = None if m is None else m.val[m.idx >= 0]
            rec["memberships"] = (None if live is None
                                  else int((live > 0).sum()))
            if detail and live is not None:
                rec.update(tier=ce.last_computation.tier,
                           membership_range=(
                               [float(live.min()), float(live.max())]
                               if live.numel() else None))
            out.append(rec)
            evalio.write_embedding(
                os.path.join(out_dir, f"emb_umap_{level}.bin"), emb)

        if (norm == NormalizationScheme.TSNE
                and not settings.skip_embedding_tsne):
            ces = ComputeEmbeddingSettings()
            ces.tsne.num_iterations = tsne_iterations_for(num_comp)
            ces.tsne.perplexity = (
                ch.level_similarities.perplexity_on_level[level])
            ce = ComputeEmbedding(ces, device=device)
            _init_embedding(settings, ch, level, num_comp, ce, out_dir,
                            "tsne")
            kl_start = []

            def first_kl(comp, kl_start=kl_start):
                if detail and not kl_start:
                    kl_start.append(comp.kl_divergence())

            t = time.perf_counter()
            emb = ce.compute_tsne(
                symmetrize_tsne(pd, device_path=ch.level_similarities
                                .device_path(level)),
                track_kl=detail, progress=first_kl)
            rec = {"level": level, "method": "tsne", "n": num_comp,
                   "iterations": ces.tsne.num_iterations,
                   "seconds": time.perf_counter() - t}
            if detail:
                rec.update(kl_start=kl_start[0] if kl_start else 0.0,
                           kl=ce.last_kl,
                           tier=ce.last_computation.tier)
            out.append(rec)
            evalio.write_embedding(
                os.path.join(out_dir, f"emb_tsne_{level}.bin"), emb)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv) or argv[i + 1] not in ("cpu", "cuda"):
            print(USAGE)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 1:
        print(USAGE)
        return 2
    try:
        settings = load_eval_settings(argv[0])
    except (OSError, ValueError) as exc:
        # reference: Evaluation.cpp:22-25 — report and EXIT_FAILURE
        print(f"Settings file at {argv[0]} not found or invalid: {exc}",
              file=sys.stderr)
        return 1
    run_evaluation(settings, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
