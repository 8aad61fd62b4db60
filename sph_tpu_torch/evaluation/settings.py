"""Evaluation grid settings.

The port's own copy of sph_tpu/evaluation/settings.py (reference:
evaluation/EvaluationSettings.hpp/.cpp — the JSON grid spec with
per-axis arrays, string -> enum parsing, and the cartesian-product run
expansion (RunEvaluation.cpp:96-136)).  The same JSON files the reference
ships (eval_settings.json, comparison/*.json) parse directly, and
``settings_string`` gives the JAX package's strings, so run folders get the
same hash names.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Iterator

from ..settings import (ComponentSim, EmbeddingInit, ImportanceWeighting,
                        KnnMetric, NeighConnection, NormalizationScheme,
                        RandomWalkHandling, RandomWalkReduction, Scaler)

_ENUM_PARSERS = {
    "componentSim": lambda s: ComponentSim[s],
    "dataInputNorm": lambda s: Scaler[s],
    "dataDistNorm": lambda s: NormalizationScheme[s],
    "neighborConnection": lambda s: NeighConnection[s],
    "knnMetric": lambda s: KnnMetric[s],
    "randomWalkStepWeight": lambda s: ImportanceWeighting[s],
    "randomWalkHandling": lambda s: RandomWalkHandling[s],
    "randomWalkReduction": lambda s: RandomWalkReduction[s],
    "initEmbeddingDataLevel": lambda s: EmbeddingInit[s],
}


@dataclass
class EvalSettings:
    """Parsed grid spec (reference: EvaluationSettings.hpp:92-116)."""

    input_path: str = ""
    cache_path_base: str = ""
    save_sub_folder: str = ""
    img_format: str = "RGB"            # RGB | TIFFSTACK
    image_names: list[str] = field(default_factory=list)
    component_sim: list[ComponentSim] = field(default_factory=list)
    data_input_norm: list[Scaler] = field(default_factory=list)
    data_dist_norm: list[NormalizationScheme] = field(default_factory=list)
    neighbor_connections: list[NeighConnection] = field(default_factory=list)
    neighbor_symmetries: list[bool] = field(default_factory=lambda: [False])
    neighbor_connect_components: list[bool] = field(
        default_factory=lambda: [False])
    n_knns: list[int] = field(default_factory=lambda: [0])
    knn_metrics: list[KnnMetric] = field(
        default_factory=lambda: [KnnMetric.L2])
    weight_transition_by_size: list[bool] = field(
        default_factory=lambda: [False])
    random_walk_nums: list[int] = field(default_factory=lambda: [90])
    random_walk_lens: list[int] = field(default_factory=lambda: [15])
    random_walk_pair_sims: list[bool] = field(default_factory=lambda: [True])
    random_walk_step_weight: list[ImportanceWeighting] = field(
        default_factory=lambda: [ImportanceWeighting.CONSTANT])
    random_walk_weight_size: list[bool] = field(
        default_factory=lambda: [True])
    random_walk_handling: list[RandomWalkHandling] = field(
        default_factory=lambda: [RandomWalkHandling.MERGE_RW_ONLY])
    random_walk_reduction: list[RandomWalkReduction] = field(
        default_factory=lambda: [
            RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION])
    init_embedding_data_level: EmbeddingInit = EmbeddingInit.RANDOM
    skip_level_similarities: bool = False
    skip_embedding_tsne: bool = False
    skip_embedding_umap: bool = False
    skip_existing_settings: bool = True
    skip_save_structures_to_disk: bool = True
    init_level_emb_with_previous: bool = False
    settings_path: str = ""


_JSON_KEYS = {
    "inputPath": "input_path",
    "cachePathBase": "cache_path_base",
    "saveSubFolder": "save_sub_folder",
    "imgFormat": "img_format",
    "imageNames": "image_names",
    "componentSim": "component_sim",
    "dataInputNorm": "data_input_norm",
    "dataDistNorm": "data_dist_norm",
    "neighborConnection": "neighbor_connections",
    "neighborSymmetries": "neighbor_symmetries",
    "neighborConnectComponents": "neighbor_connect_components",
    "nKnns": "n_knns",
    "knnMetric": "knn_metrics",
    "weightTransitionBySize": "weight_transition_by_size",
    "randomWalkNums": "random_walk_nums",
    "randomWalkLens": "random_walk_lens",
    "randomWalkPairSims": "random_walk_pair_sims",
    "randomWalkStepWeight": "random_walk_step_weight",
    "randomWalkWeightSize": "random_walk_weight_size",
    "randomWalkHandling": "random_walk_handling",
    "randomWalkReduction": "random_walk_reduction",
    "initEmbeddingDataLevel": "init_embedding_data_level",
    "skipLevelSimilarities": "skip_level_similarities",
    "skipEmbeddingTSNE": "skip_embedding_tsne",
    "skipEmbeddingUMAP": "skip_embedding_umap",
    "skipExistingSettings": "skip_existing_settings",
    "skipSaveStructuresToDisk": "skip_save_structures_to_disk",
    "initLevelEmbWithPrevious": "init_level_emb_with_previous",
}


def load_eval_settings(path: str) -> EvalSettings:
    """Parse a reference-format grid JSON (reference:
    readSettingsFromFile)."""
    with open(path) as f:
        raw = json.load(f)
    out = EvalSettings(settings_path=path)
    for jkey, attr in _JSON_KEYS.items():
        if jkey not in raw:
            continue
        val = raw[jkey]
        parser = _ENUM_PARSERS.get(jkey)
        if parser is not None:
            if isinstance(val, list):
                val = [parser(v) for v in val]
            else:
                val = parser(val)
        setattr(out, attr, val)
    return out


GEO_ONLY_SIMS = (ComponentSim.GEO_CENTROID, ComponentSim.EUCLID_CENTROID,
                 ComponentSim.NEIGH_OVERLAP)


def only_geodesic_settings(cs: ComponentSim) -> bool:
    """Sims that do not iterate the random-walk axes (reference:
    onlyGeodesicSettings, RunEvaluation.cpp:119-136,169-170)."""
    return cs in GEO_ONLY_SIMS


def expand_runs(s: EvalSettings) -> Iterator[dict]:
    """Cartesian-product expansion of the grid (reference:
    RunEvaluation.cpp:96-175).  Geodesic-style sims get a single default
    random-walk combination."""
    general = itertools.product(
        s.image_names, s.component_sim, s.data_input_norm, s.data_dist_norm,
        s.neighbor_connections, s.neighbor_symmetries,
        s.neighbor_connect_components, s.n_knns, s.knn_metrics,
        s.weight_transition_by_size)
    for (img, csim, dnorm, ddnorm, conn, sym, ncc, k, metric,
         wts) in general:
        if only_geodesic_settings(csim):
            rw_combos = [(0, 0, False, ImportanceWeighting.NORMAL, False,
                          RandomWalkHandling.MERGE_RW_ONLY,
                          RandomWalkReduction.NONE)]
        else:
            rw_combos = itertools.product(
                s.random_walk_nums, s.random_walk_lens,
                s.random_walk_pair_sims, s.random_walk_step_weight,
                s.random_walk_weight_size, s.random_walk_handling,
                s.random_walk_reduction)
        for (rw_num, rw_len, rw_pair, rw_w, rw_size, rw_han,
             rw_red) in rw_combos:
            yield {
                "image_name": img, "component_sim": csim,
                "data_input_norm": dnorm, "data_dist_norm": ddnorm,
                "neighbor_connection": conn, "neighbor_symmetric": sym,
                "neighbor_connect_components": ncc, "n_knn": k,
                "knn_metric": metric, "weight_transition_by_size": wts,
                "rw_num": rw_num, "rw_len": rw_len, "rw_pair_sims": rw_pair,
                "rw_weight": rw_w, "rw_weight_by_size": rw_size,
                "rw_handling": rw_han, "rw_reduction": rw_red,
            }


def settings_string(run: dict) -> str:
    """Canonical settings string hashed into the run folder name
    (reference: getSettingsString, RunEvaluation.cpp:205-216)."""
    parts = []
    for k in sorted(run):
        v = run[k]
        parts.append(f"{k}={getattr(v, 'value', v)}")
    return "|".join(parts)
