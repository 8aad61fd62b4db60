"""LevelSimilarities — stage 3: per-level probability distributions.

Port of sph_tpu/models/level_similarities.py (reference:
sph/LevelSimilarities.cpp — auto k/perplexity schedule (:83-115), per-level
kNN (:191-442), probability distributions (:444-587: level 0 reuses the
ImageHierarchy data-level probdist; WALKS levels use pairwise random-walk
Bhattacharyya; kNN-metric levels use Gaussian-perplexity rows) and TSNE
symmetrization (:589-623)).

Ported: the walk metrics (NEIGH_WALKS, NEIGH_WALKS_SINGLE_OVERLAP,
GEO_WALKS) with pairwise walk similarities or the top-k walk rows (and,
with force_compute_distances, the walks as the level's distance graph), or,
under MERGE_RW_NEW_WALKS_AND_KNN, the level's kNN over the walk metric
(exact, or the approximate tier above SPH_APPROX_KNN_THRESHOLD components),
NEIGH_OVERLAP and EUCLID_CENTROID with their per-level kNN (exact, or the
approximate tier above SPH_APPROX_KNN_THRESHOLD components unless exact_knn
is set), GEO_CENTROID with the geodesic Hausdorff kNN (which itself takes
the contracted component graph above CONTRACT_THRESHOLD components), the
level normalizations (walk levels take Gaussian rows under TSNE, smooth-knn
memberships under UMAP and keep their similarities under LINEAR and NONE;
kNN levels always take Gaussian rows, as in the JAX package), and the TSNE
and UMAP symmetrizations.  Level 0 reuses the image hierarchy's data-level
probdist or, without one, normalizes the data kNN graph itself.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..settings import (ComponentSim, LevelSimilaritiesSettings,
                        NormalizationScheme, RandomWalkHandling,
                        RandomWalkSettings)
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops import component_knn, shortest_path
from ..ops.distributions import (distance_rows_to_probabilities,
                                 gaussian_row_distributions,
                                 smooth_knn_rows_bucketed)
from ..ops.graph import KnnGraph, PaddedGraph
from ..ops.similarities import (build_union_neighborhoods,
                                component_hausdorff,
                                neighbor_overlap_distance,
                                sample_represented,
                                walks_bhattacharyya_distance,
                                walks_single_overlap_distance)
from ..ops.numerics import np_row_sum, row_sum
from ..ops.walks import stored_width
from ..ops.sparse import (SparseRows, drop_zero_entries,
                          pairwise_similarities, shrink_width,
                          symmetrize_tsne, symmetrize_umap, topk_rows)
from .hierarchy import WALK_SIMS, Hierarchy


def _approx_knn_threshold() -> int:
    """Component count above which the per-level kNN takes the approximate
    tier (the JAX package's rule, sph_tpu/models/level_similarities.py:
    35-40); exact_knn=True in LevelSimilaritiesSettings keeps the exact one
    at any size."""
    return int(os.environ.get("SPH_APPROX_KNN_THRESHOLD", "8192"))


@dataclass
class LevelSimilaritiesStats:
    """Reference: LevelSimilarities.hpp:26-31."""

    perplexities: list[float] = field(default_factory=list)
    ks: list[int] = field(default_factory=list)
    avg_num_neighbors: list[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"perplexities": self.perplexities, "ks": self.ks,
                "avgNumNeighbors": self.avg_num_neighbors}


class LevelSimilarities:
    """Stage-3 engine (reference: sph/LevelSimilarities.hpp:39)."""

    def __init__(self, hierarchy: Hierarchy,
                 data_knn_graph: KnnGraph | PaddedGraph,
                 data: np.ndarray,
                 lss: Optional[LevelSimilaritiesSettings] = None,
                 device: Optional[torch.device] = None):
        self.hierarchy = hierarchy
        self._graph = data_knn_graph
        self._data = data
        self._lss = lss or LevelSimilaritiesSettings()
        self.device = device
        self._image_hierarchy = None
        self.stats = LevelSimilaritiesStats()
        self.prob_dists: list[Optional[SparseRows]] = []
        self.distance_graphs: list[Optional[tuple]] = []
        # per level, which component kNN gave its distance graph: "exact",
        # "approximate", "contracted" (GEO_CENTROID's component graph), or
        # None where the level has none
        self.knn_tiers: list[Optional[str]] = []
        self.perplexity_on_level: list[float] = []
        # per level, whether its rows take the JAX package's device-path
        # symmetrization (``device_path``)
        self.device_paths: list[bool] = []
        self._symmetric: NormalizationScheme = NormalizationScheme.NONE
        self.init_output()

    def set_image_hierarchy(self, ih):
        self._image_hierarchy = ih

    def init_output(self):
        num_levels = self.hierarchy.num_levels
        self.prob_dists = [None] * num_levels
        self.distance_graphs = [None] * num_levels
        self.knn_tiers = [None] * num_levels
        self.perplexity_on_level = [0.0] * num_levels
        self.device_paths = [False] * num_levels
        self._symmetric = NormalizationScheme.NONE
        self.update_number_of_neighbors()

    def update_number_of_neighbors(self):
        """Reference: updateNumberOfNeighbors (:83-115)."""
        num_levels = self.hierarchy.num_levels
        if num_levels == 0 or not self._lss.ks:
            return
        ks = list(self._lss.ks[:1]) + [0] * (num_levels - 1)
        data_perp = (ks[0] - 1) / 3.0
        self.perplexity_on_level[0] = float(np.clip(data_perp, 10.0, 100.0))
        for level in range(1, num_levels):
            c = self.hierarchy.num_components[level]
            level_perp = float(np.clip(c / 100.0, 10.0, 100.0))
            level_perp = min(data_perp, level_perp)
            ks[level] = min(int(level_perp) * 3 + 1, c)
            self.perplexity_on_level[level] = level_perp
        self._lss.ks = ks
        Log.info("LevelSimilarities: ks per level: %s", ks)

    # ------------------------------------------------------------------

    def compute(self, lss: Optional[LevelSimilaritiesSettings] = None):
        if lss is not None:
            self._lss = lss
        if len(self._lss.ks) <= 1:
            self.update_number_of_neighbors()

        num_levels = self.hierarchy.num_levels
        start, end = 0, num_levels
        if self._lss.level_to_compute >= 0:
            start = self._lss.level_to_compute
            end = start + 1
        for level in range(start, end):
            Log.info("LevelSimilarities::compute: level %d", level)
            with phase("ls.knn"):
                self._compute_knn_on_level(level)
            with phase("ls.probdist"):
                self._compute_probdist_on_level(level)
        with phase("ls.symmetrize"):
            self.symmetrize_output(self._lss.compute_symmetric_prob_dist)

    def _current_k(self, level: int) -> int:
        c = self.hierarchy.num_components[level]
        return min(self._lss.ks[level], c)

    def _walks_knn(self) -> bool:
        """Whether walk levels take their probdist from a kNN over the walk
        metric (MERGE_RW_NEW_WALKS_AND_KNN) rather than from the walks."""
        return (self._lss.component_sim in WALK_SIMS
                and self.hierarchy.settings.rw_handling
                == RandomWalkHandling.MERGE_RW_NEW_WALKS_AND_KNN)

    def _compute_knn_on_level(self, level: int):
        """Reference: computeNearestNeighborOnLevel (:191-442).  Walk levels
        take their probdist from the walks (with force_compute_distances
        the walks also become the level's distance graph), or under
        MERGE_RW_NEW_WALKS_AND_KNN from a kNN over the walk metric.  Above
        the approximate threshold, unless exact_knn is set, the approximate
        tier (reference: computeApproximateKnn :254-334, hnswlib HNSW when
        exactKnn is false) with the JAX package's seed, the level."""
        if level == 0:
            return
        c = self.hierarchy.num_components[level]
        k = self._current_k(level)
        approximate = not self._lss.exact_knn and c > _approx_knn_threshold()
        if self._walks_knn():
            self.distance_graphs[level] = self._walk_metric_knn(
                level, k, approximate)
            self.knn_tiers[level] = "approximate" if approximate else "exact"
            return
        if self._lss.component_sim in WALK_SIMS:
            if self._lss.force_compute_distances:
                self._use_walks_as_knn_distances(level)
            return
        if self._lss.component_sim == ComponentSim.GEO_CENTROID:
            # no approximate tier: above CONTRACT_THRESHOLD components the
            # geodesic kNN takes the contracted component graph itself
            self.distance_graphs[level] = shortest_path.geodesic_hausdorff_knn(
                self._graph, self.hierarchy, level, k,
                self.hierarchy.settings.num_geodesic_samples,
                data=self._data, device=self.device)
            self.knn_tiers[level] = (
                "contracted" if c > shortest_path.CONTRACT_THRESHOLD
                else "exact")
            return
        if self._lss.component_sim == ComponentSim.EUCLID_CENTROID:
            graph = self._hausdorff_knn(level, k, approximate)
        else:
            graph = self._overlap_knn(level, k, approximate)
        self.distance_graphs[level] = graph
        self.knn_tiers[level] = "approximate" if approximate else "exact"

    def _walk_metric_knn(self, level: int, k: int, approximate: bool):
        """The level's kNN over its walk rows, by Bhattacharyya or, for
        NEIGH_WALKS_SINGLE_OVERLAP, the single overlap: exact
        (``knn_walks``) or the approximate tier over the rows' sketches."""
        single = (self._lss.component_sim
                  == ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP)
        walks = self.hierarchy.random_walks[level]
        if not approximate:
            return component_knn.knn_walks(walks, k, single_overlap=single)
        pair = (walks_single_overlap_distance if single
                else walks_bhattacharyya_distance)
        feats = component_knn.project_sparse_rows(walks, seed=level)
        return component_knn.approx_pair_metric_knn(
            lambda a, b: pair(walks, a, b), feats, k, seed=level,
            device=self.device)

    def _overlap_knn(self, level: int, k: int, approximate: bool):
        if isinstance(self._graph, KnnGraph):
            knn_idx = self._graph.indices
        else:
            knn_idx = np.where(self._graph.mask, self._graph.indices, -1)
        unions = build_union_neighborhoods(
            knn_idx, self.hierarchy.pixel_components[level],
            self.hierarchy.num_components[level], device=self.device)
        if not approximate:
            return component_knn.knn_neighbor_overlap(unions, k)
        feats = component_knn.project_sparse_rows(unions, seed=level)
        return component_knn.approx_pair_metric_knn(
            lambda a, b: neighbor_overlap_distance(unions, a, b), feats, k,
            seed=level, device=self.device)

    def _hausdorff_knn(self, level: int, k: int, approximate: bool):
        """EUCLID_CENTROID: the Hausdorff kNN of the components' sampled
        points; the approximate tier's sketch is each component's centroid
        of its samples (the JAX package's numpy expression, in chunks of
        components)."""
        rep = self._rep_samples(level)
        data = torch.as_tensor(np.asarray(self._data, np.float32),
                               device=self.device)
        if not approximate:
            return component_knn.knn_hausdorff(data, rep, k)
        feats = np.empty((rep.shape[0], self._data.shape[1]), np.float32)
        # components a chunk: about 2^26 gathered floats (256 MB)
        step = max(1, (1 << 26) // (rep.shape[1] * self._data.shape[1]))
        for c0 in range(0, rep.shape[0], step):
            r = rep[c0:c0 + step]
            mask = (r >= 0)[:, :, None]
            pts = self._data[np.maximum(r, 0)]
            feats[c0:c0 + step] = (np.where(mask, pts, 0.0).sum(1)
                                   / np.maximum(mask.sum(1), 1))
        return component_knn.approx_pair_metric_knn(
            lambda a, b: component_hausdorff(data, rep, a, b), feats, k,
            seed=level, device=self.device)

    def _rep_samples(self, level: int) -> np.ndarray:
        """Each component's represented pixels, sampled to S = min(the
        level's largest set, num_geodesic_samples when > 0) with seed
        `level`: [C, S] int64, -1 padded."""
        reps = self.hierarchy.represented_points(level)
        s = max(len(r) for r in reps)
        samples = self.hierarchy.settings.num_geodesic_samples or 0
        if samples > 0:
            s = min(s, samples)
        return sample_represented(
            reps, np.arange(self.hierarchy.num_components[level]), s,
            seed=level)

    def _use_walks_as_knn_distances(self, level: int):
        """Reference: useRandomWalksAsKnnDistances (:346-389): each row's
        walk entries as distances 1 - value, stably sorted ascending, with
        -1 / +inf where a row has no more entries."""
        walks = self.hierarchy.random_walks[level]
        dist = torch.where((walks.idx >= 0) & (walks.val != 0),
                           1.0 - walks.val, torch.inf)
        dist, order = torch.sort(dist, dim=1, stable=True)
        ids = torch.where(torch.isfinite(dist), walks.idx.gather(1, order),
                          -1)
        self.distance_graphs[level] = (ids.to(torch.int32).cpu().numpy(),
                                       dist.cpu().numpy())

    # ------------------------------------------------------------------

    def _compute_probdist_on_level(self, level: int):
        """Reference: computeProbDistOnLevel (:444-587)."""
        c = self.hierarchy.num_components[level]
        k = self._current_k(level)
        perp = self.perplexity_on_level[level]
        self.stats.perplexities.append(perp)
        self.stats.ks.append(k)

        if level == 0:
            if self._image_hierarchy is not None:
                pd = self._image_hierarchy.data_level_probdist
            else:
                pd = self._probdist_from_data_graph(perp)
        elif self._lss.component_sim in WALK_SIMS and not self._walks_knn():
            pd = self._probdist_from_walks(level, k, perp)
        else:
            pd = self._probdist_from_knn(level, perp)

        # drop zero values (reference: :566-581)
        pd = drop_zero_entries(pd, shrink=False)
        nnz = pd.row_nnz()
        # all-zero rows on a sizeable level mean an upstream op produced an
        # empty distribution: fail here, at the stage boundary, not as a
        # KL = 0 embedding downstream (tiny levels can legitimately be empty)
        if c > 32 and nnz.size and int(nnz.max()) == 0:
            raise RuntimeError(
                f"LevelSimilarities: level {level} probability rows are "
                f"all-zero ({c} components) — upstream op produced an "
                "empty distribution")
        pd = shrink_width(pd, int(nnz.max()) if nnz.size else 1)
        self.device_paths[level] = self._jax_device_resident(level)
        self.prob_dists[level] = pd
        self.stats.avg_num_neighbors.append(float(nnz.mean()))

    def device_path(self, level: int) -> bool:
        """Whether ``symmetrize_tsne`` / ``symmetrize_umap`` take the JAX
        package's device path for this level's rows: ``symmetrize_output``
        asks it, and so do the evaluation driver's per-level t-SNE and UMAP
        (``device_path=``), as the JAX package's run on its device-resident
        rows.  Decided once, when the level's rows are made
        (``_jax_device_resident``); a level cache written or loaded makes it
        False for every level (``ComputeHierarchy``)."""
        return self.device_paths[level]

    def _jax_device_resident(self, level: int) -> bool:
        """Whether the JAX package holds this level's rows only on its
        device when it symmetrizes them (its ``SparseRows.device_only``),
        so that the port takes its device path's caps here as there (in
        ``symmetrize_output``, and in its evaluation driver's per-level
        t-SNE and UMAP, which run no level cache):

        - level 0 from the image hierarchy: its data-level rows are a view
          of device arrays (its level_similarities.py:270-278); from the
          data graph, host arrays;
        - walk levels (no MERGE_RW_NEW_WALKS_AND_KNN) with pairwise walk
          similarities: the device product's rows (sparse.py:714-800);
        - walk levels from each row's top-k walk values: only where the
          level's walk rows are still device-only, i.e. simulated walks
          (MERGE_DATA_NEW_WALKS, or the top level of MERGE_RW_NEW_WALKS,
          whose lower levels the next merge reads on the host), and no
          force_compute_distances (it reads them on the host first);
        - every level from a kNN graph: Gaussian rows over host arrays.

        A level cache makes the JAX package's rows host arrays: its write
        reads them, its load is host arrays."""
        if level == 0:
            return self._image_hierarchy is not None
        if self._lss.component_sim not in WALK_SIMS or self._walks_knn():
            return False
        if self._lss.random_walk_pair_sims:
            return True
        if self._lss.force_compute_distances:
            return False
        handling = self.hierarchy.settings.rw_handling
        if handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS:
            return True
        return (handling == RandomWalkHandling.MERGE_RW_NEW_WALKS
                and level == self.hierarchy.num_levels - 1)

    def _probdist_from_data_graph(self, perp: float) -> SparseRows:
        """Reference: :528-538 — the data kNN graph normalized directly
        with the level scheme, self edge ignored."""
        if isinstance(self._graph, KnnGraph):
            idx, dist = self._graph.indices, self._graph.distances
            mask = np.ones_like(idx, dtype=bool)
        else:
            idx, mask = self._graph.indices, self._graph.mask
            dist = np.where(mask, self._graph.distances, 0.0)
        dev = self.device
        p = distance_rows_to_probabilities(
            torch.as_tensor(np.asarray(dist, np.float32), device=dev),
            torch.as_tensor(mask, device=dev),
            self._lss.normalize_prob_dist, perplexity=perp,
            ignore_first=True)
        return SparseRows(np.where(mask, idx, -1), p,
                          self.hierarchy.num_components[0], device=dev)

    def _probdist_from_walks(self, level: int, k: int, perp: float
                             ) -> SparseRows:
        """Reference: useRandomWalks (:460-508) with pairwise walk
        similarities (createSimilarities) or, without
        random_walk_pair_sims, each row's k largest walk values normalized
        to one; then Gaussian rows (TSNE) or smooth-knn memberships (UMAP);
        any other scheme leaves the similarities as they are, as in the JAX
        package."""
        walks = self.hierarchy.random_walks[level]
        if self._lss.random_walk_pair_sims:
            sizes = None
            if self._lss.weight_transition_by_size:
                sizes = self.hierarchy.component_sizes(level)
            pd = pairwise_similarities(walks, k, prune_val=1e-4,
                                       component_sizes=sizes)
        else:
            pd = self._top_walk_rows(level, k)
        mask = (pd.idx >= 0) & (pd.val != 0)
        scheme = self._lss.normalize_prob_dist
        if scheme == NormalizationScheme.TSNE:
            p = gaussian_row_distributions(pd.val, mask, perp,
                                           ignore_first=False)
        elif scheme == NormalizationScheme.UMAP:
            p = smooth_knn_rows_bucketed(pd.val, mask)
        else:
            Log.warn("LevelSimilarities: normalize_prob_dist should be TSNE "
                     "or UMAP; skipping normalization")
            return pd
        return SparseRows(pd.idx, p, pd.num_cols)

    def _top_walk_rows(self, level: int, k: int) -> SparseRows:
        """Each walk row's k largest values, normalized to one, with the
        JAX package's float32 sums over the width of its top-k rows: in
        XLA's order where its walk rows of the level came from a walk
        simulation and stayed on the device (MERGE_DATA_NEW_WALKS, and the
        top level of the other handlings that walk again), else in numpy
        (merged rows, and rows loaded from a stage cache)."""
        walks = self.hierarchy.random_walks[level]
        top = topk_rows(walks, k, largest=True)
        handling = self.hierarchy.settings.rw_handling
        ih = self._image_hierarchy
        lengths = ih._rw_lengths if ih is not None else []
        simulated = (handling != RandomWalkHandling.MERGE_RW_ONLY
                     and level < len(lengths))
        width = walks.width
        if simulated:
            rws = RandomWalkSettings(**{**ih._rws.__dict__})
            rws.single_walk_length = lengths[level]
            width = stored_width(width, walks.num_rows, rws)
        v = torch.nn.functional.pad(torch.where(top.idx >= 0, top.val, 0.0),
                                    (0, min(k, width) - top.width))
        on_device = simulated and (
            handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS
            or level == self.hierarchy.num_levels - 1)
        s = row_sum(v) if on_device else np_row_sum(v)
        s = torch.where(s == 0, 1.0, s)[:, None]
        return SparseRows(top.idx, top.val / s, top.num_cols)

    def _probdist_from_knn(self, level: int, perp: float) -> SparseRows:
        """Reference: useKnnDistances (:510-515) — Gaussian rows over the
        per-level distance graph, ignore index 0 (self)."""
        ids, dists = self.distance_graphs[level]
        mask = ids >= 0
        dev = self.device
        mask_t = torch.as_tensor(mask, device=dev)
        p = gaussian_row_distributions(
            torch.as_tensor(np.where(mask, dists, 0.0).astype(np.float32),
                            device=dev), mask_t, perp, ignore_first=True)
        c = self.hierarchy.num_components[level]
        return SparseRows(np.where(mask, ids, -1), p, c, device=dev)

    # ------------------------------------------------------------------

    def symmetrize_output(self, method: NormalizationScheme):
        """Reference: symmetrizeOutput (:589-623)."""
        if method == NormalizationScheme.NONE:
            return
        if self._symmetric != NormalizationScheme.NONE:
            Log.info("LevelSimilarities: already symmetric")
            return
        if self._lss.normalize_prob_dist != method:
            Log.info("LevelSimilarities: probdist normalized with %s, "
                     "won't symmetrize for %s",
                     self._lss.normalize_prob_dist.value, method.value)
            return
        # LINEAR rows are left as they are, as in the JAX package
        sym = {NormalizationScheme.TSNE: symmetrize_tsne,
               NormalizationScheme.UMAP: symmetrize_umap}.get(method)
        for i, pd in enumerate(self.prob_dists):
            if pd is not None and sym is not None:
                self.prob_dists[i] = sym(pd, device_path=self.device_paths[i])
        self._symmetric = method

    def get_prob_dist(self, level: int) -> SparseRows:
        pd = self.prob_dists[level]
        if pd is None:
            raise RuntimeError(f"prob dist for level {level} not computed")
        return pd

    def write_stats(self, file_name: str) -> bool:
        """The stats as JSON (reference: LevelSimilarities::writeStats)."""
        try:
            with open(file_name, "w") as f:
                json.dump(self.stats.to_dict(), f, indent=2)
            return True
        except OSError:
            return False
