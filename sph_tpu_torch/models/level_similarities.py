"""LevelSimilarities — stage 3: per-level probability distributions.

Port of sph_tpu/models/level_similarities.py (reference:
sph/LevelSimilarities.cpp — auto k/perplexity schedule (:83-115), per-level
kNN (:191-442), probability distributions (:444-587: level 0 reuses the
ImageHierarchy data-level probdist; WALKS levels use pairwise random-walk
Bhattacharyya; kNN-metric levels use Gaussian-perplexity rows) and TSNE
symmetrization (:589-623)).

Ported: NEIGH_WALKS with pairwise walk similarities (and, with
force_compute_distances, the walks as the level's distance graph),
NEIGH_OVERLAP and EUCLID_CENTROID with their per-level kNN (exact, or the
approximate tier above SPH_APPROX_KNN_THRESHOLD components unless exact_knn
is set), the TSNE normalization and symmetrization.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..settings import (ComponentSim, LevelSimilaritiesSettings,
                        NormalizationScheme)
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops import component_knn
from ..ops.distributions import gaussian_row_distributions
from ..ops.graph import KnnGraph, PaddedGraph
from ..ops.similarities import (build_union_neighborhoods,
                                component_hausdorff,
                                neighbor_overlap_distance,
                                sample_represented)
from ..ops.sparse import (SparseRows, drop_zero_entries,
                          pairwise_similarities, shrink_width,
                          symmetrize_tsne)
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
        # "approximate", or None where the level has none
        self.knn_tiers: list[Optional[str]] = []
        self.perplexity_on_level: list[float] = []
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
        cs = self._lss.component_sim
        if cs not in (ComponentSim.NEIGH_WALKS, ComponentSim.NEIGH_OVERLAP,
                      ComponentSim.EUCLID_CENTROID):
            raise NotImplementedError(
                f"level similarity {cs.value} not ported yet; see ROADMAP")
        if cs == ComponentSim.NEIGH_WALKS and not (
                self._lss.random_walk_pair_sims):
            raise NotImplementedError(
                "top-k walk rows as level probdist not ported yet; see "
                "ROADMAP")
        if self._lss.normalize_prob_dist != NormalizationScheme.TSNE:
            raise NotImplementedError(
                f"normalization {self._lss.normalize_prob_dist.value} not "
                "ported yet; see ROADMAP")
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

    def _compute_knn_on_level(self, level: int):
        """Reference: computeNearestNeighborOnLevel (:191-442).  Walk levels
        take their probdist from the walks; with force_compute_distances
        the walks also become the level's distance graph.  Above the
        approximate threshold, unless exact_knn is set, the approximate
        tier (reference: computeApproximateKnn :254-334, hnswlib HNSW when
        exactKnn is false) with the JAX package's seed, the level."""
        if level == 0:
            return
        if self._lss.component_sim in WALK_SIMS:
            if self._lss.force_compute_distances:
                self._use_walks_as_knn_distances(level)
            return
        c = self.hierarchy.num_components[level]
        k = self._current_k(level)
        approximate = not self._lss.exact_knn and c > _approx_knn_threshold()
        if self._lss.component_sim == ComponentSim.EUCLID_CENTROID:
            graph = self._hausdorff_knn(level, k, approximate)
        else:
            graph = self._overlap_knn(level, k, approximate)
        self.distance_graphs[level] = graph
        self.knn_tiers[level] = "approximate" if approximate else "exact"

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
            if self._image_hierarchy is None:
                raise NotImplementedError(
                    "level-0 probdist without the image hierarchy's "
                    "data-level rows not ported yet; see ROADMAP")
            pd = self._image_hierarchy.data_level_probdist
        elif self._lss.component_sim in WALK_SIMS:
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
        self.prob_dists[level] = shrink_width(
            pd, int(nnz.max()) if nnz.size else 1)
        self.stats.avg_num_neighbors.append(float(nnz.mean()))

    def _probdist_from_walks(self, level: int, k: int, perp: float
                             ) -> SparseRows:
        """Reference: useRandomWalks (:460-508) with pairwise walk
        similarities (createSimilarities), then Gaussian rows."""
        walks = self.hierarchy.random_walks[level]
        sizes = None
        if self._lss.weight_transition_by_size:
            sizes = self.hierarchy.component_sizes(level)
        pd = pairwise_similarities(walks, k, prune_val=1e-4,
                                   component_sizes=sizes)
        mask = (pd.idx >= 0) & (pd.val != 0)
        p = gaussian_row_distributions(pd.val, mask, perp,
                                       ignore_first=False)
        return SparseRows(pd.idx, p, pd.num_cols)

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
        if method != NormalizationScheme.TSNE:
            raise NotImplementedError(
                f"{method.value} symmetrization not ported yet; see ROADMAP")
        for i, pd in enumerate(self.prob_dists):
            if pd is not None:
                self.prob_dists[i] = symmetrize_tsne(pd)
        self._symmetric = method

    def get_prob_dist(self, level: int) -> SparseRows:
        pd = self.prob_dists[level]
        if pd is None:
            raise RuntimeError(f"prob dist for level {level} not computed")
        return pd
