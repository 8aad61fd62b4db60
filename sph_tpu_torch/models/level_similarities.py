"""LevelSimilarities — stage 3: per-level probability distributions.

Port of sph_tpu/models/level_similarities.py (reference:
sph/LevelSimilarities.cpp — auto k/perplexity schedule (:83-115), per-level
kNN (:191-442), probability distributions (:444-587: level 0 reuses the
ImageHierarchy data-level probdist; WALKS levels use pairwise random-walk
Bhattacharyya; kNN-metric levels use Gaussian-perplexity rows) and TSNE
symmetrization (:589-623)).

Ported: NEIGH_WALKS with pairwise walk similarities, NEIGH_OVERLAP with its
exact per-level kNN, the TSNE normalization and symmetrization.
"""

from __future__ import annotations

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
from ..ops.similarities import build_union_neighborhoods
from ..ops.sparse import (SparseRows, drop_zero_entries,
                          pairwise_similarities, shrink_width,
                          symmetrize_tsne)
from .hierarchy import WALK_SIMS, Hierarchy


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
        self.perplexity_on_level: list[float] = []
        self._symmetric: NormalizationScheme = NormalizationScheme.NONE
        self.init_output()

    def set_image_hierarchy(self, ih):
        self._image_hierarchy = ih

    def init_output(self):
        num_levels = self.hierarchy.num_levels
        self.prob_dists = [None] * num_levels
        self.distance_graphs = [None] * num_levels
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
        if cs not in (ComponentSim.NEIGH_WALKS, ComponentSim.NEIGH_OVERLAP):
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
        need no distance graph: their probdist comes from the walks."""
        if level == 0 or self._lss.component_sim in WALK_SIMS:
            return
        if isinstance(self._graph, KnnGraph):
            knn_idx = self._graph.indices
        else:
            knn_idx = np.where(self._graph.mask, self._graph.indices, -1)
        unions = build_union_neighborhoods(
            knn_idx, self.hierarchy.pixel_components[level],
            self.hierarchy.num_components[level], device=self.device)
        self.distance_graphs[level] = component_knn.knn_neighbor_overlap(
            unions, self._current_k(level))

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
