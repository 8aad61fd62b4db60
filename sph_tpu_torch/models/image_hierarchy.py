"""ImageHierarchy — stage 2: Borůvka-style agglomeration over the pixel grid.

Port of sph_tpu/models/image_hierarchy.py (reference: sph/ImageHierarchy.cpp
— computePreparations (:149-190), the computeBoruvkaHierarchy level loop
(:409-591) with mergeMinBelow (:312-362) / mergeAllBelow (:261-310),
percentile thresholds (:371-394), weak-CC labels of the merge graph and the
stagnation / min-comp / max-level stopping rules (:418-453)).

Each level evaluates the component distances of all spatial-neighbor edges
in one batched device call (ops/similarities); the level loop, the merge
selection and its numpy RNG stay on the host, as in the JAX package.  The
NEIGH_WALKS, NEIGH_OVERLAP and EUCLID_CENTROID metrics are ported; the
others raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..settings import (ComponentSim, ImageHierarchySettings,
                        RandomWalkHandling, RandomWalkSettings)
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops import similarities as sims
from ..ops.distributions import distance_rows_to_probabilities
from ..ops.graph import KnnGraph, PaddedGraph, edge_list_components
from ..ops.math import compute_quantile
from ..ops.sparse import SparseRows
from ..ops.walks import do_random_walks
from .hierarchy import WALK_SIMS, Hierarchy, HierarchySettings

_FLOAT_MAX = np.float32(np.finfo(np.float32).max)


@dataclass
class ImageHierarchyStats:
    """Reference: ImageHierarchy.hpp:24-33."""

    zero_similarity_count: list[int] = field(default_factory=list)
    forced_merge_count: list[int] = field(default_factory=list)
    reduction_rates: list[float] = field(default_factory=list)
    rw_sparsities: list[float] = field(default_factory=list)
    num_components: list[int] = field(default_factory=list)
    not_merged_components: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "zeroSimilarityCount": self.zero_similarity_count,
            "forcedMergeCount": self.forced_merge_count,
            "reductionRates": self.reduction_rates,
            "rwSparsities": self.rw_sparsities,
            "numComponents": self.num_components,
            "notMergedComponents": self.not_merged_components,
            "numLevels": len(self.num_components),
        }


def _graph_rows(graph: KnnGraph | PaddedGraph):
    """(indices, distances with 0 at pads, mask) of a data-level graph."""
    if isinstance(graph, KnnGraph):
        return (graph.indices, graph.distances,
                np.ones_like(graph.indices, dtype=bool))
    return (graph.indices, np.where(graph.mask, graph.distances, 0.0),
            graph.mask)


class ImageHierarchy:
    """Stage-2 engine (reference: sph/ImageHierarchy.hpp:38)."""

    def __init__(self, data_knn_graph: KnnGraph | PaddedGraph,
                 data: np.ndarray, rows: int, cols: int,
                 graph_has_wcc: bool = False, device=None):
        self._graph = data_knn_graph
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._data_on_device: Optional[torch.Tensor] = None
        self._rows = rows
        self._cols = cols
        self._graph_has_wcc = graph_has_wcc
        assert self._data.shape[0] == rows * cols
        self.device = resolve_device(device)
        self._ihs = ImageHierarchySettings()
        self._rws = RandomWalkSettings()
        self.hierarchy = Hierarchy()
        self.stats = ImageHierarchyStats()
        self.data_level_probdist: Optional[SparseRows] = None
        self.component_labels: Optional[np.ndarray] = None  # WCC of data knn

    def set_settings(self, ihs: Optional[ImageHierarchySettings] = None,
                     rws: Optional[RandomWalkSettings] = None):
        if ihs is not None:
            self._ihs = ihs
        if rws is not None:
            self._rws = rws
            if self._rws.single_walk_length < (
                    self._rws.minimum_single_walk_length):
                Log.warn("ImageHierarchy: single_walk_length < minimum, "
                         "adjusting minimum")
                self._rws.minimum_single_walk_length = (
                    self._rws.single_walk_length)

    def compute(self, ihs: Optional[ImageHierarchySettings] = None,
                rws: Optional[RandomWalkSettings] = None):
        self.set_settings(ihs, rws)
        cs = self._ihs.component_sim
        if cs not in (ComponentSim.NEIGH_WALKS, ComponentSim.NEIGH_OVERLAP,
                      ComponentSim.EUCLID_CENTROID):
            raise NotImplementedError(
                f"component similarity {cs.value} not ported yet; see "
                "ROADMAP")
        if (cs in WALK_SIMS and self._ihs.rw_handling
                != RandomWalkHandling.MERGE_RW_ONLY):
            raise NotImplementedError(
                f"rw_handling {self._ihs.rw_handling.value} not ported "
                "yet; see ROADMAP")
        self.hierarchy = Hierarchy(HierarchySettings(
            num_rows=self._rows, num_cols=self._cols,
            neighbor_connection=self._ihs.neighbor_connection,
            component_sim=cs,
            rw_norm_sim=self._ihs.rw_norm_sim,
            rw_weight_merge_by_size=self._ihs.rw_weight_merge_by_size,
            rw_handling=self._ihs.rw_handling,
            rw_remove_self_sim_after_merging=(
                self._ihs.rw_remove_self_sim_after_merging),
            num_geodesic_samples=self._ihs.num_geodesic_samples,
            verbose=self._ihs.verbose))
        self.stats = ImageHierarchyStats()
        Log.info("ImageHierarchy::compute: %s similarity, %s threshold %s, "
                 "mergeMultiple=%s", cs.value,
                 "percentile" if self._ihs.use_percentile else "absolute",
                 self._ihs.max_dist, self._ihs.merge_multiple)
        with phase("ih.preparations"):
            self._compute_preparations()
        self._compute_boruvka()

    def _compute_preparations(self):
        """Reference: ImageHierarchy.cpp:149-190."""
        n = self._data.shape[0]
        dev = self.device
        knn_idx, knn_dist, mask = _graph_rows(self._graph)
        mask_t = torch.as_tensor(mask, device=dev)
        probs = distance_rows_to_probabilities(
            torch.as_tensor(np.asarray(knn_dist, np.float32), device=dev),
            mask_t, self._ihs.norm_knn_distances, perplexity=-1.0,
            ignore_first=True, umap_row_norm=True)
        idx_t = torch.as_tensor(np.asarray(knn_idx, np.int64), device=dev)
        self.data_level_probdist = SparseRows(
            torch.where(mask_t, idx_t, -1), probs, n)

        self.hierarchy.clear()
        self.hierarchy.init_first_level(n)
        if self._ihs.component_sim in WALK_SIMS:
            Log.info("ImageHierarchy::computePreparations: random walks on "
                     "data level")
            walks = do_random_walks(self.data_level_probdist, self._rws,
                                    self._ihs.verbose)
            self.hierarchy.random_walks.append(walks)
            self.stats.rw_sparsities.append(1.0 - walks.nnz() / (float(n) * n))

    # ------------------------------------------------------------------

    def _compute_boruvka(self):
        """Reference: computeBoruvkaHierarchy, ImageHierarchy.cpp:409-591."""
        num_trees = self._data.shape[0]
        min_num_comp = max(self._ihs.min_num_comp, 1)
        rng = np.random.default_rng(self._rws.random_seed + 7919)
        level = 0
        while num_trees > min_num_comp:
            if 0 <= self._ihs.max_levels <= level:
                Log.info("ImageHierarchy: reached max level %d, stopping",
                         level)
                break
            c = self.hierarchy.num_components[level]
            with phase("ih.distances"):
                edges_src, edges_dst, edge_dist = self._compute_distances(
                    level)

            thresh = float(_FLOAT_MAX)
            if self._ihs.max_dist > 0:
                thresh = self._ihs.max_dist
                if self._ihs.use_percentile:
                    q = compute_quantile(
                        edge_dist, self._ihs.max_dist,
                        ignore_vals=(0.0, -1.0, float(_FLOAT_MAX)))
                    if q < 0:
                        Log.warn("ImageHierarchy: percentile not found, "
                                 "using float max")
                        q = float(_FLOAT_MAX)
                    thresh = q

            with phase("ih.select"):
                merge_src, merge_dst, zero_cnt, forced_cnt = (
                    self._select_merges(c, edges_src, edges_dst, edge_dist,
                                        thresh, rng))
            self.stats.zero_similarity_count.append(zero_cnt)
            self.stats.forced_merge_count.append(forced_cnt)

            with phase("ih.components"):
                ncc, labels = edge_list_components(c, merge_src, merge_dst)
            reduction = 100.0 * ncc / self.hierarchy.num_components[-1]
            self.stats.reduction_rates.append(reduction)
            Log.info("ImageHierarchy: %d trees on next level %d "
                     "(reduction to %.2f%%)", ncc, level + 1, reduction)
            if self._reduction_stagnates():
                Log.info("ImageHierarchy: no significant reduction — "
                         "level not added, stopping")
                break

            # MERGE_RW_ONLY merges walks and never re-simulates them, so the
            # walk-length schedule (ImageHierarchy.cpp:504-548) has no effect
            with phase("ih.add_level"):
                self.hierarchy.add_level(ncc, labels)
            self.stats.not_merged_components.append(
                len(self.hierarchy.not_merged[-1]))
            if len(self.hierarchy.random_walks) > 1:
                w = self.hierarchy.random_walks[-1]
                self.stats.rw_sparsities.append(
                    1.0 - w.nnz() / float(ncc) ** 2)
            num_trees = ncc
            level += 1
        self.stats.num_components = list(self.hierarchy.num_components)
        Log.info("ImageHierarchy: finished with %d levels (incl. data level)",
                 self.hierarchy.num_levels)

    def _reduction_stagnates(self) -> bool:
        """Reference: ImageHierarchy.cpp:418-424."""
        rr = self.stats.reduction_rates
        if rr[-1] == 100.0:
            return True
        return (len(rr) > 2 and rr[-1] > self._ihs.min_reduction
                and rr[-2] > self._ihs.min_reduction)

    # ------------------------------------------------------------------

    def _compute_distances(self, level: int):
        """Batched per-edge component distances (reference: computeDistances,
        ImageHierarchy.cpp:192-249).  Returns (src [E], dst [E], dist [E])
        over all spatial-neighbor pairs."""
        adj = self.hierarchy.spatial_neighbors_of(level)
        c, deg = adj.shape
        src = np.repeat(np.arange(c, dtype=np.int64), deg)
        dst = adj.ravel()
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        cs = self._ihs.component_sim
        if cs == ComponentSim.NEIGH_WALKS:
            dist = sims.walks_bhattacharyya_distance(
                self.hierarchy.random_walks[level], src, dst)
        elif cs == ComponentSim.EUCLID_CENTROID:
            dist = self._hausdorff_distances(level, src, dst)
        else:
            dist = sims.neighbor_overlap_distance(
                self._union_neighborhoods(level), src, dst)
        return src, dst, dist.astype(np.float32)

    def _hausdorff_distances(self, level: int, a: np.ndarray,
                             b: np.ndarray) -> np.ndarray:
        """EUCLID_CENTROID: the Hausdorff distance of each pair's represented
        pixels, each set sampled to S = min(the level's largest set,
        num_geodesic_samples when > 0) points with the JAX package's seeds
        (random_seed + level for the first sets, + level + 1 for the
        second)."""
        reps = self.hierarchy.represented_points(level)
        s = max(len(r) for r in reps)
        samples = self._ihs.num_geodesic_samples or 0
        if samples > 0:
            s = min(s, samples)
        seed = self._rws.random_seed + level
        rep_a = sims.sample_represented(reps, a, s, seed=seed)
        rep_b = sims.sample_represented(reps, b, s, seed=seed + 1)
        if self._data_on_device is None:
            self._data_on_device = torch.as_tensor(self._data,
                                                   device=self.device)
        return sims.hausdorff_point_set_distance(self._data_on_device,
                                                 rep_a, rep_b)

    def _union_neighborhoods(self, level: int) -> SparseRows:
        knn_idx, _, mask = _graph_rows(self._graph)
        return sims.build_union_neighborhoods(
            np.where(mask, knn_idx, -1), self.hierarchy.pixel_components[level],
            self.hierarchy.num_components[level], device=self.device)

    def _select_merges(self, c: int, src, dst, dist, thresh: float, rng):
        """Merge-edge selection (reference: mergeMinBelow :312-362 /
        mergeAllBelow :261-310).  Returns (merge_src, merge_dst,
        zero_sim_count, forced_merge_count)."""
        order = np.lexsort((dst, dist, src))
        src_s, dst_s, dist_s = src[order], dst[order], dist[order]
        below = dist_s < thresh
        if self._ihs.merge_multiple:
            msrc = src_s[below]
            mdst = dst_s[below]
            have = np.zeros(c, dtype=bool)
            have[msrc] = True
        else:
            # edges sorted by (src, dist): the first below-threshold edge
            # of each src is its minimum
            first_idx = np.full(c, -1, dtype=np.int64)
            cand = np.nonzero(below)[0]
            s_cand = src_s[cand]
            first_of_src = np.ones(len(cand), dtype=bool)
            first_of_src[1:] = s_cand[1:] != s_cand[:-1]
            sel = cand[first_of_src]
            first_idx[src_s[sel]] = sel
            have = first_idx >= 0
            msrc = src_s[first_idx[have]]
            mdst = dst_s[first_idx[have]]

        # reference counter semantics (ImageHierarchy.cpp:289-291, :343-351)
        unmerged = int(c - int(have.sum()))
        if self._ihs.merge_multiple or thresh >= float(_FLOAT_MAX):
            zero_cnt = unmerged
        else:
            zero_cnt = 0
        forced_cnt = 0
        if unmerged and self._ihs.is_always_merge:
            # forced random merge with a spatial neighbor (reference:
            # RandomMergeNeighbor, ImageHierarchy.cpp:251-259)
            adj = self.hierarchy.spatial_neighbors_of(
                len(self.hierarchy.parents))
            extra_src, extra_dst = [], []
            for comp in np.nonzero(~have)[0]:
                neighs = adj[comp][adj[comp] >= 0]
                if len(neighs) == 0:
                    continue
                extra_src.append(comp)
                extra_dst.append(rng.choice(neighs))
                forced_cnt += 1
            if extra_src:
                msrc = np.concatenate([msrc, np.array(extra_src)])
                mdst = np.concatenate([mdst, np.array(extra_dst)])
        Log.info("ImageHierarchy: %d components with no similarity on "
                 "current level (%.2f%%)", zero_cnt, 100.0 * zero_cnt / c)
        return (msrc.astype(np.int64), mdst.astype(np.int64), zero_cnt,
                forced_cnt)
