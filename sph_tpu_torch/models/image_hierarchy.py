"""ImageHierarchy — stage 2: Borůvka-style agglomeration over the pixel grid.

Port of sph_tpu/models/image_hierarchy.py (reference: sph/ImageHierarchy.cpp
— computePreparations (:149-190), the computeBoruvkaHierarchy level loop
(:409-591) with mergeMinBelow (:312-362) / mergeAllBelow (:261-310),
percentile thresholds (:371-394), weak-CC labels of the merge graph, the
stagnation / min-comp / max-level stopping rules (:418-453) and the
seven-policy walk-length schedule (:504-548)).

Each level evaluates the component distances of all spatial-neighbor edges
in one batched device call (ops/similarities, ops/shortest_path); the level
loop, the merge selection and its numpy RNG stay on the host, as in the JAX
package.  Every component metric is ported (NEIGH_WALKS,
NEIGH_WALKS_SINGLE_OVERLAP, NEIGH_OVERLAP, EUCLID_CENTROID, GEO_CENTROID,
GEO_WALKS), with every walk handling.  The data-level probdist takes any of
the normalization schemes (ops/distributions.distance_rows_to_probabilities).
The multi-scene preset preparations are ported too (set_preparations,
which parallel/sharded.multi_scene_hierarchy calls for every scene).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..settings import (ComponentSim, ImageHierarchySettings,
                        RandomWalkHandling, RandomWalkReduction,
                        RandomWalkSettings)
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops import shortest_path
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
    # never filled, in the JAX package too: kept for the stats file's keys
    merged_data_sparsities: list[float] = field(default_factory=list)
    num_components: list[int] = field(default_factory=list)
    not_merged_components: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "zeroSimilarityCount": self.zero_similarity_count,
            "forcedMergeCount": self.forced_merge_count,
            "reductionRates": self.reduction_rates,
            "rwSparsities": self.rw_sparsities,
            "mergedDataSparsities": self.merged_data_sparsities,
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
        # the walk length of each level's walks (level 0 first)
        self._rw_lengths: list[int] = []
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

    def set_preparations(self, data_level_probdist: SparseRows,
                         walks: Optional[SparseRows] = None):
        """Stage-1 preparations made elsewhere: the data-level probability
        rows and, optionally, the data-level random walks.  compute() then
        takes them and skips the normalisation and the walks.  The batched
        multi-scene path (parallel/sharded.multi_scene_stage1) makes them
        for every scene at once."""
        self._preset_probdist = data_level_probdist
        self._preset_walks = walks

    def _compute_preparations(self):
        """Reference: ImageHierarchy.cpp:149-190."""
        if getattr(self, "_preset_probdist", None) is not None:
            self._prepare_from_preset(self._preset_probdist)
            return
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
            self._rw_lengths = [self._rws.single_walk_length]
            walks = do_random_walks(self.data_level_probdist, self._rws,
                                    self._ihs.verbose)
            self.hierarchy.random_walks.append(walks)
            self.stats.rw_sparsities.append(1.0 - walks.nnz() / (float(n) * n))
            if (self._ihs.rw_handling
                    == RandomWalkHandling.MERGE_DATA_NEW_WALKS):
                # the data distances, kept for the min merges (reference:
                # :177-178)
                self.hierarchy.merged_data_graphs.append(SparseRows(
                    torch.where(mask_t, idx_t, -1),
                    torch.where(mask_t, torch.as_tensor(
                        np.asarray(knn_dist, np.float32), device=dev), 0.0),
                    n))

    def _prepare_from_preset(self, preset_pd: SparseRows):
        """Preparations from injected stage-1 outputs (JAX:
        _prepare_from_preset): the walks are simulated only when none were
        given."""
        n = self._data.shape[0]
        if preset_pd.num_rows != n:
            raise ValueError(f"preset probabilities have "
                             f"{preset_pd.num_rows} rows, not {n}")
        self.data_level_probdist = preset_pd
        self.hierarchy.clear()
        self.hierarchy.init_first_level(n)
        if self._ihs.component_sim not in WALK_SIMS:
            return
        self._rw_lengths = [self._rws.single_walk_length]
        walks = getattr(self, "_preset_walks", None)
        if walks is None:
            walks = do_random_walks(self.data_level_probdist, self._rws,
                                    self._ihs.verbose)
        self.hierarchy.random_walks.append(walks)
        self.stats.rw_sparsities.append(1.0 - walks.nnz() / (float(n) * n))
        if self._ihs.rw_handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS:
            knn_idx, knn_dist, mask = _graph_rows(self._graph)
            self.hierarchy.merged_data_graphs.append(SparseRows(
                np.where(mask, knn_idx, -1),
                np.where(mask, knn_dist, 0.0).astype(np.float32), n,
                device=self.device))

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

            self._adapt_walk_length(reduction)
            rws_next = RandomWalkSettings(**{**self._rws.__dict__})
            if self._rw_lengths:
                rws_next.single_walk_length = self._rw_lengths[-1]
            with phase("ih.add_level"):
                self.hierarchy.add_level(ncc, labels, rws_next)
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

    def _adapt_walk_length(self, reduction_rate_pct: float):
        """The next level's walk length (reference: ImageHierarchy.cpp:
        504-548, seven policies): the current length times a rate (the
        level's reduction, twice or half of it, or a constant), clamped to
        [minimum_single_walk_length, the data level's length].  Only walk
        metrics that walk again (not MERGE_RW_ONLY) keep a schedule."""
        if self._ihs.component_sim not in WALK_SIMS:
            return
        if self._ihs.rw_handling == RandomWalkHandling.MERGE_RW_ONLY:
            return
        cur = self._rw_lengths[-1]
        pol = self._ihs.rw_reduction
        r = reduction_rate_pct / 100.0
        rate = {
            RandomWalkReduction.NONE: 1.0,
            RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION: r,
            RandomWalkReduction.PROPORTIONAL_DOUBLE: r * 2.0,
            RandomWalkReduction.PROPORTIONAL_HALF: r * 0.5,
            RandomWalkReduction.CONSTANT: 0.5,
            RandomWalkReduction.CONSTANT_LOW: 0.75,
            RandomWalkReduction.CONSTANT_HIGH: 0.25,
        }[pol]
        rate = min(max(rate, 0.0), 1.0)
        nxt = min(max(int(rate * cur), self._rws.minimum_single_walk_length),
                  self._rw_lengths[0])
        self._rw_lengths.append(nxt)
        Log.info("ImageHierarchy: walk length %d -> %d (%s)", cur, nxt,
                 pol.value)

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
        elif cs == ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP:
            dist = sims.walks_single_overlap_distance(
                self.hierarchy.random_walks[level], src, dst)
        elif cs == ComponentSim.EUCLID_CENTROID:
            dist = self._hausdorff_distances(level, src, dst)
        elif cs in (ComponentSim.GEO_CENTROID, ComponentSim.GEO_WALKS):
            dist = self._geodesic_distances(level, src, dst)
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

    def _geodesic_distances(self, level: int, a: np.ndarray,
                            b: np.ndarray) -> np.ndarray:
        """GEO_CENTROID / GEO_WALKS: geodesic Hausdorff of each pair's
        sampled pixels over the data graph; above CONTRACT_THRESHOLD
        components at level > 0 from the pixel-graph sketch."""
        c = self.hierarchy.num_components[level]
        kw = dict(num_samples=self._ihs.num_geodesic_samples,
                  component_labels=self.component_labels,
                  seed=self._rws.random_seed, device=self.device)
        if level > 0 and c > shortest_path.CONTRACT_THRESHOLD:
            return shortest_path.sketch_geodesic_pairs(
                self._graph, self.hierarchy, self._data, level, a, b, **kw)
        return shortest_path.geodesic_component_distances(
            self._graph, self._data, self.hierarchy, level, a, b, **kw)

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

    def write_stats(self, file_name: str) -> bool:
        """Reference: ImageHierarchy::writeStats (:607-630)."""
        try:
            with open(file_name, "w") as f:
                json.dump(self.stats.to_dict(), f, indent=2)
            return True
        except OSError:
            return False
