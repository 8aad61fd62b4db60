"""The Hierarchy data structure.

Port of sph_tpu/models/hierarchy.py (reference: sph/utils/Hierarchy.hpp:37-142
/ Hierarchy.cpp — per level: numComponents, parents, spatialNeighbors,
pixelComponents, randomWalks, notMergedNodes; `addLevel` performs
updateParentsAndChildren, updateSpatialNeighbors and updateRandomWalks).

The per-level label arrays are host numpy (the level loop's control plane);
the walk matrices are SparseRows on the device.  All four walk handlings
are ported: MERGE_RW_ONLY (merged walks are summed child rows),
MERGE_RW_NEW_WALKS and MERGE_RW_NEW_WALKS_AND_KNN (new walks on the merged
rows) and MERGE_DATA_NEW_WALKS (new walks on the min-merged data distance
graph).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..settings import (ComponentSim, NeighConnection, NormType,
                        RandomWalkHandling, RandomWalkSettings)
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops.distributions import gaussian_row_distributions
from ..ops.sparse import (SparseRows, host_normalize, merge_rows_by_parents,
                          merge_rows_min_by_parents, normalize_matrix,
                          normalize_rows, remove_diagonal)
from ..ops.walks import do_random_walks

# pixel-grid offsets (reference: sph/utils/ImageHelper.hpp:11-52)
_OFFSETS_FOUR = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], dtype=np.int64)
_OFFSETS_EIGHT = np.array([(-1, -1), (-1, 0), (-1, 1), (0, -1),
                           (0, 1), (1, -1), (1, 0), (1, 1)], dtype=np.int64)
MERGE_WIDTH_BUDGET = 2 ** 28   # sph_tpu's SPH_MERGE_WIDTH_BUDGET default

WALK_SIMS = (ComponentSim.NEIGH_WALKS, ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP,
             ComponentSim.GEO_WALKS)


def pixel_neighbor_table(rows: int, cols: int,
                         connection: NeighConnection) -> np.ndarray:
    """[N, deg] table of pixel-grid neighbor ids, -1 where out of bounds
    (reference: pixelNeighborIDs, ImageHelper.cpp:8-28)."""
    offs = (_OFFSETS_FOUR if connection == NeighConnection.FOUR
            else _OFFSETS_EIGHT)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    rr = rr.ravel()
    cc = cc.ravel()
    out = np.full((rows * cols, len(offs)), -1, dtype=np.int64)
    for j, (dr, dc) in enumerate(offs):
        nr, nc = rr + dr, cc + dc
        ok = (nr >= 0) & (nr < rows) & (nc >= 0) & (nc < cols)
        out[ok, j] = nr[ok] * cols + nc[ok]
    return out


@dataclass
class HierarchySettings:
    """Reference: Hierarchy.hpp settings block (wired by
    ImageHierarchy::updateHierarchySettings, ImageHierarchy.cpp:98-111)."""

    num_rows: int = 0
    num_cols: int = 0
    neighbor_connection: NeighConnection = NeighConnection.FOUR
    component_sim: ComponentSim = ComponentSim.NEIGH_OVERLAP
    rw_norm_sim: NormType = NormType.ONEDIM
    rw_weight_merge_by_size: bool = True
    rw_handling: RandomWalkHandling = RandomWalkHandling.MERGE_RW_ONLY
    rw_remove_self_sim_after_merging: bool = True
    num_geodesic_samples: int = 0
    verbose: bool = False


class Hierarchy:
    """Multi-level container: host label arrays, device walk matrices."""

    def __init__(self, settings: Optional[HierarchySettings] = None):
        self.settings = settings or HierarchySettings()
        self.num_components: list[int] = []
        # parents[l]: [C_l] -> component id on level l+1
        self.parents: list[np.ndarray] = []
        # pixel_components[l]: [N] pixel -> component id on level l
        self.pixel_components: list[np.ndarray] = []
        # spatial_neighbors[l]: padded [C_{l+1}, D] adjacency (no self), -1 pad
        self.spatial_neighbors: list[np.ndarray] = []
        # random_walks[l]: SparseRows on level l's components
        self.random_walks: list[SparseRows] = []
        self.not_merged: list[np.ndarray] = []
        # MERGE_DATA_NEW_WALKS: the min-merged data distance rows per level
        self.merged_data_graphs: list[SparseRows] = []
        self._pixel_neighbors: Optional[np.ndarray] = None

    @property
    def num_levels(self) -> int:
        return len(self.num_components)

    def children_of(self, level: int) -> list[np.ndarray]:
        """Per component on `level` (> 0), the ids of its children on the
        level below (reference: Hierarchy::childrenOn)."""
        if level <= 0:
            raise ValueError("level 0 has no children")
        par = self.parents[level - 1]
        order = np.argsort(par, kind="stable")
        counts = np.bincount(par, minlength=self.num_components[level])
        return np.split(order, np.cumsum(counts)[:-1])

    def represented_points(self, level: int) -> list[np.ndarray]:
        """Per component on `level`, the data-level pixel ids it represents
        (reference: updateComponentMap)."""
        if level == 0:
            return [np.array([i]) for i in range(self.num_components[0])]
        labels = self.pixel_components[level]
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=self.num_components[level])
        return np.split(order, np.cumsum(counts)[:-1])

    def component_sizes(self, level: int) -> np.ndarray:
        return np.bincount(self.pixel_components[level],
                           minlength=self.num_components[level])

    def spatial_neighbors_of(self, level: int) -> np.ndarray:
        """Padded [C, D] spatial adjacency on `level` (no self edges).
        Level 0 is the raw pixel grid."""
        if level == 0:
            if self._pixel_neighbors is None:
                self._pixel_neighbors = pixel_neighbor_table(
                    self.settings.num_rows, self.settings.num_cols,
                    self.settings.neighbor_connection)
            return self._pixel_neighbors
        return self.spatial_neighbors[level - 1]

    def clear(self):
        self.__init__(self.settings)

    def init_first_level(self, num_points: int):
        """Reference: Hierarchy::initFirstLevel (:117-132)."""
        assert self.num_levels == 0
        self.num_components.append(num_points)
        self.pixel_components.append(np.arange(num_points, dtype=np.int64))

    def add_level(self, num_components_next: int,
                  component_labels_next: np.ndarray,
                  rws: RandomWalkSettings):
        """Reference: Hierarchy::addLevel (:134-160); `rws` (with the
        level's walk length) for the handlings that walk again."""
        assert self.num_levels > 0
        labels = np.asarray(component_labels_next, dtype=np.int64)
        assert labels.shape[0] == self.num_components[-1]
        self.parents.append(labels.copy())
        self.num_components.append(num_components_next)
        self.pixel_components.append(labels[self.pixel_components[-1]])
        child_counts = np.bincount(labels, minlength=num_components_next)
        self.not_merged.append(np.nonzero(child_counts == 1)[0])
        with phase("h.spatial"):
            self._update_spatial_neighbors(num_components_next)
        if self.settings.component_sim in WALK_SIMS:
            with phase("h.merge_walks"):
                self._update_random_walks(num_components_next, labels, rws)

    def _update_spatial_neighbors(self, num_components_next: int):
        pix_next = self.pixel_components[-1]
        grid = self.spatial_neighbors_of(0)
        n, deg = grid.shape
        src = pix_next[np.repeat(np.arange(n), deg)]
        ok = grid.ravel() >= 0
        dst = pix_next[np.maximum(grid.ravel(), 0)]
        src, dst = src[ok], dst[ok]
        diff = src != dst
        src, dst = src[diff], dst[diff]
        key = np.unique(src * num_components_next + dst)
        urow = (key // num_components_next).astype(np.int64)
        ucol = (key % num_components_next).astype(np.int64)
        counts = np.bincount(urow, minlength=num_components_next)
        width = max(int(counts.max()) if counts.size else 1, 1)
        adj = np.full((num_components_next, width), -1, dtype=np.int64)
        starts = np.zeros(num_components_next + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        adj[urow, np.arange(urow.size) - starts[urow]] = ucol
        self.spatial_neighbors.append(adj)

    def _update_random_walks(self, num_next: int, labels: np.ndarray,
                             rws: RandomWalkSettings):
        """Reference: Hierarchy::updateRandomWalks (:250-390), in the JAX
        package's order.  MERGE_RW_ONLY sums the child walk rows into their
        parents and normalizes them; MERGE_RW_NEW_WALKS[_AND_KNN] merge the
        same way, drop the self-similarity (keeping single-entry rows) when
        rw_remove_self_sim_after_merging, normalize and walk again on the
        merged rows with `rws`; MERGE_DATA_NEW_WALKS min-merges the data
        distance graph, turns it into Gaussian probability rows and walks
        on those.  Merged rows are capped in width: one giant merge
        component would otherwise force the whole padded matrix to its
        union nnz (sum merges keep the largest values, min merges the
        smallest)."""
        handling = self.settings.rw_handling
        cap = max(1024, MERGE_WIDTH_BUDGET // max(num_next, 1))
        onedim = self.settings.rw_norm_sim == NormType.ONEDIM
        if handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS:
            graph = merge_rows_min_by_parents(
                self.merged_data_graphs[-1], labels, num_next, max_width=cap)
            self.merged_data_graphs.append(graph)
            merged = distance_rows_to_probs(graph)
        elif handling == RandomWalkHandling.MERGE_RW_ONLY:
            # the normalization folds into the merge: the same numpy sums
            merged = merge_rows_by_parents(
                self.random_walks[-1], labels, num_next, norm=onedim,
                weight_by_size=self.settings.rw_weight_merge_by_size,
                max_width=cap)
            if (self.settings.rw_remove_self_sim_after_merging
                    and merged.num_rows > 1):
                Log.warn_once("Hierarchy::updateRandomWalks: MERGE_RW_ONLY "
                              "ignores rw_remove_self_sim_after_merging")
            if not onedim:
                merged = normalize_matrix(merged)
        else:
            merged = merge_rows_by_parents(
                self.random_walks[-1], labels, num_next, norm=False,
                weight_by_size=self.settings.rw_weight_merge_by_size,
                max_width=cap)
            if (self.settings.rw_remove_self_sim_after_merging
                    and merged.num_rows > 1):
                merged = remove_diagonal(merged, keep_single_entry=True)
            # the JAX package normalizes its host-side merge in numpy
            merged = SparseRows(merged.idx, host_normalize(
                merged.indices, merged.values, onedim), merged.num_cols)

        if handling == RandomWalkHandling.MERGE_RW_ONLY:
            out = merged
        else:
            Log.info("Hierarchy::updateRandomWalks: new random walks of "
                     "length %d", rws.single_walk_length)
            out = do_random_walks(merged, rws, self.settings.verbose)
        # preserve the self-similarity when the top level is a single node
        # (reference: :387-389)
        if out.num_rows == 1 and out.nnz() == 0:
            idx = torch.full((1, out.width), -1, dtype=torch.int64,
                             device=out.device)
            val = torch.zeros((1, out.width), dtype=torch.float32,
                              device=out.device)
            idx[0, 0] = 0
            val[0, 0] = 1.0
            out = SparseRows(idx, val, out.num_cols)
        self.random_walks.append(out)


def distance_rows_to_probs(dist_rows: SparseRows) -> SparseRows:
    """Sparse distance rows as transition probabilities (reference:
    updateRandomWalks' MERGE_DATA_NEW_WALKS path, normalizeKnnDistances on
    the merged graph): Gaussian rows at perplexity -1 (a third of each
    row's size) over the entries off the diagonal, then each row to one."""
    rows = torch.arange(dist_rows.num_rows, device=dist_rows.device)[:, None]
    mask = (dist_rows.idx >= 0) & (dist_rows.idx != rows)
    p = gaussian_row_distributions(dist_rows.val, mask, -1.0,
                                   ignore_first=False,
                                   sum_width=dist_rows.width)
    return normalize_rows(SparseRows(dist_rows.idx, p, dist_rows.num_cols))
