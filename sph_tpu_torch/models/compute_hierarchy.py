"""ComputeHierarchy — the stage-sequencing facade.

Port of sph_tpu/models/compute_hierarchy.py (reference:
sph/ComputeHierarchy.hpp:19-119 / .cpp — owns the three stages, propagates
connected-component labels into the settings (:139-151), and sequences
compute() = computeKnnGraph() -> computeImageHierarchy() ->
computeLevelSimilarities() (:262-277)).  Every stage runs on the facade's
device.  With an active ``cache`` each stage loads from and writes to a
utils/cache.StageCache (reference: the Cacheable chain), and a separate
``knn_cache`` shares the kNN stage across runs that differ only in later
settings; the archives are the JAX package's, so either package loads the
other's caches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..settings import (CacheSettings, ComponentSim, ImageHierarchySettings,
                        LevelSimilaritiesSettings, NearestNeighborsSettings,
                        NormalizationScheme, RandomWalkSettings)
from ..utils.cache import StageCache
from ..utils.logging import Log
from ..ops.graph import KnnGraph, PaddedGraph
from ..ops.sparse import SparseRows
from .hierarchy import Hierarchy, HierarchySettings
from .image_hierarchy import ImageHierarchy
from .level_similarities import LevelSimilarities
from .nearest_neighbors import NearestNeighbors


class ComputeHierarchy:
    """Reference: sph/ComputeHierarchy.hpp:19."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._data: Optional[np.ndarray] = None
        self._rows = 0
        self._cols = 0
        self._nns = NearestNeighborsSettings()
        self._ihs = ImageHierarchySettings()
        self._lss = LevelSimilaritiesSettings()
        self._rws = RandomWalkSettings()
        self._cache: Optional[StageCache] = None
        self._knn_cache: Optional[StageCache] = None
        self.knn_stage: Optional[NearestNeighbors] = None
        self.image_hierarchy: Optional[ImageHierarchy] = None
        self.level_similarities: Optional[LevelSimilarities] = None
        self.skip_level_similarities = False
        self._finished_knn = False
        self._finished_hierarchy = False
        self._finished_levels = False

    def init(self, data: np.ndarray, rows: int, cols: int,
             ihs: Optional[ImageHierarchySettings] = None,
             lss: Optional[LevelSimilaritiesSettings] = None,
             rws: Optional[RandomWalkSettings] = None,
             nns: Optional[NearestNeighborsSettings] = None,
             cache: Optional[CacheSettings] = None,
             knn_cache: Optional[CacheSettings] = None):
        """knn_cache: a separate cache location for the kNN stage, shared
        across runs that differ only in hierarchy or level settings
        (reference: the cs_knn cache, ComputeHierarchy.hpp:100-103,
        RunEvaluation.cpp:283-295)."""
        self.set_data(data, rows, cols)
        self.set_settings(ihs, lss, rws, nns)
        if cache is not None and cache.cache_active:
            self._cache = StageCache(cache.path, cache.file_name)
        if knn_cache is not None and knn_cache.cache_active:
            self._knn_cache = StageCache(knn_cache.path,
                                         knn_cache.file_name)
        return self

    @property
    def knn_loaded_from_cache(self) -> bool:
        """Whether the last compute_knn_graph loaded the kNN stage."""
        kc = self._knn_cache or self._cache
        return kc is not None and kc.loaded("nns")

    def set_data(self, data: np.ndarray, rows: int, cols: int):
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._rows = rows
        self._cols = cols

    def set_settings(self, ihs=None, lss=None, rws=None, nns=None):
        if nns is not None:
            self._nns = nns
        if ihs is not None:
            self._ihs = ihs
        if lss is not None:
            self._lss = lss
        if rws is not None:
            self._rws = rws
        # GEO modes need CC labels (reference: ComputeHierarchy.cpp:41-43)
        if self._ihs.component_sim in (ComponentSim.GEO_CENTROID,
                                       ComponentSim.GEO_WALKS):
            self._nns.compute_connect_components = True

    # ------------------------------------------------------------------

    def compute_knn_graph(self):
        """Reference: computeKnnGraph (:97-159)."""
        Log.info("ComputeHierarchy:: Nearest Neighbors on data level")
        self.knn_stage = NearestNeighbors(self._data, self._nns,
                                          device=self.device)
        kc = self._knn_cache or self._cache
        loaded = kc is not None and self._load_knn_cache(kc)
        if not loaded:
            self.knn_stage.compute()
            if kc is not None:
                self._write_knn_cache(kc)
        # a shared kNN cache's load status goes into the run cache's chain:
        # a recomputed kNN stage invalidates the run's later stages
        if self._cache is not None and kc is not self._cache:
            self._cache.mark("nns", loaded)
        # graph selection (reference: :120-137)
        if self._nns.neighbor_connect_components:
            data_graph = self.knn_stage.connected_graph
        elif self._nns.symmetric_neighbors:
            data_graph = self.knn_stage.sym_graph
        else:
            data_graph = self.knn_stage.knn_graph

        # adopt CC labels; bump minNumComp (reference: :139-151)
        if (not self.knn_stage.has_components_connected
                and self.knn_stage.connected_components is not None):
            ncc = self.knn_stage.num_connected_components
            if self._ihs.min_num_comp < ncc:
                Log.warn("ComputeHierarchy:: min_num_comp (%d) < number of "
                         "connected components (%d); adjusted",
                         self._ihs.min_num_comp, ncc)
                self._ihs.min_num_comp = ncc

        self.image_hierarchy = ImageHierarchy(
            data_graph, self._data, self._rows, self._cols,
            self._nns.neighbor_connect_components, device=self.device)
        if not self.knn_stage.has_components_connected:
            self.image_hierarchy.component_labels = (
                self.knn_stage.connected_components)
        self._finished_knn = True

    def compute_image_hierarchy(self):
        """Reference: computeImageHierarchy (:161-201)."""
        if not self._finished_knn:
            Log.warn("ComputeHierarchy:: call compute_knn_graph() first")
            return
        loaded = (self._cache is not None
                  and self._load_hierarchy_cache())
        if not loaded:
            self.image_hierarchy.compute(self._ihs, self._rws)
            if self._cache is not None:
                self._write_hierarchy_cache()
        if not self._lss.ks:
            # library use without an explicit k schedule: seed level-0 k
            # from the data-level kNN (reference: RunEvaluation.cpp:268)
            self._lss.ks = [self._nns.num_nearest_neighbors]
        self.level_similarities = LevelSimilarities(
            self.image_hierarchy.hierarchy, self.image_hierarchy._graph,
            self._data, self._lss, device=self.device)
        self._finished_hierarchy = True

    def compute_level_similarities(self):
        """Reference: computeLevelSimilarities (:204-245)."""
        if not self._finished_hierarchy:
            Log.warn("ComputeHierarchy:: call compute_image_hierarchy() "
                     "first")
            return
        if self.skip_level_similarities:
            return
        self.level_similarities.set_image_hierarchy(self.image_hierarchy)
        loaded = self._cache is not None and self._load_levels_cache()
        if not loaded:
            self.level_similarities.compute(self._lss)
            if self._cache is not None:
                self._write_levels_cache()
        self._finished_levels = True

    def compute_symmetric_probability_distributions(
            self, method: NormalizationScheme):
        """Reference: computeSymmetricProbabilityDistributions (:247-260)."""
        if not self._finished_levels:
            Log.warn("ComputeHierarchy:: compute level similarities first")
            return
        self.level_similarities.symmetrize_output(method)

    def compute(self):
        """Reference: compute (:262-277)."""
        self.compute_knn_graph()
        self.compute_image_hierarchy()
        self.compute_level_similarities()
        return self

    # ------------------------------------------------------------------
    # stage caching (reference: the Cacheable chain; utils/cache.py)
    # ------------------------------------------------------------------

    def _load_knn_cache(self, cache: StageCache) -> bool:
        payload = cache.load("nns", self._nns)
        if payload is None:
            return False
        st = self.knn_stage
        st.knn_graph = KnnGraph(payload["knn_idx"], payload["knn_dist"])
        if "sym_idx" in payload:
            st.sym_graph = PaddedGraph(payload["sym_idx"],
                                       payload["sym_dist"],
                                       payload["sym_counts"])
        if "con_idx" in payload:
            st.connected_graph = PaddedGraph(payload["con_idx"],
                                             payload["con_dist"],
                                             payload["con_counts"])
            st._has_connected = True
        if "cc_labels" in payload:
            st.connected_components = payload["cc_labels"]
            st.num_connected_components = int(payload["cc_num"][0])
        Log.info("ComputeHierarchy:: kNN stage loaded from cache")
        return True

    def _write_knn_cache(self, cache: StageCache):
        st = self.knn_stage
        payload = {"knn_idx": st.knn_graph.indices,
                   "knn_dist": st.knn_graph.distances}
        if st.sym_graph is not None:
            payload.update(sym_idx=st.sym_graph.indices,
                           sym_dist=st.sym_graph.distances,
                           sym_counts=st.sym_graph.counts)
        if st.connected_graph is not None:
            payload.update(con_idx=st.connected_graph.indices,
                           con_dist=st.connected_graph.distances,
                           con_counts=st.connected_graph.counts)
        if st.connected_components is not None:
            payload.update(cc_labels=st.connected_components,
                           cc_num=np.array([st.num_connected_components]))
        cache.write("nns", self._nns, payload)

    def _load_hierarchy_cache(self) -> bool:
        payload = self._cache.load("ihs", (self._ihs, self._rws),
                                   depends_on="nns")
        if payload is None:
            return False
        ih = self.image_hierarchy
        ih.set_settings(self._ihs, self._rws)
        dev = self.device
        num_levels = int(payload["num_levels"][0])
        # the settings block of ImageHierarchy.compute: a loaded hierarchy
        # behaves as a fresh one
        hier = Hierarchy(HierarchySettings(
            num_rows=self._rows, num_cols=self._cols,
            neighbor_connection=self._ihs.neighbor_connection,
            component_sim=self._ihs.component_sim,
            rw_norm_sim=self._ihs.rw_norm_sim,
            rw_weight_merge_by_size=self._ihs.rw_weight_merge_by_size,
            rw_handling=self._ihs.rw_handling,
            rw_remove_self_sim_after_merging=(
                self._ihs.rw_remove_self_sim_after_merging),
            num_geodesic_samples=self._ihs.num_geodesic_samples,
            verbose=self._ihs.verbose))
        hier.num_components = [int(c) for c in payload["num_components"]]
        hier.pixel_components = [payload[f"pix_{i}"].astype(np.int64)
                                 for i in range(num_levels)]
        hier.parents = [payload[f"par_{i}"].astype(np.int64)
                        for i in range(num_levels - 1)]
        hier.spatial_neighbors = [payload[f"spn_{i}"].astype(np.int64)
                                  for i in range(num_levels - 1)]
        # not_merged: the parents with a single child
        for lvl in range(1, num_levels):
            counts = np.bincount(hier.parents[lvl - 1],
                                 minlength=hier.num_components[lvl])
            hier.not_merged.append(np.nonzero(counts == 1)[0])
        for i in range(int(payload["num_walks"][0])):
            hier.random_walks.append(SparseRows(
                payload[f"rw_idx_{i}"], payload[f"rw_val_{i}"],
                hier.num_components[i], device=dev))
        ih.hierarchy = hier
        ih.data_level_probdist = SparseRows(
            payload["pd_idx"], payload["pd_val"], hier.num_components[0],
            device=dev)
        Log.info("ComputeHierarchy:: hierarchy stage loaded from cache")
        return True

    def _write_hierarchy_cache(self):
        ih = self.image_hierarchy
        h = ih.hierarchy
        payload = {"num_levels": np.array([h.num_levels]),
                   "num_components": np.array(h.num_components),
                   "num_walks": np.array([len(h.random_walks)])}
        for i, p in enumerate(h.pixel_components):
            payload[f"pix_{i}"] = p
        for i, p in enumerate(h.parents):
            payload[f"par_{i}"] = p
        for i, p in enumerate(h.spatial_neighbors):
            payload[f"spn_{i}"] = p
        for i, w in enumerate(h.random_walks):
            payload[f"rw_idx_{i}"] = w.indices
            payload[f"rw_val_{i}"] = w.values
        payload["pd_idx"] = ih.data_level_probdist.indices
        payload["pd_val"] = ih.data_level_probdist.values
        self._cache.write("ihs", (self._ihs, self._rws), payload)

    def _load_levels_cache(self) -> bool:
        payload = self._cache.load("lss", self._lss, depends_on="ihs")
        if payload is None:
            return False
        ls = self.level_similarities
        for i in range(int(payload["num_levels"][0])):
            if f"pd_idx_{i}" not in payload:
                continue        # a level not computed (level_to_compute)
            ls.prob_dists[i] = SparseRows(
                payload[f"pd_idx_{i}"], payload[f"pd_val_{i}"],
                ls.hierarchy.num_components[i], device=self.device)
        # the JAX package loads host arrays: its host-path symmetrizations
        ls.device_paths = [False] * len(ls.prob_dists)
        ls._symmetric = self._lss.compute_symmetric_prob_dist
        Log.info("ComputeHierarchy:: level similarities loaded from cache")
        return True

    def _write_levels_cache(self):
        ls = self.level_similarities
        payload = {"num_levels": np.array([len(ls.prob_dists)])}
        for i, pd in enumerate(ls.prob_dists):
            if pd is None:
                continue
            payload[f"pd_idx_{i}"] = pd.indices
            payload[f"pd_val_{i}"] = pd.values
        self._cache.write("lss", self._lss, payload)
        # the JAX package's write reads the rows on its host, and later
        # symmetrizations of host rows take its host path
        ls.device_paths = [False] * len(ls.prob_dists)
