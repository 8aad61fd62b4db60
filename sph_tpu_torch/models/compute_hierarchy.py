"""ComputeHierarchy — the stage-sequencing facade.

Port of sph_tpu/models/compute_hierarchy.py (reference:
sph/ComputeHierarchy.hpp:19-119 / .cpp — owns the three stages, propagates
connected-component labels into the settings (:139-151), and sequences
compute() = computeKnnGraph() -> computeImageHierarchy() ->
computeLevelSimilarities() (:262-277)).  Every stage runs on the facade's
device.  Stage caching is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..settings import (CacheSettings, ComponentSim, ImageHierarchySettings,
                        LevelSimilaritiesSettings, NearestNeighborsSettings,
                        NormalizationScheme, RandomWalkSettings)
from ..utils.logging import Log
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
        for c in (cache, knn_cache):
            if c is not None and c.cache_active:
                raise NotImplementedError(
                    "stage caching not ported yet; see ROADMAP")
        self.set_data(data, rows, cols)
        self.set_settings(ihs, lss, rws, nns)
        return self

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
        self.knn_stage.compute()
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
        self.image_hierarchy.compute(self._ihs, self._rws)
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
        self.level_similarities.compute(self._lss)
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
