"""NearestNeighbors — stage 1: the data-level kNN graph.

Port of sph_tpu/models/nearest_neighbors.py (reference:
sph/NearestNeighbors.cpp — engine dispatch (:131-141), post-processing
(:152-170), symmetrization (:411-492), connected components (:318-409) and
component connection via a Kruskal MST over component centroids plus
min-distance pair insertion (:494-861)).  The kNN runs on the stage's
device; the graph restructurings and the few closest-pair searches of the
component bridging run on the host, as in the JAX package off the TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..settings import KnnMetric, NearestNeighborsSettings
from ..utils.logging import Log
from ..utils.timer import phase
from ..ops.graph import (KnnGraph, PaddedGraph, graph_sparsity,
                         insert_edges_bidirectional,
                         strong_connected_components, symmetrize_graph,
                         weak_connected_components)
from ..ops.knn import compute_knn


def _mst_over_centroids(centers: np.ndarray) -> np.ndarray:
    """Kruskal MST edges over component centroids (reference:
    computeSpanningTree, NearestNeighbors.cpp:684-708).  Returns [ncc-1, 2]
    component-id pairs."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree

    d = np.sqrt(np.maximum(
        ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1), 0))
    # scipy drops explicit zeros: coincident centroids must stay connectable
    d = np.where(d <= 0, 1e-12, d)
    mst = minimum_spanning_tree(sp.csr_matrix(np.triu(d, 1)))
    rows, cols = mst.nonzero()
    return np.stack([rows, cols], axis=1)


def _closest_pair(data: np.ndarray, ids_a: np.ndarray, ids_b: np.ndarray,
                  l2_squared: bool = False) -> tuple[int, int, float]:
    """Min-distance point pair between two components (reference:
    insertConnectionsBetweenComponents, NearestNeighbors.cpp:592-656): a
    blocked distance matrix + argmin.  The distance matches the graph's
    metric scale (squared L2 when l2_squared).  It runs on the host in numpy,
    as the JAX package runs it off the TPU: a handful of MST edges, and the
    same arithmetic gives the same inserted distances."""
    a = data[ids_a]
    b = data[ids_b]
    best = (0, 0, np.inf)
    block = 4096
    bsq = np.sum(b * b, 1)
    for i0 in range(0, len(ids_a), block):
        ab = a[i0:i0 + block]
        absq = np.sum(ab * ab, 1)
        for j0 in range(0, len(ids_b), block):
            bb = b[j0:j0 + block]
            d2 = (absq[:, None] + bsq[j0:j0 + block][None, :]
                  - 2.0 * ab @ bb.T)
            r, c = divmod(int(np.argmin(d2)), d2.shape[1])
            val = float(d2[r, c])
            if val < best[2]:
                best = (int(ids_a[i0 + r]), int(ids_b[j0 + c]), val)
    d2 = max(best[2], 0.0)
    return best[0], best[1], float(d2 if l2_squared else np.sqrt(d2))


class NearestNeighbors:
    """Reference: sph/NearestNeighbors.hpp:22."""

    def __init__(self, data: np.ndarray,
                 nns: Optional[NearestNeighborsSettings] = None,
                 device=None):
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._nns = nns or NearestNeighborsSettings()
        self.device = resolve_device(device)
        self.knn_graph: Optional[KnnGraph] = None
        self.sym_graph: Optional[PaddedGraph] = None
        self.connected_graph: Optional[PaddedGraph] = None
        self.connected_components: Optional[np.ndarray] = None
        self.num_connected_components: int = -1
        self._has_connected = False

    def compute(self, nns: Optional[NearestNeighborsSettings] = None):
        """Reference: NearestNeighbors::compute (:98-189)."""
        if nns is not None:
            self._nns = nns
        s = self._nns
        Log.info("NearestNeighbors::compute: %d neighbors, metric %s, "
                 "index %s", s.num_nearest_neighbors, s.knn_metric.value,
                 s.knn_index.value)
        with phase("nn.knn"):
            idx, dist = compute_knn(self._data, s.num_nearest_neighbors,
                                    s.knn_index, s.knn_metric, s.l2_squared,
                                    device=self.device)
            self.knn_graph = KnnGraph(idx, dist)
        Log.info("NearestNeighbors: graph sparsity %.6f%%",
                 graph_sparsity(self.knn_graph))
        if s.symmetric_neighbors:
            with phase("nn.symmetrize"):
                self.compute_symmetrized_graph()
        if s.compute_connect_components:
            with phase("nn.cc"):
                self.compute_connected_components()
        if s.neighbor_connect_components:
            with phase("nn.connect"):
                self.connect_components()

    def compute_symmetrized_graph(self) -> PaddedGraph:
        """Reference: computeSymmetrizedNnGraph (:411-492)."""
        self.sym_graph = symmetrize_graph(self.knn_graph)
        return self.sym_graph

    def compute_connected_components(self):
        """Reference: computeConnectedComponents (:318-409): strong CC on the
        symmetric graph, weak CC on the raw kNN graph."""
        if self.sym_graph is not None:
            ncc, labels = strong_connected_components(self.sym_graph)
        else:
            ncc, labels = weak_connected_components(self.knn_graph)
        self.num_connected_components = ncc
        self.connected_components = labels
        Log.info("NearestNeighbors: %d connected components", ncc)
        return ncc, labels

    def connect_components(self) -> PaddedGraph:
        """Reference: connectComponents (:494-861): MST over component
        centroids, then for each MST edge the min-distance point pair
        between the two components, inserted bidirectionally."""
        if self.connected_components is None:
            self.compute_connected_components()
        base = (self.sym_graph if self.sym_graph is not None
                else self.knn_graph.to_padded())
        if self.num_connected_components == 1:
            Log.info("NearestNeighbors::connectComponents: already one "
                     "component")
            self.connected_graph = PaddedGraph(base.indices.copy(),
                                               base.distances.copy(),
                                               base.counts.copy())
            self._has_connected = True
            return self.connected_graph

        labels = self.connected_components
        ncc = self.num_connected_components
        data = self._data
        if self._nns.knn_metric == KnnMetric.COSINE:
            norms = np.linalg.norm(data, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            data = data / norms
        centers = np.zeros((ncc, data.shape[1]), dtype=np.float64)
        np.add.at(centers, labels, data)
        counts = np.bincount(labels, minlength=ncc)
        centers /= np.maximum(counts, 1)[:, None]
        mst = _mst_over_centroids(centers.astype(np.float32))
        Log.info("NearestNeighbors::connectComponents: inserting %d MST "
                 "edges between components", len(mst))

        members = [np.nonzero(labels == c)[0] for c in range(ncc)]
        squared = (self._nns.l2_squared
                   and self._nns.knn_metric == KnnMetric.L2)
        pairs, dists = [], []
        for ca, cb in mst:
            ia, ib, d = _closest_pair(data, members[ca], members[cb],
                                      squared)
            pairs.append((ia, ib))
            dists.append(d)
        graph = PaddedGraph(base.indices.copy(), base.distances.copy(),
                            base.counts.copy())
        if pairs:
            graph = insert_edges_bidirectional(
                graph, np.asarray(pairs), np.asarray(dists, np.float32))
        self.connected_graph = graph
        self._has_connected = True
        Log.info("NearestNeighbors::connectComponents: new edge count %d",
                 graph.num_edges())
        return graph

    @property
    def has_components_connected(self) -> bool:
        return self._has_connected
