"""Graph containers and host restructuring ops.

Port of sph_tpu/ops/graph.py (reference: sph/utils/Graph.hpp — the ragged
CSR kNN graph and its fixed-k variant, with the invariant *first neighbor is
the point itself with distance 0*).  Both variants are padded host numpy
arrays:

* ``KnnGraph``    — fixed-k: indices/distances of shape [N, K]
* ``PaddedGraph`` — variable-k: [N, Kmax] with pad index -1, pad distance
  +inf, and a per-row count

The irregular restructurings (connected components, edge insertion) run
on the host through the shared C++ library, which is what the JAX package
runs off the TPU; the symmetrization runs on the caller's card where it
names one (``ops/device_merge.py``).  Consumers that compute on a device
copy the arrays there themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.logging import Log
from . import device_merge

PAD_INDEX = -1
PAD_DIST = np.inf
SYM_WIDTH_CAP = 1024   # sph_tpu's SPH_SYM_WIDTH_CAP default


class KnnGraph:
    """Fixed-k kNN graph (reference KGraph, Graph.hpp:399-564)."""

    __slots__ = ("indices", "distances")

    def __init__(self, indices, distances):
        self.indices = np.asarray(indices)      # [N, K] int32
        self.distances = np.asarray(distances)  # [N, K] f32, ascending rows

    @property
    def shape(self) -> tuple:
        return self.indices.shape

    @property
    def num_points(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    def is_valid(self) -> bool:
        n, k = self.indices.shape
        if self.distances.shape != (n, k):
            return False
        if not np.all(self.indices[:, 0] == np.arange(n)):
            return False
        if not np.all(self.distances[:, 0] == 0):
            return False
        return bool(np.all(np.diff(self.distances, axis=1) >= 0))

    def to_padded(self) -> "PaddedGraph":
        n, k = self.shape
        return PaddedGraph(self.indices.astype(np.int32).copy(),
                           self.distances.astype(np.float32).copy(),
                           np.full(n, k, dtype=np.int32))


class PaddedGraph:
    """Variable-k graph as padded arrays (reference Graph, Graph.hpp:155-273).

    Rows are sorted by distance with the self edge first; pads live at the end
    of each row (index PAD_INDEX, distance +inf).
    """

    __slots__ = ("indices", "distances", "counts")

    def __init__(self, indices, distances, counts):
        self.indices = np.asarray(indices)      # [N, Kmax] int32
        self.distances = np.asarray(distances)  # [N, Kmax] f32
        self.counts = np.asarray(counts)        # [N] int32

    @property
    def shape(self) -> tuple:
        return self.indices.shape

    @property
    def num_points(self) -> int:
        return self.shape[0]

    @property
    def max_k(self) -> int:
        return self.shape[1]

    @property
    def mask(self) -> np.ndarray:
        return self.indices >= 0

    def num_edges(self) -> int:
        return int(self.counts.sum())

    def is_valid(self) -> bool:
        n = self.num_points
        if not np.all(self.indices[:, 0] == np.arange(n)):
            return False
        if not np.all(self.distances[:, 0] == 0):
            return False
        col = np.arange(self.max_k)[None, :]
        in_range = col < self.counts[:, None]
        if not np.all((self.indices >= 0) == in_range):
            return False
        d = self.distances
        adj_valid = in_range[:, 1:]
        return bool(np.all(np.where(adj_valid,
                                    d[:, 1:] >= d[:, :-1], True)))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        c = self.counts[i]
        return self.indices[i, :c], self.distances[i, :c]


def ensure_self_first(indices: np.ndarray, distances: np.ndarray,
                      ) -> tuple[np.ndarray, np.ndarray, int]:
    """Enforce the self-first invariant (reference: GraphUtils.cpp
    ensureClosestPointIsSelf:23-96).

    If the self edge appears elsewhere in the row, swap it to slot 0.  If it is
    missing, shift the row right (dropping the most distant neighbor) and put
    (self, 0) first.  Returns new arrays + the number of adjusted rows.
    """
    indices = np.asarray(indices).copy()
    distances = np.asarray(distances).copy()
    n, k = indices.shape
    rows = np.arange(n)

    already = indices[:, 0] == rows
    num_adjusted = int((~already).sum())
    if num_adjusted == 0:
        return indices, distances, 0

    is_self = indices == rows[:, None]
    has_self = is_self.any(axis=1)
    self_pos = np.where(has_self, is_self.argmax(axis=1), k - 1)

    fix = ~already
    fix_swap = fix & has_self
    if fix_swap.any():
        r = rows[fix_swap]
        p = self_pos[fix_swap]
        i0, d0 = indices[r, 0].copy(), distances[r, 0].copy()
        indices[r, 0] = indices[r, p]
        distances[r, 0] = distances[r, p]
        indices[r, p] = i0
        distances[r, p] = d0
        distances[r, 0] = 0.0

    fix_ins = fix & ~has_self
    if fix_ins.any():
        r = rows[fix_ins]
        indices[r, 1:] = indices[r, :-1]
        distances[r, 1:] = distances[r, :-1]
        indices[r, 0] = r
        distances[r, 0] = 0.0
    return indices, distances, num_adjusted


def symmetrize_graph(graph: KnnGraph | PaddedGraph,
                     device=None) -> PaddedGraph:
    """Undirected union of edges with min-distance dedup (reference:
    GraphUtils.cpp symmetrizeGraph — union of i->j and j->i, duplicate edges
    keep the smaller distance, rows sorted by distance, self first).  Rows
    are capped at SYM_WIDTH_CAP entries: hub rows keep their closest edges.

    device: where the caller computes.  On the card the union runs there
    (``device_merge.symmetrize_graph_device``); on the CPU, and without a
    device, on the host (``native.symmetrize``).  Both give the same bits,
    and the result is host numpy either way: its consumers (the
    components, the bridging) are host code.
    """
    if isinstance(graph, KnnGraph):
        graph = graph.to_padded()
    idx_in = np.where(graph.mask, graph.indices, -1).astype(np.int32)
    dist_in = np.where(graph.mask, graph.distances, 0.0).astype(np.float32)
    if device is not None and device_merge.on_card(device):
        dev = torch.device(device)
        oi, od, oc = (t.cpu().numpy()
                      for t in device_merge.symmetrize_graph_device(
                          torch.from_numpy(idx_in).to(dev),
                          torch.from_numpy(dist_in).to(dev),
                          max_width=SYM_WIDTH_CAP))
    else:
        oi, od, oc = native.symmetrize(idx_in, dist_in,
                                       max_width=SYM_WIDTH_CAP)
    if oi.shape[1] >= SYM_WIDTH_CAP:
        Log.info("symmetrize_graph: row width capped at %d (hub nodes keep "
                 "their closest edges)", SYM_WIDTH_CAP)
    return PaddedGraph(oi, od, oc)


def weak_connected_components(graph: KnnGraph | PaddedGraph
                              ) -> tuple[int, np.ndarray]:
    """Weak CC labels of the directed kNN graph (reference: GraphUtils
    labelGraphWeakComponents), in order of first appearance."""
    g = graph.to_padded() if isinstance(graph, KnnGraph) else graph
    return native.weak_components(
        np.where(g.mask, g.indices, -1).astype(np.int32))


def strong_connected_components(graph: KnnGraph | PaddedGraph
                                ) -> tuple[int, np.ndarray]:
    """Strong CC labels (reference: labelGraphStrongComponents; used on the
    symmetrized graph where strong == weak)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    g = graph.to_padded() if isinstance(graph, KnnGraph) else graph
    n, kmax = g.indices.shape
    mask = g.mask
    rows = np.broadcast_to(np.arange(n)[:, None], (n, kmax))[mask]
    cols = g.indices[mask]
    m = sp.coo_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                      shape=(n, n))
    ncc, labels = connected_components(m, directed=True, connection="strong")
    return ncc, _normalize_labels(labels)


def _normalize_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel components in order of first appearance."""
    _, first_idx, inverse = np.unique(labels, return_index=True,
                                      return_inverse=True)
    rank = np.argsort(np.argsort(first_idx))
    return rank[inverse].astype(np.int64)


def edge_list_components(num_nodes: int, src: np.ndarray, dst: np.ndarray
                         ) -> tuple[int, np.ndarray]:
    """Weak CC of an explicit edge list (used for the per-level merge graph,
    reference: ImageHierarchy.cpp:468-471)."""
    return native.edge_list_components(num_nodes, src, dst)


def insert_edges_bidirectional(graph: PaddedGraph, pairs: np.ndarray,
                               dists: np.ndarray) -> PaddedGraph:
    """Insert undirected edges keeping per-row distance sort and the self-first
    invariant (reference: NearestNeighbors.cpp insertDistance:547-571 — skips
    edges already present, never inserts before slot 0).
    """
    n, kmax = graph.indices.shape
    extra = np.zeros(n, dtype=np.int64)
    add: list[tuple[int, int, float]] = []
    for (a, b), d in zip(pairs, dists):
        a, b, d = int(a), int(b), float(d)
        if a == b:
            continue
        if b not in graph.indices[a, :graph.counts[a]]:
            add.append((a, b, d))
            extra[a] += 1
        if a not in graph.indices[b, :graph.counts[b]]:
            add.append((b, a, d))
            extra[b] += 1
    if not add:
        return graph

    new_kmax = max(int((graph.counts + extra).max()), kmax)
    indices = np.full((n, new_kmax), PAD_INDEX, dtype=np.int32)
    distances = np.full((n, new_kmax), PAD_DIST, dtype=np.float32)
    indices[:, :kmax] = graph.indices
    distances[:, :kmax] = graph.distances
    counts = graph.counts.copy()

    for a, b, d in add:
        c = counts[a]
        # insertion point (upper bound), but never before slot 1
        pos = max(int(np.searchsorted(distances[a, :c], d, side="right")), 1)
        indices[a, pos + 1:c + 1] = indices[a, pos:c]
        distances[a, pos + 1:c + 1] = distances[a, pos:c]
        indices[a, pos] = b
        distances[a, pos] = d
        counts[a] = c + 1
    return PaddedGraph(indices, distances, counts)


def graph_sparsity(graph: KnnGraph | PaddedGraph) -> float:
    """Percentage of absent edges (reference: NearestNeighbors.cpp:193)."""
    n = graph.num_points
    edges = (n * graph.k if isinstance(graph, KnnGraph)
             else graph.num_edges())
    return 100.0 - 100.0 * edges / float(n * n)
