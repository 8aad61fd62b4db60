"""Field-level geodesic distance cache.

Port of sph_tpu/utils/distance_cache.py (reference:
sph/utils/DistanceCache.hpp:12-60, a hash map of pair distances with hit and
miss counters, ShortestPath.cpp:18-42).  One converged SSSP field answers
every query from its source, so the cache unit is the whole [N] field: an
LRU of fields over one graph, whose in-edge table goes to the device once,
and a prefetch that computes all missing fields in one batch.  A field of
either endpoint answers a pair on the symmetrized graph.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class DistanceCache:
    """LRU of SSSP distance fields over one graph; `max_fields` bounds the
    resident memory at ``max_fields * N * 4`` bytes (the reference's
    maxSize guard, DistanceCache.hpp:27)."""

    def __init__(self, graph, max_fields: int = 64, device=None):
        from ..ops.shortest_path import FieldGraph, _graph_arrays
        self._idx, self._dist, self._mask = _graph_arrays(graph)
        self._graph = FieldGraph.from_graph(graph, device)
        self.max_fields = max(1, int(max_fields))
        self._fields: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _insert(self, source: int, field: np.ndarray) -> None:
        self._fields[source] = field
        self._fields.move_to_end(source)
        while len(self._fields) > self.max_fields:
            self._fields.popitem(last=False)
            self.evictions += 1

    def field(self, source: int) -> np.ndarray:
        """The [N] distance field from `source` (unreachable = +inf)."""
        source = int(source)
        cached = self._fields.get(source)
        if cached is not None:
            self.hits += 1
            self._fields.move_to_end(source)
            return cached
        self.misses += 1
        out = self._compute([source])[0]
        self._insert(source, out)
        return out

    def _compute(self, sources) -> np.ndarray:
        """Converged [len(sources), N] fields of single-node sources."""
        from ..ops.shortest_path import _fields_full
        g = self._graph
        return _fields_full(g, np.asarray(sources, np.int64)[:, None],
                            g.n).cpu().numpy()

    def prefetch(self, sources) -> None:
        """Compute all missing fields in one batch."""
        missing = [int(s) for s in np.unique(np.asarray(sources, np.int64))
                   if int(s) not in self._fields]
        if not missing:
            return
        self.misses += len(missing)
        for s, f in zip(missing, self._compute(missing)):
            self._insert(s, f)

    def query(self, start: int, end: int) -> float:
        """Pair geodesic with the reference's query ladder
        (ShortestPath.cpp:100-166): trivial pair, direct-neighbour
        early-out, either endpoint's cached field, a new field.  Returns
        -1.0 when unreachable."""
        start, end = int(start), int(end)
        if start == end:
            return 0.0
        row = self._idx[start][self._mask[start]]
        hit = np.nonzero(row == end)[0]
        if hit.size:
            self.hits += 1
            return float(self._dist[start][self._mask[start]][hit[0]])
        cached = self._fields.get(end)  # symmetric: field(end)[start]
        if cached is not None and start not in self._fields:
            self.hits += 1
            self._fields.move_to_end(end)
            d = float(cached[start])
            return d if np.isfinite(d) else -1.0
        d = float(self.field(start)[end])
        return d if np.isfinite(d) else -1.0

    def stats(self) -> dict:
        """Hit / miss counters (reference: ShortestPath.cpp:18-35)."""
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "resident_fields": len(self._fields),
                "hit_rate": (self.hits / total) if total else 0.0}
