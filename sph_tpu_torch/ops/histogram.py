"""Binned histogram with under/overflow tracking.

Copied from sph_tpu/ops/histogram.py, which uses no jax (reference:
sph/utils/Histogram.hpp:13-63 — binned histogram with explicit underflow
and overflow counts, used for distance-distribution inspection), over numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Histogram:
    edges: np.ndarray     # [bins + 1]
    counts: np.ndarray    # [bins]
    underflow: int
    overflow: int

    @classmethod
    def create(cls, data, num_bins: int, lo: float | None = None,
               hi: float | None = None) -> "Histogram":
        arr = np.asarray(data, dtype=np.float64).ravel()
        if lo is None:
            lo = float(arr.min()) if arr.size else 0.0
        if hi is None:
            hi = float(arr.max()) if arr.size else 1.0
        if hi <= lo:
            hi = lo + 1.0
        under = int((arr < lo).sum())
        over = int((arr > hi).sum())
        inside = arr[(arr >= lo) & (arr <= hi)]
        counts, edges = np.histogram(inside, bins=num_bins, range=(lo, hi))
        return cls(edges, counts, under, over)

    @property
    def num_bins(self) -> int:
        return len(self.counts)

    def bin_centers(self) -> np.ndarray:
        return 0.5 * (self.edges[:-1] + self.edges[1:])

    def total(self) -> int:
        return int(self.counts.sum()) + self.underflow + self.overflow
