"""Sparse-matrix statistics.

Port of sph_tpu/utils/stats.py's ``SparseMatrixStats`` (reference:
sph/utils/Statistics.hpp:14-30: sparsity, nnz and average nnz).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SparseMatrixStats:
    """Reference: Statistics.hpp:14-30."""

    non_zeros: int = 0
    total_entries: int = 0
    average_non_zeros: float = 0.0
    sparsity: float = 0.0

    @classmethod
    def of(cls, rows) -> "SparseMatrixStats":
        """Over a SparseRows, KnnGraph or PaddedGraph."""
        from ..ops.graph import KnnGraph, PaddedGraph
        from ..ops.sparse import SparseRows
        if isinstance(rows, SparseRows):
            nnz = rows.nnz()
            n, c = rows.num_rows, rows.num_cols
        elif isinstance(rows, KnnGraph):
            n = c = rows.num_points
            nnz = n * rows.k
        elif isinstance(rows, PaddedGraph):
            n = c = rows.num_points
            nnz = rows.num_edges()
        else:
            raise TypeError(type(rows))
        total = n * c
        return cls(nnz, total, nnz / max(n, 1), 1.0 - nnz / max(total, 1))

