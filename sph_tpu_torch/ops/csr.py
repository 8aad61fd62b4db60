"""Explicit CSR utilities.

Reference: sph/utils/MatrixCSR.hpp:17-44 — a 3-array CSR struct with
conversions to/from Eigen, transpose, and triangle printers (utility, not on
the hot path).  Here CSR interoperates with SparseRows and scipy.  Copied
from sph_tpu/ops/csr.py, which uses no jax; the port's SparseRows has no
mask, so a live entry is an index >= 0, and it lands on a named device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MatrixCSR:
    """3-array CSR (reference: MatrixCSR.hpp)."""

    indptr: np.ndarray   # [rows + 1] int64
    indices: np.ndarray  # [nnz] int32
    data: np.ndarray     # [nnz] float32
    shape: tuple[int, int]

    @classmethod
    def from_sparse_rows(cls, sr) -> "MatrixCSR":
        mask = (sr.indices >= 0) & (sr.values != 0)
        counts = mask.sum(axis=1)
        indptr = np.zeros(sr.num_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, sr.indices[mask].astype(np.int32),
                   sr.values[mask].astype(np.float32),
                   (sr.num_rows, sr.num_cols))

    def to_sparse_rows(self, device=None):
        """The rows as SparseRows on `device` (CUDA when None)."""
        from .sparse import SparseRows, PAD
        n = self.shape[0]
        counts = np.diff(self.indptr)
        width = max(int(counts.max()) if counts.size else 1, 1)
        idx = np.full((n, width), PAD, dtype=np.int32)
        val = np.zeros((n, width), dtype=np.float32)
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(len(self.indices)) - np.repeat(self.indptr[:-1],
                                                        counts)
        idx[rows, slot] = self.indices
        val[rows, slot] = self.data
        return SparseRows(idx, val, self.shape[1], device=device)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)

    @classmethod
    def from_scipy(cls, m) -> "MatrixCSR":
        m = m.tocsr()
        return cls(m.indptr.astype(np.int64), m.indices.astype(np.int32),
                   m.data.astype(np.float32), m.shape)

    def transpose(self) -> "MatrixCSR":
        return MatrixCSR.from_scipy(self.to_scipy().T.tocsr())

    @property
    def nnz(self) -> int:
        return len(self.data)
