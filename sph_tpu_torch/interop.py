"""Carrying state across from the JAX package.

This system has no weights: its state is data and settings.  These helpers
turn the JAX package's settings objects and numpy outputs into the port's,
so a test can hand both packages the same inputs (or hand the port a P or a
graph that sph_tpu built).  They use neither jax nor sph_tpu: a settings
object is read through its dataclass fields and enum values.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .ops.graph import KnnGraph, PaddedGraph
from .ops.sparse import SparseRows
from .settings import settings_from_dict, settings_to_dict


def settings_from_jax(obj: Any) -> Any:
    """The port's settings dataclass equal to a sph_tpu settings object."""
    return settings_from_dict(settings_to_dict(obj))


def sparse_rows_from_numpy(indices: np.ndarray, values: np.ndarray,
                           num_cols: int, device) -> SparseRows:
    """SparseRows on `device` from the JAX package's host arrays."""
    return SparseRows(np.asarray(indices), np.asarray(values), num_cols,
                      device=device)


def graph_from_numpy(indices: np.ndarray, distances: np.ndarray,
                     counts: Optional[np.ndarray] = None
                     ) -> KnnGraph | PaddedGraph:
    """A KnnGraph (no counts) or PaddedGraph from host arrays."""
    if counts is None:
        return KnnGraph(np.asarray(indices), np.asarray(distances))
    return PaddedGraph(np.asarray(indices), np.asarray(distances),
                       np.asarray(counts))
