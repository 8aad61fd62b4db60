"""Debug printers for graphs, sparse rows and image component layouts.

Copied from sph_tpu/utils/printers.py, which uses no jax.  Reference:
sph/utils/PrintHelper.hpp — dense matrix printers for graphs and
sparse matrices plus the per-level image component layout printer used by
the hierarchy tests.
"""

from __future__ import annotations

import numpy as np


def format_sparse_dense(rows, digits: int = 3) -> str:
    """Dense rendering of SparseRows (reference: printSparseMatrixAsDense)."""
    d = rows.to_dense()
    return format_matrix(d, digits)


def format_graph_dense(graph, digits: int = 3) -> str:
    """Dense rendering of a KnnGraph/PaddedGraph distance matrix
    (reference: printGraphAsDenseMatrix)."""
    from ..ops.graph import KnnGraph
    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask
    n = idx.shape[0]
    d = np.zeros((n, n), dtype=np.float32)
    r = np.broadcast_to(np.arange(n)[:, None], idx.shape)
    d[r[mask], idx[mask]] = dist[mask]
    return format_matrix(d, digits)


def format_matrix(m: np.ndarray, digits: int = 3) -> str:
    with np.printoptions(precision=digits, suppress=True, linewidth=200,
                         threshold=10_000):
        return str(np.asarray(m))


def format_image_components(pixel_components: np.ndarray, rows: int,
                            cols: int) -> str:
    """Per-level component layout (reference: printImageComponents — used by
    the hierarchy golden tests to show e.g.
        0  0  0  0
        1  2  2  3
        ...)."""
    grid = np.asarray(pixel_components).reshape(rows, cols)
    width = max(len(str(int(grid.max()))), 2)
    return "\n".join(" ".join(f"{int(v):>{width}d}" for v in row)
                     for row in grid)


def print_image_components(hierarchy, level: int):
    s = hierarchy.settings
    print(format_image_components(hierarchy.pixel_components[level],
                                  s.num_rows, s.num_cols))
