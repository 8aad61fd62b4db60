"""Host numeric helpers the port uses (copied from sph_tpu/ops/math.py, which
uses no jax; reference: sph/utils/Math.hpp/.cpp)."""

from __future__ import annotations

from typing import Iterable

import numpy as np


def compute_quantile(data: np.ndarray, quantile: float,
                     ignore_vals: Iterable[float] = (),
                     interpolation: int = 0) -> float:
    """Quantile with ignore values (reference: Math.cpp:133-165).

    interpolation == 1: linear between neighbors; otherwise midpoint.
    Returns a negative value if no data remains after filtering (callers treat
    that as "could not find percentile", ImageHierarchy.cpp:379-385).
    """
    arr = np.asarray(data, dtype=np.float32).ravel()
    ignore_vals = list(ignore_vals)
    if ignore_vals:
        mask = np.ones(arr.shape, dtype=bool)
        for v in ignore_vals:
            mask &= arr != np.float32(v)
        arr = arr[mask]
    if arr.size == 0:
        return -1.0
    arr = np.sort(arr)
    rank = quantile * (arr.size - 1)
    lo = int(np.floor(rank))
    hi = int(np.ceil(rank))
    if lo == hi:
        return float(arr[lo])
    frac = rank - lo
    if interpolation == 1:
        return float(arr[lo] + (arr[hi] - arr[lo]) * frac)
    return float(0.5 * (arr[lo] + arr[hi]))


def random_disk_init(n: int, radius: float, seed: int = 0) -> np.ndarray:
    """Uniform random points in a disk of given radius via polar sampling
    (reference: Math.cpp:264-277 randomVec — sqrt(u) radial distribution)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(n, dtype=np.float32))
    t = 2.0 * np.pi * rng.random(n, dtype=np.float32)
    return np.stack([r * np.cos(t), r * np.sin(t)], axis=1).astype(np.float32)


def spectral_embedding(indices: np.ndarray, distances: np.ndarray,
                       num_components: int = 2,
                       seed: int = 123456) -> tuple[np.ndarray, bool]:
    """Spectral layout from a kNN-style edge set via the normalized Laplacian
    (reference: Math.cpp:229-261 wraps umappp::normalized_laplacian).

    indices/distances: [N, K] padded rows (pad index < 0); column 0 may be the
    self edge and is skipped.  Uses the smallest nontrivial eigenvectors of the
    symmetrically-normalized Laplacian of the symmetrized weight graph
    (scipy's eigsh on the host); a random layout when that fails.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n, k = indices.shape
    rows = np.repeat(np.arange(n), k - 1)
    cols = indices[:, 1:].ravel()
    vals = distances[:, 1:].ravel().astype(np.float64)
    valid = cols >= 0
    rows, cols, vals = rows[valid], cols[valid], vals[valid]

    w = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    w = w.maximum(w.T)  # symmetrize
    deg = np.asarray(w.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    dmh = sp.diags(1.0 / np.sqrt(deg))
    lap = sp.eye(n) - dmh @ w @ dmh

    try:
        ncv = min(n - 1, max(2 * (num_components + 1) + 1, 20))
        vals_, vecs = spla.eigsh(lap, k=num_components + 1, sigma=0.0,
                                 which="LM", ncv=ncv, tol=1e-4, maxiter=2000)
        order = np.argsort(vals_)
        emb = vecs[:, order[1:num_components + 1]]
        # scale like umappp: normalize to max-abs 10
        mx = np.abs(emb).max()
        if mx > 0:
            emb = emb / mx * 10.0
        return emb.astype(np.float32), True
    except Exception:
        rng = np.random.default_rng(seed)
        return (rng.uniform(-10, 10, (n, num_components))
                .astype(np.float32)), False
