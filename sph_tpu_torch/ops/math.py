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


def pca(data: np.ndarray, num_components: int = 2
        ) -> tuple[np.ndarray, bool]:
    """PCA projection to num_components (reference: Math.cpp:208-227 /
    PCA.hpp): centred per dimension, projected on the right singular
    vectors of numpy's economic SVD in float64, as the JAX package does."""
    x = np.asarray(data, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    try:
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        proj = x @ vt[:num_components].T
        return proj.astype(np.float32), True
    except np.linalg.LinAlgError:
        return np.zeros((x.shape[0], num_components), np.float32), False


def spectral_embedding(indices: np.ndarray, distances: np.ndarray,
                       num_components: int = 2,
                       seed: int = 123456) -> tuple[np.ndarray, bool]:
    """Spectral layout from a kNN-style edge set via the normalized Laplacian
    (reference: Math.cpp:229-261 wraps umappp::normalized_laplacian).

    indices/distances: [N, K] padded rows (pad index < 0); column 0 may be the
    self edge and is skipped.  Uses the smallest nontrivial eigenvectors of the
    symmetrically-normalized Laplacian of the symmetrized weight graph
    (scipy's eigsh on the host); a random layout when that fails.  ARPACK
    starts from a vector drawn from `seed`: without one it takes its own
    process-wide random start (the JAX package's case), and a layout would
    then depend on the eigensolves run before it in the process.
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
        v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
        vals_, vecs = spla.eigsh(lap, k=num_components + 1, sigma=0.0,
                                 which="LM", ncv=ncv, tol=1e-4, maxiter=2000,
                                 v0=v0)
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


def invlin(x):
    """Map [0, inf] -> [1, 0] via 1 / (1 + x) (reference: Math.hpp invlin)."""
    return 1.0 / (1.0 + x)



def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))



def symmetric_hausdorff(distance_matrix: np.ndarray) -> float:
    """max(max_i min_j D, max_j min_i D) (reference: Math.cpp:167-172)."""
    d = np.asarray(distance_matrix)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))



def jaccard_coefficient(a: np.ndarray, b: np.ndarray) -> float:
    """Weighted Jaccard: sum(min) / sum(max) over aligned vectors
    (reference: Math.cpp jaccardCoeff:53-116 — dense and sparse variants;
    pass dense vectors or use SparseRows.to_dense rows)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    union = np.maximum(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.minimum(a, b).sum() / union)

