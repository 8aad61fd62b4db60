"""Exact kNN as blocked float32 matmuls with a stable bottom-k.

Port of the exact tier of sph_tpu/ops/knn.py (reference: sph/utils/Knn.cpp
BruteForce/Flat and the post-processing of sph/NearestNeighbors.cpp:131-170:
sqrt of L2^2, epsilon cleanup, self first).

Distances use the same |x|^2 + |y|^2 - 2 x.y expansion as the JAX package's
``_knn_device`` (not ``torch.cdist``, whose algorithm differs), with the self
distance forced to exactly 0.  The JAX package streams column blocks through
a stable sort of [previous top, new block], so ties go to the lower column;
here each block of query rows is scored against all columns and stable-sorted
once, which selects the same neighbors in the same order.  ``torch.topk``
promises no tie order and is not used.

The approximate tiers (IVF_FLAT, HNSW*, PQ) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..settings import KnnIndex, KnnMetric
from ..utils.logging import Log
from .graph import ensure_self_first
from .numerics import row_sum, sqrt

_F32_EPS = float(np.finfo(np.float32).eps)


def _prepare(data: np.ndarray, metric: KnnMetric) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.float32)
    if metric == KnnMetric.COSINE:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        data = data / norms
    return data


def _knn_rows(base: torch.Tensor, rows: torch.Tensor, k: int,
              metric: KnnMetric, l2_squared: bool, row_block: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of base[rows] against all of base: (indices [M, k] int64,
    distances [M, k] f32), ascending per row."""
    sq = row_sum(base * base)
    col_ids = torch.arange(base.shape[0], device=base.device)
    out_i, out_d = [], []
    for r0 in range(0, rows.numel(), row_block):
        q_ids = rows[r0:r0 + row_block]
        ip = base[q_ids] @ base.T
        if metric == KnnMetric.L2:
            dist = torch.clamp(sq[q_ids, None] + sq[None, :] - 2.0 * ip,
                               min=0.0)
        elif metric == KnnMetric.COSINE:
            # data pre-normalized: chord distance^2 = 2 - 2 cos
            dist = torch.clamp(2.0 - 2.0 * ip, min=0.0)
        else:  # inner product: ascending distance == descending similarity
            dist = -ip
        if metric != KnnMetric.INNER_PRODUCT:
            # force an exact-zero self distance (cancellation in the
            # expansion can leave a residue on the diagonal)
            dist = torch.where(col_ids[None, :] == q_ids[:, None], 0.0, dist)
        sd, si = torch.sort(dist, dim=1, stable=True)
        out_d.append(sd[:, :k])
        out_i.append(si[:, :k])
    top_d = torch.cat(out_d)
    if metric != KnnMetric.INNER_PRODUCT:
        # epsilon cleanup then sqrt (reference: NearestNeighbors.cpp:224-242)
        top_d = torch.where(top_d <= _F32_EPS, 0.0, top_d)
        if metric == KnnMetric.COSINE or not l2_squared:
            top_d = sqrt(top_d)
    return torch.cat(out_i), top_d


def knn_bruteforce(data: np.ndarray, k: int,
                   metric: KnnMetric = KnnMetric.L2,
                   l2_squared: bool = False, device=None,
                   row_block: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN: returns (indices [N, k] int32, distances [N, k] f32).

    The self point is guaranteed to be in slot 0 with distance 0 (reference:
    NearestNeighbors.cpp:162-170 via GraphUtils ensureClosestPointIsSelf).
    COSINE uses chord distance on L2-normalized vectors.
    """
    data = _prepare(data, metric)
    n = data.shape[0]
    if k > n:
        raise ValueError(f"k={k} > num_points={n}")
    base = torch.as_tensor(data, device=resolve_device(device))
    idx, dist = _knn_rows(base, torch.arange(n, device=base.device), k,
                          metric, l2_squared, row_block)
    idx, dist, adjusted = ensure_self_first(
        idx.to(torch.int32).cpu().numpy(), dist.cpu().numpy())
    if adjusted:
        Log.info("knn_bruteforce: self-first adjusted %d of %d rows",
                 adjusted, n)
    return idx.astype(np.int32), dist.astype(np.float32)


def knn_exact_rows(data: np.ndarray, rows: np.ndarray, k: int,
                   metric: KnnMetric = KnnMetric.L2,
                   l2_squared: bool = False, device=None,
                   row_block: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN restricted to `rows` query ids: (indices [M, k] int32,
    distances [M, k] f32) with `knn_bruteforce`'s semantics for those rows.
    """
    base = torch.as_tensor(_prepare(data, metric),
                           device=resolve_device(device))
    q = torch.as_tensor(np.asarray(rows, np.int64), device=base.device)
    idx, dist = _knn_rows(base, q, k, metric, l2_squared, row_block)
    return (idx.to(torch.int32).cpu().numpy(),
            dist.cpu().numpy().astype(np.float32))


def index_heuristic(num_points: int) -> KnnIndex:
    """Size-tier engine choice (reference: sph/NearestNeighbors.hpp:50-63,
    with the JAX package's 50k exact cutoff)."""
    if num_points <= 50_000:
        return KnnIndex.BRUTE_FORCE
    if num_points <= 100_000:
        return KnnIndex.IVF_FLAT
    if num_points <= 25_000_000:
        return KnnIndex.HNSW
    if num_points <= 50_000_000:
        return KnnIndex.HNSWSQ
    return KnnIndex.HNSW_IVFPQ


def compute_knn(data: np.ndarray, k: int,
                index: KnnIndex = KnnIndex.FLAT,
                metric: KnnMetric = KnnMetric.L2,
                l2_squared: bool = False,
                device=None) -> tuple[np.ndarray, np.ndarray]:
    """Engine dispatch (reference: NearestNeighbors.cpp:131-141)."""
    if index in (KnnIndex.BRUTE_FORCE, KnnIndex.FLAT):
        return knn_bruteforce(data, k, metric, l2_squared, device=device)
    raise NotImplementedError(
        f"kNN index {index.value} not ported yet; see ROADMAP")
