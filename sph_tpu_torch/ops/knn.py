"""Exact kNN as blocked float32 matmuls with a stable bottom-k.

Port of the exact tier of sph_tpu/ops/knn.py (reference: sph/utils/Knn.cpp
BruteForce/Flat and the post-processing of sph/NearestNeighbors.cpp:131-170:
sqrt of L2^2, epsilon cleanup, self first).

Distances use the same |x|^2 + |y|^2 - 2 x.y expansion as the JAX package's
``_knn_device`` (not ``torch.cdist``, whose algorithm differs), with the self
distance forced to exactly 0.  The JAX package streams column blocks through
a stable sort of [previous top, new block], so ties go to the lower column.
Here each block of query rows is scored against all columns with one
float32 matmul, and the bottom-k is selected in the exact (distance, column)
order: ``torch.topk`` picks the k + 1 smallest distances, a sort of their
tie-free int64 keys (orderable float bits << 32 | column) orders them, and a
row whose k-th and (k + 1)-th distances tie, where ``torch.topk`` may have
left out a lower column of equal distance, takes the bottom-k of the keys of
its whole row instead.  The row block is sized from a memory budget that
counts the [rows, N] distance tile and its float32 product; the tied rows
are keyed in sub-blocks sized from the half of it that the tile leaves
free.  ``torch.topk``'s own scratch and the data matrix come on top.

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


# bytes held for each scored (query, column) pair: the float32 product and
# the float32 distance tile built from it
_BYTES_PER_PAIR = 8
# bytes for each (tied row, column) pair keyed in full: the gathered float32
# distances, their int32 bits and the int64 keys with one temporary
_KEY_BYTES_PER_PAIR = 28
KNN_MEMORY_BUDGET = 4 << 30


def knn_row_block(num_cols: int, memory_budget: int = KNN_MEMORY_BUDGET
                  ) -> int:
    """Query rows per block so that the block's [rows, num_cols] buffers stay
    within `memory_budget` bytes (a multiple of 8, at least 8)."""
    rows = memory_budget // (_BYTES_PER_PAIR * max(num_cols, 1))
    return max(8, rows // 8 * 8)


def _keys(dist: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (distance, column): the float32 bits mapped to
    an order-preserving int32 (-0.0 taken as +0.0), shifted above the
    column."""
    bits = torch.where(dist == 0, 0.0, dist).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) | cols


def knn_tied_block(num_cols: int, memory_budget: int = KNN_MEMORY_BUDGET
                   ) -> int:
    """Tied rows keyed at once: their [rows, num_cols] keys and temporaries
    stay within the half of `memory_budget` that the distance tile leaves
    (at least 1)."""
    return max(1, memory_budget // 2 // (_KEY_BYTES_PER_PAIR
                                         * max(num_cols, 1)))


def _bottom_k(dist: torch.Tensor, k: int, memory_budget: int
              ) -> torch.Tensor:
    """Columns of the k smallest entries of each row of `dist` [R, N],
    ascending by (distance, column), as [R, k] int64."""
    n = dist.shape[1]
    m = min(k + 1, n)
    cand_d, cand_i = torch.topk(dist, m, dim=1, largest=False, sorted=True)
    keys, _ = torch.sort(_keys(cand_d, cand_i), dim=1)
    if m > k:
        tied = torch.nonzero(cand_d[:, k] == cand_d[:, k - 1]).flatten()
        cols = torch.arange(n, device=dist.device)[None, :]
        step = knn_tied_block(n, memory_budget)
        for t0 in range(0, tied.numel(), step):
            rows = tied[t0:t0 + step]
            keys[rows, :k] = torch.topk(_keys(dist[rows], cols), k, dim=1,
                                        largest=False, sorted=True).values
    return keys[:, :k] & 0xFFFFFFFF


def _knn_rows(base: torch.Tensor, rows: torch.Tensor, k: int,
              metric: KnnMetric, l2_squared: bool, memory_budget: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of base[rows] against all of base: (indices [M, k] int64,
    distances [M, k] f32), ascending per row."""
    sq = row_sum(base * base)
    row_block = knn_row_block(base.shape[0], memory_budget)
    out_i, out_d = [], []
    for r0 in range(0, rows.numel(), row_block):
        q_ids = rows[r0:r0 + row_block]
        ip = base[q_ids] @ base.T
        if metric == KnnMetric.L2:
            # (|x|^2 + |y|^2) - 2 x.y, in place, in the JAX package's order
            dist = torch.add(sq[q_ids, None], sq[None, :])
            dist.sub_(ip.mul_(2.0)).clamp_(min=0.0)
        elif metric == KnnMetric.COSINE:
            # data pre-normalized: chord distance^2 = 2 - 2 cos
            dist = ip.mul_(-2.0).add_(2.0).clamp_(min=0.0)
        else:  # inner product: ascending distance == descending similarity
            dist = ip.neg_()
        del ip
        if metric != KnnMetric.INNER_PRODUCT:
            # force an exact-zero self distance (cancellation in the
            # expansion can leave a residue on the diagonal)
            dist[torch.arange(q_ids.numel(), device=dist.device), q_ids] = 0.0
        top_i = _bottom_k(dist, k, memory_budget)
        out_d.append(dist.gather(1, top_i))
        out_i.append(top_i)
        del dist
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
                   memory_budget: int = KNN_MEMORY_BUDGET
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN: returns (indices [N, k] int32, distances [N, k] f32).

    The self point is guaranteed to be in slot 0 with distance 0 (reference:
    NearestNeighbors.cpp:162-170 via GraphUtils ensureClosestPointIsSelf).
    COSINE uses chord distance on L2-normalized vectors.  `memory_budget`
    bounds the bytes of each block's distance tile (``knn_row_block``).
    """
    data = _prepare(data, metric)
    n = data.shape[0]
    if k > n:
        raise ValueError(f"k={k} > num_points={n}")
    base = torch.as_tensor(data, device=resolve_device(device))
    idx, dist = _knn_rows(base, torch.arange(n, device=base.device), k,
                          metric, l2_squared, memory_budget)
    idx, dist, adjusted = ensure_self_first(
        idx.to(torch.int32).cpu().numpy(), dist.cpu().numpy())
    if adjusted:
        Log.info("knn_bruteforce: self-first adjusted %d of %d rows",
                 adjusted, n)
    return idx.astype(np.int32), dist.astype(np.float32)


def knn_exact_rows(data: np.ndarray, rows: np.ndarray, k: int,
                   metric: KnnMetric = KnnMetric.L2,
                   l2_squared: bool = False, device=None,
                   memory_budget: int = KNN_MEMORY_BUDGET
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN restricted to `rows` query ids: (indices [M, k] int32,
    distances [M, k] f32) with `knn_bruteforce`'s semantics for those rows.
    """
    base = torch.as_tensor(_prepare(data, metric),
                           device=resolve_device(device))
    q = torch.as_tensor(np.asarray(rows, np.int64), device=base.device)
    idx, dist = _knn_rows(base, q, k, metric, l2_squared, memory_budget)
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
