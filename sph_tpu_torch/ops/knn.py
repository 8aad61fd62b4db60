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

The approximate tiers (IVF_FLAT and HNSW as flat IVF, HNSWSQ over SQ8
reconstructions, HNSW_IVFPQ over product-quantized codes with an exact
re-rank) are ``knn_ivf``: k-means clustering, the inverted lists cut into
fixed-size segments, and each query segment scored against the segments of
its cluster's probe clusters.  Its host layout is the JAX package's numpy,
call for call, so the candidate lists and their order are the same; see
``knn_ivf`` for what differs on the device.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..settings import KnnIndex, KnnMetric
from ..utils.logging import Log
from .graph import ensure_self_first
from .numerics import row_dot, sqrt

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
    sq = row_dot(base, base)
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


# ---------------------------------------------------------------------------
# IVF tier: k-means coarse quantizer + cluster-grouped exact search
# ---------------------------------------------------------------------------
# Port of sph_tpu/ops/knn.py:328-907 (reference: Knn.cpp computeIndexIVFFlat
# :138-175, HNSWSQ :246-319, HNSW_IVFPQ :322-368).  Queries are grouped by
# their own cluster; every query segment scores against all segments of its
# cluster's nprobe nearest clusters.

def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_rows(data: np.ndarray, npad: int) -> np.ndarray:
    out = np.zeros((npad, data.shape[1]), dtype=np.float32)
    out[:data.shape[0]] = data
    return out


def _kmeans(data: torch.Tensor, n_valid: int, init: torch.Tensor,
            nlist: int, iters: int, block: int = 65536
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd sweeps over `data` [npts, D] (npts a multiple of `block`),
    blocked over rows: (centroids [nlist, D] f32, assignment [npts] int64).
    Rows >= n_valid are pads: left out of the update and assigned `nlist`.

    The JAX package's arithmetic (sph_tpu/ops/knn.py:398-446): distances
    |x|^2 + |c|^2 - 2 x.c, argmin with ties to the first centroid, centroid
    sums as one-hot matmuls accumulated block by block, so the sums run in
    a fixed order (no atomics) and two runs give the same clustering.  The
    sums' order differs from XLA's, by ulps."""
    npts = data.shape[0]
    sq = row_dot(data, data)
    valid = torch.arange(npts, device=data.device) < n_valid

    def assign(cents, csq, b0):
        x = data[b0:b0 + block]
        d = torch.add(sq[b0:b0 + block, None], csq[None, :])
        d.sub_((x @ cents.T).mul_(2.0))
        a = torch.argmin(d, dim=1)
        return x, torch.where(valid[b0:b0 + block], a, nlist)

    cells = torch.arange(nlist, device=data.device)
    cents = init
    for _ in range(iters):
        csq = row_dot(cents, cents)
        sums = torch.zeros_like(cents)
        cnts = torch.zeros(nlist, dtype=torch.float32, device=data.device)
        for b0 in range(0, npts, block):
            x, a = assign(cents, csq, b0)
            oh = (a[:, None] == cells).to(torch.float32)   # pads: all 0
            sums = sums + oh.T @ x
            cnts = cnts + oh.sum(0)
        cents = torch.where(cnts[:, None] > 0,
                            sums / cnts.clamp(min=1.0)[:, None], cents)
    csq = row_dot(cents, cents)
    return cents, torch.cat([assign(cents, csq, b0)[1]
                             for b0 in range(0, npts, block)])


def sq8_reconstruct(data: np.ndarray) -> np.ndarray:
    """HNSWSQ-tier 8-bit scalar quantization round-trip (reference: Knn.cpp
    computeIndexHNSWSQ:246-319 with faiss QT_8bit): per-dimension affine
    codes; candidates are scored on the dequantized values.  Shared by the
    IVF scoring and the exact refill, so one result never mixes
    full-precision and reconstruction distances."""
    lo = data.min(axis=0)
    hi = data.max(axis=0)
    scale_q = np.where(hi > lo, (hi - lo) / 255.0, 1.0)
    codes = np.clip(np.round((data - lo) / scale_q), 0, 255).astype(np.uint8)
    return (codes.astype(np.float32) * scale_q + lo).astype(np.float32)


# Product quantization, the HNSW_IVFPQ tier's codec (reference: Knn.cpp
# computeIndexHNSW_IVFPQ:322-368, faiss IndexIVFPQ with m = 16 one-byte
# subquantizers over the residual x - coarse_centroid(x)).

def pq_train(data: np.ndarray, cents: np.ndarray, assign: np.ndarray,
             m: int = 16, ksub: int = 256, sample: int = 65536,
             seed: int = 0, iters: int = 10, device=None) -> np.ndarray:
    """Per-subspace codebooks [m, ksub, ds] f32 (ds = ceil(D / m), D
    zero-padded to m * ds) from k-means over a sample of coarse residuals;
    the numpy draws are the JAX package's, in its order."""
    dev = resolve_device(device)
    n, d = data.shape
    ds = (d + m - 1) // m
    rng = np.random.default_rng(seed)
    take = rng.choice(n, min(sample, n), replace=False)
    resid = data[take] - cents[assign[take]]
    if m * ds != d:
        resid = np.pad(resid, ((0, 0), (0, m * ds - d)))
    sub = resid.reshape(-1, m, ds)

    codebooks = np.zeros((m, ksub, ds), np.float32)
    block = min(65536, _ceil_to(sub.shape[0], 1024))
    for s in range(m):
        x = np.ascontiguousarray(sub[:, s, :], np.float32)
        kk = min(ksub, x.shape[0])
        init = x[rng.choice(x.shape[0], kk, replace=False)]
        if kk < ksub:
            init = np.pad(init, ((0, ksub - kk), (0, 0)))
        npad = _ceil_to(x.shape[0], block)
        cb, _ = _kmeans(torch.as_tensor(_pad_rows(x, npad), device=dev),
                        x.shape[0], torch.as_tensor(init, device=dev), ksub,
                        iters, block=block)
        codebooks[s] = cb.cpu().numpy()
    return codebooks


def _pq_encode_block(resid: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """Nearest codebook entry of each subvector: resid [B, m, ds],
    codebooks [m, ksub, ds] -> codes [B, m] uint8."""
    ip = torch.bmm(resid.transpose(0, 1), codebooks.transpose(1, 2))
    d2 = row_dot(codebooks, codebooks)[:, None, :] - 2.0 * ip
    return torch.argmin(d2, dim=2).to(torch.uint8).T


def pq_encode(data: np.ndarray, cents: np.ndarray, assign: np.ndarray,
              codebooks: np.ndarray, block: int = 131072,
              device=None) -> np.ndarray:
    """Every vector's coarse residual as [N, m] uint8 codes."""
    dev = resolve_device(device)
    n, d = data.shape
    m, _, ds = codebooks.shape
    cb = torch.as_tensor(codebooks, device=dev)
    out = np.empty((n, m), np.uint8)
    for b0 in range(0, n, block):
        be = min(b0 + block, n)
        resid = data[b0:be] - cents[assign[b0:be]]
        if m * ds != d:
            resid = np.pad(resid, ((0, 0), (0, m * ds - d)))
        out[b0:be] = _pq_encode_block(torch.as_tensor(
            resid.reshape(be - b0, m, ds), device=dev), cb).cpu().numpy()
    return out


def _pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [..., m] -> the codebook entries [..., m * ds]: a gather, equal
    bit for bit to the JAX package's one_hot(codes) @ codebook (one nonzero
    term times 1.0)."""
    m, _, ds = codebooks.shape
    sub = torch.arange(m, device=codes.device)
    return codebooks[sub, codes.long()].reshape(*codes.shape[:-1], m * ds)


def pq_reconstruct_rows(codes: np.ndarray, cents: np.ndarray,
                        assign: np.ndarray, codebooks: np.ndarray,
                        d: int, block: int = 262144,
                        device=None) -> np.ndarray:
    """PQ codes decoded back to [N, d] f32: coarse centroid plus codebook
    entries."""
    dev = resolve_device(device)
    n = codes.shape[0]
    cb = torch.as_tensor(codebooks, device=dev)
    out = np.empty((n, d), np.float32)
    for b0 in range(0, n, block):
        be = min(b0 + block, n)
        dec = _pq_decode(torch.as_tensor(codes[b0:be], device=dev), cb)
        out[b0:be] = dec[:, :d].cpu().numpy() + cents[assign[b0:be]]
    return out


# bytes held for each scored (query, candidate) pair of an IVF window: the
# float32 product, the distance tile built from it, and the copy of the live
# query rows that the selection reads
_IVF_BYTES_PER_PAIR = 12


def _smallest(dist: torch.Tensor, k: int, memory_budget: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions and values of the k smallest entries of each row of `dist`
    [R, L], ascending by (value, position): a stable sort's order.  Rows
    narrower than k end in (position -1, +inf)."""
    pos = _bottom_k(dist, min(k, dist.shape[1]), memory_budget)
    val = dist.gather(1, pos)
    if pos.shape[1] < k:
        pos = F.pad(pos, (0, k - pos.shape[1]), value=-1)
        val = F.pad(val, (0, k - val.shape[1]), value=float("inf"))
    return pos, val


def _expansion(q: torch.Tensor, qsq: torch.Tensor, c: torch.Tensor,
               csq: torch.Tensor, metric: KnnMetric) -> torch.Tensor:
    """Distances of query batches q [W, S, D] to candidate batches
    c [W, L, D] (squared norms qsq [W, S], csq [W, L]): [W, S, L], as the
    JAX package's IVF scoring computes them, max((|q|^2 + |c|^2) - 2 q.c, 0),
    with no forced zero self distance."""
    ip = torch.bmm(q, c.transpose(1, 2))
    if metric == KnnMetric.INNER_PRODUCT:
        return ip.neg_()
    dist = torch.add(qsq[:, :, None], csq[:, None, :])
    return dist.sub_(ip.mul_(2.0)).clamp_(min=0.0)


def _rerank_exact(data: torch.Tensor, sq: torch.Tensor, qids: torch.Tensor,
                  short: torch.Tensor, k: int, metric: KnnMetric,
                  memory_budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of ADC shortlists (sph_tpu/ops/knn.py:595-633): query
    points `qids` [R] against their candidates `short` [R, L] (-1 pads) at
    full precision, the self pair exactly 0 (the expansion cancels there),
    ties to the earlier shortlist slot: (ids [R, k], squared distances)."""
    per_row = short.shape[1] * (4 * data.shape[1] + 24)
    rows = max(1, memory_budget // per_row)
    out_i, out_d = [], []
    for r0 in range(0, qids.numel(), rows):
        ids, qi = short[r0:r0 + rows], qids[r0:r0 + rows]
        safe = ids.clamp(min=0)
        ip = torch.bmm(data[safe], data[qi][:, :, None])[:, :, 0]
        if metric == KnnMetric.INNER_PRODUCT:
            dist = ip.neg_()
        else:
            dist = torch.add(sq[qi][:, None], sq[safe])
            dist.sub_(ip.mul_(2.0)).clamp_(min=0.0)
            dist.masked_fill_(ids == qi[:, None], 0.0)
        dist.masked_fill_(ids < 0, float("inf"))
        pos, val = _smallest(dist, k, memory_budget)
        out_i.append(torch.where(pos >= 0, ids.gather(1, pos.clamp(min=0)),
                                 -1))
        out_d.append(val)
    return torch.cat(out_i), torch.cat(out_d)


def knn_ivf(data: np.ndarray, k: int,
            metric: KnnMetric = KnnMetric.L2,
            l2_squared: bool = False,
            nlist: Optional[int] = None,
            nprobe: Optional[int] = None,
            seed: int = 0,
            quantize: bool = False,
            pq: bool = False,
            query_rows: Optional[np.ndarray] = None,
            device=None,
            stats: Optional[dict] = None) -> tuple[np.ndarray, np.ndarray]:
    """Approximate kNN by IVF cluster pruning (reference: Knn.cpp
    computeIndexIVFFlat:138-175: nlist = max(100, sqrt(n)), nprobe =
    sqrt(nlist)): (indices [N, k] int32, distances [N, k] f32), rows with
    fewer than k candidates ending in (-1, +inf).

    The host layout (k-means draws, empty-cell reseeding, cluster order,
    probes, segments) is the JAX package's numpy, call for call.  On the
    device each window of query segments is scored as one batched matmul
    against its probe segments, in place of the JAX package's per-probe
    streaming sort: the k smallest are selected by (distance, position in
    the concatenated probe-segment list), which is the order that sort
    leaves.  Pad query lanes are dropped before the selection and trailing
    pad segments are not scored.  The window is sized so its tiles stay
    within KNN_MEMORY_BUDGET bytes.  quantize: score SQ8 reconstructions
    (HNSWSQ); pq: score 16-byte PQ codes asymmetrically against
    full-precision queries, keep a shortlist of max(SPH_PQ_RERANK, 2k) and
    re-rank it exactly (HNSW_IVFPQ).  query_rows: return only these rows.
    `stats`, when given, receives the layout's sizes.
    """
    dev = resolve_device(device)
    data = _prepare(data, metric)
    n, d = data.shape

    if nlist is None:
        nlist = max(100, int(math.sqrt(n)))
    nlist = min(nlist, n)
    if nprobe is None:
        nprobe = max(1, int(math.sqrt(nlist)))
    nprobe = min(nprobe, nlist)

    rng = np.random.default_rng(seed)
    init = data[rng.choice(n, nlist, replace=False)]
    km_block = min(65536, _ceil_to(n, 1024))
    data_km = torch.as_tensor(_pad_rows(data, _ceil_to(n, km_block)),
                              device=dev)
    cents_d, assign_d = _kmeans(data_km, n, torch.as_tensor(init, device=dev),
                                nlist, 10, block=km_block)
    # empty-cell reseeding (FAISS Clustering::train semantics), the JAX
    # package's loop (sph_tpu/ops/knn.py:715-737) with its draws in order
    for _ in range(3):
        assign = assign_d.cpu().numpy()[:n]
        counts0 = np.bincount(assign, minlength=nlist)
        empty = np.nonzero(counts0 == 0)[0]
        if len(empty) <= max(nlist // 200, 0):
            break
        cents = cents_d.cpu().numpy()
        big = np.argsort(-counts0)[:max(len(empty), 1)]
        donors = rng.permutation(np.nonzero(np.isin(assign, big))[0])
        take = donors[:len(empty)] if len(donors) >= len(empty) else (
            rng.choice(n, len(empty)))
        cents[empty] = data[take] * (1.0 + 1e-4) + 1e-6
        cents_d, assign_d = _kmeans(data_km, n,
                                    torch.as_tensor(cents, device=dev),
                                    nlist, 5, block=km_block)
    cents = cents_d.cpu().numpy()
    assign = assign_d.cpu().numpy()[:n]

    # cluster-sorted point order (the inverted lists)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    if quantize:
        data = sq8_reconstruct(data)

    # nprobe nearest centroids per cluster, the cluster itself always in
    ccd = (np.sum(cents * cents, 1)[:, None]
           + np.sum(cents * cents, 1)[None, :] - 2.0 * cents @ cents.T)
    probes = np.argpartition(ccd, min(nprobe, nlist - 1),
                             axis=1)[:, :nprobe].astype(np.int32)
    has_self = (probes == np.arange(nlist)[:, None]).any(axis=1)
    probes[:, 0] = np.where(has_self, probes[:, 0], np.arange(nlist))

    # every inverted list cut into segments of seg points (-1 padded)
    seg = max(256, 1 << max(int(math.ceil(n / nlist)) - 1, 0).bit_length())
    seg = min(seg, 8192)
    nseg_per = np.maximum((counts + seg - 1) // seg, 0)
    seg_starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(nseg_per, out=seg_starts[1:])
    s_total = int(seg_starts[-1])
    flat = np.full(s_total * seg, -1, np.int32)
    within = np.arange(n) - starts[sorted_assign]
    flat[seg_starts[sorted_assign] * seg + within] = order.astype(np.int32)
    segtab = flat.reshape(s_total, seg)
    seg_cluster = np.repeat(np.arange(nlist), nseg_per)

    if pq:
        codebooks = pq_train(data, cents, assign, seed=seed, device=dev)
        codes = pq_encode(data, cents, assign, codebooks, device=dev)
        Log.info("knn_ivf: PQ codec m=%d ksub=%d ds=%d (%d B/vec vs %d)",
                 codebooks.shape[0], codebooks.shape[1], codebooks.shape[2],
                 codebooks.shape[0], 4 * d)

    # the probe segments of each cluster, in probe order (-1 padded at the
    # end), shared by all of its query segments
    psegs_counts = nseg_per[probes].sum(axis=1)
    max_psegs = max(int(psegs_counts.max()), 1)
    psegs_cl = np.full((nlist, max_psegs), -1, np.int32)
    for c in range(nlist):
        out = []
        for pc in probes[c]:
            out.extend(range(int(seg_starts[pc]), int(seg_starts[pc + 1])))
        psegs_cl[c, :len(out)] = out
    psegs = psegs_cl[seg_cluster]

    data_d = (torch.as_tensor(data, device=dev) if quantize
              else data_km[:n])
    del data_km
    sq = row_dot(data_d, data_d)
    segtab_d = torch.as_tensor(segtab.astype(np.int64), device=dev)
    psegs_d = torch.as_tensor(psegs.astype(np.int64), device=dev)
    if pq:
        cb_d = torch.as_tensor(codebooks, device=dev)
        codes_d = torch.as_tensor(codes, device=dev)
        cents_t = torch.as_tensor(cents, device=dev)
        segcl_d = torch.as_tensor(seg_cluster.astype(np.int64), device=dev)
        dpad = cb_d.shape[0] * cb_d.shape[2] - d
        # ADC alone misranks near-ties below the quantization noise: search
        # a wider shortlist, then re-rank it exactly
        ksearch = min(max(int(os.environ.get("SPH_PQ_RERANK", "512")),
                          2 * k), seg * max_psegs)
    budget = KNN_MEMORY_BUDGET
    swin = max(1, budget // (_IVF_BYTES_PER_PAIR * seg * seg * max_psegs))
    out_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    out_d = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    for s0 in range(0, s_total, swin):
        qids = segtab_d[s0:s0 + swin]
        plist = psegs_d[s0:s0 + swin]
        plist = plist[:, :int((plist >= 0).sum(1).max())]
        w = qids.shape[0]
        cand = torch.where(plist[:, :, None] >= 0,
                           segtab_d[plist.clamp(min=0)], -1).reshape(w, -1)
        safe = cand.clamp(min=0)
        q = data_d[qids.clamp(min=0)]
        if pq:
            coarse = cents_t[segcl_d[plist.clamp(min=0)]]
            c = (_pq_decode(codes_d[safe], cb_d).view(
                w, plist.shape[1], seg, -1)
                + F.pad(coarse, (0, dpad))[:, :, None, :]).view(
                    w, cand.shape[1], -1)
            q = F.pad(q, (0, dpad))
            dist = _expansion(q, row_dot(q, q), c, row_dot(c, c), metric)
        else:
            c = data_d[safe]
            dist = _expansion(q, sq[qids.clamp(min=0)], c, sq[safe], metric)
        del c
        dist.masked_fill_((cand < 0)[:, None, :], float("inf"))
        live = qids.reshape(-1) >= 0
        rows = dist.view(-1, cand.shape[1])[live]
        del dist
        owner = torch.arange(w, device=dev).repeat_interleave(seg)[live]
        pos, val = _smallest(rows, ksearch if pq else k, budget)
        del rows
        ids = torch.where(torch.isfinite(val),
                          cand[owner[:, None], pos.clamp(min=0)], -1)
        qrows = qids.reshape(-1)[live]
        if pq:
            ids, val = _rerank_exact(data_d, sq, qrows, ids, k, metric,
                                     budget)
        out_i[qrows] = ids
        out_d[qrows] = val

    if metric != KnnMetric.INNER_PRODUCT:
        out_d = torch.where(out_d <= _F32_EPS, 0.0, out_d)
        if not l2_squared:
            out_d = sqrt(out_d)
    if stats is not None:
        stats.update({"n": n, "nlist": nlist, "nprobe": nprobe, "seg": seg,
                      "segments": s_total, "max_psegs": max_psegs,
                      "window_segments": swin,
                      "empty_cells": int((counts == 0).sum()),
                      "shortlist": ksearch if pq else k})
    idx, dist, _ = ensure_self_first(out_i.to(torch.int32).cpu().numpy(),
                                     out_d.cpu().numpy())
    if query_rows is not None:
        rows = np.asarray(query_rows, np.int64)
        idx, dist = idx[rows], dist[rows]
    return idx.astype(np.int32), dist.astype(np.float32)


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
                seed: int = 0,
                device=None,
                stats: Optional[dict] = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Engine dispatch (reference: NearestNeighbors.cpp:131-141): the exact
    engines are ``knn_bruteforce``; IVF_FLAT and HNSW are flat ``knn_ivf``,
    HNSWSQ scores SQ8 reconstructions, HNSW_IVFPQ PQ codes.  Rows the IVF
    tier leaves incomplete get an exact refill (reference: Knn.cpp:214-243),
    on the SQ8 reconstruction for HNSWSQ; more than max(1024, n / 4) of them
    fall back to the exact kNN of all rows, as the reference does
    (NearestNeighbors.cpp:143-148).  `stats`, when given, receives the IVF
    layout's sizes, `refilled_rows` and `exact_fallback`."""
    if index in (KnnIndex.BRUTE_FORCE, KnnIndex.FLAT):
        return knn_bruteforce(data, k, metric, l2_squared, device=device)
    if index not in (KnnIndex.IVF_FLAT, KnnIndex.HNSW, KnnIndex.HNSWSQ,
                     KnnIndex.HNSW_IVFPQ):
        raise ValueError(f"unknown index {index}")
    quantize = index == KnnIndex.HNSWSQ
    stats = {} if stats is None else stats
    idx, dist = knn_ivf(data, k, metric, l2_squared, seed=seed,
                        quantize=quantize, pq=index == KnnIndex.HNSW_IVFPQ,
                        device=device, stats=stats)
    miss = np.unique(np.nonzero(idx < 0)[0])
    stats.update({"refilled_rows": 0, "exact_fallback": False})
    if miss.size == 0:
        return idx, dist
    if miss.size > max(1024, idx.shape[0] // 4):
        Log.warn("compute_knn: IVF left %d/%d incomplete rows, falling back "
                 "to exact (reference: NearestNeighbors.cpp:143-148)",
                 miss.size, idx.shape[0])
        stats["exact_fallback"] = True
        return knn_bruteforce(data, k, metric, l2_squared, device=device)
    Log.warn("compute_knn: exact refill of %d/%d incomplete IVF rows "
             "(reference: NearestNeighbors.cpp:143-148)", miss.size,
             idx.shape[0])
    stats["refilled_rows"] = int(miss.size)
    refill_data = sq8_reconstruct(np.ascontiguousarray(
        data, dtype=np.float32)) if quantize else data
    idx[miss], dist[miss] = knn_exact_rows(refill_data, miss, k, metric,
                                           l2_squared, device=device)
    idx, dist, _ = ensure_self_first(idx, dist)
    return idx.astype(np.int32), dist.astype(np.float32)
