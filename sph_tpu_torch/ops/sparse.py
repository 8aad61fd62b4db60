"""Fixed-width sparse row algebra on torch tensors.

Port of the main path's subset of sph_tpu/ops/sparse.py (reference: the Eigen
``SparseVecSPH`` rows and sph/utils/SparseMatrixAlgorithms.cpp).  The layout
is the JAX package's: ``indices [N, R]`` (pad -1, ascending within each row,
pads last) and ``values [N, R]`` (0 at pads), here as int64 / float32 tensors
on one device.  Widths are the exact widest row, not the JAX package's
power-of-two buckets, which existed only to bound XLA recompiles.

Each op runs as torch ops on the rows' device, except the two merges
(``merge_rows_by_parents``, ``merge_rows_min_by_parents``), which take the
host C++ merge (native/graphops.cpp) as the JAX package does off the TPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..utils.logging import Log
from .numerics import _fma, log, row_sum, sqrt

PAD = -1
_BIG = torch.iinfo(torch.int64).max


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=resolve_device(device))


class SparseRows:
    """Row-sparse matrix with fixed-width rows.

    idx: [N, R] int64 tensor, PAD (-1) padded, ascending within each row
    val: [N, R] float32 tensor, 0 at pads
    num_cols: logical column count of the matrix

    The constructor takes numpy arrays or tensors; numpy input lands on
    `device` (CUDA when none is given, see device.py), tensors stay where
    they are unless `device` is named.  `indices` / `values` return host numpy
    copies in the JAX package's dtypes (int32 / float32).
    """

    __slots__ = ("idx", "val", "num_cols")

    def __init__(self, indices, values, num_cols: int, device=None):
        self.idx = _as_tensor(indices, torch.int64, device)
        self.val = _as_tensor(values, torch.float32, self.idx.device)
        self.num_cols = int(num_cols)

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def indices(self) -> np.ndarray:
        return self.idx.to(torch.int32).cpu().numpy()

    @property
    def values(self) -> np.ndarray:
        return self.val.cpu().numpy()

    @property
    def shape(self) -> tuple:
        return tuple(self.idx.shape)

    @property
    def num_rows(self) -> int:
        return self.idx.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    def _live(self) -> torch.Tensor:
        return (self.idx >= 0) & (self.val != 0)

    def nnz(self) -> int:
        return int(self._live().sum())

    def row_nnz(self) -> np.ndarray:
        return self._live().sum(1).cpu().numpy()

    def row_sums(self) -> np.ndarray:
        return row_sum(torch.where(self.idx >= 0, self.val, 0.0)).cpu().numpy()

    def to_dense(self) -> np.ndarray:
        out = torch.zeros((self.num_rows, self.num_cols), dtype=torch.float32,
                          device=self.device)
        rows = torch.arange(self.num_rows, device=self.device)[:, None]
        ok = self.idx >= 0
        out.index_put_((rows.expand_as(self.idx)[ok], self.idx[ok]),
                       self.val[ok], accumulate=True)
        return out.cpu().numpy()

    def copy(self) -> "SparseRows":
        return SparseRows(self.idx.clone(), self.val.clone(), self.num_cols)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def compact(idx: torch.Tensor, val: torch.Tensor, num_cols: int
            ) -> SparseRows:
    """Push pads to the row ends, keep ascending index order (stable)."""
    key = torch.where(idx < 0, _BIG, idx)
    _, order = torch.sort(key, dim=1, stable=True)
    return SparseRows(idx.gather(1, order), val.gather(1, order), num_cols)


def pack_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             num_rows: int, num_cols: int,
             max_width: Optional[int] = None) -> SparseRows:
    """Pack (row, col, val) triples, sorted by (row, col), into padded rows
    of the exact widest row.  max_width keeps each row's largest values
    (ties to the lower column), as ``topk_rows`` would on the packed rows,
    without ever holding rows wider than that."""
    dev = vals.device
    counts = torch.bincount(rows, minlength=num_rows)
    if (max_width is not None and rows.numel()
            and int(counts.max()) > max_width):
        by_val = torch.sort(-vals, stable=True).indices
        order = by_val[torch.sort(rows[by_val], stable=True).indices]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(rows.numel(), device=dev) - starts[rows[order]]
        keep = torch.sort(order[rank < max_width]).values
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        counts = torch.bincount(rows, minlength=num_rows)
    width = max(int(counts.max()) if rows.numel() else 1, 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=dev) - starts[rows]
    idx = torch.full((num_rows, width), PAD, dtype=torch.int64, device=dev)
    val = torch.zeros((num_rows, width), dtype=torch.float32, device=dev)
    idx[rows, slot] = cols
    val[rows, slot] = vals
    return SparseRows(idx, val, num_cols)


def _live_coo(sr: SparseRows):
    """(rows, cols, vals) of the entries with a valid index and a non-zero
    value, in row-major order."""
    live = sr._live()
    rows = torch.arange(sr.num_rows, device=sr.device)[:, None].expand_as(
        sr.idx)
    return rows[live], sr.idx[live], sr.val[live]


# ---------------------------------------------------------------------------
# normalization / cleanup (reference: SparseMatrixAlgorithms.cpp:617-718)
# ---------------------------------------------------------------------------

def normalize_rows(sr: SparseRows) -> SparseRows:
    """Each row sums to one (normalizeUnitSparseMatrix)."""
    s = row_sum(torch.where(sr.idx >= 0, sr.val, 0.0))[:, None]
    return SparseRows(sr.idx, sr.val / torch.where(s == 0, 1.0, s),
                      sr.num_cols)


def normalize_matrix(sr: SparseRows) -> SparseRows:
    """The whole matrix sums to one (normalizeSparseMatrix)."""
    s = torch.where(sr.idx >= 0, sr.val, 0.0).sum()
    return SparseRows(sr.idx, sr.val / torch.where(s == 0, 1.0, s),
                      sr.num_cols)


def remove_diagonal(sr: SparseRows, keep_single_entry: bool = True
                    ) -> SparseRows:
    """Zero out self entries (removeDiagonalElements,
    SparseMatrixAlgorithms.cpp:704-718).  Rows whose only entry is the
    diagonal keep it when keep_single_entry."""
    rows = torch.arange(sr.num_rows, device=sr.device)[:, None]
    diag = sr.idx == rows
    if keep_single_entry:
        diag = diag & (sr._live().sum(1, keepdim=True) > 1)
    val = torch.where(diag, 0.0, sr.val)
    idx = torch.where(diag & (val == 0), PAD, sr.idx)
    return compact(idx, val, sr.num_cols)


def prune_values(sr: SparseRows, threshold: float) -> SparseRows:
    """Remove entries with value <= threshold (doRandomWalks pruning)."""
    keep = sr.val > threshold
    return compact(torch.where(keep, sr.idx, PAD),
                   torch.where(keep, sr.val, 0.0), sr.num_cols)


def shrink_width(sr: SparseRows, need: int) -> SparseRows:
    """Slice compact rows down to `need` slots (the widest live row)."""
    w = max(int(need), 1)
    if w >= sr.width:
        return sr
    return SparseRows(sr.idx[:, :w].contiguous(), sr.val[:, :w].contiguous(),
                      sr.num_cols)


def drop_zero_entries(sr: SparseRows, shrink: bool = True) -> SparseRows:
    """Remove zero-valued entries, keeping ascending-column order (the final
    cleanup of computeProbDistOnLevel, LevelSimilarities.cpp:566-581);
    shrink=True also trims the width to the widest surviving row."""
    keep = sr.val != 0
    out = compact(torch.where(keep, sr.idx, PAD),
                  torch.where(keep, sr.val, 0.0), sr.num_cols)
    if not shrink:
        return out
    return shrink_width(out, int(out.row_nnz().max()) if out.num_rows else 1)


def topk_rows(sr: SparseRows, k: int, largest: bool = True) -> SparseRows:
    """Per-row top-k by value (ties to the earlier slot), result sorted by
    column index (findTopK / findBottomK, SparseMatrixAlgorithms.cpp:720-776).
    """
    k = min(k, sr.width)
    fill = -torch.inf if largest else torch.inf
    v = torch.where(sr.idx >= 0, sr.val, fill)
    key, order = torch.sort(-v if largest else v, dim=1, stable=True)
    keep = torch.isfinite(key[:, :k])
    tv = torch.where(keep, sr.val.gather(1, order[:, :k]), 0.0)
    ti = torch.where(tv == 0, PAD, sr.idx.gather(1, order[:, :k]))
    return compact(ti, tv, sr.num_cols)


# ---------------------------------------------------------------------------
# merge by parents (reference: mergeNodesRandomWalks,
# SparseMatrixAlgorithms.cpp:292-441)
# ---------------------------------------------------------------------------

def merge_rows_by_parents(sr: SparseRows, parents: np.ndarray,
                          num_merged: int, norm: bool = False,
                          weight_by_size: bool = True,
                          max_width: Optional[int] = None) -> SparseRows:
    """Sum child rows into parent rows, mapping columns through `parents` too.

    weight_by_size: each child row is weighted by its nnz before summing and
    the merged row divided by the summed weights (reference:
    mergeNodesRandomWalks rowWeights logic, :321-346).  Rows wider than
    max_width keep their largest values.  norm: row-normalize afterwards.

    The whole merge runs on the host, as the JAX package runs it off the
    TPU: the C++ accumulation, the packing and the normalization (a numpy
    float32 sum, so the rows match the JAX package's bit for bit).  The
    result is uploaded to the input's device once.
    """
    parents = np.asarray(parents, dtype=np.int64)
    assert parents.shape[0] == sr.num_rows
    out_rows, out_cols, sums = native.merge_sum(
        sr.indices, sr.values, parents, num_merged, weight_by_size)

    counts = np.bincount(out_rows, minlength=num_merged)
    width = max(int(counts.max()) if counts.size else 1, 1)
    if max_width is not None and width > max_width:
        Log.info("merge_rows_by_parents: truncating rows from width %d to %d "
                 "(keeping largest values)", width, max_width)
        width = max_width
        starts = np.zeros(num_merged + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        order = np.lexsort((-sums, out_rows))
        out_rows, out_cols, sums = (out_rows[order], out_cols[order],
                                    sums[order])
        slot = np.arange(out_rows.size) - starts[out_rows]
        ok = slot < width
        indices = np.full((num_merged, width), PAD, dtype=np.int32)
        values = np.zeros((num_merged, width), dtype=np.float32)
        indices[out_rows[ok], slot[ok]] = out_cols[ok]
        values[out_rows[ok], slot[ok]] = sums[ok]
        key = np.where(indices < 0, np.iinfo(np.int32).max, indices)
        order = np.argsort(key, axis=1, kind="stable")
        indices = np.take_along_axis(indices, order, 1)
        values = np.take_along_axis(values, order, 1)
    else:
        indices, values = native.pack_rows(out_rows, out_cols, sums,
                                           num_merged, width)
    if norm:
        values = host_normalize(indices, values, onedim=True)
    return SparseRows(indices, values, num_merged, device=sr.device)


def host_normalize(indices: np.ndarray, values: np.ndarray,
                   onedim: bool = True) -> np.ndarray:
    """The JAX package's host normalization of merged rows, in numpy's
    float32 sums: each row to one (onedim, normalizeUnitSparseMatrix) or
    the whole matrix to one (normalizeSparseMatrix); all-zero rows (or an
    all-zero matrix) stay as they are."""
    s = np.where(indices >= 0, values, np.float32(0.0)).sum(axis=1)
    if onedim:
        s = np.where(s == 0, np.float32(1.0), s)
        return (values / s[:, None]).astype(np.float32)
    total = s.sum()
    return values if total == 0 else (values / total).astype(np.float32)


def merge_rows_min_by_parents(sr: SparseRows, parents: np.ndarray,
                              num_merged: int,
                              max_width: Optional[int] = None) -> SparseRows:
    """Min-distance merge (reference: mergeNodesDataDistances /
    mergeGraphNodes, SparseMatrixAlgorithms.cpp:443-561): child rows and
    their columns map to their parents, and duplicate merged entries keep
    the smallest value; zero entries drop out.  Rows wider than max_width
    keep their smallest values (ties to the lower column).

    The accumulation is the host C++ merge (``native.merge_min``), as the
    JAX package runs it off the TPU; the packed rows are uploaded to the
    input's device once."""
    parents = np.asarray(parents, dtype=np.int64)
    assert parents.shape[0] == sr.num_rows
    out_rows, out_cols, mins = native.merge_min(sr.indices, sr.values,
                                                parents, num_merged)
    counts = np.bincount(out_rows, minlength=num_merged)
    width = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.zeros(num_merged + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    if max_width is not None and width > max_width:
        Log.info("merge_rows_min_by_parents: truncating rows from width %d "
                 "to %d (keeping smallest distances)", width, max_width)
        width = max_width
        order = np.lexsort((mins, out_rows))
        out_rows, out_cols, mins = (out_rows[order], out_cols[order],
                                    mins[order])
        keep = np.arange(out_rows.size) - starts[out_rows] < width
        out_rows, out_cols, mins = out_rows[keep], out_cols[keep], mins[keep]
        # back to ascending columns within each row
        order = np.lexsort((out_cols, out_rows))
        out_rows, out_cols, mins = (out_rows[order], out_cols[order],
                                    mins[order])
        counts = np.bincount(out_rows, minlength=num_merged)
        starts[1:] = np.cumsum(counts)
    slot = np.arange(out_rows.size) - starts[out_rows]
    indices = np.full((num_merged, width), PAD, dtype=np.int64)
    values = np.zeros((num_merged, width), dtype=np.float32)
    indices[out_rows, slot] = out_cols
    values[out_rows, slot] = mins
    return SparseRows(indices, values, num_merged, device=sr.device)


# ---------------------------------------------------------------------------
# Bhattacharyya similarities (reference: createSimilarities*,
# SparseMatrixAlgorithms.cpp:963-1488)
# ---------------------------------------------------------------------------

def bhattacharyya_pairs(sr: SparseRows, rows_a: np.ndarray,
                        rows_b: np.ndarray) -> np.ndarray:
    """BC(a, b) = sum_i sqrt(p_a[i] * p_b[i]) for given row pairs (reference:
    randomWalksBhattacharyya, Similarities.cpp:379-396), as the product of
    the two rows' square roots at their common columns.  Row b's columns are
    found with a batched binary search; pairs are chunked so the [E, R] row
    gathers stay near 2^26 entries."""
    dev = sr.device
    e = len(rows_a)
    if e == 0:
        return np.empty(0, np.float32)
    key = torch.where(sr.idx < 0, _BIG, sr.idx)
    root = sqrt(torch.clamp(sr.val, min=0.0))
    a_all = torch.as_tensor(np.asarray(rows_a, np.int64), device=dev)
    b_all = torch.as_tensor(np.asarray(rows_b, np.int64), device=dev)
    r = sr.width
    chunk = max(4096, (1 << 26) // max(r, 1))
    out = torch.empty(e, dtype=torch.float32, device=dev)
    for i0 in range(0, e, chunk):
        a = a_all[i0:i0 + chunk]
        b = b_all[i0:i0 + chunk]
        ka, kb = key[a], key[b]
        pos = torch.searchsorted(kb, ka).clamp_(max=r - 1)
        match = (kb.gather(1, pos) == ka) & (ka != _BIG)
        prod = torch.where(match, root[a] * root[b].gather(1, pos), 0.0)
        out[i0:i0 + chunk] = prod.sum(1)
    return out.cpu().numpy()


def pairwise_similarities(sr: SparseRows, k: int, prune_val: float = 1e-4,
                          component_sizes: Optional[np.ndarray] = None,
                          block: int = 2048) -> SparseRows:
    """All-pairs Bhattacharyya distances with per-row bottom-k (reference:
    createSimilarities, SparseMatrixAlgorithms.cpp:963-995 — blocked
    sqrt(A)*sqrt(A)^T, prune, -log, keep the k smallest distances per row,
    sort them by column index and normalize the row to sum 1).

    The rows are densified once to [N, N] square roots; each block of rows
    takes one float32 matmul against all of them, then a stable sort keeps
    the k smallest -log(BC) per row with ties to the lower column, as the
    JAX package's streaming bottom-k does.  Rows wider than 2048 entries are
    first cut to their top 2048 values and renormalized (the JAX package's
    SPH_PAIRWISE_WIDTH default).

    component_sizes: optional per-row weights; rows are scaled by
    sqrt(size) before the product (:1200-1212).
    """
    n = sr.num_rows
    dev = sr.device
    k = min(k, max(n - 1, 1))
    cap = 2048
    if sr.width > cap:
        orig_width = sr.width
        sr = normalize_rows(topk_rows(sr, cap))
        Log.info("pairwise_similarities: capped row width %d -> %d",
                 orig_width, sr.width)

    root = sqrt(torch.clamp(sr.val, min=0.0))
    if component_sizes is not None:
        scale = torch.as_tensor(
            np.sqrt(np.asarray(component_sizes, np.float32)), device=dev)
        root = root * scale[:, None]
    ok = sr.idx >= 0
    dense = torch.zeros((n, n), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand_as(sr.idx)
    dense.index_put_((rows[ok], sr.idx[ok]), root[ok], accumulate=True)

    ids = torch.arange(n, device=dev)
    top_i = torch.empty((n, k), dtype=torch.int64, device=dev)
    top_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        bc = dense[r0:r1] @ dense.T
        valid = (bc > prune_val) & (ids[None, :] != ids[r0:r1, None])
        dist = torch.where(valid, -log(torch.clamp(bc, min=1e-38)),
                           torch.inf)
        sd, si = torch.sort(dist, dim=1, stable=True)
        top_d[r0:r1] = sd[:, :k]
        top_i[r0:r1] = si[:, :k]

    # drop +inf (fewer than k similar rows), sort by column, normalize
    finite = torch.isfinite(top_d)
    out = compact(torch.where(finite, top_i, PAD),
                  torch.where(finite, top_d, 0.0), n)
    return normalize_rows(out)


def symmetrize_tsne(sr: SparseRows, max_width: Optional[int] = None,
                    device_path: bool = False) -> SparseRows:
    """p_sym = (p + p^T) / 2 on the union support, rows ascending by column
    (reference: symmetrizeTSNE, HDILibHelper.hpp:260-280), as the JAX
    package's host (scipy) path gives it.  max_width: the result's rows cut
    to their largest values as in ``pack_coo`` (the t-SNE width cap,
    applied before hub rows set the width of all).  device_path: take
    ``symmetrize_device_path`` instead, where the JAX package holds the
    rows on its device (the caller decides: ``LevelSimilarities.
    device_path``); max_width is then not used (no such caller caps)."""
    n = sr.num_rows
    assert sr.num_cols == n, "symmetrize_tsne needs a square matrix"
    if device_path:
        return symmetrize_device_path(sr, "tsne")
    rows, cols, vals = _live_coo(sr)
    keys = torch.cat([rows * n + cols, cols * n + rows])
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    # each key collects at most two addends, so the sum is order-exact
    sums = torch.zeros(uniq.numel(), dtype=torch.float32, device=sr.device)
    sums.index_add_(0, inv, torch.cat([vals, vals]))
    return pack_coo(uniq // n, uniq % n, sums * 0.5, n, n, max_width)


def symmetrize_umap(sr: SparseRows, device_path: bool = False
                    ) -> SparseRows:
    """The fuzzy union p + p^T - p * p^T elementwise on the union support,
    rows ascending by column (reference: symmetrizeUMAP,
    HDILibHelper.hpp:282-302), each entry as (a + b) - a * b in float32
    with a = p_ij and b = p_ji (0 where absent), as the JAX package's
    scipy sums give it.  device_path: take ``symmetrize_device_path``
    instead (see ``symmetrize_tsne``)."""
    n = sr.num_rows
    assert sr.num_cols == n, "symmetrize_umap needs a square matrix"
    if device_path:
        return symmetrize_device_path(sr, "umap")
    rows, cols, vals = _live_coo(sr)
    fwd, order = torch.sort(rows * n + cols)
    vals = vals[order]
    keys = torch.unique(torch.cat([fwd, cols * n + rows]), sorted=True)

    def value_at(k: torch.Tensor) -> torch.Tensor:
        if fwd.numel() == 0:
            return torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        pos = torch.searchsorted(fwd, k).clamp_(max=fwd.numel() - 1)
        return torch.where(fwd[pos] == k, vals[pos], 0.0)

    a = value_at(keys)
    b = value_at((keys % n) * n + keys // n)
    out = (a + b) - a * b
    keep = out != 0
    return pack_coo(keys[keep] // n, keys[keep] % n, out[keep], n, n)


# ---------------------------------------------------------------------------
# the JAX package's device-path symmetrization (sph_tpu/ops/sparse.py
# _symmetrize_p_device_dispatch, :933-1016)
# ---------------------------------------------------------------------------

def _next_pow2(x: int, lo: int = 8) -> int:
    x = max(int(x), lo)
    return 1 << (x - 1).bit_length()


def _bucket_rows(x: int) -> int:
    """The JAX package's row bucket (sph_tpu/ops/bucketing.py bucket_rows):
    powers of two from 512 up to 2048 rows, then multiples of 4096."""
    if x <= 2048:
        return _next_pow2(x, lo=512)
    return -(-x // 4096) * 4096


def _bucket_width(w: int) -> int:
    """The JAX package's width bucket: a power of two, at least 32."""
    return _next_pow2(max(int(w), 1), lo=32)


def reverse_cap(n: int) -> int:
    """The most reverse entries a row of an n-row matrix keeps on the JAX
    package's device path: SPH_SYM_WREV_MAX (default 1024; 0 or less for
    no cap), and at most the rows' bucket rounded to a power of two."""
    cap = int(os.environ.get("SPH_SYM_WREV_MAX", "1024"))
    if cap <= 0:
        cap = 1 << 30
    return min(cap, _next_pow2(_bucket_rows(max(8, n))))


def reverse_width(n: int, width: int, max_in_degree: int) -> int:
    """The reverse-entry width the JAX package's device path ends with for
    an n-row matrix of `width` whose busiest column has `max_in_degree`
    entries: its start and its doubling loop (sparse.py:984-1012), with the
    loop's overflow probe answered from the in-degree (an entry is lost at
    width w iff some row has more than w reverse entries).  Each row keeps
    at most this many reverse entries; it stops at ``reverse_cap``."""
    nb = _bucket_rows(max(8, n))
    wb = _bucket_width(width)
    wrev_max = reverse_cap(n)
    if nb <= 2048 and nb * wrev_max <= (1 << 26):
        wrev = wrev_max
    else:
        wrev = max(min(_next_pow2(max(2 * wb, 64)), wrev_max), 1)
    while max_in_degree > wrev and wrev < min(n, wrev_max):
        wrev = min(_next_pow2(wrev * 2), _next_pow2(nb), wrev_max)
    return wrev


def symmetrize_device_path(sr: SparseRows, mode: str) -> SparseRows:
    """The t-SNE ("tsne": (p + p^T) / 2) or UMAP ("umap": p + p^T - p p^T)
    symmetrization as the JAX package computes it on device-resident rows
    (``_symmetrize_p_device_dispatch``), which its driver and level
    similarities reach wherever the rows never left the device (see
    ``LevelSimilarities``).  Its results, not its XLA machinery:

    - above SPH_SYM_FLAT_BUDGET elements (rows x width, default 48 Mi),
      rows wider than SPH_SYM_P_WIDTH_CAP (default 256) keep their largest
      values (``topk_rows``: ties to the lower column); "tsne" then
      renormalizes them (XLA's row sum), "umap" does not;
    - each row keeps at most ``reverse_width`` reverse entries, its largest
      by value; among equal values the entry from the lower source row
      (the JAX package's stable sort on (row, -value) over the row-major
      entries);
    - each entry combines its forward value a and its kept reverse value b
      (0 where absent), forward first: (a + b) * 0.5, or (a + b) - a * b
      with the product fused into the subtraction, as XLA-CPU contracts it
      (one rounding; the host path rounds a * b first); where only the
      reverse entry exists it is a.  Entries whose result is 0 stay, as
      there.

    Rows come out ascending by column at the exact widest row (the JAX
    package slices to a power-of-two bucket)."""
    n = sr.num_rows
    assert sr.num_cols == n, "symmetrize_device_path needs a square matrix"
    budget = int(os.environ.get("SPH_SYM_FLAT_BUDGET", str(48 * 2**20)))
    wcap = int(os.environ.get("SPH_SYM_P_WIDTH_CAP", "256"))
    if 0 < wcap < sr.width and n * sr.width > budget:
        orig_width = sr.width
        sr = topk_rows(sr, wcap)
        if mode == "tsne":
            sr = normalize_rows(sr)
        Log.info("symmetrize: capped row width %d -> %d (row budget)",
                 orig_width, sr.width)
    dev = sr.device
    rows, cols, vals = _live_coo(sr)
    in_degree = torch.bincount(cols, minlength=n)
    wrev = reverse_width(n, sr.width,
                         int(in_degree.max()) if cols.numel() else 0)
    # reverse entries grouped by target row, largest value first, ties in
    # row-major (source row) order: two stable sorts
    by_val = torch.sort(-vals, stable=True).indices
    order = by_val[torch.sort(cols[by_val], stable=True).indices]
    starts = torch.cumsum(in_degree, 0) - in_degree
    rank = torch.arange(cols.numel(), device=dev) - starts[cols[order]]
    kept = order[rank < wrev]
    lost = cols.numel() - kept.numel()
    if lost:
        Log.info("symmetrize: wrev cap %d sheds %d faint reverse entries of "
                 "hub rows", wrev, lost)
    # forward entries first, then the kept reverse ones; a stable sort by
    # (row, col) puts a key's forward entry before its reverse one
    keys = torch.cat([rows * n + cols, cols[kept] * n + rows[kept]])
    both = torch.cat([vals, vals[kept]])
    keys, perm = torch.sort(keys, stable=True)
    both = both[perm]
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    pair = torch.zeros_like(both)
    pair[:-1] = torch.where(keys[1:] == keys[:-1], both[1:], 0.0)
    a, b = both[start], pair[start]
    out = (a + b) * 0.5 if mode == "tsne" else _fma(-a, b, a + b)
    keys = keys[start]
    return pack_coo(keys // n, keys % n, out, n, n)
