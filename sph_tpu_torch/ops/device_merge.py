"""The sparse merges and the kNN-graph symmetrization on the rows' device.

Port of sph_tpu/ops/device_merge.py, the JAX package's accelerator path for
the per-level merges of walk rows (sum) and of distance rows (min), and for
the kNN graph's symmetrization.  The JAX package takes it on its
accelerator, because downloading the rows, merging them on one host core
and uploading the result was the last host step of the hierarchy loop.
The port takes it wherever the rows lie on the card (``on_card``), so they
never leave it; rows on the CPU take the host C++ merge.

What comes out is the port's host path bit for bit (``ops/sparse.py``'s
C++ merges and ``native.symmetrize``), which the JAX package's host path
also gives: the same entries, the same values, and rows of the exact
widest width.  The JAX package's device path differs from that in three
ways, which the port does not copy:

- it pads rows to a power-of-two width (a bucket for XLA's compiled
  programs, as ``ops/bucketing.py`` is, which the port does not have);
- it floors a width cap to a power of two (:388-396), so where the cap
  bites below a width that is not a power of two it keeps fewer entries
  than its host path; the port keeps ``max_width`` entries, as the host;
- it sums each run in the scatter's order.

A merge (``merge_by_parents_device``) is the kernel
``csrc/merge_runs.cu`` (``merge_runs``) on the children's rows as they lie:
the parents are uploaded once and the rows grouped by parent with N-sized
torch ops (``merge_kernel_inputs``); a block of the kernel takes a parent,
folds its children's live entries (index >= 0 and value != 0) column by
column in shared memory in the host's order (ascending child, then slot)
and writes its columns in ascending order; after one synchronisation (the
widest row and a column outside the domain) the runs are laid out as rows
of the exact widest width.  Where ``max_width`` bites, each row keeps its
largest sums (smallest minima), ties to the lower column, in torch ops
(``keep_best``).  No sort, key or flag buffer runs over the entries, and
no parent takes another path.  The plain version, ``merge_runs_reference``,
is the torch pipeline the kernel replaced: the live entries flattened, keyed
``parent[row] * num_merged + parent[col]`` and sorted stably (the host's
LSD radix sort is stable too), each run of equal keys folded in order.

The symmetrization (``symmetrize_graph_device``) has no sums: stable sorts,
first-of-run flags, ranks in a row and a scatter, as torch ops.

``_merge_lanes`` (:182-262), the JAX package's opt-in lane merge
(``SPH_MERGE_LANE_BUDGET``, off by default), is a TPU layout of the same
result and is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.logging import Log
from .cuda_build import _launch

# the columns a block of merge_runs folds at once, its shared-memory window
# (4 B an accumulator, a bit of occupancy): a parent whose columns pass it
# takes another pass over its rows.  8192 columns and the 8 KB tile take
# 42 KB, five blocks an SM
MERGE_WINDOW = 8192


def on_card(device) -> bool:
    """Whether rows on `device` merge and symmetrize there (on a CUDA
    device); elsewhere they take the host C++ path."""
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# the kernel and its twin
# ---------------------------------------------------------------------------

def _check_inputs(idx, val, par, order, child_start, by_size, num_merged,
                  combine, weighted):
    if combine not in ("sum", "min"):
        raise ValueError(f"merge_runs: combine must be 'sum' or 'min', got "
                         f"{combine!r}")
    if combine == "min" and weighted:
        raise ValueError("merge_runs: the min merge takes no weights")
    if idx.dtype != torch.int64 or val.dtype != torch.float32:
        raise TypeError("merge_runs: idx must be int64, val float32")
    if par.dtype != torch.int32:
        raise TypeError("merge_runs: par must be int32")
    if any(t.dtype != torch.int64 for t in (order, child_start, by_size)):
        raise TypeError("merge_runs: order, child_start and by_size must be "
                        "int64")
    n = idx.shape[0] if idx.dim() == 2 else -1
    if (idx.dim() != 2 or val.shape != idx.shape or par.shape != (n,)
            or order.shape != (n,)
            or child_start.shape != (num_merged + 1,)
            or by_size.shape != (num_merged,)):
        raise ValueError("merge_runs: idx and val [N, W], par and order [N], "
                         "child_start [M + 1] and by_size [M] expected")
    if not 0 < num_merged < 2 ** 31:
        raise ValueError(f"merge_runs: num_merged {num_merged} outside "
                         "[1, 2^31)")
    dev = idx.device
    if any(t.device != dev for t in (val, par, order, child_start, by_size)):
        raise ValueError("merge_runs: all tensors on one device")


def _column_error(n: int) -> ValueError:
    return ValueError("merge_by_parents_device: a column id lies outside "
                      f"[0, {n})")


def merge_runs(idx: torch.Tensor, val: torch.Tensor, par: torch.Tensor,
               order: torch.Tensor, child_start: torch.Tensor,
               by_size: torch.Tensor, num_merged: int, combine: str,
               weighted: bool, window: int = MERGE_WINDOW):
    """The rows idx [N, W] int64 / val [N, W] float32 merged into
    num_merged parent rows: each row and each live column (idx >= 0 and
    val != 0) mapped through par [N] int32; the rows grouped by parent in
    ascending order by order [N] and child_start [M + 1] (int64); by_size
    [M] int64 the parents in the order the kernel takes them (most children
    first).  combine "sum" folds each parent column's values ``s += v``
    from 0 in float32, in ascending child and then slot, as the host C++
    merge does; where `weighted`, each value is first multiplied by its
    row's live count and each sum divided by max(the parent's summed
    counts, 1).  combine "min" keeps the running ``(v < m) ? v : m``.

    Returns (idx [M, width] int64 with -1 pads, val [M, width] float32,
    merged_w [M] float32 or None): each parent's columns ascending, width
    the widest row (at least 1).  A live column at or above N raises
    ValueError.  The kernel ``csrc/merge_runs.cu`` on a CUDA tensor (counted
    in ``merge_runs.launches``; `window` the columns a block folds at once,
    a multiple of 32), the twin ``merge_runs_reference`` on a CPU one."""
    _check_inputs(idx, val, par, order, child_start, by_size, num_merged,
                  combine, weighted)
    dev = idx.device
    if dev.type == "cpu":
        return merge_runs_reference(idx, val, par, order, child_start,
                                    by_size, num_merged, combine, weighted)
    if dev.type != "cuda":
        raise ValueError(f"merge_runs: no kernel for {dev}")
    if window < 32 or window % 32:
        raise ValueError(f"merge_runs: window {window} is not a positive "
                         "multiple of 32")
    fold = _merge_fold(idx, val, par, order, child_start, by_size,
                       num_merged, combine, weighted, window)
    width = _merge_width(idx.shape[0], fold)
    out_idx, out_val = _merge_pack(idx.shape[1], child_start, fold, width)
    return out_idx, out_val, fold["merged_w"]


# launches of merge_runs (the kernel), counted where the kernel launches;
# the windows its blocks took in the last launch (a parent's pass a window)
merge_runs.launches = 0
merge_runs.windows = 0


def _merge_fold(idx, val, par, order, child_start, by_size, num_merged,
                combine, weighted, window) -> dict:
    """The kernel's launch: each parent's runs at child_start[p] * W of
    out_col / out_val, their count, the merged weights, the state words.
    The window is cut to the parent columns there are."""
    dev = idx.device
    window = min(window, -(-num_merged // 32) * 32)
    n, w = idx.shape
    fold = {"out_col": torch.empty(n * w, dtype=torch.int32, device=dev),
            "out_val": torch.empty(n * w, dtype=torch.float32, device=dev),
            "state": torch.zeros(2, dtype=torch.int64, device=dev),
            "merged_w": None}
    nnz = rowmin = pmin = None
    if weighted:
        nnz = torch.empty(n, dtype=torch.int32, device=dev)
        fold["merged_w"] = torch.empty(num_merged, dtype=torch.float32,
                                       device=dev)
    if num_merged > window:       # each parent's first window at its first
        rowmin = torch.empty(n, dtype=torch.int32, device=dev)    # column
        pmin = torch.empty(num_merged, dtype=torch.int32, device=dev)
    if n == 0 or w == 0:
        fold["run_count"] = torch.zeros(num_merged, dtype=torch.int32,
                                        device=dev)
        if weighted:
            fold["merged_w"].zero_()
        return fold
    fold["run_count"] = torch.empty(num_merged, dtype=torch.int32,
                                    device=dev)
    idx, val = idx.contiguous(), val.contiguous()
    _launch("merge_runs", dev, idx.data_ptr(), val.data_ptr(), n, w,
            par.contiguous().data_ptr(), order.contiguous().data_ptr(),
            child_start.contiguous().data_ptr(),
            by_size.contiguous().data_ptr(), num_merged, window,
            1 if combine == "min" else 0, 1 if weighted else 0,
            *(None if t is None else t.data_ptr()
              for t in (nnz, rowmin, pmin)),
            fold["out_col"].data_ptr(), fold["out_val"].data_ptr(),
            fold["run_count"].data_ptr(),
            None if nnz is None else fold["merged_w"].data_ptr(),
            fold["state"].data_ptr())
    merge_runs.launches += 1
    return fold


def _merge_width(n: int, fold: dict) -> int:
    """The one wait on the card: the widest row, and whether a live column
    lay outside [0, n) (raises ValueError)."""
    width, bad, windows = torch.cat([
        fold["run_count"].max().view(1).to(torch.int64),
        fold["state"]]).tolist()
    merge_runs.windows = windows
    if bad:
        raise _column_error(n)
    return max(width, 1)


def _merge_pack(w: int, child_start, fold: dict, width: int):
    """The runs laid out as [M, width] rows (the kernel's second entry
    point)."""
    run_count = fold["run_count"]
    m = run_count.numel()
    dev = run_count.device
    out_idx = torch.empty((m, width), dtype=torch.int64, device=dev)
    out_val = torch.empty((m, width), dtype=torch.float32, device=dev)
    if w == 0 or fold["out_col"].numel() == 0:
        out_idx.fill_(-1)
        out_val.zero_()
        return out_idx, out_val
    _launch("merge_runs", dev, fold["out_col"].data_ptr(),
            fold["out_val"].data_ptr(), child_start.contiguous().data_ptr(),
            w, run_count.data_ptr(), m, width, out_idx.data_ptr(),
            out_val.data_ptr(), entry="merge_runs_pack")
    return out_idx, out_val


def _fold_segments(vals: torch.Tensor, starts: torch.Tensor, combine: str
                   ) -> torch.Tensor:
    """Each segment [starts[i], starts[i + 1]) of vals folded left to right
    (``s += v`` from 0, or the running ``(v < m) ? v : m``): the segments
    laid side by side as the columns of a [segments, longest] matrix, longest
    first, and the matrix folded column by column over the segments still
    running."""
    count = starts.numel() - 1
    dev = vals.device
    if count <= 0:
        return torch.empty(0, dtype=torch.float32, device=dev)
    lengths = starts[1:] - starts[:-1]
    order = torch.sort(lengths, descending=True, stable=True).indices
    ls, st = lengths[order], starts[:-1][order]
    longest = int(ls[0])
    # running[j]: the segments longer than j, a prefix of the sorted order
    running = count - torch.cumsum(
        torch.bincount(ls, minlength=longest + 1), 0).cpu().numpy()
    if combine == "sum":
        acc = torch.zeros(count, dtype=torch.float32, device=dev)
        first = 0
    else:                  # runs are never empty
        acc = vals[st].clone()
        first = 1
    for j in range(first, longest):
        m = int(running[j])
        v = vals[st[:m] + j]
        if combine == "sum":
            acc[:m] = acc[:m] + v
        else:
            acc[:m] = torch.where(v < acc[:m], v, acc[:m])
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def sorted_entries(idx, val, par, order, num_merged: int, weighted: bool):
    """The twin's entries: the live entries of the rows grouped by parent,
    flattened (child, then slot), keyed ``par[row] * num_merged +
    par[col]`` and sorted stably.  Returns (keys [E] int64, values [E]
    float32, weighted where asked, run_start [U + 1] int64, each run's first
    entry and E, nnz [N] int64, each row's live count).  A live column at or
    above N raises ValueError."""
    n = idx.shape[0]
    live = (idx >= 0) & (val != 0)
    if n and bool((live & (idx >= n)).any()):
        raise _column_error(n)
    nnz = live.sum(1)
    p64 = par.to(torch.int64)
    idx_c, live_c = idx[order], live[order]
    child = order[:, None].expand_as(idx_c)[live_c]
    v = val[order][live_c]
    if weighted:
        v = v * nnz.to(torch.float32)[child]
    key = p64[child] * num_merged + p64[idx_c[live_c]]
    del idx_c, live_c
    key, perm = torch.sort(key, stable=True)
    v = v[perm]
    first = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    run_start = torch.cat([
        torch.nonzero(first).flatten(),
        torch.tensor([key.numel()], dtype=torch.int64, device=key.device)])
    return key, v, run_start, nnz


def merge_runs_reference(idx: torch.Tensor, val: torch.Tensor,
                         par: torch.Tensor, order: torch.Tensor,
                         child_start: torch.Tensor, by_size: torch.Tensor,
                         num_merged: int, combine: str, weighted: bool,
                         window: int = MERGE_WINDOW):
    """The twin of ``merge_runs``, the kernel's arguments in torch ops
    (by_size and window only schedule the kernel): ``sorted_entries``,
    each run folded left to right and each parent's weight over its
    children in order (``_fold_segments``: the same float32 operations in
    the same order), the same true division, then the runs laid out as
    rows."""
    _check_inputs(idx, val, par, order, child_start, by_size, num_merged,
                  combine, weighted)
    key, v, run_start, nnz = sorted_entries(idx, val, par, order,
                                            num_merged, weighted)
    out = _fold_segments(v, run_start, combine)
    first = key[run_start[:-1]]
    rows = torch.div(first, num_merged, rounding_mode="floor")
    cols = first - rows * num_merged
    del key, v, first
    merged_w = None
    if weighted:
        merged_w = _fold_segments(nnz.to(torch.float32)[order], child_start,
                                  "sum")
        if out.numel():
            out = out / torch.clamp_min(merged_w[rows], 1.0)
    counts = torch.bincount(rows, minlength=num_merged)
    width = max(int(counts.max()) if rows.numel() else 0, 1)
    slot = torch.arange(rows.numel(), device=rows.device) - (
        torch.cumsum(counts, 0) - counts)[rows]
    out_idx = torch.full((num_merged, width), -1, dtype=torch.int64,
                         device=rows.device)
    out_val = torch.zeros((num_merged, width), dtype=torch.float32,
                          device=rows.device)
    out_idx[rows, slot] = cols
    out_val[rows, slot] = out
    return out_idx, out_val, merged_w


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------

def merge_kernel_inputs(sr, parents: np.ndarray, num_merged: int,
                        weight_by_size: bool, combine: str) -> dict:
    """The arguments of ``merge_runs`` that merge the rows of `sr` into
    their parents (see ``merge_by_parents_device``), built with N-sized
    torch ops on the rows' device: the parents uploaded (int32 for the
    kernel), the rows grouped by parent (a stable sort of the parents and
    a search for each parent's first row) and the parents by their number
    of rows.  Raises ValueError on a parent outside the domain, as the C++
    merge rejects it."""
    if combine not in ("sum", "min"):
        raise ValueError(f"merge_by_parents_device: combine must be 'sum' or "
                         f"'min', got {combine!r}")
    dev = sr.device
    n = sr.num_rows
    parents = np.asarray(parents, dtype=np.int64)
    if parents.shape != (n,):
        raise ValueError(f"merge_by_parents_device: parents must be [{n}], "
                         f"got {parents.shape}")
    if not 0 < num_merged < 2 ** 31 or (n and (
            int(parents.min()) < 0 or int(parents.max()) >= num_merged)):
        raise ValueError("merge_by_parents_device: a parent id lies outside "
                         f"[0, {num_merged})")
    par = torch.as_tensor(parents.astype(np.int32), device=dev)
    sorted_par, order = torch.sort(par, stable=True)
    child_start = torch.searchsorted(
        sorted_par, torch.arange(num_merged + 1, dtype=torch.int32,
                                 device=dev))
    by_size = torch.sort(child_start.diff().to(torch.int32),
                         descending=True, stable=True).indices
    return {"idx": sr.idx, "val": sr.val, "par": par,
            "order": order, "child_start": child_start, "by_size": by_size,
            "num_merged": int(num_merged), "combine": combine,
            "weighted": combine == "sum" and bool(weight_by_size)}


def keep_best(idx: torch.Tensor, val: torch.Tensor, max_width: int,
              largest: bool):
    """Each row's max_width largest values (smallest where not `largest`),
    ties to the lower column, back in ascending column order: the host
    path's lexsort by (row, -value) and cut, as torch ops on the merged
    rows."""
    key = torch.where(idx >= 0, -val if largest else val, float("inf"))
    keep = torch.sort(key + 0.0, dim=1, stable=True).indices[:, :max_width]
    keep = torch.sort(keep, dim=1).values
    return idx.gather(1, keep), val.gather(1, keep)


def merge_by_parents_device(sr, parents: np.ndarray, num_merged: int,
                            weight_by_size: bool, combine: str,
                            max_width: Optional[int] = None):
    """Merge the rows of `sr` (a SparseRows) into `num_merged` parent rows,
    mapping rows and columns through `parents` [N]: "sum" adds duplicate
    entries (each child row weighted by its live count and each merged row
    divided by its children's summed counts, where weight_by_size), "min"
    keeps the smallest.  Rows wider than max_width keep their largest sums
    or smallest minima, ties to the lower column.  Returns a SparseRows on
    the input's device, equal bit for bit to the host C++ path's
    (``ops/sparse.merge_rows_by_parents`` / ``merge_rows_min_by_parents``
    on CPU rows).  A parent or a live column outside the domain raises
    ValueError, as the C++ merge rejects it."""
    from .sparse import SparseRows
    idx, val, _ = merge_runs(**merge_kernel_inputs(
        sr, parents, num_merged, weight_by_size, combine))
    if max_width is not None and idx.shape[1] > max_width:
        Log.info("merge_by_parents_device: truncating rows from width %d to "
                 "%d (keeping %s values)", idx.shape[1], max_width,
                 "largest" if combine == "sum" else "smallest")
        idx, val = keep_best(idx, val, max_width, combine == "sum")
    return SparseRows(idx, val, num_merged)

# ---------------------------------------------------------------------------
# the kNN graph's symmetrization
# ---------------------------------------------------------------------------

def _sortable(d: torch.Tensor) -> torch.Tensor:
    """float32 values as int64 keys in [0, 2^32) ordered as the floats
    compare with `<` (-0.0 and 0.0 equal; NaN not expected)."""
    b = (d + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + (1 << 31)


def symmetrize_graph_device(indices: torch.Tensor, distances: torch.Tensor,
                            max_width: int = 0):
    """The undirected union of a padded kNN graph (indices [N, K], pads < 0,
    and their distances), each duplicate edge with its smaller distance;
    each row the self edge first (distance 0), then its neighbours by
    (distance, column); rows of more than max_width - 1 neighbours keep
    their closest (max_width 0: no cap).  Returns (out_idx [N, w] int32,
    out_dist [N, w] float32, counts [N] int32) on the inputs' device, w the
    exact widest row: ``native.symmetrize`` (graphops.cpp
    collect_canonical_edges and symmetrize_fill) bit for bit.  An id at or
    above N raises ValueError, as the C++ rejects it."""
    if indices.dim() != 2 or distances.shape != indices.shape:
        raise ValueError("symmetrize_graph_device: indices and distances "
                         "must be [N, K] alike")
    dev = indices.device
    n, k = indices.shape
    idx = indices.to(torch.int64)
    dist = distances.to(device=dev, dtype=torch.float32)
    if idx.numel() and bool((idx >= n).any()):
        raise ValueError("symmetrize_graph_device: a neighbour id lies "
                         f"outside [0, {n})")
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    valid = (idx >= 0) & (idx != rows)
    a = torch.minimum(rows, idx)[valid]
    b = torch.maximum(rows, idx)[valid]
    d = dist[valid]
    # dedup (a, b) keeping the smallest distance: by distance, then by key
    key = a * n + b
    o = torch.sort(_sortable(d), stable=True).indices
    o = o[torch.sort(key[o], stable=True).indices]
    key, d = key[o], d[o]
    first = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    key, d = key[first], d[first]
    ua = torch.div(key, n, rounding_mode="floor")
    ub = key - ua * n
    r = torch.cat([ua, ub])
    c = torch.cat([ub, ua])
    d = torch.cat([d, d])
    # each row by (distance, column): by column, then by (row, distance)
    o = torch.sort(c, stable=True).indices
    o = o[torch.sort((r[o] << 32) + _sortable(d[o]), stable=True).indices]
    r, c, d = r[o], c[o], d[o]
    deg = torch.bincount(r, minlength=n)
    width = (int(deg.max()) if n else 0) + 1
    if max_width > 0:
        width = min(width, max_width)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(r.numel(), device=dev) - starts[r] + 1
    keep = slot < width
    out_idx = torch.full((n, width), -1, dtype=torch.int32, device=dev)
    out_dist = torch.full((n, width), float("inf"), dtype=torch.float32,
                          device=dev)
    out_idx[r[keep], slot[keep]] = c[keep].to(torch.int32)
    out_dist[r[keep], slot[keep]] = d[keep]
    out_idx[:, 0] = torch.arange(n, dtype=torch.int32, device=dev)
    out_dist[:, 0] = 0.0
    counts = (1 + torch.clamp(deg, max=width - 1)).to(torch.int32)
    return out_idx, out_dist, counts
