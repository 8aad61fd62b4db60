"""kNN in component metric spaces: the exact NEIGH_OVERLAP, walk and
EUCLID_CENTROID tiers and the approximate tier.

Port of sph_tpu/ops/component_knn.py (reference:
sph/LevelSimilarities.cpp computeNearestNeighborOnLevel :191-442 with
NeighborOverlapSpace.hpp:31-42, and computeApproximateKnn :254-334).
``knn_neighbor_overlap`` is exact: the intersection counts of a block of
components with all others are one sparse product of the 0/1 membership
rows with the block's dense membership columns (exact in float32: counts
<< 2^24).  ``knn_walks`` is exact: the walk rows' Bhattacharyya (a float32 product of
densified square-root tiles) or single overlap (the max of a row tile and
its transposed column tile) over all components.  ``knn_hausdorff`` is
exact: blocked products of the components' sampled points.
``approx_pair_metric_knn`` is the approximate tier: k-means cluster pruning
over a sketch of each component (``project_sparse_rows``,
``ivf_candidate_table``), then the exact pair metric on the candidates
only.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..device import resolve_device
from . import knn
from .graph import ensure_self_first
from .numerics import row_dot, sqrt
from .sparse import SparseRows


# bytes of the exact NEIGH_OVERLAP kNN's blocks: a block's dense membership
# columns [N, block] and its [block, C] counts, distances and selection
OVERLAP_MEMORY_BUDGET = 1 << 30


def overlap_block(c: int, n: int,
                  memory_budget: int = OVERLAP_MEMORY_BUDGET) -> int:
    """Row components per block of `knn_neighbor_overlap`: the block's
    float32 membership columns [n, block] and its [block, c] float32
    counts and distances and int64 keys within `memory_budget` bytes."""
    return max(1, min(c, memory_budget // (4 * n + 24 * c)))


def knn_neighbor_overlap(unions: SparseRows, k: int,
                         memory_budget: int = OVERLAP_MEMORY_BUDGET
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per component, the k nearest components by 1 - |A^B| / min(|A|,|B|):
    (ids [C, k] int32, dists [C, k] f32), ascending with ties to the lower
    id, self first.

    The intersection counts of a block of components with all C come from
    one sparse product: the 0/1 membership rows of all components (CSR,
    [C, N]) times the block's membership as dense columns [N, block].
    Every count is a sum of 1.0s below 2^24, exact in float32 in any
    order, so the counts are the JAX package's int8 membership product's.
    No [C, N] matrix is built; blocks are sized from `memory_budget`
    (``overlap_block``)."""
    c, n = unions.num_rows, unions.num_cols
    dev = unions.device
    ok = unions.idx >= 0
    counts = ok.sum(1).to(torch.float32)
    cols = unions.idx[ok]
    crow = torch.zeros(c + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(ok.sum(1), 0)
    with warnings.catch_warnings():       # CSR support is marked beta
        warnings.simplefilter("ignore")
        members = torch.sparse_csr_tensor(
            crow, cols, torch.ones(cols.numel(), device=dev), (c, n))
    kk = min(k, c)
    block = overlap_block(c, n, memory_budget)
    ids = torch.arange(c, device=dev)
    out_i, out_d = [], []
    for r0 in range(0, c, block):
        r1 = min(r0 + block, c)
        rok = ok[r0:r1]
        dense = torch.zeros((n, r1 - r0), dtype=torch.float32, device=dev)
        dense[unions.idx[r0:r1][rok],
              torch.nonzero(rok, as_tuple=True)[0]] = 1.0
        inter = (members @ dense).T                     # [block, C]
        del dense
        m = torch.minimum(counts[r0:r1, None], counts[None, :])
        sim = torch.where(m > 0, inter / torch.clamp(m, min=1.0), 0.0)
        dist = torch.where(ids[None, :] == ids[r0:r1, None], 0.0, 1.0 - sim)
        del inter, m, sim
        top = knn._bottom_k(dist, kk, memory_budget)
        out_d.append(dist.gather(1, top))
        out_i.append(top)
    idx, dist, _ = ensure_self_first(
        torch.cat(out_i).to(torch.int32).cpu().numpy(),
        torch.cat(out_d).cpu().numpy())
    return idx.astype(np.int32), dist.astype(np.float32)


# ---------------------------------------------------------------------------
# NEIGH_WALKS (Bhattacharyya) and NEIGH_WALKS_SINGLE_OVERLAP
# ---------------------------------------------------------------------------

# bytes of one tile of `knn_walks`: the row tile's dense [rows, C] rows and
# [rows, C] distances with their selection keys, and one column tile's dense
# [cols, C] rows
WALKS_MEMORY_BUDGET = 2 << 30
_WALKS_ROW_BYTES = 24      # dense row, distance, int64 key, per column
_BIG_ID = torch.iinfo(torch.int64).max


def walks_blocks(c: int, memory_budget: int = WALKS_MEMORY_BUDGET
                 ) -> tuple[int, int]:
    """(row components, column components) of one tile of `knn_walks`:
    half of `memory_budget` for the row tile's [rows, c] buffers, half for
    the column tile's dense [cols, c] rows."""
    half = memory_budget // 2
    rows = max(1, min(c, half // (_WALKS_ROW_BYTES * c)))
    cols = max(1, min(c, half // (4 * c)))
    return rows, cols


def check_sparse_rows(rows: SparseRows, name: str = "rows") -> None:
    """Raise ValueError unless every row's columns ascend strictly (so they
    are unique) with the pads (-1) after them, all within [0, num_cols):
    the invariant densifying scatters trust."""
    idx = rows.idx
    if idx.numel() == 0:
        return
    if bool((idx >= rows.num_cols).any()) or bool((idx < -1).any()):
        raise ValueError(f"{name}: column ids outside [0, {rows.num_cols})")
    key = torch.where(idx < 0, _BIG_ID, idx)
    bad = (key[:, 1:] <= key[:, :-1]) & (key[:, 1:] != _BIG_ID)
    if bool(bad.any()):
        row = int(torch.nonzero(bad.any(1))[0, 0])
        raise ValueError(
            f"{name}: row {row} has columns that are not ascending and "
            f"unique, or a pad before a column: {idx[row].tolist()}")


def _dense_tile(rows: SparseRows, r0: int, r1: int, root: bool
                ) -> torch.Tensor:
    """Rows r0:r1 as dense [r1 - r0, num_cols] float32 (their square roots
    when `root`); columns are unique, so each entry is written once."""
    idx, val = rows.idx[r0:r1], rows.val[r0:r1]
    ok = idx >= 0
    v = sqrt(torch.clamp(val[ok], min=0.0)) if root else val[ok]
    out = torch.zeros((r1 - r0, rows.num_cols), dtype=torch.float32,
                      device=rows.device)
    out[torch.nonzero(ok, as_tuple=True)[0], idx[ok]] = v
    return out


def _transposed_tile(rows: SparseRows, r0: int, r1: int) -> torch.Tensor:
    """Columns r0:r1 of the rows as dense [r1 - r0, num_rows]: entry [a, b]
    is w[b, r0 + a]."""
    ok = (rows.idx >= r0) & (rows.idx < r1)
    src = torch.nonzero(ok, as_tuple=True)[0]
    out = torch.zeros((r1 - r0, rows.num_rows), dtype=torch.float32,
                      device=rows.device)
    out[rows.idx[ok] - r0, src] = rows.val[ok]
    return out


def knn_walks(walks: SparseRows, k: int, single_overlap: bool = False,
              memory_budget: int = WALKS_MEMORY_BUDGET
              ) -> tuple[np.ndarray, np.ndarray]:
    """Per component, the k nearest components by its walk row (reference:
    NeighborWalksBhattacharyyaSpace / NeighborWalksSingleOverlapSpace):
    (ids [C, k] int32, dists [C, k] f32), ascending with ties to the lower
    id, self first with distance 0.

    Bhattacharyya (the default): 1 - min(<sqrt(w_a), sqrt(w_b)>, 1), the
    product of two dense square-root tiles in float32 (TF32 is off).
    Single overlap: 1 - max(w[a, b], w[b, a]), a row tile against the same
    columns' transposed tile, bit for bit the JAX package's.  Tiles are
    sized from `memory_budget` (``walks_blocks``); no [C, C] matrix is
    held.  The rows must keep the SparseRows invariant (ascending unique
    columns, pads last): ``check_sparse_rows`` raises where they do not,
    as a densify that trusted them would build a wrong graph."""
    c = walks.num_rows
    if walks.num_cols != c:
        raise ValueError(f"knn_walks needs square walk rows, got {c} rows "
                         f"of {walks.num_cols} columns")
    check_sparse_rows(walks, "knn_walks")
    dev = walks.device
    kk = min(k, c)
    rb, cb = walks_blocks(c, memory_budget)
    cols = torch.arange(c, device=dev)
    out_i, out_d = [], []
    for r0 in range(0, c, rb):
        r1 = min(r0 + rb, c)
        if single_overlap:
            sim = torch.maximum(_dense_tile(walks, r0, r1, False),
                                _transposed_tile(walks, r0, r1))
            dist = 1.0 - sim
            del sim
        else:
            rows = _dense_tile(walks, r0, r1, True)
            dist = torch.empty((r1 - r0, c), dtype=torch.float32, device=dev)
            for c0 in range(0, c, cb):
                c1 = min(c0 + cb, c)
                bc = rows @ _dense_tile(walks, c0, c1, True).T
                dist[:, c0:c1] = 1.0 - torch.clamp(bc, max=1.0)
                del bc
            del rows
        dist[torch.arange(r1 - r0, device=dev), cols[r0:r1]] = 0.0
        top = knn._bottom_k(dist, kk, memory_budget)
        out_d.append(dist.gather(1, top))
        out_i.append(top)
        del dist
    idx, dist, _ = ensure_self_first(
        torch.cat(out_i).to(torch.int32).cpu().numpy(),
        torch.cat(out_d).cpu().numpy())
    return idx.astype(np.int32), dist.astype(np.float32)


# ---------------------------------------------------------------------------
# EUCLID_CENTROID: sampled-point Hausdorff matrix
# ---------------------------------------------------------------------------

# bytes held for each (row sample, column sample) pair of a tile: the float32
# product and the float32 squared distances built from it
_HAUSDORFF_BYTES_PER_PAIR = 8


def hausdorff_blocks(c: int, s: int,
                     memory_budget: int = knn.KNN_MEMORY_BUDGET
                     ) -> tuple[int, int]:
    """(row components, column components) of one tile of `knn_hausdorff`:
    about 4096 row samples, and as many columns as the tile's
    [rows * s, cols * s] buffers fit in `memory_budget` bytes."""
    rows = max(1, min(c, 4096 // s))
    cols = memory_budget // (_HAUSDORFF_BYTES_PER_PAIR * rows * s * s)
    return rows, max(1, min(c, cols))


def knn_hausdorff(data, rep_samples: np.ndarray, k: int, device=None,
                  memory_budget: int = knn.KNN_MEMORY_BUDGET
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per component, the k nearest components by the symmetric Hausdorff
    distance of their sampled points (rep_samples [C, S] data point ids, -1
    padded): (ids [C, k] int32, dists [C, k] f32), ascending with ties to
    the lower id, self first (reference: EuclidSpace over the components'
    represented points).

    The JAX package's arithmetic (_hausdorff_knn): the squared distances
    (|a|^2 + |b|^2) - 2 a.b of all sample pairs from one 2-D product, the
    max over each set's samples of the min over the other's, floored at 0
    and square-rooted (monotone, so taken after the min and max: same
    values), 0 on the diagonal, then the bottom k.  Blocked over row
    components and, where a row block's [rows * S, C * S] tile exceeds
    `memory_budget`, over column components (``hausdorff_blocks``)."""
    c, s = rep_samples.shape
    if isinstance(data, torch.Tensor):
        x = data.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(data, np.float32),
                            device=resolve_device(device))
    dev = x.device
    rep = torch.as_tensor(np.asarray(rep_samples, np.int64), device=dev)
    ok = rep >= 0
    ids = rep.clamp(min=0)
    # a pad sample's norm is +inf, which drops it from the minima
    norms = torch.where(ok, row_dot(x, x)[ids], torch.inf)
    points = x[ids]                                     # [C, S, D]
    kk = min(k, c)
    rb, cb = hausdorff_blocks(c, s, memory_budget)
    cols = torch.arange(c, device=dev)
    out_i, out_d = [], []
    for r0 in range(0, c, rb):
        r1 = min(r0 + rb, c)
        rows = points[r0:r1].reshape(-1, x.shape[1])
        h = torch.empty((r1 - r0, c), dtype=torch.float32, device=dev)
        for c0 in range(0, c, cb):
            c1 = min(c0 + cb, c)
            ip = rows @ points[c0:c1].reshape(-1, x.shape[1]).T
            d2 = torch.add(norms[r0:r1].reshape(-1, 1),
                           norms[c0:c1].reshape(1, -1))
            d2.sub_(ip.mul_(2.0))
            del ip
            d2 = d2.view(r1 - r0, s, c1 - c0, s)
            h1 = torch.where(ok[r0:r1, :, None], d2.amin(3),
                             -torch.inf).amax(1)
            h2 = torch.where(ok[None, c0:c1, :], d2.amin(1),
                             -torch.inf).amax(2)
            h[:, c0:c1] = torch.maximum(h1, h2)
            del d2
        h = sqrt(torch.clamp(h, min=0.0))
        h[torch.arange(r1 - r0, device=dev), cols[r0:r1]] = 0.0
        top = knn._bottom_k(h, kk, memory_budget)
        out_d.append(h.gather(1, top))
        out_i.append(top)
    idx, dist, _ = ensure_self_first(
        torch.cat(out_i).to(torch.int32).cpu().numpy(),
        torch.cat(out_d).cpu().numpy())
    return idx.astype(np.int32), dist.astype(np.float32)


# ---------------------------------------------------------------------------
# Approximate tier: IVF cluster pruning in a proxy sketch space
# (sph_tpu/ops/component_knn.py:317-432): the reference's hnswlib HNSW over
# ComponentID spaces becomes candidate generation by k-means pruning, then
# the exact pair metric on the candidates.

def project_sparse_rows(rows: SparseRows, dim: int = 128,
                        seed: int = 0) -> np.ndarray:
    """JL sketch of sqrt-valued sparse rows, feat = sqrt(S) @ R, on the host
    (scipy), with the JAX package's numpy draws: [C, dim] f32."""
    import scipy.sparse as sp
    c, n = rows.num_rows, rows.num_cols
    indices, values = rows.indices, rows.values
    mask = indices >= 0
    indptr = np.zeros(c + 1, np.int64)
    np.cumsum(mask.sum(1), out=indptr[1:])
    data = np.sqrt(np.maximum(values[mask], 0.0)).astype(np.float32)
    cols = indices[mask].astype(np.int64)
    s = sp.csr_matrix((data, cols, indptr), shape=(c, n))
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((n, dim)) / np.sqrt(dim)).astype(np.float32)
    return np.asarray(s @ r, dtype=np.float32)


def ivf_candidate_table(features: np.ndarray, nlist: int | None = None,
                        nprobe: int | None = None, seed: int = 0,
                        kmeans_iters: int = 8, device=None) -> np.ndarray:
    """Candidate component ids per component, [C, nprobe * Lmax] int32, -1
    padded: the members of the nprobe clusters whose centroids lie nearest
    to the component's sketch.  The k-means (``knn._kmeans``, no reseeding)
    runs on `device`; the rest is the JAX package's numpy."""
    c, _ = features.shape
    if nlist is None:
        nlist = max(16, int(math.sqrt(c)))
    nlist = min(nlist, c)
    if nprobe is None:
        nprobe = max(4, int(math.sqrt(nlist)))
    nprobe = min(nprobe, nlist)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    init = features[rng.choice(c, nlist, replace=False)]
    km_block = min(65536, ((c + 1023) // 1024) * 1024)
    cpad = ((c + km_block - 1) // km_block) * km_block
    feats_pad = np.zeros((cpad, features.shape[1]), np.float32)
    feats_pad[:c] = features
    cents, assign = knn._kmeans(torch.as_tensor(feats_pad, device=dev), c,
                                torch.as_tensor(init, device=dev), nlist,
                                kmeans_iters, block=km_block)
    cents = cents.cpu().numpy()
    assign = assign.cpu().numpy()[:c]

    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist)
    lmax = int(counts.max())
    lists = np.full((nlist, lmax), -1, dtype=np.int32)
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(c) - starts[assign[order]]
    lists[assign[order], slot] = order.astype(np.int32)

    cd = (np.sum(features * features, 1)[:, None]
          + np.sum(cents * cents, 1)[None, :] - 2.0 * features @ cents.T)
    probes = np.argpartition(cd, min(nprobe, nlist - 1),
                             axis=1)[:, :nprobe]
    return lists[probes].reshape(c, -1)


def approx_pair_metric_knn(pair_fn, features: np.ndarray, k: int,
                           seed: int = 0,
                           nlist: int | None = None,
                           nprobe: int | None = None,
                           device=None) -> tuple[np.ndarray, np.ndarray]:
    """Approximate component kNN: IVF candidates from `features`, exact
    distances from `pair_fn(rows_a, rows_b) -> [E] float32`, then each
    row's bottom-k (numpy's argpartition and a stable sort, as the JAX
    package selects it), self first with distance 0: (ids [C, k] int32,
    dists [C, k] f32), -1 / +inf where a row has fewer candidates."""
    c = features.shape[0]
    cand = ivf_candidate_table(features, nlist=nlist, nprobe=nprobe,
                               seed=seed, device=device)
    m = cand.shape[1]
    rows = np.repeat(np.arange(c, dtype=np.int32), m)
    cols = cand.ravel()
    valid = cols >= 0
    d = np.full(c * m, np.inf, dtype=np.float32)
    d[valid] = pair_fn(rows[valid], cols[valid])
    d = d.reshape(c, m)
    # self is left out of the ranking and put first below
    d = np.where(cand == np.arange(c)[:, None], np.inf, d)

    kk = min(k, m)
    part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
    r = np.arange(c)[:, None]
    dk = d[r, part]
    order = np.argsort(dk, axis=1, kind="stable")
    ids = cand[r, part[r, order]]
    dists = dk[r, order]
    if kk < k:
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        dists = np.pad(dists, ((0, 0), (0, k - kk)),
                       constant_values=np.inf)
    ids = np.where(np.isfinite(dists), ids, -1)
    # self goes to slot 0 with distance 0; the last neighbour is displaced
    ids = np.concatenate([np.arange(c, dtype=ids.dtype)[:, None],
                          ids[:, :-1]], axis=1)
    dists = np.concatenate([np.zeros((c, 1), np.float32),
                            dists[:, :-1]], axis=1)
    ids, dists, _ = ensure_self_first(ids.astype(np.int32),
                                      dists.astype(np.float32))
    return ids, dists
