"""Batched component-pair distances for the Borůvka merge step.

Port of the NEIGH_WALKS, NEIGH_WALKS_SINGLE_OVERLAP, NEIGH_OVERLAP and
EUCLID_CENTROID metrics of sph_tpu/ops/similarities.py (reference:
sph/utils/Similarities.cpp — componentDistance :123-156, NEIGH_OVERLAP
:174-228, NEIGH_WALKS single overlap :328-351 and Bhattacharyya :353-396,
EUCLID_CENTROID Hausdorff :414-483).  Every metric evaluates all requested
(a, b) pairs in batched calls on one device; the geodesic metrics are in
ops/shortest_path.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .numerics import row_dot, sqrt
from .sparse import PAD, SparseRows, bhattacharyya_pairs

_BIG = torch.iinfo(torch.int64).max
# bytes of one chunk of Hausdorff pairs: both gathered point sets and the
# [S, S] product of each pair
HAUSDORFF_MEMORY_BUDGET = 2 << 30


def walks_bhattacharyya_distance(walks: SparseRows, pairs_a: np.ndarray,
                                 pairs_b: np.ndarray) -> np.ndarray:
    """1 - BC(row_a, row_b) (reference: simRandomWalksBhattacharyya)."""
    bc = bhattacharyya_pairs(walks, pairs_a, pairs_b)
    return np.asarray(np.float32(1.0) - bc, dtype=np.float32)


def walks_single_overlap_distance(walks: SparseRows, pairs_a: np.ndarray,
                                  pairs_b: np.ndarray) -> np.ndarray:
    """1 - max(w[a, b], w[b, a]) (reference: simRandomWalksSingleOverlay,
    Similarities.cpp:328-351): each lookup a binary search of the row's
    ascending columns, 0 where the column is absent.  A max and a
    subtraction, so the JAX package's values bit for bit.  Pairs are
    chunked so the [E, R] row gathers stay near 2^26 entries."""
    e = len(pairs_a)
    if e == 0:
        return np.empty(0, np.float32)
    dev = walks.device
    key = torch.where(walks.idx < 0, _BIG, walks.idx)
    r = walks.width
    a_all = torch.as_tensor(np.asarray(pairs_a, np.int64), device=dev)
    b_all = torch.as_tensor(np.asarray(pairs_b, np.int64), device=dev)

    def lookup(rows, cols):
        kr = key[rows]
        pos = torch.searchsorted(kr, cols[:, None]).clamp_(max=r - 1)
        hit = kr.gather(1, pos)[:, 0] == cols
        return torch.where(hit, walks.val[rows].gather(1, pos)[:, 0], 0.0)

    chunk = max(4096, (1 << 26) // max(r, 1))
    out = torch.empty(e, dtype=torch.float32, device=dev)
    for i0 in range(0, e, chunk):
        a, b = a_all[i0:i0 + chunk], b_all[i0:i0 + chunk]
        out[i0:i0 + chunk] = 1.0 - torch.maximum(lookup(a, b), lookup(b, a))
    return out.cpu().numpy()


def build_union_neighborhoods(knn_indices: np.ndarray,
                              pixel_components: np.ndarray,
                              num_components: int,
                              device=None) -> SparseRows:
    """Per component: sorted unique union of the kNN ids of its represented
    pixels (reference: representedOverlap getKnn, Similarities.cpp:192-205),
    as SparseRows with value 1 at each member."""
    n, k = knn_indices.shape
    comp = np.repeat(pixel_components.astype(np.int64), k)
    nbr = knn_indices.ravel().astype(np.int64)
    ok = nbr >= 0      # padded slots are not members
    comp, nbr = comp[ok], nbr[ok]
    key = np.unique(comp * n + nbr)
    rows = (key // n).astype(np.int64)
    cols = (key % n).astype(np.int64)
    counts = np.bincount(rows, minlength=num_components)
    width = max(int(counts.max()) if counts.size else 1, 1)
    indices = np.full((num_components, width), PAD, dtype=np.int64)
    values = np.zeros((num_components, width), dtype=np.float32)
    starts = np.zeros(num_components + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(rows.size) - starts[rows]
    indices[rows, slot] = cols
    values[rows, slot] = 1.0
    return SparseRows(indices, values, n, device=device)


def neighbor_overlap_distance(unions: SparseRows, pairs_a: np.ndarray,
                              pairs_b: np.ndarray) -> np.ndarray:
    """1 - |A intersect B| / min(|A|, |B|) (reference: simNeighborOverlap,
    Similarities.cpp:216-228)."""
    e = len(pairs_a)
    if e == 0:
        return np.empty(0, np.float32)
    dev = unions.device
    key = torch.where(unions.idx < 0, _BIG, unions.idx)
    counts = (unions.idx >= 0).sum(1)
    a = torch.as_tensor(np.asarray(pairs_a, np.int64), device=dev)
    b = torch.as_tensor(np.asarray(pairs_b, np.int64), device=dev)
    r = unions.width
    chunk = max(4096, (1 << 26) // max(r, 1))
    out = torch.empty(e, dtype=torch.float32, device=dev)
    for i0 in range(0, e, chunk):
        ka, kb = key[a[i0:i0 + chunk]], key[b[i0:i0 + chunk]]
        pos = torch.searchsorted(kb, ka).clamp_(max=r - 1)
        inter = ((kb.gather(1, pos) == ka) & (ka != _BIG)).sum(1)
        msize = torch.minimum(counts[a[i0:i0 + chunk]],
                              counts[b[i0:i0 + chunk]])
        sim = torch.where(msize > 0,
                          inter.to(torch.float32) / msize.to(torch.float32),
                          0.0)
        out[i0:i0 + chunk] = 1.0 - sim
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# EUCLID_CENTROID: symmetric Hausdorff of represented point sets
# ---------------------------------------------------------------------------

def sample_represented(rep_lists: list[np.ndarray], comp_ids: np.ndarray,
                       max_samples: int, seed: int) -> np.ndarray:
    """[E, max_samples] int64 data point ids of each component in
    `comp_ids`, -1 padded (reference: geodesic/euclid sampling,
    Similarities.cpp:286-305).  A set of at most `max_samples` points is
    taken whole; a larger one is drawn uniformly with replacement by the
    JAX package's ``rng.choice`` calls, in the same order from the same
    seed, so the draws are the same numbers."""
    comp_ids = np.asarray(comp_ids, np.int64)
    sizes = np.fromiter((len(r) for r in rep_lists), np.int64,
                        len(rep_lists))
    starts = np.zeros(len(rep_lists) + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    flat = (np.concatenate(rep_lists).astype(np.int64) if len(rep_lists)
            else np.zeros(1, np.int64))
    size = sizes[comp_ids]
    slot = np.arange(max_samples)
    pos = np.minimum(starts[comp_ids][:, None] + slot, max(flat.size - 1, 0))
    out = np.where(slot < size[:, None], flat[pos], -1)
    rng = np.random.default_rng(seed)
    for i in np.nonzero(size > max_samples)[0]:
        out[i] = rng.choice(rep_lists[comp_ids[i]], size=max_samples,
                            replace=True)
    return out


def hausdorff_chunk(samples: int, dim: int,
                    memory_budget: int = HAUSDORFF_MEMORY_BUDGET) -> int:
    """Pairs per chunk: the two gathered [S, D] sets and the [S, S] product
    and distances of each pair within `memory_budget` bytes."""
    per_pair = 4 * (2 * samples * dim + 2 * samples * samples)
    return max(1, memory_budget // per_pair)


def _hausdorff_sets(x: torch.Tensor, sq: torch.Tensor, ra: torch.Tensor,
                    rb: torch.Tensor) -> torch.Tensor:
    """Symmetric Hausdorff distance of the point sets x[ra[e]] and x[rb[e]]
    ([E, S] ids, -1 padded; `sq` the points' squared norms): the larger of
    the two directed distances, each the max over one set's points of the
    min over the other's.  The JAX package's arithmetic (_hausdorff_device):
    (|a|^2 + |b|^2) - 2 a.b per point pair, floored at 0, square-rooted.
    The root and the floor are monotone, so they are taken after the min
    and max, which leaves every value as it was; a pad point's norm is
    +inf, which drops it from the minima."""
    ma, mb = ra >= 0, rb >= 0
    ia, ib = ra.clamp(min=0), rb.clamp(min=0)
    na = torch.where(ma, sq[ia], torch.inf)
    nb = torch.where(mb, sq[ib], torch.inf)
    ip = torch.bmm(x[ia], x[ib].transpose(1, 2))
    d2 = torch.add(na[:, :, None], nb[:, None, :])
    d2.sub_(ip.mul_(2.0))
    del ip
    h1 = torch.where(ma, d2.amin(2), -torch.inf).amax(1)
    h2 = torch.where(mb, d2.amin(1), -torch.inf).amax(1)
    return sqrt(torch.clamp(torch.maximum(h1, h2), min=0.0))


def component_hausdorff(data, rep, pairs_a, pairs_b, device=None,
                        memory_budget: int = HAUSDORFF_MEMORY_BUDGET
                        ) -> np.ndarray:
    """Symmetric Hausdorff distance between the sample sets rep[a] and
    rep[b] of each component pair (a, b): [E] float32.  `rep` [C, S] holds
    each component's data point ids, -1 padded; `data` [N, D] is a numpy
    array or a tensor.  The pairs' sets are gathered on the device chunk by
    chunk (``hausdorff_chunk``), so no [E, S] array is built."""
    e = len(pairs_a)
    if e == 0:
        return np.empty(0, np.float32)
    if isinstance(data, torch.Tensor):
        x = data.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(data, np.float32),
                            device=resolve_device(device))
    dev = x.device
    sq = row_dot(x, x)
    rep = torch.as_tensor(np.asarray(rep, np.int64), device=dev)
    a = torch.as_tensor(np.asarray(pairs_a, np.int64), device=dev)
    b = torch.as_tensor(np.asarray(pairs_b, np.int64), device=dev)
    chunk = hausdorff_chunk(rep.shape[1], x.shape[1], memory_budget)
    out = torch.empty(e, dtype=torch.float32, device=dev)
    for i0 in range(0, e, chunk):
        out[i0:i0 + chunk] = _hausdorff_sets(x, sq, rep[a[i0:i0 + chunk]],
                                             rep[b[i0:i0 + chunk]])
    return out.cpu().numpy()


def hausdorff_point_set_distance(data, rep_a: np.ndarray,
                                 rep_b: np.ndarray, device=None,
                                 memory_budget: int = HAUSDORFF_MEMORY_BUDGET
                                 ) -> np.ndarray:
    """Symmetric Hausdorff over represented data points (reference:
    euclidDistance, Similarities.cpp:414-483 + symmetricHausdorffDistance):
    rep_a / rep_b [E, S] data point ids, -1 padded (sampling to S is the
    caller's job, ``sample_represented``) -> [E] float32."""
    e = rep_a.shape[0]
    idx = np.arange(e)
    return component_hausdorff(data, np.concatenate([rep_a, rep_b]), idx,
                               idx + e, device, memory_budget)
