"""Batched component-pair distances for the Borůvka merge step.

Port of the NEIGH_WALKS and NEIGH_OVERLAP metrics of
sph_tpu/ops/similarities.py (reference: sph/utils/Similarities.cpp —
componentDistance :123-156, NEIGH_OVERLAP :174-228, NEIGH_WALKS
Bhattacharyya :353-396).  Every metric evaluates all requested (a, b) pairs
in one batched call on the rows' device.  The geodesic, Hausdorff and
single-overlap metrics are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import PAD, SparseRows, bhattacharyya_pairs

_BIG = torch.iinfo(torch.int64).max


def walks_bhattacharyya_distance(walks: SparseRows, pairs_a: np.ndarray,
                                 pairs_b: np.ndarray) -> np.ndarray:
    """1 - BC(row_a, row_b) (reference: simRandomWalksBhattacharyya)."""
    bc = bhattacharyya_pairs(walks, pairs_a, pairs_b)
    return np.asarray(np.float32(1.0) - bc, dtype=np.float32)


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
