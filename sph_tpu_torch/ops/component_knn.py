"""Exact kNN in the NEIGH_OVERLAP component metric space.

Port of sph_tpu/ops/component_knn.py::knn_neighbor_overlap (reference:
sph/LevelSimilarities.cpp computeNearestNeighborOnLevel :191-442 with
NeighborOverlapSpace.hpp:31-42).  The 0/1 membership matrix M gives every
intersection count at once as M M^T (exact in float32: counts << 2^24).
The other component metrics and the approximate tier are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import ensure_self_first
from .sparse import SparseRows


def knn_neighbor_overlap(unions: SparseRows, k: int, block: int = 1024
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per component, the k nearest components by 1 - |A^B| / min(|A|,|B|):
    (ids [C, k] int32, dists [C, k] f32), ascending with ties to the lower
    id, self first."""
    c, n = unions.num_rows, unions.num_cols
    dev = unions.device
    ok = unions.idx >= 0
    members = torch.zeros((c, n), dtype=torch.float32, device=dev)
    rows = torch.arange(c, device=dev)[:, None].expand_as(unions.idx)
    members[rows[ok], unions.idx[ok]] = 1.0
    counts = members.sum(1)
    kk = min(k, c)
    ids = torch.arange(c, device=dev)
    out_i, out_d = [], []
    for r0 in range(0, c, block):
        inter = members[r0:r0 + block] @ members.T
        m = torch.minimum(counts[r0:r0 + block, None], counts[None, :])
        sim = torch.where(m > 0, inter / torch.clamp(m, min=1.0), 0.0)
        dist = torch.where(ids[None, :] == ids[r0:r0 + block, None], 0.0,
                           1.0 - sim)
        sd, si = torch.sort(dist, dim=1, stable=True)
        out_d.append(sd[:, :kk])
        out_i.append(si[:, :kk])
    idx, dist, _ = ensure_self_first(
        torch.cat(out_i).to(torch.int32).cpu().numpy(),
        torch.cat(out_d).cpu().numpy())
    return idx.astype(np.int32), dist.astype(np.float32)
