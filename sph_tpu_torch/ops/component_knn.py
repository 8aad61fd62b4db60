"""kNN in component metric spaces: the exact NEIGH_OVERLAP tier and the
approximate tier.

Port of sph_tpu/ops/component_knn.py (reference:
sph/LevelSimilarities.cpp computeNearestNeighborOnLevel :191-442 with
NeighborOverlapSpace.hpp:31-42, and computeApproximateKnn :254-334).
``knn_neighbor_overlap`` is exact: the 0/1 membership matrix M gives every
intersection count at once as M M^T (exact in float32: counts << 2^24).
``approx_pair_metric_knn`` is the approximate tier: k-means cluster pruning
over a JL sketch of each component (``project_sparse_rows``,
``ivf_candidate_table``), then the exact pair metric on the candidates only.
The exact Hausdorff and walk metrics are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from . import knn
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
