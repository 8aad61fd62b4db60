"""Bounded-hop geodesic sketch over the pixel kNN graph.

Port of sph_tpu/ops/geo_sketch.py (the replacement for the reference's
per-pair A* + DistanceCache, ShortestPath.cpp:100-166, at component counts
where per-component fields stop being feasible): every node keeps its
`width` geodesically closest nodes within 2^hops graph hops (pruned
min-plus squaring of the kNN adjacency), and a pixel-pair geodesic is the
meet-in-the-middle merge of the two rows.

The JAX package's multi-key stable ``lax.sort`` calls become stable
``torch.sort`` calls on integer keys that order as its comparator does:
ids with distances packed into one int64 ((id, distance) rows), distances
as order-preserving int32 bits (-0.0 equal to +0.0, as ``lax.sort``
canonicalizes it), ids doubled with the side bit for the query merge.
Every value is a min of one float32 add, so the sketch and the queries
equal the JAX package's bit for bit.  Blocks and chunks are sized from a
memory budget; rows and queries are independent, so the sizes change no
result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_I32_MAX = 2 ** 31 - 1
# bytes of one block of squaring rows or one chunk of queries (the
# gathered candidates, their keys and the sort's outputs)
SKETCH_MEMORY_BUDGET = 1 << 30
_BYTES_PER_CANDIDATE = 48


def _order_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 in the same order (-0.0 taken as +0.0)."""
    bits = torch.where(x == 0, 0.0, x).view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _square_block(si: torch.Tensor, sd: torch.Tensor, bi: torch.Tensor,
                  bd: torch.Tensor, width: int):
    """One pruned min-plus squaring step for a row block: si/sd [N, W2] the
    whole sketch (ids -1 padded, distances inf padded), bi/bd [B, W] the
    block's rows.  Returns [B, width] rows with the `width` smallest
    deduplicated two-leg distances, id-ascending."""
    b, w = bi.shape
    n, w2 = si.shape
    ok = bi >= 0
    safe = bi.clamp(0, n - 1).long()
    gi = si[safe].long()                              # [B, W, W2]
    cd = bd[:, :, None] + sd[safe]
    ci = torch.where(ok[:, :, None] & (gi >= 0), gi, _I32_MAX)
    cd = torch.where(ci < _I32_MAX, cd, torch.inf)
    ci = ci.reshape(b, w * w2)
    cd = cd.reshape(b, w * w2)

    # (id, distance) ascending, stable: each id's minimum first in its run
    key = (ci << 32) | (_order_bits(cd).long() + 2 ** 31)
    key, order = torch.sort(key, dim=1, stable=True)
    ci_s = key >> 32
    cd_s = cd.gather(1, order)
    first = torch.ones_like(ci_s, dtype=torch.bool)
    first[:, 1:] = ci_s[:, 1:] != ci_s[:, :-1]
    keep = first & (ci_s < _I32_MAX)
    dsel = torch.where(keep, cd_s, torch.inf)
    isel = torch.where(keep, ci_s, _I32_MAX)

    # keep the `width` nearest (stable by distance), then id-ascending
    _, order = torch.sort(_order_bits(dsel), dim=1, stable=True)
    order = order[:, :width]
    isel = isel.gather(1, order)
    dsel = dsel.gather(1, order)
    isel, order = torch.sort(isel, dim=1, stable=True)
    dsel = dsel.gather(1, order)
    pad = isel >= _I32_MAX
    return (torch.where(pad, -1, isel).to(torch.int32),
            torch.where(pad, torch.inf, dsel))


def _query_block(si: torch.Tensor, sd: torch.Tensor, pa: torch.Tensor,
                 pb: torch.Tensor) -> torch.Tensor:
    """Meet-in-the-middle geodesics for pixel pairs (pa[e], pb[e]): the min
    over the sketch entries c shared by both rows of D_p(c) + D_q(c); the
    self entry (distance 0) makes one-sided containment exact.  Returns [E]
    float32, inf where the rows do not meet."""
    n = si.shape[0]
    ia = pa.clamp(0, n - 1).long()
    ib = pb.clamp(0, n - 1).long()
    ra_i = si[ia].long()
    rb_i = si[ib].long()
    ra_i = torch.where((pa >= 0)[:, None] & (ra_i >= 0), ra_i, _I32_MAX)
    rb_i = torch.where((pb >= 0)[:, None] & (rb_i >= 0), rb_i, _I32_MAX)
    # (id, side) ascending, stable
    key = torch.cat([ra_i * 2, rb_i * 2 + 1], dim=1)
    cd = torch.cat([sd[ia], sd[ib]], dim=1)
    key, order = torch.sort(key, dim=1, stable=True)
    cd = cd.gather(1, order)
    ci, side = key >> 1, key & 1
    meet = ((ci[:, 1:] == ci[:, :-1]) & (ci[:, 1:] < _I32_MAX)
            & (side[:, 1:] != side[:, :-1]))
    sums = torch.where(meet, cd[:, 1:] + cd[:, :-1], torch.inf)
    return sums.amin(1)


def _rows_per_block(candidates: int,
                    memory_budget: int = SKETCH_MEMORY_BUDGET) -> int:
    return max(1, memory_budget // (_BYTES_PER_CANDIDATE
                                    * max(candidates, 1)))


def build_geo_sketch(graph, width: int = 64, hops: int = 3,
                     row_block: int = 0, device=None):
    """The [N, width] sketch of a SYMMETRIZED kNN graph (meet-in-the-middle
    sums two forward half-paths, which equals the geodesic only on an
    undirected graph); `hops` squarings cover paths of up to 2^hops
    edges.  Rows are taken `row_block` at a time (0: from the memory
    budget).  Returns device tensors (si [N, width] int32 id-ascending, -1
    padded; sd [N, width] float32, inf padded)."""
    from .shortest_path import _graph_arrays
    idx, dist, mask = _graph_arrays(graph)
    dev = resolve_device(device)
    n, k = idx.shape
    w0 = min(width, k)
    si0 = np.where(mask, idx, -1).astype(np.int32)
    sd0 = np.where(mask, dist, np.inf).astype(np.float32)
    # the self entry at distance 0, made explicit
    si0[:, 0] = np.arange(n, dtype=np.int32)
    sd0[:, 0] = 0.0
    si0 = si0[:, :w0]
    sd0 = sd0[:, :w0]
    order = np.argsort(np.where(si0 >= 0, si0, _I32_MAX), axis=1,
                       kind="stable")
    si = torch.as_tensor(np.take_along_axis(si0, order, axis=1), device=dev)
    sd = torch.as_tensor(np.take_along_axis(sd0, order, axis=1), device=dev)
    for _ in range(hops):
        step = row_block or _rows_per_block(si.shape[1] ** 2)
        blocks = [_square_block(si, sd, si[r0:r0 + step], sd[r0:r0 + step],
                                width) for r0 in range(0, n, step)]
        si = torch.cat([b[0] for b in blocks])
        sd = torch.cat([b[1] for b in blocks])
        del blocks
    return si, sd


def sketch_pair_distances(si, sd, p: np.ndarray, q: np.ndarray,
                          chunk: int = 0) -> np.ndarray:
    """Geodesics for explicit pixel pairs; inf where the sketches do not
    meet.  `chunk` pairs at a time (0: from the memory budget)."""
    dev = si.device
    p = torch.as_tensor(np.asarray(p, np.int64), device=dev)
    q = torch.as_tensor(np.asarray(q, np.int64), device=dev)
    step = chunk or _rows_per_block(2 * si.shape[1])
    out = torch.empty(p.shape[0], device=dev)
    for c0 in range(0, p.shape[0], step):
        out[c0:c0 + step] = _query_block(si, sd, p[c0:c0 + step],
                                         q[c0:c0 + step])
    return out.cpu().numpy()


def sketch_hausdorff_pairs(si, sd, rep_a: np.ndarray, rep_b: np.ndarray,
                           chunk: int = 0) -> np.ndarray:
    """Symmetric Hausdorff of sketch geodesics over sampled represented
    pixels (Similarities.cpp:234-310: the larger directed term, each the
    max over one side's samples of the min over the other's).  rep_a,
    rep_b [E, S] pixel ids, -1 padded.  Returns [E] float32; inf where a
    needed sample pair's sketches do not meet.  Only the sample pairs
    where both samples are real are queried (the JAX package queries all
    S^2 and masks the padded ones out), `chunk` component pairs at a time
    (0: from the memory budget)."""
    e, s = rep_a.shape
    dev = si.device
    ra = torch.as_tensor(np.asarray(rep_a, np.int64), device=dev)
    rb = torch.as_tensor(np.asarray(rep_b, np.int64), device=dev)
    # per pair: its [S, S] values and, at worst, S^2 queried sample pairs'
    # three int64 coordinates and mask
    step = chunk or max(1, SKETCH_MEMORY_BUDGET // (32 * s * s))
    queries = _rows_per_block(2 * si.shape[1])
    out = torch.empty(e, device=dev)
    for c0 in range(0, e, step):
        a, b = ra[c0:c0 + step], rb[c0:c0 + step]
        va, vb = a >= 0, b >= 0
        pe, pi, pj = (va[:, :, None] & vb[:, None, :]).nonzero(as_tuple=True)
        g = torch.full((a.shape[0], s, s), torch.inf, device=dev)
        for q0 in range(0, pe.numel(), queries):
            sl = slice(q0, q0 + queries)
            g[pe[sl], pi[sl], pj[sl]] = _query_block(
                si, sd, a[pe[sl], pi[sl]], b[pe[sl], pj[sl]])
        d_ab = torch.where(va, g.amin(2), -torch.inf).amax(1)
        d_ba = torch.where(vb, g.amin(1), -torch.inf).amax(1)
        out[c0:c0 + step] = torch.maximum(d_ab, d_ba)
    return out.cpu().numpy()
