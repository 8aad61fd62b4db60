"""Batched geodesic distances over the kNN graph.

Port of sph_tpu/ops/shortest_path.py (reference: sph/utils/ShortestPath.cpp
computeShortestPath :100-166 and sph/utils/Similarities.cpp geodesicDistance
:234-310).  Per-pair A* becomes multi-source Bellman-Ford: one distance
field per source set, relaxed over the graph's in-edges until no distance
changes, and the Hausdorff identity max_{p in A} min_{q in B} d(p, q) =
max_{p in A} D_B(p) turns a component pair into two field lookups.

Why the port's fields equal the JAX package's bit for bit: a candidate is
one float32 add of a non-negative weight, and float32 rounding is monotone,
so every relaxation order converges to the same least fixed point (for each
node, the minimum over paths of the left-to-right float32 sum).  The JAX
package relaxes in Jacobi sweeps over its in-edge slots; the port does the
same sweeps laid out for a GPU:

- fields are [N + 1, F], node-major, so one in-edge reads F contiguous
  values; row N is an +inf sentinel that pad slots point at;
- on the card a sweep is the kernel csrc/bellman_ford_relax.cu, a warp a
  node reading its live in-edges from a CSR: ``relax`` a stateless full
  sweep, ``relax_delta`` a field batch's delta sweep (``RelaxBatch``: only
  the 8-field sectors that changed in the sweep before are gathered, only
  the changed ones written, and the stop test is decided in the kernel);
  on the CPU it is the plain twin ``relax_reference``: nodes renumbered by
  descending in-degree, so the nodes that have a j-th in-edge are a
  prefix, and the slots are gathered in chunks sized from a memory budget
  ([rows, slots, F], then ``amin``); ``relax_delta_reference`` is the
  delta sweep's twin;
- a sweep also returns, per field, the least value among the nodes it
  changed (the frontier).  No later sweep can lower a node below it, since
  every later candidate is a frontier value plus weights >= 0.  So a field
  evaluated only at a few nodes (the pair values) stops once each of them
  is at or below its frontier: those values are already the converged ones.
  Every other field runs until a sweep changes nothing, or ``max_iter``.

``LOG`` records each field batch (fields, nodes, sweeps) and each level-0
call's unresolved pairs, for the smoke script and the profile to print.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .cuda_build import _launch, sm_count
from .knn import _keys

_FLOAT_MAX = np.float32(np.finfo(np.float32).max)
# bytes of the gathered [rows, slots, F] candidates of one relax chunk, and
# of the [components, samples, F] gather that reduces fields to components
FIELD_MEMORY_BUDGET = 1 << 30

# components above this count use the contracted-graph approximation
# (stage 3) or the sketch (stage 2): exact pixel-level fields scale as C x N
CONTRACT_THRESHOLD = int(os.environ.get("SPH_CONTRACT_THRESHOLD", 4096))

# the newest entries only: a long-lived process would otherwise keep all
LOG: deque = deque(maxlen=1 << 16)


def _graph_arrays(graph):
    """(indices, distances, mask) of a KnnGraph or PaddedGraph."""
    from .graph import KnnGraph
    if isinstance(graph, KnnGraph):
        return (graph.indices, graph.distances,
                np.ones_like(graph.indices, dtype=bool))
    return graph.indices, graph.distances, graph.mask


def build_reverse_adjacency(indices: np.ndarray, distances: np.ndarray,
                            mask: Optional[np.ndarray] = None):
    """Incoming-edge table for directed relaxation.

    Returns (in_idx [N, Dmax], in_w [N, Dmax]) with -1 / +inf padding:
    in_idx[v] lists all u with an edge u -> v of weight in_w, in edge order.
    """
    n, k = indices.shape
    if mask is None:
        mask = np.ones_like(indices, dtype=bool)
    src = np.broadcast_to(np.arange(n)[:, None], (n, k))[mask]
    dst = indices[mask]
    w = distances[mask]
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    return _pack_in_edges(n, src, dst, w)


def _edge_list_reverse(n: int, src: np.ndarray, dst: np.ndarray,
                       w: np.ndarray):
    """Padded in-edge table from an explicit (src, dst, w) edge list; both
    directions are added (spatial adjacency is symmetric)."""
    return _pack_in_edges(n, np.concatenate([src, dst]),
                          np.concatenate([dst, src]),
                          np.concatenate([w, w]).astype(np.float32))


def _pack_in_edges(n: int, src, dst, w):
    deg = np.bincount(dst, minlength=n)
    dmax = max(int(deg.max()) if deg.size else 1, 1)
    in_idx = np.full((n, dmax), -1, dtype=np.int32)
    in_w = np.full((n, dmax), np.inf, dtype=np.float32)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s, w_s = dst[order], src[order], w[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(dst_s.size) - starts[dst_s]
    in_idx[dst_s, slot] = src_s
    in_w[dst_s, slot] = w_s
    return in_idx, in_w


def _locality_order(n: int, src: np.ndarray, off: np.ndarray) -> np.ndarray:
    """int32 [n]: the rows of the in-edge CSR (src, off) in reverse
    Cuthill-McKee order over the graph made undirected."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    graph = csr_matrix((np.ones(src.size, np.int8), src, off), shape=(n, n))
    return reverse_cuthill_mckee(graph, symmetric_mode=False).astype(
        np.int32)


class FieldGraph:
    """An in-edge table on a device, laid out for the relax sweeps: nodes
    renumbered by descending in-degree (``rank`` maps a node id to its
    row), pad slots pointing at row N, the +inf sentinel (``idx``, ``w``
    [N, Dmax], the twin's); and the same live in-edges as a CSR in rank
    order, slot order within a row (the kernel's): ``csr_src`` int32 [E]
    the sources' rows, ``csr_w`` float32 [E] the weights, ``csr_off``
    int64 [N + 1] where each row's in-edges start; ``order`` int32 [N],
    the rows in a reverse Cuthill-McKee order of the graph, the order in
    which the kernel's warps take the nodes (graph neighbours close
    together, so the warps in flight share their in-neighbours)."""

    def __init__(self, in_idx, in_w, device=None):
        in_idx = np.asarray(in_idx)
        in_w = np.asarray(in_w, np.float32)
        self.device = resolve_device(device)
        n, dmax = in_idx.shape
        valid = in_idx >= 0
        # a row's degree is one past its last valid slot
        deg = np.where(valid.any(1), dmax - np.argmax(valid[:, ::-1], 1), 0)
        order = np.argsort(-deg, kind="stable")
        rank = np.empty(n + 1, np.int64)
        rank[order] = np.arange(n)
        rank[n] = n
        idx = in_idx[order]
        self.n, self.dmax = n, dmax
        self.idx = torch.as_tensor(np.where(idx >= 0, rank[idx], n),
                                   device=self.device)
        self.w = torch.as_tensor(
            np.where(idx >= 0, in_w[order], np.inf).astype(np.float32),
            device=self.device)
        self.rank = torch.as_tensor(rank, device=self.device)
        # active[j]: the rows that have a j-th in-edge (a prefix)
        at_least = np.cumsum(np.bincount(deg, minlength=dmax + 1)[::-1])
        self.active = [int(v) for v in at_least[::-1][1:]]
        live = idx >= 0
        self.csr_src = torch.as_tensor(rank[idx[live]].astype(np.int32),
                                       device=self.device)
        self.csr_w = torch.as_tensor(in_w[order][live], device=self.device)
        off = np.zeros(n + 1, np.int64)
        np.cumsum(live.sum(1), out=off[1:])
        self.csr_off = torch.as_tensor(off, device=self.device)
        self.order = torch.as_tensor(
            _locality_order(n, rank[idx[live]], off), device=self.device)

    @classmethod
    def from_graph(cls, graph, device=None) -> "FieldGraph":
        return cls(*build_reverse_adjacency(*_graph_arrays(graph)), device)

    def rows(self, nodes: torch.Tensor) -> torch.Tensor:
        """Rows of node ids, -1 (a pad) to the sentinel row."""
        return self.rank[torch.where(nodes < 0, self.n, nodes)]

    def init(self, field_samples) -> torch.Tensor:
        """[F, S] padded (-1) source-id lists -> [N + 1, F] initial
        distances, 0 at sources, +inf elsewhere."""
        fs = torch.as_tensor(np.asarray(field_samples, np.int64),
                             device=self.device)
        f, s = fs.shape
        d = torch.full((self.n + 1, f), torch.inf, device=self.device)
        cols = torch.arange(f, device=self.device).repeat_interleave(s)
        d[self.rows(fs.reshape(-1)), cols] = 0.0
        d[self.n] = torch.inf
        return d

    def node_major(self, d: torch.Tensor) -> torch.Tensor:
        """[N + 1, F] rows -> [F, N] fields in node order."""
        return d[self.rank[:self.n]].T


# the field graph of the last graph object asked for (``field_graph``)
_FIELD_GRAPH_CACHE: dict = {}


def field_graph(graph, device=None) -> FieldGraph:
    """``FieldGraph.from_graph(graph, device)``, kept for the last graph
    object and device asked for: a hierarchy's geodesic calls at every
    level relax over the same pixel graph, whose table is host work that
    grows with the graph.  The entry pins the graph (a
    collected graph's id could be reused by a new one); a FieldGraph is
    not changed after it is built."""
    dev = resolve_device(device)
    hit = _FIELD_GRAPH_CACHE.get("last")
    if hit is None or hit[0] is not graph or hit[1] != dev:
        hit = (graph, dev, FieldGraph.from_graph(graph, dev))
        _FIELD_GRAPH_CACHE["last"] = hit
    return hit[2]


def relax_chunk_slots(rows: int, fields: int,
                      memory_budget: int = FIELD_MEMORY_BUDGET) -> int:
    """In-edge slots gathered at once: [rows, slots, fields] float32 within
    `memory_budget` bytes (at least 1)."""
    return max(1, memory_budget // (4 * max(rows, 1) * max(fields, 1)))


def _check_fields(d: torch.Tensor, g: FieldGraph, name: str):
    if d.dim() != 2 or d.shape[0] != g.n + 1:
        raise ValueError(f"{name}: fields must be [{g.n + 1}, F], got "
                         f"{tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"{name}: fields must be float32, got {d.dtype}")


def relax(d: torch.Tensor, g: FieldGraph,
          memory_budget: int = FIELD_MEMORY_BUDGET):
    """One Jacobi sweep: d'[v] = min(d[v], min_j d[in_j(v)] + w_j(v)) over
    the [N + 1, F] fields `d`.  Returns (d', frontier [F]): the least new
    value among the nodes the sweep lowered, +inf where it lowered none.
    d' is a new tensor; `d` is left as it is.

    On a CUDA tensor the kernel csrc/bellman_ford_relax.cu, counted in
    ``relax.launches``; on a CPU tensor the twin ``relax_reference`` (in
    chunks of `memory_budget` bytes).  The two are bit-equal."""
    _check_fields(d, g, "relax")
    if d.device.type == "cpu" and g.device.type == "cpu":
        return relax_reference(d, g, memory_budget)
    if d.device.type != "cuda":
        raise ValueError(f"relax: no kernel for {d.device}")
    if g.csr_src.device != d.device:
        raise ValueError(f"relax: the fields lie on {d.device}, the graph "
                         f"on {g.csr_src.device}")
    if not d.is_contiguous():
        raise ValueError("relax: the fields must be contiguous")
    f = d.shape[1]
    out = torch.empty_like(d)
    frontier = torch.full((f,), torch.inf, dtype=torch.float32,
                          device=d.device)
    _launch("bellman_ford_relax", d.device, d.data_ptr(),
            g.csr_src.data_ptr(), g.csr_w.data_ptr(), g.csr_off.data_ptr(),
            g.order.data_ptr(), g.n, f, d.stride(0), sm_count(d.device),
            out.data_ptr(), frontier.data_ptr(), None, None, None, None,
            None, None, None, 0)
    relax.launches += 1
    return out, frontier


# launches of bellman_ford_relax, stateless (``relax``) and in batches
# (``relax_delta``)
relax.launches = 0


def relax_reference(d: torch.Tensor, g: FieldGraph,
                    memory_budget: int = FIELD_MEMORY_BUDGET):
    """The plain PyTorch twin of ``relax``, on whatever device the tensors
    lie: the padded in-edge slots gathered in chunks ([rows, slots, F]
    within `memory_budget` bytes), one float32 add a candidate, ``amin``."""
    _check_fields(d, g, "relax_reference")
    best = d.clone()
    if g.dmax and g.active[0]:
        step = relax_chunk_slots(g.active[0], d.shape[1], memory_budget)
        for j0 in range(0, g.dmax, step):
            r = g.active[j0]
            if r == 0:
                break
            cand = d[g.idx[:r, j0:j0 + step]]
            cand.add_(g.w[:r, j0:j0 + step, None])
            best[:r] = torch.minimum(best[:r], cand.amin(1))
            del cand
    frontier = torch.where(best < d, best, torch.inf).amin(0)
    return best, frontier


def stop_test(d: torch.Tensor, frontier: torch.Tensor,
              evaluate: Optional[tuple] = None) -> torch.Tensor:
    """A sweep's stop test on its output d and frontier, as a 0-d bool
    tensor: no finite frontier value, or, with `evaluate` = (rows [E],
    fields [E]), each of those values at or below its field's frontier."""
    stop = ~torch.isfinite(frontier).any()
    if evaluate is not None:
        rows, cols = evaluate
        stop |= (d[rows, cols] <= frontier[cols]).all()
    return stop


# the delta sweep's sectors: 8 contiguous fields (32 bytes) a lane, 32
# lanes a chunk of 256 fields
SECTOR = 8
CHUNK = 32 * SECTOR


def sector_masks(marked: torch.Tensor) -> torch.Tensor:
    """[N + 1, F] bool -> the kernel's words, int32 [ceil(F / 256), N + 1]:
    bit l of row v's word in chunk c is set when any of fields
    256 c + 8 l .. 256 c + 8 l + 7 is marked."""
    rows, f = marked.shape
    chunks = -(-f // CHUNK)
    wide = torch.zeros((rows, chunks * CHUNK), dtype=torch.bool,
                       device=marked.device)
    wide[:, :f] = marked
    lanes = wide.view(rows, chunks, 32, SECTOR).any(3)
    shifts = torch.arange(32, device=marked.device)
    words = (lanes.to(torch.int64) << shifts).sum(2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.T.to(torch.int32).contiguous()


def sector_fields(words: torch.Tensor, f: int) -> torch.Tensor:
    """The inverse of ``sector_masks``: [chunks, N + 1] words -> [N + 1, F]
    bool, each field its sector's bit."""
    shifts = torch.arange(32, device=words.device)
    lanes = (words.T.to(torch.int64)[:, :, None] >> shifts) & 1
    rows = lanes.shape[0]
    return lanes.bool().repeat_interleave(SECTOR, dim=2).reshape(
        rows, -1)[:, :f]


class RelaxBatch:
    """One field batch's delta sweeps (``relax_delta``; the kernel's batch
    path, csrc/bellman_ford_relax.cu).  After `sweeps` sweeps from d_0:

    - ``d``: d_t, [N + 1, F] rows of a buffer padded to a multiple of 8
      fields (the pads +inf, never changed); ``out``: the buffer the next
      sweep writes, which holds d_{t-1} (a copy of d_0 at the start), so
      that sweep rewrites only the sectors that changed in either of the
      two sweeps;
    - ``changed``: int32 [ceil(F / 256), N + 1] words (``sector_masks``),
      the sectors the last sweep changed (d_t < d_{t-1}); at the start
      those holding a finite value, which are all that can lower a node;
      ``out_changed`` is where the next sweep writes its own;
    - ``frontier``: the last sweep's, one of two [F] buffers that alternate
      (the kernel sets the next one to +inf);
    - ``stop``: int32 [1], the last sweep's ``stop_test``; ``ticket`` the
      kernel's block counter.

    Skipping the sources that did not change lowers nothing that a full
    sweep lowers, so d', the frontier and the sweep counts are
    ``relax_reference``'s bit for bit."""

    def __init__(self, g: FieldGraph, d: torch.Tensor,
                 evaluate: Optional[tuple] = None):
        _check_fields(d, g, "RelaxBatch")
        self.g = g
        rows, f = d.shape
        dev = d.device
        bufs = torch.full((2, rows, -(-f // SECTOR) * SECTOR), torch.inf,
                          device=dev)
        bufs[:, :, :f] = d
        self.d, self.out = bufs[0, :, :f], bufs[1, :, :f]
        self.changed = sector_masks(torch.isfinite(d))
        self.out_changed = torch.empty_like(self.changed)
        frontiers = torch.full((2, f), torch.inf, device=dev)
        self.frontiers = (frontiers[0], frontiers[1])
        self.stop = torch.zeros(1, dtype=torch.int32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.evaluate = evaluate
        self.eval32 = None if evaluate is None else tuple(
            torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
            for x in evaluate)
        self.sweeps = 0

    @property
    def frontier(self) -> torch.Tensor:
        """The last sweep's frontier."""
        return self.frontiers[(self.sweeps - 1) % 2]

    def advance(self):
        """After a sweep wrote `out`, `out_changed` and the frontier."""
        self.d, self.out = self.out, self.d
        self.changed, self.out_changed = self.out_changed, self.changed
        self.sweeps += 1

    def run(self, max_iter: int) -> int:
        """Sweep (``relax_delta``) until the stop test holds or `max_iter`
        sweeps ran; returns the sweeps.  On a card each sweep's stop word
        is copied to pinned memory without blocking and read once the next
        sweep is queued, so the host never waits for the sweep it has just
        queued; the one sweep run past the stop changes no value a caller
        reads (the fields are at their fixed point, or the evaluated values
        are final)."""
        lag = self.d.is_cuda
        if lag:
            host = torch.zeros(2, dtype=torch.int32, pin_memory=True)
            slots, flags = (host[0:1], host[1:2]), host.numpy()
            posted = (torch.cuda.Event(), torch.cuda.Event())
        while self.sweeps < max_iter:
            relax_delta(self)
            if not lag:
                if bool(self.stop):
                    break
                continue
            slot = (self.sweeps - 1) % 2
            slots[slot].copy_(self.stop, non_blocking=True)
            posted[slot].record()
            if self.sweeps > 1:
                posted[1 - slot].synchronize()
                if flags[1 - slot]:
                    break
        return self.sweeps


def relax_delta(b: RelaxBatch) -> None:
    """One delta sweep of the batch `b`, in place: on a CUDA tensor the
    kernel csrc/bellman_ford_relax.cu (one launch, counted in
    ``relax.launches``, which also decides the stop test); on a CPU tensor
    the twin ``relax_delta_reference``."""
    d, g = b.d, b.g
    if d.device.type == "cpu" and g.device.type == "cpu":
        return relax_delta_reference(b)
    if d.device.type != "cuda":
        raise ValueError(f"relax_delta: no kernel for {d.device}")
    if g.csr_src.device != d.device:
        raise ValueError(f"relax_delta: the fields lie on {d.device}, the "
                         f"graph on {g.csr_src.device}")
    t = b.sweeps % 2
    rows, cols = b.eval32 if b.eval32 is not None else (None, None)
    _launch("bellman_ford_relax", d.device, d.data_ptr(),
            g.csr_src.data_ptr(), g.csr_w.data_ptr(), g.csr_off.data_ptr(),
            g.order.data_ptr(), g.n, d.shape[1], d.stride(0),
            sm_count(d.device), b.out.data_ptr(), b.frontiers[t].data_ptr(),
            b.changed.data_ptr(), b.out_changed.data_ptr(),
            b.frontiers[1 - t].data_ptr(), b.ticket.data_ptr(),
            b.stop.data_ptr(), None if rows is None else rows.data_ptr(),
            None if cols is None else cols.data_ptr(),
            0 if rows is None else rows.numel())
    relax.launches += 1
    b.advance()


def relax_delta_reference(b: RelaxBatch,
                          memory_budget: int = FIELD_MEMORY_BUDGET) -> None:
    """The plain PyTorch twin of ``relax_delta``, on whatever device the
    batch lies: ``relax_reference``'s chunks of in-edge slots over the
    fields with every sector not marked in ``b.changed`` read as +inf (a
    candidate is taken only from a marked sector); the new words mark the
    sectors where d' < d; `out` is written only in the sectors marked in
    either; the frontier and the stop word as the kernel writes them."""
    g, d = b.g, b.d
    f = d.shape[1]
    gathered = torch.where(sector_fields(b.changed, f), d, torch.inf)
    best = d.clone()
    if g.dmax and g.active[0]:
        step = relax_chunk_slots(g.active[0], f, memory_budget)
        for j0 in range(0, g.dmax, step):
            r = g.active[j0]
            if r == 0:
                break
            cand = gathered[g.idx[:r, j0:j0 + step]]
            cand.add_(g.w[:r, j0:j0 + step, None])
            best[:r] = torch.minimum(best[:r], cand.amin(1))
            del cand
    lowered = best < d
    new = sector_masks(lowered)
    write = sector_fields(b.changed | new, f)
    b.out.copy_(torch.where(write, best, b.out))
    b.out_changed.copy_(new)
    t = b.sweeps % 2
    b.frontiers[t].copy_(torch.where(lowered, best, torch.inf).amin(0))
    b.frontiers[1 - t].fill_(torch.inf)
    b.stop.copy_(stop_test(b.out, b.frontiers[t], b.evaluate).reshape(1))
    b.advance()


def converge(g: FieldGraph, d: torch.Tensor, max_iter: int,
             evaluate: Optional[tuple] = None, what: str = "fields"):
    """Relax until a sweep changes nothing or `max_iter` sweeps ran.  With
    `evaluate` = (rows [E], fields [E]), stop as soon as each of those
    values is at or below its field's frontier (they are final then).
    On a card the sweeps are a ``RelaxBatch``'s delta sweeps, one launch
    each, the stop read one sweep late (``RelaxBatch.run``); on the CPU
    full sweeps of ``relax`` (the twin), the stop read after each.
    Returns d and logs the batch with the sweeps it ran and its
    seconds."""
    t0 = time.perf_counter()
    if d.is_cuda:
        b = RelaxBatch(g, d, evaluate)
        sweeps = b.run(max_iter)
        d = b.d
    else:
        sweeps = 0
        while sweeps < max_iter:
            d, frontier = relax(d, g)
            sweeps += 1
            if bool(stop_test(d, frontier, evaluate)):
                break
    LOG.append({"what": what, "fields": int(d.shape[1]), "nodes": g.n,
                "sweeps": sweeps, "seconds": time.perf_counter() - t0})
    return d


# ---------------------------------------------------------------------------
# field reducers (sph_tpu/ops/shortest_path.py:112-216)
# ---------------------------------------------------------------------------

def _fields_component_max(g: FieldGraph, field_samples, eval_samples:
                          torch.Tensor, max_iter: int,
                          memory_budget: int = FIELD_MEMORY_BUDGET
                          ) -> torch.Tensor:
    """Converged fields reduced to per-component sample maxima: [F, C]
    max over component c's valid samples (eval_samples [C, S2], -1 pads)
    of each field, -inf where c has none."""
    d = converge(g, g.init(field_samples), max_iter, what="component_max")
    c, s2 = eval_samples.shape
    f = d.shape[1]
    out = torch.empty((c, f), device=d.device)
    step = max(1, memory_budget // (4 * max(s2, 1) * f))
    for c0 in range(0, c, step):
        ev = eval_samples[c0:c0 + step]
        v = d[g.rows(ev)]
        v = torch.where((ev >= 0)[:, :, None], v, -torch.inf)
        out[c0:c0 + step] = v.amax(1)
    return out.T


def _fields_pair_values(g: FieldGraph, field_samples, eval_ids:
                        torch.Tensor, field_of_eval: torch.Tensor,
                        max_iter: int) -> torch.Tensor:
    """[E] values D_{field_of_eval[j]}(eval_ids[j]) of the converged
    fields; the sweeps stop once every one of them is final."""
    rows = g.rows(eval_ids)
    d = converge(g, g.init(field_samples), max_iter,
                 evaluate=(rows, field_of_eval), what="pair_values")
    return d[rows, field_of_eval]


def _pair_values_batched(g: FieldGraph, srcs: np.ndarray,
                         field_pos: np.ndarray, eval_nodes: np.ndarray,
                         field_batch: int) -> np.ndarray:
    """Singleton-source SSSP values at per-pair eval nodes: srcs [S] unique
    source ids (one field each), field_pos [E] index into srcs per pair,
    eval_nodes [E] where to read that pair's field.  Returns [E] float32
    (inf where unreachable), one batch of `field_batch` fields at a time."""
    e = len(field_pos)
    out = np.full(e, np.inf, dtype=np.float32)
    dev = g.device
    for f0 in range(0, len(srcs), field_batch):
        fe = min(f0 + field_batch, len(srcs))
        sel = np.nonzero((field_pos >= f0) & (field_pos < fe))[0]
        if sel.size == 0:
            continue
        vals = _fields_pair_values(
            g, srcs[f0:fe, None],
            torch.as_tensor(eval_nodes[sel].astype(np.int64), device=dev),
            torch.as_tensor((field_pos[sel] - f0).astype(np.int64),
                            device=dev), g.n)
        out[sel] = vals.cpu().numpy()
    return out


def _fields_full(g: FieldGraph, field_samples, max_iter: int
                 ) -> torch.Tensor:
    """Converged fields, [F, N] in node order."""
    d = converge(g, g.init(field_samples), max_iter, what="full")
    return g.node_major(d)


def _fields_topk(g: FieldGraph, field_samples, max_iter: int, kk: int):
    """Converged fields reduced to their kk nearest nodes: (ids [F, kk]
    int32, dists [F, kk]), unreachable = FLOAT_MAX, ties toward the lower
    id (tie-free (distance, id) keys, as a stable ascending sort)."""
    d = converge(g, g.init(field_samples), max_iter, what="topk")
    d = g.node_major(d)
    d = torch.where(torch.isfinite(d), d, float(_FLOAT_MAX))
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    keys = torch.topk(_keys(d, cols), kk, dim=1, largest=False,
                      sorted=True).values
    ids = keys & 0xFFFFFFFF
    return ids.to(torch.int32), d.gather(1, ids)


def sssp_fields(in_idx: np.ndarray, in_w: np.ndarray,
                source_sets: np.ndarray, max_iter: int = 0,
                device=None) -> np.ndarray:
    """Multi-source SSSP distance fields over build_reverse_adjacency's
    table: source_sets [F, S] padded (-1) node-id lists -> [F, N] float32,
    unreachable nodes at +inf."""
    g = FieldGraph(in_idx, in_w, device)
    if max_iter <= 0:
        max_iter = g.n
    return _fields_full(g, np.asarray(source_sets), max_iter).cpu().numpy()


def compute_shortest_path(graph, start: int, end: int, cache=None,
                          device=None) -> float:
    """Single point-pair geodesic (reference: computeShortestPath,
    ShortestPath.cpp:100-166, with the direct-neighbour early-out).
    `cache`: a utils.distance_cache.DistanceCache bound to `graph`.
    Returns -1.0 when `end` is unreachable."""
    if cache is not None:
        return cache.query(start, end)
    idx, dist, mask = _graph_arrays(graph)
    if start == end:
        return 0.0
    row = idx[start][mask[start]]
    hit = np.nonzero(row == end)[0]
    if hit.size:
        return float(dist[start][mask[start]][hit[0]])
    in_idx, in_w = build_reverse_adjacency(idx, dist, mask)
    field = sssp_fields(in_idx, in_w, np.array([[start]], dtype=np.int64),
                        device=device)[0]
    d = float(field[end])
    return d if np.isfinite(d) else -1.0


def shortest_path_fields(graph, sources: np.ndarray, device=None
                         ) -> np.ndarray:
    """Distance fields from single-node sources [S] -> [S, N] (unreachable
    = +inf)."""
    in_idx, in_w = build_reverse_adjacency(*_graph_arrays(graph))
    return sssp_fields(in_idx, in_w, np.asarray(sources, np.int64)[:, None],
                       device=device)


# ---------------------------------------------------------------------------
# the contracted component graph (sph_tpu/ops/shortest_path.py:295-420)
# ---------------------------------------------------------------------------

def _max_samples(reps, num_samples: int) -> int:
    s = max(len(r) for r in reps)
    if num_samples and num_samples > 0:
        s = min(s, num_samples)
    return s


def _contracted_graph(hierarchy, data, level: int, num_samples: int,
                      seed: int, device) -> FieldGraph:
    """The level's components as nodes, its spatial adjacency as edges,
    weighted by the sampled euclidean Hausdorff of the two components."""
    from .similarities import hausdorff_point_set_distance, sample_represented
    adj = hierarchy.spatial_neighbors_of(level)
    c, deg = adj.shape
    src = np.repeat(np.arange(c, dtype=np.int64), deg)
    dst = adj.ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    reps = hierarchy.represented_points(level)
    max_s = _max_samples(reps, num_samples)
    rep_a = sample_represented(reps, src, max_s, seed=seed + level)
    rep_b = sample_represented(reps, dst, max_s, seed=seed + level + 1)
    w = hausdorff_point_set_distance(data, rep_a, rep_b, device=device)
    return FieldGraph(*_edge_list_reverse(c, src, dst, w), device)


def contracted_geodesics(hierarchy, data, level: int, num_samples: int = 0,
                         seed: int = 1, batch: int = 256, device=None
                         ) -> np.ndarray:
    """All-pairs geodesics over the contracted component graph: the dense
    [C, C] matrix (inf where unreachable)."""
    g = _contracted_graph(hierarchy, data, level, num_samples, seed, device)
    c = g.n
    out = np.empty((c, c), dtype=np.float32)
    for f0 in range(0, c, batch):
        fe = min(f0 + batch, c)
        out[f0:fe] = _fields_full(
            g, np.arange(f0, fe)[:, None], c).cpu().numpy()
    return out


def contracted_geodesic_knn(hierarchy, data, level: int, k: int,
                            num_samples: int = 0, seed: int = 1,
                            batch: int = 256, device=None):
    """kNN over contracted geodesics, each source batch's fields reduced
    to their top k at once (no [C, C] matrix): (ids [C, k], dists)."""
    from .graph import ensure_self_first
    g = _contracted_graph(hierarchy, data, level, num_samples, seed, device)
    c = g.n
    kk = min(k, c)
    ids = np.empty((c, kk), dtype=np.int32)
    dists = np.empty((c, kk), dtype=np.float32)
    for f0 in range(0, c, batch):
        fe = min(f0 + batch, c)
        bi, bd = _fields_topk(g, np.arange(f0, fe)[:, None], c, kk)
        ids[f0:fe] = bi.cpu().numpy()
        dists[f0:fe] = bd.cpu().numpy()
    return ensure_self_first(ids, dists)[:2]


def contracted_geodesic_pairs(hierarchy, data, level: int, a: np.ndarray,
                              b: np.ndarray, num_samples: int = 0,
                              seed: int = 1, batch: int = 256, device=None
                              ) -> np.ndarray:
    """Contracted geodesics for explicit (a, b) component pairs
    (unreachable = FLOAT_MAX)."""
    g = _contracted_graph(hierarchy, data, level, num_samples, seed, device)
    srcs = np.unique(a)
    pos = np.full(int(srcs.max()) + 1, -1, dtype=np.int64)
    pos[srcs] = np.arange(len(srcs))
    vals = _pair_values_batched(g, srcs, pos[a], np.asarray(b, np.int64),
                                batch)
    return np.where(np.isfinite(vals), vals, _FLOAT_MAX).astype(np.float32)


# ---------------------------------------------------------------------------
# the pixel-graph sketch tier (sph_tpu/ops/shortest_path.py:420-498)
# ---------------------------------------------------------------------------

_SKETCH_CACHE: dict = {}


def get_geo_sketch(graph, device=None):
    """Bounded-hop geodesic sketch of the pixel graph, cached per graph
    object; the entry pins the graph (a collected graph's id could be
    reused by a new one) and at most one sketch is kept."""
    from .geo_sketch import build_geo_sketch
    from .graph import symmetrize_graph
    dev = resolve_device(device)
    width = int(os.environ.get("SPH_GEO_SKETCH_WIDTH", "64"))
    hops = int(os.environ.get("SPH_GEO_SKETCH_HOPS", "3"))
    key = id(graph)
    hit = _SKETCH_CACHE.get(key)
    if hit is None or hit[2] != (width, hops, dev) or hit[3] is not graph:
        # meet-in-the-middle is exact only on an undirected graph:
        # symmetrize (idempotent on an already-symmetric graph)
        t = time.perf_counter()
        si, sd = build_geo_sketch(symmetrize_graph(graph, device=dev),
                                  width=width, hops=hops, device=dev)
        sd[-1, -1].item()                      # the build has finished
        LOG.append({"what": "sketch_build", "shape": list(si.shape),
                    "seconds": time.perf_counter() - t})
        _SKETCH_CACHE.clear()
        hit = (si, sd, (width, hops, dev), graph)
        _SKETCH_CACHE[key] = hit
    return hit[0], hit[1]


def sketch_geodesic_pairs(graph, hierarchy, data, level: int, a: np.ndarray,
                          b: np.ndarray, num_samples: int = 0,
                          component_labels=None, seed: int = 1,
                          device=None) -> np.ndarray:
    """Geodesic Hausdorff of component pairs through the pixel-graph
    sketch, one sample set per component (seed + level), as the exact
    path; pairs whose sketches never meet fall back to the sampled
    euclidean Hausdorff, cross-component pairs are FLOAT_MAX."""
    from .geo_sketch import sketch_hausdorff_pairs
    from .similarities import hausdorff_point_set_distance, sample_represented
    from ..utils.logging import Log
    LOG.append({"what": "call", "fn": "sketch_geodesic_pairs",
                "level": level})
    si, sd = get_geo_sketch(graph, device)
    reps = hierarchy.represented_points(level)
    max_s = _max_samples(reps, num_samples)
    comp_ids = np.unique(np.concatenate([a, b]))
    samples = sample_represented(reps, comp_ids, max_s, seed=seed + level)
    pos_of = np.full(int(comp_ids.max()) + 1, -1, dtype=np.int64)
    pos_of[comp_ids] = np.arange(len(comp_ids))
    rep_a = samples[pos_of[a]]
    rep_b = samples[pos_of[b]]
    out = sketch_hausdorff_pairs(si, sd, rep_a, rep_b)

    cross = None
    if component_labels is not None:
        first_rep = np.array([r[0] for r in reps], dtype=np.int64)
        comp_label = np.asarray(component_labels)[first_rep]
        cross = comp_label[a] != comp_label[b]
    miss = ~np.isfinite(out)
    if cross is not None:
        miss &= ~cross
    n_miss = int(miss.sum())
    LOG.append({"what": "sketch_pairs", "level": level, "pairs": len(out),
                "fallback_pairs": n_miss})
    if n_miss:
        Log.info("sketch_geodesic_pairs: %d/%d pairs without sketch meet "
                 "-> euclid-Hausdorff fallback", n_miss, len(out))
        out[miss] = hausdorff_point_set_distance(
            data, rep_a[miss], rep_b[miss], device=si.device)
    if cross is not None:
        out[cross] = _FLOAT_MAX
    out[~np.isfinite(out)] = _FLOAT_MAX
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# the two callers (sph_tpu/ops/shortest_path.py:530-718)
# ---------------------------------------------------------------------------

def geodesic_hausdorff_knn(graph, hierarchy, level: int, k: int,
                           num_samples: int = 0, seed: int = 1,
                           field_batch: int = 256, data=None, device=None):
    """Exact kNN over components under the geodesic Hausdorff metric
    (reference: GeodesicPathSpace.hpp + LevelSimilarities.cpp:211-252);
    above CONTRACT_THRESHOLD components at level > 0 the contracted-graph
    kNN.  One field per component (its sampled pixels as sources), reduced
    to H[a, b] = max(max_{p in a} D_b(p), max_{q in b} D_a(q)) on the
    device; rows sorted stably (ties to the lower id).  Returns (ids
    [C, k] int32, dists [C, k] float32), self first."""
    from .graph import ensure_self_first
    from .similarities import sample_represented
    c = hierarchy.num_components[level]
    LOG.append({"what": "call", "fn": "geodesic_hausdorff_knn",
                "level": level})
    if level > 0 and c > CONTRACT_THRESHOLD and data is not None:
        return contracted_geodesic_knn(hierarchy, data, level, k,
                                       num_samples, seed, device=device)
    g = field_graph(graph, device)
    reps = hierarchy.represented_points(level)
    assert all(len(r) >= 1 for r in reps), \
        "component with no represented pixels"
    samples = sample_represented(reps, np.arange(c),
                                 _max_samples(reps, num_samples),
                                 seed=seed + level)
    eval_d = torch.as_tensor(samples, device=g.device)
    term = torch.empty((c, c), device=g.device)
    for f0 in range(0, c, field_batch):
        fe = min(f0 + field_batch, c)
        m = _fields_component_max(g, samples[f0:fe], eval_d, g.n)
        term[:, f0:fe] = m.T                      # max over p in a
    term = torch.where(torch.isneginf(term), torch.inf, term)
    h = torch.maximum(term, term.T)
    h.fill_diagonal_(0.0)
    h = torch.where(torch.isfinite(h), h, float(_FLOAT_MAX))
    kk = min(k, c)
    cols = torch.arange(c, device=h.device)[None, :]
    keys = torch.topk(_keys(h, cols), kk, dim=1, largest=False,
                      sorted=True).values
    sel = keys & 0xFFFFFFFF
    dists = h.gather(1, sel)
    ids, dists, _ = ensure_self_first(sel.to(torch.int32).cpu().numpy(),
                                      dists.cpu().numpy())
    return ids, dists


def level0_pairs(idx, dist, mask, a: np.ndarray, b: np.ndarray):
    """Level-0 pairs (a[e], b[e]) over the kNN rows.  Returns (values [E]
    float32: the direct kNN edge's max where both directions have one,
    else FLOAT_MAX; todo: the unresolved pairs; srcs: their unique nodes,
    one field each; field_pos [2T], eval_nodes [2T]: the field each lookup
    reads, as an index into srcs, and where, b in a's field, then a in
    b's)."""
    def direct_lookup(src, dst):
        rows_i = idx[src]
        rows_d = np.where(mask[src], dist[src], np.inf)
        hit = rows_i == dst[:, None]
        has = hit.any(axis=1) & mask[src].any(axis=1)
        return np.where(has, np.where(hit, rows_d, np.inf).min(axis=1),
                        np.inf)

    d_ab = direct_lookup(a, b)
    d_ba = direct_lookup(b, a)
    resolved = np.isfinite(d_ab) & np.isfinite(d_ba)
    vals = np.full(len(a), _FLOAT_MAX, dtype=np.float32)
    vals[resolved] = np.maximum(d_ab, d_ba)[resolved].astype(np.float32)
    todo = np.nonzero(~resolved)[0]
    srcs = np.unique(np.concatenate([a[todo], b[todo]]))
    src_pos = np.full(int(srcs.max()) + 1 if srcs.size else 0, -1,
                      dtype=np.int64)
    src_pos[srcs] = np.arange(len(srcs))
    field_pos = np.concatenate([src_pos[a[todo]], src_pos[b[todo]]])
    eval_nodes = np.concatenate([b[todo], a[todo]])
    return vals, todo, srcs, field_pos, eval_nodes


def geodesic_component_distances(graph, data, hierarchy, level: int,
                                 a: np.ndarray, b: np.ndarray,
                                 num_samples: int = 0,
                                 component_labels: Optional[np.ndarray]
                                 = None, seed: int = 1,
                                 field_batch: int = 256, device=None
                                 ) -> np.ndarray:
    """Geodesic component distances for edge pairs (a[e], b[e]) at `level`
    (reference: Similarities.cpp geodesicDistance).  Level 0: the direct
    kNN edge where both directions have one, else the larger of the two
    point-to-point geodesics.  Higher levels: the symmetric Hausdorff of
    the sampled represented pixels' geodesics.  Cross-component pairs (kNN
    weak-CC labels) and unreachable pairs are FLOAT_MAX."""
    from .similarities import sample_represented
    LOG.append({"what": "call", "fn": "geodesic_component_distances",
                "level": level})
    idx, dist, mask = _graph_arrays(graph)
    g = field_graph(graph, device)
    dev = g.device
    e = len(a)
    out = np.full(e, _FLOAT_MAX, dtype=np.float32)

    if level == 0:
        out, todo, srcs, field_pos, eval_nodes = level0_pairs(
            idx, dist, mask, a, b)
        LOG.append({"what": "level0_pairs", "pairs": e,
                    "unresolved_pairs": int(todo.size),
                    "unique_sources": int(srcs.size)})
        if todo.size:
            vals = _pair_values_batched(g, srcs, field_pos, eval_nodes,
                                        field_batch)
            haus0 = np.maximum(vals[:todo.size], vals[todo.size:])
            ok = np.isfinite(haus0)
            out[todo[ok]] = haus0[ok]
        if component_labels is not None:
            labels = np.asarray(component_labels)
            out[labels[a] != labels[b]] = _FLOAT_MAX
        return out

    reps = hierarchy.represented_points(level)
    comp_ids = np.unique(np.concatenate([a, b]))
    samples = sample_represented(reps, comp_ids,
                                 _max_samples(reps, num_samples),
                                 seed=seed + level)
    num_fields = len(comp_ids)
    pos_of = np.full(int(comp_ids.max()) + 1, -1, dtype=np.int64)
    pos_of[comp_ids] = np.arange(num_fields)
    a_pos = torch.as_tensor(pos_of[a], device=dev)
    b_pos = torch.as_tensor(pos_of[b], device=dev)
    eval_d = torch.as_tensor(samples, device=dev)
    # max over a's samples of b's field, and the other way round
    max_b_at_a = torch.full((e,), -torch.inf, device=dev)
    max_a_at_b = torch.full((e,), -torch.inf, device=dev)
    for f0 in range(0, num_fields, field_batch):
        fe = min(f0 + field_batch, num_fields)
        m = _fields_component_max(g, samples[f0:fe], eval_d, g.n)  # [F, C]
        sel = (b_pos >= f0) & (b_pos < fe)
        max_b_at_a[sel] = torch.maximum(max_b_at_a[sel],
                                        m[b_pos[sel] - f0, a_pos[sel]])
        sel = (a_pos >= f0) & (a_pos < fe)
        max_a_at_b[sel] = torch.maximum(max_a_at_b[sel],
                                        m[a_pos[sel] - f0, b_pos[sel]])
    haus = torch.maximum(max_b_at_a, max_a_at_b).cpu().numpy()
    reachable = np.isfinite(haus)
    out[reachable] = haus[reachable]
    if component_labels is not None:
        first_rep = np.array([r[0] for r in reps], dtype=np.int64)
        comp_label = np.asarray(component_labels)[first_rep]
        out[comp_label[a] != comp_label[b]] = _FLOAT_MAX
    return out
