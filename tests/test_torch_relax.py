"""The Bellman-Ford relax: the layout csrc/bellman_ford_relax.cu reads and
its wrapper.

On the CPU: FieldGraph's CSR holds exactly the live in-edge slots, in slot
order; a plain torch sweep over that CSR (what the kernel computes, its
frontier taken as a minimum of the values' bits, as the kernel's atomics
take it) is bit-equal to the twin ``relax_reference`` on hub rows, zero
weights, unreachable nodes and a node with no in-edges, at F = 1, 3, 4 and
256; the wrapper takes the twin for CPU tensors and counts no launch, and
raises on a wrong shape, type or device; ``converge`` through the wrapper,
and through the CSR sweep in the wrapper's place, gives the JAX package's
fields (``sssp_fields``, its ``_bellman_ford``) bit for bit, in the twin's
sweeps.  The delta sweep: the sector words round-trip; its twin
``relax_delta_reference`` equals ``relax_reference`` sweep by sweep (d',
the frontier, the words marking exactly the sectors where d' < d, the stop
word, the sweeps) at F = 1, 3, 8, 37, 256 and 300, from sources and from a
batch stopped by evaluated values; ``RelaxBatch.run`` gives ``converge``'s
values and sweeps.  On the card (marked ``cuda``) the kernel against the
twins, bit for bit, stateless and in batches."""

import numpy as np
import pytest
import torch

from sph_tpu.ops import shortest_path as jsp
from sph_tpu_torch.ops import shortest_path as tsp
from test_torch_reference_native import use_reference_native

use_reference_native()

INF = float("inf")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def edge_graph(n=420, hub_in=300, seed=0, zero_share=0.15):
    """(in_idx, in_w) of a directed graph made to stress the relax: node 0
    a hub with `hub_in` in-edges, a share of zero weights, two node blocks
    with no edge between them (unreachable from each other), node n - 1
    with out-edges but no in-edge, node n - 2 with no edge at all, and
    duplicate (u, v) edges of other weights."""
    rng = np.random.default_rng(seed)
    half = (n - 2) // 2
    block = np.where(np.arange(n) < half, 0, 1)
    src, dst = [], []
    for v in range(n - 2):
        pool = np.nonzero((block == block[v]) & (np.arange(n) < n - 2)
                          & (np.arange(n) != v))[0]
        m = int(rng.integers(1, 9))
        src += list(rng.choice(pool, m, replace=False))
        dst += [v] * m
    hubs = rng.choice(np.arange(1, half), min(hub_in, half - 1),
                      replace=False)
    src += list(hubs)
    dst += [0] * len(hubs)
    src += [n - 1] * 4
    dst += list(rng.choice(half, 4, replace=False))
    src += src[:20]                               # duplicates, new weights
    dst += dst[:20]
    src, dst = np.asarray(src), np.asarray(dst)
    w = rng.random(len(src)).astype(np.float32) * 3
    w[rng.random(len(src)) < zero_share] = 0.0
    return tsp._pack_in_edges(n, src, dst, w)


GRAPHS = {"hubs": lambda: edge_graph(),
          "ties": lambda: edge_graph(n=200, hub_in=150, seed=3,
                                     zero_share=0.4)}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def tables(request):
    return GRAPHS[request.param]()


def sources(n, f, s, seed):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, n, (f, s))
    out[rng.random((f, s)) < 0.3] = -1
    out[:, 0] = rng.integers(0, n, f)
    return out


def csr_sweep(d, g):
    """One sweep over the CSR, as the kernel computes it: each live
    in-edge's candidate d[u] + w, the least per row with the node's own
    value, and the frontier as the least lowered value's bits."""
    counts = g.csr_off[1:] - g.csr_off[:-1]
    rows = torch.repeat_interleave(torch.arange(g.n), counts)
    cand = d[g.csr_src.long()] + g.csr_w[:, None]
    best = d.clone()
    best[:g.n] = best[:g.n].scatter_reduce(
        0, rows[:, None].expand_as(cand), cand, "amin", include_self=True)
    lowered = torch.where(best < d, best, INF)
    frontier = lowered.view(torch.int32).amin(0).view(torch.float32)
    return best, frontier


def bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_csr_holds_the_live_slots_in_slot_order(tables):
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    assert g.csr_src.dtype == torch.int32 and g.csr_w.dtype == torch.float32
    assert g.csr_off.dtype == torch.int64 and g.csr_off.shape == (g.n + 1,)
    live = g.idx != g.n
    assert int(g.csr_off[-1]) == int(live.sum()) == int((in_idx >= 0).sum())
    for r in range(g.n):
        lo, hi = int(g.csr_off[r]), int(g.csr_off[r + 1])
        assert torch.equal(g.csr_src[lo:hi].long(), g.idx[r][live[r]])
        assert torch.equal(g.csr_w[lo:hi], g.w[r][live[r]])
    # the hub's row is first (rank order), with every in-edge
    assert int(g.csr_off[1]) == int((in_idx[0] >= 0).sum()) >= 100
    # the kernel's node order: a permutation of the rows
    assert g.order.dtype == torch.int32
    assert torch.equal(torch.sort(g.order.long()).values, torch.arange(g.n))


def test_batch_rows_are_padded_to_whole_sectors(tables):
    """A RelaxBatch keeps its fields in rows padded to a multiple of 8
    (+inf pads, which no sweep changes), both buffers a copy of the start,
    apart from the caller's tensor."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, 37, 2, seed=3))
    b = tsp.RelaxBatch(g, d)
    assert b.d.shape == d.shape and b.d.stride(0) == 40
    assert b.out.stride(0) == 40 and bits_equal(b.out, d)
    assert torch.equal(b.d, d) and b.d.data_ptr() != d.data_ptr()
    assert b.changed.shape == (1, g.n + 1)
    for _ in range(3):
        tsp.relax_delta(b)
        for buf in (b.d, b.out):
            pads = buf.as_strided((g.n + 1, 3), (40, 1), buf.storage_offset()
                                  + 37)
            assert torch.isinf(pads).all()


@pytest.mark.parametrize("f", [1, 3, 4, 256])
def test_csr_sweep_equals_reference(tables, f):
    """Eight sweeps from padded multi-source sets, each bit-equal (d' and
    the frontier) to the twin's, in chunks of one slot and of all."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, f, 3, seed=f))
    lowered_any = False
    for _ in range(8):
        want, want_front = tsp.relax_reference(d, g)
        small, small_front = tsp.relax_reference(d, g, memory_budget=1)
        got, front = csr_sweep(d, g)
        assert bits_equal(got, want) and bits_equal(front, want_front)
        assert bits_equal(small, want) and bits_equal(small_front,
                                                      want_front)
        assert torch.isinf(got[g.n]).all()
        lowered_any |= bool(torch.isfinite(front).any())
        d = got
    assert lowered_any
    # unreachable nodes and the node without in-edges stay +inf
    assert torch.isinf(d).any()


def test_field_graph_is_kept_for_the_last_graph():
    """field_graph builds a graph's table once for repeated calls with the
    same graph object and device, and anew for another graph; the table
    equals a fresh build."""
    from sph_tpu_torch.ops.graph import KnnGraph
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 50, (50, 6)).astype(np.int32)
    dist = rng.random((50, 6)).astype(np.float32)
    a, b = KnnGraph(idx, dist), KnnGraph(idx.copy(), dist.copy())
    first = tsp.field_graph(a, "cpu")
    assert tsp.field_graph(a, "cpu") is first
    other = tsp.field_graph(b, "cpu")
    assert other is not first and tsp.field_graph(b, "cpu") is other
    fresh = tsp.FieldGraph.from_graph(b, "cpu")
    for name in ("idx", "w", "rank", "csr_src", "csr_w", "csr_off", "order"):
        assert torch.equal(getattr(other, name), getattr(fresh, name))


def test_cpu_wrapper_takes_the_twin_and_counts_no_launch(tables):
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, 5, 2, seed=1))
    before = tsp.relax.launches
    got, front = tsp.relax(d, g)
    want, want_front = tsp.relax_reference(d, g)
    assert tsp.relax.launches == before
    assert bits_equal(got, want) and bits_equal(front, want_front)
    assert got.data_ptr() != d.data_ptr()


def test_wrapper_raises_on_wrong_inputs():
    in_idx, in_w = edge_graph(n=60, hub_in=20)
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, 4, 2, seed=2))
    with pytest.raises(ValueError, match="fields must be"):
        tsp.relax(d[:-1], g)
    with pytest.raises(ValueError, match="fields must be"):
        tsp.relax(d[:, 0], g)
    with pytest.raises(TypeError, match="float32"):
        tsp.relax(d.double(), g)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tsp.relax(torch.empty(d.shape, device="meta"), g)


@pytest.mark.parametrize("max_iter", [0, 3])
def test_converge_equals_jax_sssp_fields(tables, max_iter, monkeypatch):
    """sssp_fields through the wrapper, and with the CSR sweep in the
    wrapper's place, against the JAX package's sssp_fields (its
    _bellman_ford): the fields bit-equal, the sweeps the twin's."""
    in_idx, in_w = tables
    n = in_idx.shape[0]
    src = sources(n, 9, 3, seed=7 + max_iter)
    want = jsp.sssp_fields(in_idx, in_w, src, max_iter)
    tsp.LOG.clear()
    got = tsp.sssp_fields(in_idx, in_w, src, max_iter, device="cpu")
    twin_sweeps = tsp.LOG[-1]["sweeps"]
    monkeypatch.setattr(tsp, "relax", lambda d, g, memory_budget=0:
                        csr_sweep(d, g))
    via_csr = tsp.sssp_fields(in_idx, in_w, src, max_iter, device="cpu")
    assert np.array_equal(got, want) and np.array_equal(via_csr, want)
    assert tsp.LOG[-1]["sweeps"] == twin_sweeps
    assert twin_sweeps == max_iter if max_iter else twin_sweeps > 1


def test_pair_values_stop_at_the_twins_sweep(tables, monkeypatch):
    """The pair values' early stop (each value at or below its field's
    frontier) takes the same sweeps through the CSR sweep as through the
    twin, and the values are equal."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    rng = np.random.default_rng(5)
    srcs = np.unique(rng.integers(0, g.n, 40))
    pos = rng.integers(0, len(srcs), 300)
    nodes = rng.integers(0, g.n, 300)
    tsp.LOG.clear()
    want = tsp._pair_values_batched(g, srcs, pos, nodes, 16)
    twin = [e["sweeps"] for e in tsp.LOG]
    monkeypatch.setattr(tsp, "relax", lambda d, g, memory_budget=0:
                        csr_sweep(d, g))
    tsp.LOG.clear()
    got = tsp._pair_values_batched(g, srcs, pos, nodes, 16)
    assert np.array_equal(got, want)
    assert [e["sweeps"] for e in tsp.LOG] == twin and len(twin) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 4, 37, 256, 300])
def test_cuda_kernel_bit_equal_to_twin(f, monkeypatch):
    """The kernel against the twin on the card: d' and the frontier bit for
    bit over eight sweeps (vector rows where F % 4 == 0, scalar ones else
    and on a row start that is not 16-byte aligned), one launch each; and
    converge's fields and sweeps on the card through the kernel and
    through the twin, and the fields on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    in_idx, in_w = edge_graph()
    g = tsp.FieldGraph(in_idx, in_w, "cuda")
    d = g.init(sources(g.n, f, 3, seed=f))
    for aligned in (True, False):
        cur = d
        if not aligned:
            base = torch.empty(d.numel() + 1, device="cuda")
            cur = base[1:].view(d.shape)
            cur.copy_(d)
        for _ in range(8):
            before = tsp.relax.launches
            got, front = tsp.relax(cur, g)
            want, want_front = tsp.relax_reference(cur, g)
            torch.cuda.synchronize()
            assert tsp.relax.launches == before + 1
            assert bits_equal(got, want) and bits_equal(front, want_front)
            cur = got
    src = sources(g.n, f, 3, seed=11)
    before = tsp.relax.launches
    got = tsp.sssp_fields(in_idx, in_w, src, device="cuda")
    sweeps = tsp.LOG[-1]["sweeps"]
    assert tsp.relax.launches == before + sweeps
    with monkeypatch.context() as mp:
        mp.setattr(tsp, "relax_delta", tsp.relax_delta_reference)
        twin = tsp.sssp_fields(in_idx, in_w, src, device="cuda")
    assert np.array_equal(got, twin) and tsp.LOG[-1]["sweeps"] == sweeps
    assert np.array_equal(got, tsp.sssp_fields(in_idx, in_w, src,
                                               device="cpu"))


# one in-edge slot a gather in the twins (the hub row makes the padded
# table wide; its prefixes are short)
SLOT_BUDGET = 1


def lockstep(g, d, evaluate=None, max_iter=10_000, sweep=None, b=None):
    """Delta sweeps of a RelaxBatch `b` (default one from a copy of d) by
    ``sweep`` (default the twin) beside full twin sweeps from d, each sweep
    compared bit for bit (d', frontier, stop word; the words against the
    sectors where d' < d) until the stop test holds; returns the sweeps."""
    sweep = sweep or (lambda b: tsp.relax_delta_reference(b, SLOT_BUDGET))
    b = b or tsp.RelaxBatch(g, d.clone(), evaluate)
    for t in range(max_iter):
        want, want_front = tsp.relax_reference(d, g, SLOT_BUDGET)
        sweep(b)
        assert b.sweeps == t + 1
        assert bits_equal(b.d, want) and bits_equal(b.frontier, want_front)
        assert torch.equal(b.changed, tsp.sector_masks(want < d))
        stop = bool(tsp.stop_test(want, want_front, evaluate))
        assert bool(b.stop) == stop
        d = want
        if stop:
            return t + 1
    return max_iter


def test_sector_words_round_trip():
    """A field's sector bit: fields 256 c + 8 l .. + 7 set bit l of chunk
    c's word, bit 31 included (a negative int32); the inverse gives each
    field its sector's bit."""
    marked = torch.zeros((3, 300), dtype=torch.bool)
    marked[0, 0] = marked[0, 255] = marked[1, 263] = marked[2, 299] = True
    words = tsp.sector_masks(marked)
    assert words.dtype == torch.int32 and words.shape == (2, 3)
    assert words.tolist() == [[1 | -(1 << 31), 0, 0], [0, 1, 1 << 5]]
    back = tsp.sector_fields(words, 300)
    sectors = marked[:, list(range(300)) + [299] * 4].view(3, 38, 8).any(2)
    assert torch.equal(back, sectors.repeat_interleave(8, 1)[:, :300])


@pytest.mark.parametrize("f", [1, 3, 8, 37, 256, 300])
def test_delta_reference_equals_reference_sweep_by_sweep(tables, f):
    """relax_delta_reference against relax_reference from padded source
    sets until the fields stop changing: every sweep equal, the same
    sweeps; RelaxBatch.run stops at that sweep, and the wrapper takes the
    twin on the CPU and counts no launch."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, f, 3, seed=f))
    sweeps = lockstep(g, d)
    assert sweeps > 2
    before = tsp.relax.launches
    b = tsp.RelaxBatch(g, d.clone())
    assert b.run(g.n) == sweeps and tsp.relax.launches == before
    tsp.LOG.clear()
    assert bits_equal(b.d, tsp.converge(g, d, g.n))
    assert tsp.LOG[-1]["sweeps"] == sweeps and torch.isinf(b.d[g.n]).all()


def test_delta_reference_on_a_relaxed_start_and_evaluated_values(tables):
    """From fields already relaxed 3 sweeps (the first words mark every
    finite sector), and a batch stopped by evaluated values (pads read the
    sentinel row): each sweep equal to the full twin's, and RelaxBatch.run
    gives converge's values and sweeps."""
    in_idx, in_w = tables
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, 40, 2, seed=4))
    for _ in range(3):
        d, _ = tsp.relax_reference(d, g)
    lockstep(g, d)
    rng = np.random.default_rng(9)
    nodes = torch.as_tensor(rng.integers(-1, g.n, 120))
    evaluate = (g.rows(nodes), torch.as_tensor(rng.integers(0, 40, 120)))
    start = g.init(sources(g.n, 40, 1, seed=5))
    sweeps = lockstep(g, start, evaluate)
    tsp.LOG.clear()
    want = tsp.converge(g, start.clone(), g.n, evaluate=evaluate)
    assert tsp.LOG[-1]["sweeps"] == sweeps
    b = tsp.RelaxBatch(g, start.clone(), evaluate)
    assert b.run(g.n) == sweeps and bits_equal(b.d, want)
    assert lockstep(g, start, evaluate, max_iter=2) == 2


def test_delta_wrapper_raises_on_wrong_inputs():
    in_idx, in_w = edge_graph(n=60, hub_in=20)
    g = tsp.FieldGraph(in_idx, in_w, "cpu")
    d = g.init(sources(g.n, 4, 2, seed=2))
    with pytest.raises(ValueError, match="fields must be"):
        tsp.RelaxBatch(g, d[:-1])
    with pytest.raises(TypeError, match="float32"):
        tsp.RelaxBatch(g, d.double())
    b = tsp.RelaxBatch(g, d)
    b.d = torch.empty(d.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        tsp.relax_delta(b)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 8, 37, 256, 300])
def test_cuda_delta_kernel_against_both_twins(f):
    """The kernel's batch path on the card, sweep by sweep against the
    full twin and the delta twin (d', the frontier, the stop word decided
    in the kernel, the words), one launch a sweep, until the stop; from a
    row start that is not 16-byte aligned too (the scalar loads on the
    sweeps that read it); and a batch stopped by evaluated values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    in_idx, in_w = edge_graph()
    g = tsp.FieldGraph(in_idx, in_w, "cuda")
    d = g.init(sources(g.n, f, 3, seed=f))
    base = torch.empty(d.numel() + 1, device="cuda")
    unaligned = base[1:].view(d.shape)
    unaligned.copy_(d)
    rng = np.random.default_rng(f)
    nodes = torch.as_tensor(rng.integers(-1, g.n, 200), device="cuda")
    evaluate = (g.rows(nodes),
                torch.as_tensor(rng.integers(0, f, 200), device="cuda"))
    for start, ev in ((d, None), (unaligned, None), (d, evaluate)):
        twin = tsp.RelaxBatch(g, start.clone(), ev)
        # the batch owns its start: the unaligned view stays unaligned
        kernel = tsp.RelaxBatch(g, start if start is unaligned
                                else start.clone(), ev)

        def both(b):
            before = tsp.relax.launches
            tsp.relax_delta(b)
            tsp.relax_delta_reference(twin)
            torch.cuda.synchronize()
            assert tsp.relax.launches == before + 1
            assert bits_equal(b.d, twin.d)
            assert bits_equal(b.frontier, twin.frontier)
            assert torch.equal(b.changed, twin.changed)
            assert bool(b.stop) == bool(twin.stop)

        assert lockstep(g, d.clone(), ev, sweep=both, b=kernel) > 1


def test_kernel_source_and_build_registry():
    """The source names what it replaces and what bounds it; the build
    registry holds it beside the t-SNE kernels (one nvcc each, all of
    them when none is named), its library named by its content."""
    import os
    from sph_tpu_torch.ops import cuda_build, tsne_kernels
    with open(cuda_build.source("bellman_ford_relax")) as f:
        src = f.read()
    assert "sph_tpu/ops/shortest_path.py::_bellman_ford" in src
    assert "Replaces no TPU kernel" in src and "bound" in src
    assert 'extern "C" int bellman_ford_relax_launch' in src
    assert "delta sweep" in src and "ticket" in src
    assert "use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    assert cuda_build.ALL_KERNELS == (*tsne_kernels.KERNELS,
                                      "bellman_ford_relax", "walk_row_sort",
                                      "merge_runs")
    assert tsne_kernels.build is cuda_build.build
    assert os.path.basename(cuda_build.library_path(
        "bellman_ford_relax")).startswith("libbellman_ford_relax_")
