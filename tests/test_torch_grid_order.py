"""The grid deposit's passes.

``csrc/grid_deposit.cu`` orders the points by base cell with a counting
sort of its own (two stable LSD radix passes over 2048-point tiles, the
cells' starts from a scan of their counts), sums a dense cell's pieces
over many threads and folds them, and stages each node tile's covering
cells in shared memory.  Here it is transcribed into numpy as written
(float32, one rounded operation a step, the kernel's loops and lanes) and
held against the twin of ``ops/tsne_grid.py``: the order index for index
against ``torch.sort(stable=True)``, the charges bit for bit.  On the card (``cuda``) the kernels against the
twins and against ``torch.sort``.  No JAX here: the twins are held against
the JAX package in tests/test_torch_grid_kernels.py.
"""

import numpy as np
import pytest
import torch

from sph_tpu_torch.ops import tsne_grid as tgrid

F32 = np.float32
SIXTH = F32(tgrid._SIXTH)
TILE = tgrid._ORDER_TILE          # points (or cells) a tile of the passes
WARP_POINTS = TILE // 8           # a warp's points of a tile, 8 rounds of 32
PIECE = tgrid._PIECE


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def layout(kind: str, n: int, seed: int) -> np.ndarray:
    """n points [n, 2] float32 made from a seed.  "crowded": 300 points
    within 1e-3 of one spot and one far out alone; "line": every point at
    one x (the box degenerate along x); "one_cell": every point within 3
    ulps of one spot (one base cell); "own_cells": a jittered lattice of
    spacing 1.5, at most one point a base cell on the 16 grid; "spread":
    uniform in a square; "mixture": 16 Gaussian clusters."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, 2)).astype(F32) * 5
    if kind == "crowded":
        y[:300] = y[300] + 1e-3 * rng.standard_normal((300, 2)).astype(F32)
        y[n - 1] = y[:n - 1].max(0) + 7.0
    elif kind == "line":
        y[:, 0] = F32(1.25)
    elif kind == "one_cell":
        base = np.full((n, 2), F32(0.75))
        y = np.nextafter(base, F32(2), dtype=F32)
        y[rng.integers(0, 2, (n, 2)).astype(bool)] = F32(0.75)
    elif kind == "own_cells":
        side = int(np.ceil(np.sqrt(n)))
        grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
        y = (grid.reshape(-1, 2)[:n] * 1.5
             + rng.uniform(-0.1, 0.1, (n, 2))).astype(F32)
    elif kind == "spread":
        y = rng.uniform(-1, 1, (n, 2)).astype(F32)
    elif kind == "mixture":
        c = rng.uniform(-30, 30, (16, 2))
        y = (c[rng.integers(0, 16, n)]
             + rng.standard_normal((n, 2)) * 2.5).astype(F32)
    return np.ascontiguousarray(y)


def box(y: np.ndarray, grid: int):
    lo, h = tgrid.grid_box(torch.from_numpy(y), y.shape[0], grid)
    return lo.numpy(), h.numpy()


# ---------------------------------------------------------------------------
# the kernels' arithmetic, transcribed
# ---------------------------------------------------------------------------

def coord(y, lo, h):
    """(y - lo) / h + 3, each step rounded (csrc: coord)."""
    return (y - lo) / h + F32(3)


def cardinal(s):
    inner = ((s + F32(1)) * (s - F32(1))) * (s - F32(2)) * F32(0.5)
    outer = ((-(s - F32(1))) * (s - F32(2))) * (s - F32(3)) * SIXTH
    return np.where(s < 1, inner, np.where(s < 2, outer, F32(0))).astype(F32)


def weights(t):
    """[c, 4] weights of the nodes floor(t) - 1 .. floor(t) + 2."""
    first = np.floor(t) - F32(1)
    return np.stack([cardinal(np.abs(t - (first + F32(j))))
                     for j in range(4)], 1)


def keys_of(y, lo, h, grid):
    """bin_points: each point's base cell u0 * G + v0, clamped on the
    grid."""
    first = [np.clip((np.floor(coord(y[:, a], lo[a], h[a])) - F32(1))
                     .astype(np.int64), 0, grid - 1) for a in range(2)]
    return (first[1] * grid + first[0]).astype(np.int64)


def radix_pass(keys, idx, shift, bits, base):
    """One order pass as written: each 2048-key tile split among 8 warps of
    256 keys, each warp ranking its keys round by round (32 lanes a round:
    a lane's rank is the digit's count in the warp before the round plus
    the lanes below it with the same digit), the warps' counts scanned a
    digit at a time, and each tile's digit offset the sum of the tiles
    before it (the look-back).  Returns the keys and indices in the pass's
    output order."""
    n, bins = keys.shape[0], 1 << bits
    digit = (keys >> shift) & (bins - 1)
    before_tiles = np.zeros(bins, np.int64)
    out_keys = np.full(n, -1, np.int64)
    out_idx = np.full(n, -1, np.int64)
    for t0 in range(0, n, TILE):
        warp_hist = np.zeros((8, bins), np.int64)
        ranks = []
        for w in range(8):
            for r in range(8):
                j = t0 + w * WARP_POINTS + r * 32 + np.arange(32)
                j = j[j < n]
                d = digit[j]
                same = d[:, None] == d[None, :]
                below = np.tril(same, -1).sum(1)
                ranks.append((j, w, warp_hist[w, d] + below))
                np.add.at(warp_hist[w], d, 1)
        offsets = np.cumsum(warp_hist, 0) - warp_hist        # warps before
        for j, w, rank in ranks:
            d = digit[j]
            pos = base[d] + before_tiles[d] + offsets[w, d] + rank
            out_keys[pos] = keys[j]
            out_idx[pos] = idx[j]
        before_tiles += warp_hist.sum(0)
    assert (out_idx >= 0).all()
    return out_keys, out_idx


def kernel_order(keys, grid):
    """bin_points and the two order passes: the counts and their scan
    (start [G^2 + 1]), the low digits' histogram and its scan, pass 1 by
    the low digit, pass 2 by the high digit (its buckets' starts read from
    start).  Returns (order, start)."""
    cells = grid * grid
    bits = max(cells - 1, 1).bit_length()
    low, high = bits // 2, bits - bits // 2
    counts = np.bincount(keys, minlength=cells)
    start = np.concatenate([[0], np.cumsum(counts)])
    low_hist = np.bincount(keys & ((1 << low) - 1), minlength=1 << low)
    base1 = np.cumsum(low_hist) - low_hist
    k1, i1 = radix_pass(keys, np.arange(keys.shape[0]), 0, low, base1)
    base2 = start[np.minimum(np.arange(1 << high) << low, cells)]
    _, order = radix_pass(k1, i1, low, high, base2)
    return order, start


def piece_sums(ys, bounds, lo, h):
    """sum_points for many pieces at once, [pieces, 48] laid out (q, du,
    dv): each tap adds wy[du] * (q * wx[dv]) point by point from 0
    (add_point).  Each step adds the k-th point of every piece that has
    one, so each piece's sums run in its points' order."""
    acc = np.zeros((len(bounds), 3, 4, 4), F32)
    b = np.array([p[0] for p in bounds], np.int64)
    e = np.array([p[1] for p in bounds], np.int64)
    for k in range(int((e - b).max(initial=0))):
        live = b + k < e
        p = ys[b[live] + k]
        wx = weights(coord(p[:, 0], lo[0], h[0]))
        wy = weights(coord(p[:, 1], lo[1], h[1]))
        rec = np.stack([wx, p[:, 0:1] * wx, p[:, 1:2] * wx], 1)   # [c, q, dv]
        acc[live] = acc[live] + wy[:, None, :, None] * rec[:, :, None, :]
    return acc.reshape(len(bounds), 48)


def kernel_deposit(y, lo, h, grid, dense, seed=0):
    """csrc/grid_deposit.cu's launches as written: the order; the dense
    cells (more than `dense` points) listed in a shuffled order, as the
    warps' atomics may place them, a table row for each of their pieces
    (piece_sums); each cell of more than _INLINE_FOLD pieces folded in
    order from 0 into its first row (fold_cells); then each cell staged
    (node_sums): a sparse one's pieces summed and added from 0, a dense
    one's rows added from 0 (a large one's first row), and 16 adds a node.
    Returns (charges [3, G, G], order)."""
    keys = keys_of(y, lo, h, grid)
    order, start = kernel_order(keys, grid)
    ys = y[order]
    cells = grid * grid
    count = start[1:] - start[:-1]
    pieces = -(-count // PIECE)
    dense_cells = np.random.default_rng(seed).permutation(
        np.nonzero(count > dense)[0])
    assert len(dense_cells) <= tgrid.dense_cells_bound(len(y), grid, dense)
    rows, first = [], {}
    for c in dense_cells:                        # the dense list and rows
        first[c] = len(rows)
        rows += [(start[c] + p, min(start[c] + p + PIECE, start[c + 1]))
                 for p in range(0, count[c], PIECE)]
    assert len(rows) <= tgrid.deposit_rows(len(y), grid, dense)
    table = piece_sums(ys, rows, lo, h)           # piece_sums
    large = [c for c in dense_cells if pieces[c] > tgrid._INLINE_FOLD]
    assert len(large) <= tgrid.large_cells_bound(len(y))
    for c in large:                              # fold_cells
        acc = np.zeros(48, F32)
        for r in range(first[c], first[c] + pieces[c]):
            acc = acc + table[r]
        table[first[c]] = acc
    stage = np.zeros((cells, 48), F32)
    for c in dense_cells:                        # node_sums: dense cells
        for r in range(first[c], first[c] + (
                1 if pieces[c] > tgrid._INLINE_FOLD else pieces[c])):
            stage[c] = stage[c] + table[r]
    sparse = np.nonzero((count <= dense) & (count > 0))[0]
    bounds = [(s, min(s + PIECE, start[c + 1]))  # node_sums: sparse cells
              for c in sparse for s in range(start[c], start[c + 1], PIECE)]
    part = piece_sums(ys, bounds, lo, h)
    first_piece = np.cumsum(pieces[sparse]) - pieces[sparse]
    for k in range(int(pieces[sparse].max(initial=0))):
        # each sparse cell's k-th piece, added in turn from 0
        live = pieces[sparse] > k
        stage[sparse[live]] = stage[sparse[live]] + part[first_piece[live]
                                                         + k]
    taps = stage.T.reshape(3, 4, 4, grid, grid)
    out = np.zeros((3, grid, grid), F32)
    for du in range(4):                          # each node, (du, dv) order
        for dv in range(4):
            out[:, du:, dv:] = out[:, du:, dv:] + taps[:, du, dv,
                                                        :grid - du,
                                                        :grid - dv]
    return out, order


def torch_order(y, lo, h, grid):
    keys = tgrid.base_cells(tgrid.grid_coords(torch.from_numpy(y),
                                              torch.from_numpy(lo),
                                              torch.from_numpy(h)), grid)
    return torch.sort(keys, stable=True).indices.numpy()


def same_bits(a, b):
    return np.array_equal(np.asarray(a, F32).view(np.int32),
                          np.asarray(b, F32).view(np.int32))


# ---------------------------------------------------------------------------
# the deposit's passes against the twin
# ---------------------------------------------------------------------------

CASES = [("crowded", 3000, 128), ("crowded", 3000, 256), ("line", 3000, 128),
         ("line", 3000, 256), ("one_cell", 5000, 128),
         ("own_cells", 36, 16), ("spread", 1, 8), ("spread", 2100, 8),
         ("spread", 3000, 1024), ("mixture", 4097, 1024)]


@pytest.mark.parametrize("kind,n,grid", CASES)
def test_kernel_passes_give_the_twins_order_and_bits(kind, n, grid):
    """The order index for index torch.sort(stable=True)'s, the charges
    the twin's bits, at the default dense threshold."""
    y = layout(kind, n, seed=n + grid)
    lo, h = box(y, grid)
    got, order = kernel_deposit(y, lo, h, grid,
                                tgrid.DEPOSIT_DENSE_POINTS)
    assert np.array_equal(order, torch_order(y, lo, h, grid))
    want = tgrid.grid_deposit_reference(torch.from_numpy(y),
                                        torch.from_numpy(lo),
                                        torch.from_numpy(h), grid).numpy()
    assert same_bits(got, want)


def test_layouts_are_what_they_say():
    """The one-cell layout lies in one base cell past a tile and many
    pieces; the lattice puts at most one point in a cell; n = 2100 is no
    multiple of a tile; the 1024 grid's keys take 20 bits."""
    for kind, n, grid, fullest in (("one_cell", 5000, 128, 5000),
                                   ("own_cells", 36, 16, 1)):
        y = layout(kind, n, seed=n + grid)
        lo, h = box(y, grid)
        assert np.bincount(keys_of(y, lo, h, grid)).max() == fullest
    assert 5000 > TILE and 5000 // PIECE > 64 and 2100 % TILE
    y = layout("spread", 3000, seed=3000 + 1024)
    lo, h = box(y, 1024)
    assert keys_of(y, lo, h, 1024).max() >= 1 << 19


@pytest.mark.parametrize("grid", [8, 128])
def test_a_point_on_the_far_edge(grid):
    """The box maps its largest point onto node G - 4, up to a rounding:
    its base cell G - 5 or G - 6 keeps its taps inside the grid, in the
    kernel's passes as in the twin."""
    y = layout("spread", 500, seed=grid)
    lo, h = box(y, grid)
    far = coord(y.max(0), lo, h)
    assert (np.abs(far - F32(grid - 4)) < F32(1e-3)).all()
    got, order = kernel_deposit(y, lo, h, grid, 4)
    assert np.array_equal(order, torch_order(y, lo, h, grid))
    want = tgrid.grid_deposit_reference(torch.from_numpy(y),
                                        torch.from_numpy(lo),
                                        torch.from_numpy(h), grid).numpy()
    assert same_bits(got, want)


@pytest.mark.parametrize("dense", [0, 1, 16, 63, 64])
def test_every_dense_threshold_gives_the_same_bits(dense):
    """Cells moved between the piece pass and the node tiles' staging:
    every threshold gives the twin's bits (the crowded cell's 600 points
    take ten pieces, folded by the fold pass)."""
    grid, n = 32, 2500
    y = layout("crowded", n, seed=17)
    y[300:600] = y[:300]
    lo, h = box(y, grid)
    assert np.bincount(keys_of(y, lo, h, grid)).max() > 8 * PIECE
    got, _ = kernel_deposit(y, lo, h, grid, dense, seed=dense)
    want = tgrid.grid_deposit_reference(torch.from_numpy(y),
                                        torch.from_numpy(lo),
                                        torch.from_numpy(h), grid).numpy()
    assert same_bits(got, want)


@pytest.mark.parametrize("n,grid,dense,cells,rows", [
    (10**6, 256, 16, 58823, 15625 + 58823), (10**6, 128, 0, 16384,
                                             15625 + 16384),
    (100, 1024, 64, 1, 1 + 1), (5000, 128, 16, 294, 78 + 294)])
def test_dense_cells_and_rows_bound_the_lists(n, grid, dense, cells, rows):
    assert tgrid.dense_cells_bound(n, grid, dense) == cells
    assert tgrid.deposit_rows(n, grid, dense) == rows
    assert tgrid.large_cells_bound(n) == n // 513


@pytest.mark.parametrize("n,grid,words", [
    (10**6, 256, 32 + 489 * (256 + 256)), (10**6, 128, 8 + 489 * (128 + 128)),
    (1, 8, 1 + (8 + 8)), (3000, 1024, 512 + 2 * (1024 + 1024)),
    (100, 100, 5 + 1 * (128 + 128))])
def test_order_status_words(n, grid, words):
    """One look-back word a tile of the cells' scan and a tile and digit of
    each radix pass: G = 100 takes 14-bit keys, two 7-bit digits."""
    assert tgrid.order_status_words(n, grid) == words


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card_case(kind, n, grid, dev, seed):
    y = torch.from_numpy(layout(kind, n, seed)).to(dev)
    lo, h = tgrid.grid_box(y, n, grid)
    return y, lo, h


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,grid", [
    ("crowded", 20000, 128), ("crowded", 20000, 1024), ("one_cell", 5000, 128),
    ("own_cells", 36, 16), ("spread", 1, 8), ("spread", 2100, 8),
    ("mixture", 200000, 256)])
def test_kernel_order_and_bits_on_the_card(kind, n, grid):
    """The kernel's order index for index torch.sort(stable=True)'s on the
    card, its charges the twin's bits, two calls bit-equal."""
    dev = _card()
    y, lo, h = _on_card_case(kind, n, grid, dev, seed=n + grid)
    ws = tgrid.GridWorkspace(dev)
    got = tgrid.grid_deposit(y, lo, h, grid, ws)
    order = ws.order.clone()
    again = tgrid.grid_deposit(y, lo, h, grid, ws)
    want = tgrid.grid_deposit_reference(y, lo, h, grid)
    keys = tgrid.base_cells(tgrid.grid_coords(y, lo, h), grid)
    torch.cuda.synchronize()
    assert torch.equal(order.long(), torch.sort(keys, stable=True).indices)
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.cuda
def test_half_the_points_in_one_cell_on_the_card():
    """10^6 points, half of them within a few ulps of one spot (one base
    cell of 500000 points, 7813 pieces): the twin's bits and
    torch.sort's order."""
    dev = _card()
    rng = np.random.default_rng(5)
    y = rng.standard_normal((10**6, 2)).astype(F32) * 5
    y[:500000] = np.nextafter(y[500000], F32(100), dtype=F32)
    y[:250000] = y[500000]
    y = torch.from_numpy(y[rng.permutation(10**6)]).to(dev)
    lo, h = tgrid.grid_box(y, 10**6, 256)
    ws = tgrid.GridWorkspace(dev)
    got = tgrid.grid_deposit(y, lo, h, 256, ws)
    keys = tgrid.base_cells(tgrid.grid_coords(y, lo, h), 256)
    assert int(torch.bincount(keys).max()) >= 500000
    assert torch.equal(ws.order.long(), torch.sort(keys, stable=True).indices)
    assert torch.equal(got, tgrid.grid_deposit_reference(y, lo, h, 256))


@pytest.mark.cuda
def test_a_workspace_reused_across_grid_sizes_on_the_card():
    """One workspace through 256, 1024, 8 and 256 again, and through more
    points then fewer: each call the twin's bits and the sort's order."""
    dev = _card()
    ws = tgrid.GridWorkspace(dev)
    for n, grid in ((30000, 256), (30000, 1024), (500, 8), (70000, 256),
                    (30000, 256)):
        y, lo, h = _on_card_case("mixture", n, grid, dev, seed=grid)
        got = tgrid.grid_deposit(y, lo, h, grid, ws)
        keys = tgrid.base_cells(tgrid.grid_coords(y, lo, h), grid)
        assert torch.equal(ws.order.long(),
                           torch.sort(keys, stable=True).indices), (n, grid)
        assert torch.equal(got, tgrid.grid_deposit_reference(y, lo, h, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,grid", [
    ("crowded", 20000, 256), ("one_cell", 5000, 128), ("spread", 1, 8)])
def test_order_passes_alone_on_the_card(kind, n, grid):
    """GridWorkspace.order_passes: torch.sort's order, no launch counted,
    and a deposit on the same workspace afterwards still the twin's bits."""
    dev = _card()
    y, lo, h = _on_card_case(kind, n, grid, dev, seed=n)
    ws = tgrid.GridWorkspace(dev)
    before = tgrid.grid_deposit.launches
    ws.order_passes(y, lo, h, grid)
    keys = tgrid.base_cells(tgrid.grid_coords(y, lo, h), grid)
    assert torch.equal(ws.order.long(), torch.sort(keys, stable=True).indices)
    assert tgrid.grid_deposit.launches == before
    got = tgrid.grid_deposit(y, lo, h, grid, ws)
    assert torch.equal(got, tgrid.grid_deposit_reference(y, lo, h, grid))


@pytest.mark.cuda
def test_the_card_requires_a_workspace():
    """On a card grid_deposit and grid_repulsion raise without the
    caller's workspace."""
    dev = _card()
    y, lo, h = _on_card_case("spread", 100, 16, dev, seed=3)
    with pytest.raises(ValueError, match="GridWorkspace is required"):
        tgrid.grid_deposit(y, lo, h, 16)
    with pytest.raises(ValueError, match="GridWorkspace is required"):
        tgrid.grid_repulsion(y, 100, 16)


def _c_params(name: str, entry: str) -> list:
    """The ctypes type of each parameter of `entry`_launch as the kernel's
    source declares it."""
    import ctypes
    import re
    from sph_tpu_torch.ops import cuda_build
    with open(cuda_build.source(name)) as f:
        text = f.read()
    found = re.search(r'extern "C" int ' + entry + r'_launch\(([^)]*)\)',
                      text)
    assert found, entry
    out = []
    for param in found.group(1).split(","):
        decl = " ".join(param.split()[:-1]) if "*" not in param else "*"
        out.append(ctypes.c_void_p if decl == "*" else {
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[decl.replace("const ", "")])
    return out


def _entries():
    from sph_tpu_torch.ops import cuda_build
    for name, argtypes in cuda_build._SIGNATURES.items():
        yield name, name, argtypes
        for entry, more in cuda_build._ENTRIES.get(name, {}).items():
            yield name, entry, more


@pytest.mark.parametrize("name,entry,argtypes", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_entry_argtypes_match_the_sources(name, entry, argtypes):
    """Every C entry point's ctypes argument types, the stream included,
    are the parameters its source declares, one for one: a missing type
    would pass a 64-bit pointer as an int."""
    assert _c_params(name, entry) == list(argtypes)
