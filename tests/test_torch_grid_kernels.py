"""The grid tier's point work: ``grid_deposit`` and ``grid_interpolate``.

On the CPU the wrappers take their twins (ops/tsne_grid.py), which are
held against the JAX package's ``deposit_charges``, ``field_matrix`` and
``interpolate_fields`` on layouts made from a seed with numpy: a crowded
base cell (more than one deposit piece), a point alone, and a box that is
degenerate along x.  A transcription of each kernel's arithmetic and loops
into numpy float32 (the deposit's steps, its rows in any order, included)
gives the twins' bits, wherever the dense threshold falls.  On the card
(``cuda``) each kernel gives its twin's bits at 20000 points on the 128
and the 1024 grid.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sph_tpu.ops import tsne_grid as jgrid
from sph_tpu_torch.ops import cuda_build, tsne_kernels
from sph_tpu_torch.ops import tsne_grid as tgrid
from test_torch_reference_native import use_reference_native

use_reference_native()

F32 = np.float32


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layout(kind: str, n: int, npad: int, seed: int) -> np.ndarray:
    """n points (normal, scale 5) and garbage pad rows.  "crowded": 300
    points within 1e-3 of one spot (one base cell far past a 64-point
    piece) and one point far out alone at the box's corner; "line": every
    point at one x, so the box is degenerate along x (h_x floored at
    1e-6)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((npad, 2)).astype(F32) * 50
    y[:n] = rng.standard_normal((n, 2)).astype(F32) * 5
    if kind == "crowded":
        y[:300] = y[300] + 1e-3 * rng.standard_normal((300, 2)).astype(F32)
        y[n - 1] = y[:n - 1].max(0) + 7.0
    else:
        y[:n, 0] = F32(1.25)
    return y


def _box(y: np.ndarray, n: int, grid: int):
    lo, h = tgrid.grid_box(torch.from_numpy(y), n, grid)
    return lo, h


def _jax_coords(y, n, lo, h, grid):
    valid = jnp.arange(y.shape[0]) < n
    lo_, h_ = lo.numpy(), h.numpy()
    tx, ty = jgrid.grid_coords(jnp.asarray(y), valid, lo_[0], lo_[1], h_[0],
                               h_[1], grid)
    return valid, tx, ty


KINDS = ["crowded", "line"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid", [128, 256])
def test_deposit_twin_matches_jax(grid, kind):
    """The twin against the dense Lagrange matmuls, within 1e-6 x
    max|charges| (measured at most 1.7e-7: the products round alike, the
    sums run in other orders); the crowded cell takes several pieces."""
    n, npad = 3000, 3072
    y = _layout(kind, n, npad, seed=grid)
    lo, h = _box(y, n, grid)
    yt = torch.from_numpy(y[:n])
    base = tgrid.base_cells(tgrid.grid_coords(yt, lo, h), grid)
    if kind == "crowded":
        counts = torch.bincount(base)
        assert int(counts.max()) > 4 * tgrid._PIECE
        assert int((counts == 1).sum()) > 0              # a point alone
    else:
        assert float(h[0]) == float(F32(1e-6))
    got = tgrid.grid_deposit(yt, lo, h, grid).numpy()
    valid, tx, ty = _jax_coords(y, n, lo, h, grid)
    want = np.asarray(jgrid.deposit_charges(jnp.asarray(y), tx, ty, valid,
                                            grid, 512))
    assert got.shape == (3, grid, grid)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("grid", [128, 256])
def test_field_grids_match_jax_field_matrix(grid):
    """The FFT convolution from one set of charges: torch's pocketfft and
    XLA-CPU's FFT round differently, so within 1e-6 x max|field| (measured
    at most 2.2e-7)."""
    n, npad = 3000, 3072
    y = _layout("crowded", n, npad, seed=grid + 1)
    lo, h = _box(y, n, grid)
    charges = tgrid.grid_deposit(torch.from_numpy(y[:n]), lo, h, grid)
    got = tgrid.field_grids(charges, h, grid).numpy()
    h_ = h.numpy()
    v_mat = np.asarray(jgrid.field_matrix(jnp.asarray(charges.numpy()),
                                          h_[0], h_[1], grid))
    want = v_mat.reshape(grid, 4, grid).transpose(1, 0, 2)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid", [128, 256])
def test_interpolate_twin_matches_jax(grid, kind):
    """The twin's phi against the JAX package's interpolation of the same
    fields, within 1e-6 x max|phi| (measured at most 2.1e-7), and rep from
    them with pad rows 0."""
    n, npad = 3000, 3072
    y = _layout(kind, n, npad, seed=grid + 2)
    lo, h = _box(y, n, grid)
    yt = torch.from_numpy(y)
    fields = tgrid.field_grids(tgrid.grid_deposit(yt[:n], lo, h, grid), h,
                               grid)
    cells, wx, wy = tgrid.grid_taps(yt[:n], lo, h, grid)
    phi = tgrid.interpolate_fields(fields, cells, wx, wy).numpy()
    valid, tx, ty = _jax_coords(y, n, lo, h, grid)
    v_mat = jnp.asarray(fields.numpy().transpose(1, 0, 2).reshape(
        grid, 4 * grid))
    want = np.asarray(jgrid.interpolate_fields(v_mat, tx, ty, grid,
                                               512))[:n]
    assert np.abs(phi - want).max() <= 1e-6 * np.abs(want).max()
    rep, z = tgrid.grid_interpolate(fields, yt, n, lo, h)
    assert torch.equal(rep[n:], torch.zeros((npad - n, 2)))
    assert torch.equal(rep[:n], yt[:n] * torch.from_numpy(phi[:, 0:1])
                       - torch.from_numpy(phi[:, 1:3]))
    assert torch.equal(z, torch.from_numpy(phi[:, 3]).contiguous().sum())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid", [128, 256])
def test_grid_repulsion_within_the_jax_band(grid, kind):
    """The whole repulsion against the JAX package's, within 2e-5 x
    max|rep| and Z within 1e-6; two calls bit-equal.  rep is a difference
    of two large fields (y_i phi0 - phi_y), so their rounding shows: the
    twin measured 9.5e-6 to 1.5e-5 here, and before its order was spelled
    out (fold's col2im, the division by 6) 9.5e-6 to 1.7e-5; on
    test_torch_grid_tsne.py's layouts both measure at most 9.6e-6."""
    n, npad = 3000, 3072
    y = _layout(kind, n, npad, seed=grid + 3)
    rep_j, z_j = jgrid.grid_repulsion(jnp.asarray(y), jnp.int32(n), grid)
    yt = torch.from_numpy(y)
    rep, z = tgrid.grid_repulsion(yt, n, grid)
    rep_j = np.asarray(rep_j)
    assert np.abs(rep.numpy() - rep_j).max() <= 2e-5 * np.abs(rep_j).max()
    assert abs(float(z) - float(z_j)) <= 1e-6 * float(z_j)
    rep2, z2 = tgrid.grid_repulsion(yt, n, grid)
    assert torch.equal(rep, rep2) and torch.equal(z, z2)
    assert torch.equal(rep[n:], torch.zeros((npad - n, 2)))


@pytest.mark.parametrize("grid", [128, 256])
def test_twins_give_the_same_bits_twice(grid):
    n, npad = 3000, 3072
    y = torch.from_numpy(_layout("crowded", n, npad, seed=grid + 4))
    lo, h = tgrid.grid_box(y, n, grid)
    a = tgrid.grid_deposit_reference(y[:n], lo, h, grid)
    assert torch.equal(a, tgrid.grid_deposit_reference(y[:n], lo, h, grid))
    fields = tgrid.field_grids(a, h, grid)
    r1, z1 = tgrid.grid_interpolate_reference(fields, y, n, lo, h)
    r2, z2 = tgrid.grid_interpolate_reference(fields, y, n, lo, h)
    assert torch.equal(r1, r2) and torch.equal(z1, z2)


def test_wrappers_take_the_twins_on_the_cpu_and_launch_nothing():
    n, npad, grid = 2000, 2048, 128
    y = torch.from_numpy(_layout("crowded", n, npad, seed=9))
    lo, h = tgrid.grid_box(y, n, grid)
    before = (tsne_kernels.grid_deposit.launches,
              tsne_kernels.grid_interpolate.launches)
    charges = tgrid.grid_deposit(y[:n], lo, h, grid)
    assert torch.equal(charges,
                       tgrid.grid_deposit_reference(y[:n], lo, h, grid))
    fields = tgrid.field_grids(charges, h, grid)
    got = tgrid.grid_interpolate(fields, y, n, lo, h)
    want = tgrid.grid_interpolate_reference(fields, y, n, lo, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tsne_kernels.grid_deposit.launches,
            tsne_kernels.grid_interpolate.launches) == before
    assert tsne_kernels.grid_deposit is tgrid.grid_deposit


def test_wrappers_never_take_a_twin_off_the_cpu():
    """A tensor on neither the CPU nor a card (the meta device) raises: the
    twins are for CPU tensors only."""
    y = torch.zeros((10, 2), device="meta")
    lo = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        tgrid.grid_deposit(y, lo, lo, 128)
    fields = torch.zeros((4, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        tgrid.grid_interpolate(fields, y, 10, lo, lo)


def test_no_valid_rows():
    y = torch.zeros((8, 2))
    lo, h = tgrid.grid_box(y, 0, 128)
    assert float(h.max()) == F32(1e-6)
    assert torch.equal(tgrid.grid_deposit(y[:0], lo, h, 128),
                       torch.zeros((3, 128, 128)))
    rep, z = tgrid.grid_repulsion(y, 0, 128)
    assert torch.equal(rep, torch.zeros((8, 2))) and float(z) == F32(1e-12)


def test_sources_name_what_they_replace_and_their_bounds():
    for name, jax_fn in (("grid_deposit", "deposit_charges"),
                         ("grid_interpolate", "interpolate_fields")):
        assert name in cuda_build.ALL_KERNELS and name in tsne_kernels.KERNELS
        with open(cuda_build.source(name)) as f:
            src = f.read()
        assert f"sph_tpu/ops/tsne_grid.py::{jax_fn}" in src
        assert "Replaces no Pallas kernel" in src
        assert "What bounds it: bytes" in src
        assert f'extern "C" int {name}_launch' in src
        # the twin's float32(1 / 6), bit for bit
        assert "__int_as_float(0x3E2AAAAB)" in src
        assert np.float32(tgrid._SIXTH).view(np.int32) == 0x3E2AAAAB
        assert "__fmaf" not in src and "fmaf(" not in src
    assert "use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# the kernels' arithmetic and loops, transcribed into numpy float32
# ---------------------------------------------------------------------------

SIXTH = F32(tgrid._SIXTH)


def _coord(y, lo, h):
    return (y - lo) / h + F32(3)


def _cardinal(s):
    """csrc/grid_*.cu cardinal(), one rounded float32 operation a step."""
    if s < F32(1):
        return ((s + F32(1)) * (s - F32(1))) * (s - F32(2)) * F32(0.5)
    if s < F32(2):
        return ((-(s - F32(1))) * (s - F32(2))) * (s - F32(3)) * SIXTH
    return F32(0)


def _weights(t):
    first = np.floor(t) - F32(1)
    return [_cardinal(abs(t - (first + F32(j)))) for j in range(4)]


def kernel_deposit(y: np.ndarray, lo: np.ndarray, h: np.ndarray, grid: int,
                   dense: int) -> np.ndarray:
    """csrc/grid_deposit.cu's steps as written: mark_cells, reserve_rows
    (the rows in a shuffled order, as the warps' atomics may place them),
    piece_sums, cell_sums and node_sums."""
    t = _coord(y, lo, h)
    keys = ((np.floor(t) - F32(1)).astype(np.int32) * np.array(
        [1, grid], np.int32)).sum(1)
    order = np.argsort(keys, kind="stable")
    keys, ys = keys[order], y[order]
    start = np.zeros(grid * grid, np.int64)
    end = np.zeros(grid * grid, np.int64)
    for i, k in enumerate(keys):
        if i == 0 or keys[i - 1] != k:
            start[k] = i
        if i == len(keys) - 1 or keys[i + 1] != k:
            end[k] = i + 1
    piece = tgrid._PIECE
    # reserve_rows: a header and a row a piece for each dense cell
    dense_row = np.full(grid * grid, -1, np.int64)
    rows = []
    cells = [c for c in range(grid * grid) if end[c] - start[c] > dense]
    for c in np.random.default_rng(0).permutation(cells):
        dense_row[c] = len(rows)
        rows.append((c, -1))
        rows += [(c, p) for p in range(-(-(end[c] - start[c]) // piece))]
    assert len(rows) <= tgrid.deposit_rows(len(y), grid, dense)
    table = np.zeros((len(rows), 48), F32)
    for r, (c, p) in enumerate(rows):             # piece_sums
        if p < 0:
            continue
        s = [F32(0)] * 48
        b = start[c] + p * piece
        for i in range(b, min(b + piece, end[c])):
            px, py = ys[i]
            wx = _weights(_coord(px, lo[0], h[0]))
            wy = _weights(_coord(py, lo[1], h[1]))
            for dv in range(4):
                qx = (wx[dv], px * wx[dv], py * wx[dv])
                for q in range(3):
                    for du in range(4):
                        j = q * 16 + du * 4 + dv
                        s[j] = s[j] + wy[du] * qx[q]
        table[r] = s
    for r, (c, p) in enumerate(rows):             # cell_sums
        if p >= 0:
            continue
        for j in range(48):
            acc = F32(0)
            for q in range(1, -(-(end[c] - start[c]) // piece) + 1):
                acc = acc + table[r + q, j]
            table[r, j] = acc
    out = np.zeros((3, grid, grid), F32)
    for u in range(grid):                         # node_sums
        for v in range(grid):
            node = [F32(0)] * 3
            for du in range(4):
                for dv in range(4):
                    if u < du or v < dv:
                        continue
                    c = (u - du) * grid + v - dv
                    if dense_row[c] >= 0:
                        cs = [table[dense_row[c], q * 16 + du * 4 + dv]
                              for q in range(3)]
                    else:
                        s = [F32(0)] * 3
                        for i in range(start[c], end[c]):
                            px, py = ys[i]
                            wx = _cardinal(abs(_coord(px, lo[0], h[0])
                                               - F32(v)))
                            wy = _cardinal(abs(_coord(py, lo[1], h[1])
                                               - F32(u)))
                            s = [s[0] + wy * wx, s[1] + wy * (px * wx),
                                 s[2] + wy * (py * wx)]
                        cs = [F32(0) + a for a in s]
                    node = [a + b for a, b in zip(node, cs)]
            out[:, u, v] = node
    return out


def _cardinal_vec(s):
    inner = ((s + F32(1)) * (s - F32(1))) * (s - F32(2)) * F32(0.5)
    outer = ((-(s - F32(1))) * (s - F32(2))) * (s - F32(3)) * SIXTH
    return np.where(s < 1, inner, np.where(s < 2, outer, F32(0)))


def kernel_interpolate(fields, y, n, lo, h):
    """csrc/grid_interpolate.cu's interpolate_points for every row at once:
    the taps, the y contraction, the x contraction, rep and phi_z."""
    grid = fields.shape[-1]
    node_major = fields.transpose(1, 2, 0)
    yv = y[:n]
    w, first = [], []
    for a in range(2):
        t = _coord(yv[:, a], lo[a], h[a])
        f = np.floor(t) - F32(1)
        w.append([_cardinal_vec(np.abs(t - (f + F32(j)))) for j in range(4)])
        first.append(np.clip(f.astype(np.int64), 0, grid - 4))
    (wx, wy), (v0, u0) = w, first
    phi = None
    for dv in range(4):
        tv = None
        for du in range(4):
            term = wy[du][:, None] * node_major[u0 + du, v0 + dv]
            tv = term if tv is None else tv + term
        term = wx[dv][:, None] * tv
        phi = term if phi is None else phi + term
    rep = np.zeros_like(y)
    rep[:n, 0] = yv[:, 0] * phi[:, 0] - phi[:, 1]
    rep[:n, 1] = yv[:, 1] * phi[:, 0] - phi[:, 2]
    return rep, phi[:, 3]


@pytest.mark.parametrize("dense", [0, 1, 4, 16, 64])
def test_kernel_deposit_transcription_gives_the_twins_bits(dense):
    """On a 16 grid: 150 of 400 points in one base cell (three pieces), a
    point alone; every cell summed in pieces (dense 0), none but the
    crowded one (64), or some, gives the twin's bits."""
    grid, n = 16, 400
    rng = np.random.default_rng(7)
    y = rng.standard_normal((n, 2)).astype(F32)
    y[:150] = y[150] + 1e-3 * rng.standard_normal((150, 2)).astype(F32)
    y[-1] = y[:-1].max(0) + 2.0
    yt = torch.from_numpy(y)
    lo, h = tgrid.grid_box(yt, n, grid)
    want = tgrid.grid_deposit_reference(yt, lo, h, grid).numpy()
    got = kernel_deposit(y, lo.numpy(), h.numpy(), grid, dense)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,grid,dense,rows", [
    (10**6, 256, 16, 2 * 58823 + 15625 + 1),
    (10**6, 128, 0, 2 * 16384 + 15625 + 1), (100, 1024, 64, 2 * 1 + 1 + 1)])
def test_deposit_rows_bound_the_piece_table(n, grid, dense, rows):
    assert tgrid.deposit_rows(n, grid, dense) == rows


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_interpolate_transcription_gives_the_twins_bits(kind):
    n, npad, grid = 3000, 3072, 128
    y = _layout(kind, n, npad, seed=11)
    yt = torch.from_numpy(y)
    lo, h = tgrid.grid_box(yt, n, grid)
    fields = tgrid.field_grids(tgrid.grid_deposit(yt[:n], lo, h, grid), h,
                               grid)
    rep, z = tgrid.grid_interpolate_reference(fields, yt, n, lo, h)
    got_rep, phi_z = kernel_interpolate(fields.numpy(), y, n, lo.numpy(),
                                        h.numpy())
    assert np.array_equal(got_rep.view(np.int32), rep.numpy().view(np.int32))
    assert torch.equal(torch.from_numpy(np.ascontiguousarray(phi_z)).sum(), z)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [128, 1024])
def test_grid_deposit_kernel_gives_the_twins_bits(grid):
    """20000 points with a crowded cell: the kernel with every nonempty
    cell summed in pieces, none but the crowded ones, and between, twice
    each, against the twin on the card, bit for bit."""
    dev = _card()
    n = 20000
    y = torch.from_numpy(_layout("crowded", n, n, seed=grid)).to(dev)
    lo, h = tgrid.grid_box(y, n, grid)
    want = tgrid.grid_deposit_reference(y, lo, h, grid)
    before = tsne_kernels.grid_deposit.launches
    denses = (0, 1, 4, 16, tgrid._PIECE)
    for dense in denses:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgrid, "DEPOSIT_DENSE_POINTS", dense)
            got = tgrid.grid_deposit(y, lo, h, grid)
            again = tgrid.grid_deposit(y, lo, h, grid)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(again, got), dense
    assert tsne_kernels.grid_deposit.launches == before + 2 * len(denses)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [128, 1024])
def test_grid_interpolate_kernel_gives_the_twins_bits(grid):
    dev = _card()
    n, npad = 20000, 20480
    y = torch.from_numpy(_layout("crowded", n, npad, seed=grid)).to(dev)
    lo, h = tgrid.grid_box(y, n, grid)
    fields = tgrid.field_grids(tgrid.grid_deposit(y[:n], lo, h, grid), h,
                               grid)
    want = tgrid.grid_interpolate_reference(fields, y, n, lo, h)
    before = tsne_kernels.grid_interpolate.launches
    got = tgrid.grid_interpolate(fields, y, n, lo, h)
    again = tgrid.grid_interpolate(fields, y, n, lo, h)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert torch.equal(got[0][n:], torch.zeros_like(got[0][n:]))
    assert tsne_kernels.grid_interpolate.launches == before + 2


@pytest.mark.cuda
def test_grid_repulsion_on_the_card_launches_both_kernels():
    dev = _card()
    n, npad, grid = 20000, 20480, 256
    y = torch.from_numpy(_layout("line", n, npad, seed=5)).to(dev)
    before = (tsne_kernels.grid_deposit.launches,
              tsne_kernels.grid_interpolate.launches)
    rep, z = tgrid.grid_repulsion(y, n, grid)
    torch.cuda.synchronize()
    assert (tsne_kernels.grid_deposit.launches,
            tsne_kernels.grid_interpolate.launches) == (before[0] + 1,
                                                        before[1] + 1)
    lo, h = tgrid.grid_box(y, n, grid)
    fields = tgrid.field_grids(tgrid.grid_deposit_reference(
        y[:n], lo, h, grid), h, grid)
    rep_t, z_t = tgrid.grid_interpolate_reference(fields, y, n, lo, h)
    assert torch.equal(rep, rep_t)
    assert torch.equal(z, torch.clamp(z_t - float(n), min=1e-12))
    assert os.path.exists(cuda_build.library_path("grid_deposit"))
