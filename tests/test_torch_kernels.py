"""tsne_forces_dense: the port's plain twin against the JAX package's Pallas
kernel (interpret mode on the CPU) and against a numpy oracle; the CUDA
kernel against the twin on the card.  The wrapper routes CPU tensors to the
twin, so the CPU tests reach it through the public wrapper.

tsne_repulsion: its launch plan (row tiles by column splits) covers every
pair once, and the plan's sums over units and splits give the twin's
result; on the card the kernel against the twin at odd sizes, bit-equal
from call to call.  The twin's own parity tests are in
test_torch_sparse_tsne.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_tpu.ops.pallas.tsne_kernels import tsne_forces_dense as jax_forces
from sph_tpu_torch.ops import tsne_kernels
from sph_tpu_torch.ops.tsne_kernels import (REPULSION_CHUNK,
                                            REPULSION_TILE,
                                            REPULSION_UNITS_PER_SM,
                                            repulsion_plan,
                                            tsne_forces_dense,
                                            tsne_forces_dense_reference,
                                            tsne_repulsion,
                                            tsne_repulsion_blocks_per_sm,
                                            tsne_repulsion_reference,
                                            tsne_repulsion_rows)
from test_torch_reference_native import use_reference_native

use_reference_native()

INTERPRET = jax.default_backend() != "tpu"


def _inputs(n, npad, seed=2):
    """The fixture of tests/test_pallas_kernels.py:42-52: y and a sparse
    symmetric joint P with zero diagonal and pads."""
    rng = np.random.default_rng(seed)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 3
    p = np.zeros((npad, npad), np.float32)
    sup = rng.random((n, n)) < 0.05
    p[:n, :n] = np.where(sup | sup.T, rng.random((n, n)), 0).astype(np.float32)
    p[:n, :n] = (p[:n, :n] + p[:n, :n].T) / 2
    np.fill_diagonal(p, 0.0)
    p /= max(p.sum(), 1e-12)
    return y, p


# csrc/tsne_forces_dense.cu's order of Z: kZRows rows a tile, kZLanes
# partials of the tiles
Z_ROWS, Z_LANES = 16, 256


def forces_z(zrow: torch.Tensor) -> torch.Tensor:
    """Z from the rows' z (0 on pad rows) in csrc/tsne_forces_dense.cu's
    order, vectorized: each tile of Z_ROWS rows added in row order, tile t
    added into partial t mod Z_LANES in tile order, then the partials
    halved pairwise (lane i + lane i + h for h = Z_LANES / 2, ..., 1)."""
    lanes_n = Z_LANES
    rows = zrow.reshape(-1, Z_ROWS)
    tile_z = rows[:, 0]
    for r in range(1, Z_ROWS):
        tile_z = tile_z + rows[:, r]
    m = -(-tile_z.numel() // lanes_n)
    lanes = torch.zeros(max(m, 1) * lanes_n, dtype=zrow.dtype,
                        device=zrow.device)
    lanes[:tile_z.numel()] = tile_z
    lanes = lanes.reshape(-1, lanes_n)
    acc = lanes[0]
    for i in range(1, lanes.shape[0]):
        acc = acc + lanes[i]
    h = lanes_n // 2
    while h:
        acc = acc[:h] + acc[h:2 * h]
        h //= 2
    return acc[0]


def _assert_close(attr, rep, z, attr_ref, rep_ref, z_ref, n):
    assert np.isclose(float(z), float(z_ref), rtol=1e-5)
    for got, ref in ((rep, rep_ref), (attr, attr_ref)):
        scale = max(float(np.abs(ref[:n]).max()), 1e-30)
        assert np.abs(got[:n] - ref[:n]).max() <= 1e-5 * scale
        assert np.all(got[n:] == 0)


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256), (700, 1024)])
def test_forces_twin_matches_pallas_interpret(n, npad):
    """The twin against the Pallas kernel in interpret mode, and Z summed
    in the kernel's order (forces_z over the rows' z): Z within 1e-5
    relative, attr and rep within 1e-5 x max|JAX| (float32 sums in other
    orders), pad rows 0."""
    y, p = _inputs(n, npad)
    attr_j, rep_j, z_j = jax_forces(jnp.asarray(y), jnp.asarray(p),
                                    jnp.int32(n), row_block=128,
                                    col_block=min(npad, 512),
                                    interpret=INTERPRET)
    attr, rep, z = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p),
                                     n)
    _assert_close(attr.numpy(), rep.numpy(), z, np.asarray(attr_j),
                  np.asarray(rep_j), z_j, n)
    d2 = ((y[:n, None, :] - y[None, :n, :]) ** 2).sum(-1)
    w = (1.0 / (1.0 + d2)).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    zrow = np.zeros(npad, np.float32)
    zrow[:n] = w.sum(1)
    z_kernel_order = forces_z(torch.from_numpy(zrow))
    assert np.isclose(float(z_kernel_order), float(z_j), rtol=1e-5)


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256)])
def test_forces_twin_matches_numpy_oracle(n, npad):
    y, p = _inputs(n, npad)
    d2 = ((y[:n, None, :] - y[None, :n, :]) ** 2).sum(-1)
    w = 1.0 / (1.0 + d2)
    np.fill_diagonal(w, 0.0)
    diff = y[:n, None, :] - y[None, :n, :]
    rep_ref = np.zeros_like(y)
    attr_ref = np.zeros_like(y)
    rep_ref[:n] = ((w ** 2)[:, :, None] * diff).sum(1)
    attr_ref[:n] = ((p[:n, :n] * w)[:, :, None] * diff).sum(1)
    attr, rep, z = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p),
                                     n)
    _assert_close(attr.numpy(), rep.numpy(), z, attr_ref, rep_ref, w.sum(), n)


def test_forces_cpu_tensor_takes_twin_and_counts_no_launch():
    y, p = _inputs(50, 128)
    before = tsne_forces_dense.launches
    out = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p), 50)
    ref = tsne_forces_dense_reference(torch.from_numpy(y),
                                      torch.from_numpy(p), 50)
    assert tsne_forces_dense.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,npad", [(50, 128), (700, 1024)])
def test_forces_caller_owned_buffers_on_the_cpu(n, npad):
    """With ``out`` the results are the buffers' tensors, equal to the
    twin's, and a second call overwrites the same buffers."""
    y, p = _inputs(n, npad)
    y_t, p_t = torch.from_numpy(y), torch.from_numpy(p)
    out = tsne_kernels.DenseForces(npad, "cpu")
    got = tsne_forces_dense(y_t, p_t, n, out=out)
    assert got[0] is out.attr and got[1] is out.rep and got[2] is out.z
    ref = tsne_forces_dense_reference(y_t, p_t, n)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ptrs = [t.data_ptr() for t in got]
    y2 = y_t * 1.5
    again = tsne_forces_dense(y2, p_t, n, out=out)
    assert [t.data_ptr() for t in again] == ptrs
    for a, b in zip(again, tsne_forces_dense_reference(y2, p_t, n)):
        assert torch.equal(a, b)


def _kernel_z_order(zrow: np.ndarray) -> np.float32:
    """csrc/tsne_forces_dense.cu's Z, step by step in numpy float32: each
    tile of Z_ROWS rows left to right, partial t of Z_LANES over tiles t,
    t + Z_LANES, ... left to right, then the halving tree."""
    threads = Z_LANES
    tiles = zrow.reshape(-1, Z_ROWS)
    tz = []
    for row in tiles:
        acc = np.float32(row[0])
        for v in row[1:]:
            acc = np.float32(acc + v)
        tz.append(acc)
    red = []
    for t in range(threads):
        acc = np.float32(0.0)
        for j in range(t, len(tz), threads):
            acc = np.float32(acc + tz[j])
        red.append(acc)
    h = threads // 2
    while h:
        red = [np.float32(red[i] + red[i + h]) for i in range(h)]
        h //= 2
    return red[0]


@pytest.mark.parametrize("npad", [128, 256, 8192, 16384, 28672])
def test_forces_z_sums_in_the_kernel_order(npad):
    """forces_z (the kernel's order, vectorized) is the step-by-step
    emulation bit for bit, on rows with pad zeros, at one and at several
    tiles per thread."""
    r = np.random.default_rng(npad)
    zrow = np.zeros(npad, np.float32)
    zrow[:npad - 40] = r.random(npad - 40, dtype=np.float32) * 100
    got = forces_z(torch.from_numpy(zrow))
    assert got.dtype == torch.float32
    assert float(got) == float(_kernel_z_order(zrow))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("npad", [128, 256, 512, 768, 1024, 2048, 4096, 6144,
                                  16384, 21504, 28672])
@pytest.mark.parametrize("pads", [0, 7])
def test_forces_plan_covers_every_column_once(npad, sms, pads):
    """For n_valid = npad (pads 0) or npad less a seventh, rounded to whole
    rows (pads 7): the splits cut the live columns [0, ceil128(n_valid))
    into ranges of whole warp steps; the row tiles cover the rows; where
    the columns allow it, the plan gives each SM at least
    FORCES_BLOCKS_PER_SM blocks of tiles that hold a real row."""
    n = npad - (npad // pads if pads else 0)
    plan = tsne_kernels.forces_plan(n, npad, sms)
    step = tsne_kernels.FORCES_STEP
    cols = -(-n // step) * step
    live_tiles = -(-n // tsne_kernels.FORCES_ROWS)
    assert plan.tiles * tsne_kernels.FORCES_ROWS == npad
    assert plan.split_cols % step == 0
    ranges = [(s * plan.split_cols, min((s + 1) * plan.split_cols, cols))
              for s in range(plan.splits)]
    assert _partition(ranges, cols)
    if plan.splits > 1:
        assert plan.split_cols >= tsne_kernels.FORCES_MIN_SPLIT
    if cols // tsne_kernels.FORCES_MIN_SPLIT > plan.splits:
        assert plan.split_cols <= tsne_kernels.FORCES_MAX_SPLIT
    if cols // tsne_kernels.FORCES_MIN_SPLIT >= plan.splits + 1:
        assert live_tiles * plan.splits >= (
            tsne_kernels.FORCES_BLOCKS_PER_SM * sms)
    assert live_tiles * plan.splits >= min(
        live_tiles, tsne_kernels.FORCES_BLOCKS_PER_SM * sms)


def test_dense_tier_steps_match_jax_with_caller_owned_buffers(monkeypatch):
    """Five dense-tier iterations, each from the JAX package's state (its
    Pallas kernel in interpret mode), n_valid 300 of Npad 512: the port's
    step through one DenseForces allocated once a run gives the JAX
    package's layout, velocity and gain within 1e-5 x their largest
    value."""
    import sph_tpu as J
    from sph_tpu.ops.pallas import tsne_kernels as jax_kernels
    from sph_tpu.ops.sparse import normalize_rows, symmetrize_tsne
    import sph_tpu_torch as T
    from sph_tpu_torch.models import tsne as ttsne
    from sph_tpu_torch.ops.math import random_disk_init
    import functools
    monkeypatch.setattr(jax_kernels, "tsne_forces_dense", functools.partial(
        jax_kernels.tsne_forces_dense, interpret=True))
    n = 300
    r = np.random.default_rng(8)
    idx = np.sort(np.stack([r.choice(n, 20, replace=False)
                            for _ in range(n)]), 1).astype(np.int32)
    p = symmetrize_tsne(normalize_rows(J.SparseRows(
        idx, r.random((n, 20), dtype=np.float32), n)))
    init = random_disk_init(n, 0.1, seed=0)
    tj = J.TsneComputation(J.TsneParameters(), use_pallas=True)
    tj.set_probability_distribution(p)
    tj.set_initial_embedding(init)
    tj._init_gradient_descent()
    tt = ttsne.TsneComputation(T.TsneParameters(), device="cpu")
    tt.set_probability_distribution(T.SparseRows(p.indices, p.values, n,
                                                  device="cpu"))
    tt.set_initial_embedding(init)
    tt._init_gradient_descent()
    assert tt.tier == "dense" and tt._npad == 512
    bufs = tt._forces_out
    assert isinstance(bufs, tsne_kernels.DenseForces) and bufs.npad == 512
    for _ in range(5):
        s = tj._state
        tt._y = torch.tensor(np.array(s.embedding))
        tt._vel = torch.tensor(np.array(s.velocity))
        tt._gain = torch.tensor(np.array(s.gain))
        tt._iteration = s.iteration
        tt._step()
        tj.continue_gradient_descent(1)
        s = tj._state
        for got, ref in ((tt._y, s.embedding), (tt._vel, s.velocity),
                         (tt._gain, s.gain)):
            ref = np.asarray(ref)
            scale = float(np.abs(ref).max())
            assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
        assert tt._forces_out is bufs


@pytest.mark.parametrize("bad", ["shape", "dtype", "n_valid"])
def test_forces_rejects_what_the_kernel_does_not_take(bad):
    y = torch.zeros((128, 2))
    p = torch.zeros((128, 128))
    n = 10
    if bad == "shape":
        p = torch.zeros((128, 64))
    elif bad == "dtype":
        y = y.double()
    else:
        n = 129
    with pytest.raises((ValueError, TypeError)):
        tsne_forces_dense(y, p, n)


def test_kernel_source_notes_the_tpu_kernel_it_replaces():
    """Each source names what it replaces: the two Pallas kernels, for
    tsne_attraction the JAX package's XLA attraction, and for the grid
    kernels its grid deposit and interpolation."""
    replaces = {"tsne_forces_dense": "sph_tpu/ops/pallas/tsne_kernels.py",
                "tsne_repulsion": "sph_tpu/ops/pallas/tsne_kernels.py",
                "tsne_attraction":
                    "sph_tpu/models/tsne.py::_attractive_forces",
                "grid_deposit": "sph_tpu/ops/tsne_grid.py::deposit_charges",
                "grid_interpolate":
                    "sph_tpu/ops/tsne_grid.py::interpolate_fields"}
    assert tsne_kernels.KERNELS == tuple(replaces)
    for name in tsne_kernels.KERNELS:
        with open(tsne_kernels.source(name)) as f:
            src = f.read()
        assert replaces[name] in src and name in src
        assert f'extern "C" int {name}_launch' in src
        # one library per kernel and source content
        assert os.path.basename(tsne_kernels.library_path(name)).startswith(
            f"lib{name}_")
    assert "sm_90a" in " ".join(tsne_kernels.NVCC_FLAGS)


@pytest.mark.cuda
def test_forces_cuda_reciprocal_is_ieee():
    """The kernel's branch-free reciprocal gives IEEE 1 / x's bits on every
    float32 in [1, 2^126)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    assert tsne_kernels.forces_rcp_mismatches() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,npad", [(1, 256), (255, 256),
                                    (402, 512), (1000, 1024), (1286, 2048),
                                    (5284, 6144)])
def test_forces_cuda_kernel_matches_twin(n, npad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    y, p = _inputs(n, npad, seed=5)
    y_d, p_d = torch.from_numpy(y).cuda(), torch.from_numpy(p).cuda()
    before = tsne_forces_dense.launches
    out = tsne_kernels.DenseForces(npad, y_d.device)
    attr, rep, z = tsne_forces_dense(y_d, p_d, n, out=out)
    first = [t.clone() for t in (attr, rep, z)]
    again = tsne_forces_dense(y_d, p_d, n, out=out)
    fresh = tsne_forces_dense(y_d, p_d, n)
    attr_r, rep_r, z_r = tsne_forces_dense_reference(y_d, p_d, n)
    torch.cuda.synchronize()
    assert tsne_forces_dense.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, fresh))
    _assert_close(attr.cpu().numpy(), rep.cpu().numpy(), z.cpu(),
                  attr_r.cpu().numpy(), rep_r.cpu().numpy(), z_r.cpu(), n)


# ---------------------------------------------------------------------------
# tsne_repulsion: the launch plan
# ---------------------------------------------------------------------------

# (n_valid, Npad): the edges of a tile and a chunk, the paths' shapes (the
# Pines KL at 5358 / 6144, grid_vs_exact at 65536, the 1M path), pads
PLAN_SHAPES = [(0, 0), (0, 64), (1, 1), (1, 8), (2, 2), (511, 512),
               (512, 512), (513, 513), (513, 1024), (5358, 6144),
               (65536, 65536), (1_000_000, 1_000_448)]


def _partition(ranges, n):
    """The sorted distinct [lo, hi) ranges cut [0, n) into non-empty pieces
    that meet end to end."""
    ranges = sorted(set(ranges))
    if n == 0:
        return not ranges
    return (ranges[0][0] == 0 and ranges[-1][1] == n
            and all(lo < hi for lo, hi in ranges)
            and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])))


@pytest.mark.parametrize("sms", [132, 114])     # H100 SXM and PCIe
@pytest.mark.parametrize("n,npad", PLAN_SHAPES)
def test_repulsion_plan_covers_every_pair_once(n, npad, sms):
    """The blocks are the product of a partition of the rows [0, n) into
    tiles and of the columns [0, n) into splits, each pair in one block;
    no block reaches a pad row; splits in whole chunks, as the kernel
    requires."""
    plan = repulsion_plan(n, sms)
    units = [plan.unit(b) for b in range(plan.blocks)]
    rows = [(a, b) for a, b, _, _ in units]
    cols = [(c, d) for _, _, c, d in units]
    assert len(set(units)) == len(units) == len(set(rows)) * len(set(cols))
    assert _partition(rows, n) and _partition(cols, n)
    assert all(b <= n <= npad for _, b, _, _ in units)
    assert plan.tiles == -(-n // REPULSION_TILE)
    assert plan.split_cols % REPULSION_CHUNK == 0
    if n:
        assert ((plan.splits - 1) * plan.split_cols < n
                <= plan.splits * plan.split_cols)
    if n <= 1024:                        # pair by pair where that is cheap
        count = np.zeros((n, n), np.int32)
        for a, b, c, d in units:
            count[a:b, c:d] += 1
        assert np.all(count == 1)


@pytest.mark.parametrize("n", [5358, 65536, 1_000_000])
def test_repulsion_plan_fills_the_card(n):
    """Units for about three or more blocks an SM at the paths' sizes (the
    old layout had 12 blocks at 5358 and 128 at 65536), and the target of
    REPULSION_UNITS_PER_SM an SM where the columns allow it, less what
    rounding the splits to whole chunks takes (32 splits, not 33, at
    65536)."""
    plan = repulsion_plan(n, sms=132)
    assert plan.blocks >= 3 * 132
    if n >= 65536:
        assert plan.blocks >= 0.9 * REPULSION_UNITS_PER_SM * 132


def _plan_sums(plan, y):
    """The kernel's sums as the plan cuts them, in float64: each block's
    partial (fx, fy, z) over its rows and columns, then the splits of each
    row added in split order."""
    n = plan.n_valid
    y64 = y.astype(np.float64)
    out = np.zeros((n, 3))
    for b in range(plan.blocks):
        r0, r1, c0, c1 = plan.unit(b)
        d = y64[r0:r1, None, :] - y64[None, c0:c1, :]
        w = 1.0 / (1.0 + (d * d).sum(-1))
        w[np.arange(r0, r1)[:, None] == np.arange(c0, c1)[None, :]] = 0.0
        out[r0:r1, :2] += ((w * w)[..., None] * d).sum(1)
        out[r0:r1, 2] += w.sum(1)
    return out


@pytest.mark.parametrize("n,npad", [(1, 8), (2, 2), (513, 1024),
                                    (1025, 1536)])
def test_repulsion_plan_sums_give_the_twin(n, npad):
    rng = np.random.default_rng(n)
    y = rng.standard_normal((npad, 2)).astype(np.float32) * 50
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5
    rep, zrow = tsne_repulsion_reference(torch.from_numpy(y), n)
    sums = _plan_sums(repulsion_plan(n), y)
    scale = max(float(rep.abs().max()), 1e-30)
    assert np.abs(sums[:, :2] - rep[:n].numpy()).max() <= 1e-5 * scale
    assert np.allclose(sums[:, 2], zrow[:n].numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [0, 1, 1000, 5358, 5632, 5633, 65536])
def test_repulsion_plan_takes_4_rows_by_default(n):
    """Tiles of 512 rows, 4 a thread; at most one split a chunk, so that a
    split never holds less than a whole chunk; on one SM, no more splits
    than REPULSION_UNITS_PER_SM units need."""
    plan = repulsion_plan(n, sms=132)
    assert plan.tiles == -(-n // 512)
    assert plan.splits <= max(1, -(-n // REPULSION_CHUNK))
    assert repulsion_plan(n, sms=1).splits <= max(
        1, -(-REPULSION_UNITS_PER_SM // max(plan.tiles, 1)))


def test_repulsion_plan_one_split_when_tiles_fill_the_card():
    """With a tile for every unit the plan aims at, the columns are not
    split and the kernel writes rep itself, with no scratch."""
    plan = repulsion_plan(REPULSION_UNITS_PER_SM * 2 * REPULSION_TILE, sms=2)
    assert plan.splits == 1 and plan.split_cols >= plan.n_valid


# ---------------------------------------------------------------------------
# tsne_repulsion on the card
# ---------------------------------------------------------------------------

def _repulsion_layout(n, npad, seed):
    """n points (normal, scale 5) and garbage in the pad rows."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((npad, 2)).astype(np.float32) * 50
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5
    return torch.from_numpy(y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npad", [(0, 16), (1, 1), (1, 8), (2, 2),
                                    (2, 64), (513, 513), (513, 1024),
                                    (1025, 1536), (5358, 6144)])
def test_repulsion_cuda_kernel_odd_sizes(n, npad):
    """Against the twin (rep within 1e-5 x max|ref|, zrow within 1e-5
    relative, pad rows exactly 0), and two calls bit-equal: the splits are
    summed in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    y = _repulsion_layout(n, npad, seed=n + npad).cuda()
    before = tsne_repulsion.launches
    rep, zrow = tsne_repulsion_rows(y, n)
    rep2, zrow2 = tsne_repulsion_rows(y, n)
    rep_r, zrow_r = tsne_repulsion_reference(y, n)
    torch.cuda.synchronize()
    assert tsne_repulsion.launches == before + 2
    assert torch.equal(rep, rep2) and torch.equal(zrow, zrow2)
    assert torch.allclose(zrow, zrow_r, rtol=1e-5, atol=0)
    scale = float(rep_r.abs().max())
    assert float((rep - rep_r).abs().max()) <= 1e-5 * scale
    assert torch.all(rep[n:] == 0) and torch.all(zrow[n:] == 0)


@pytest.mark.cuda
def test_repulsion_cuda_occupancy_and_input_checks():
    """At least the 4 blocks an SM that the launch bounds ask for; y that
    is not float32 is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    assert tsne_repulsion_blocks_per_sm() >= 4
    y = _repulsion_layout(100, 128, seed=1).cuda()
    with pytest.raises(TypeError):
        tsne_repulsion_rows(y.double(), 100)


# ---------------------------------------------------------------------------
# tsne_repulsion: scenes in one launch and row windows
# ---------------------------------------------------------------------------

def _scene_layouts(s, n, npad):
    return torch.stack([_repulsion_layout(n, npad, seed=10 + i)
                        for i in range(s)])


def test_repulsion_twin_scenes_and_windows():
    """The twin of a [S, Npad, 2] batch is each scene's twin, and a row
    window is those rows of the full result, pad rows 0."""
    y = _scene_layouts(3, 90, 128)
    rep, zrow = tsne_repulsion_reference(y, 90)
    assert rep.shape == (3, 128, 2) and zrow.shape == (3, 128)
    for i in range(3):
        r1, z1 = tsne_repulsion_reference(y[i], 90)
        assert torch.equal(rep[i], r1) and torch.equal(zrow[i], z1)
    wr, wz = tsne_repulsion_rows(y, 90, rows=(40, 128))
    assert torch.equal(wr, rep[:, 40:]) and torch.equal(wz, zrow[:, 40:])
    assert torch.all(wr[:, 50:] == 0)
    with pytest.raises(ValueError):
        tsne_repulsion_rows(y, 90, rows=(10, 129))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,npad", [(1, 5358, 6144), (3, 1025, 1536),
                                      (16, 2304, 2560), (2, 0, 16)])
def test_repulsion_cuda_scenes_bit_equal_to_one_scene(s, n, npad):
    """One launch for S scenes: each scene's rows bit-equal to its own
    one-scene call, and one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    y = _scene_layouts(s, n, npad).cuda()
    before = tsne_repulsion.launches
    rep, zrow = tsne_repulsion_rows(y, n)
    assert tsne_repulsion.launches == before + 1
    for i in range(s):
        r1, z1 = tsne_repulsion_rows(y[i].contiguous(), n)
        assert torch.equal(rep[i], r1) and torch.equal(zrow[i], z1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npad,rows", [(5358, 6144, (0, 3072)),
                                         (5358, 6144, (3072, 6144)),
                                         (5358, 6144, (700, 5000)),
                                         (65536, 65536, (32768, 65536)),
                                         (100, 128, (100, 128))])
def test_repulsion_cuda_window_bit_equal_to_full(n, npad, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    y = _repulsion_layout(n, npad, seed=n).cuda()
    rep, zrow = tsne_repulsion_rows(y, n)
    wr, wz = tsne_repulsion_rows(y, n, rows=rows)
    assert torch.equal(wr, rep[rows[0]:rows[1]])
    assert torch.equal(wz, zrow[rows[0]:rows[1]])
