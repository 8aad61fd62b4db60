"""The u16-packed gathers of the PyTorch port against the JAX package.

The JAX package's defaults read neighbour positions from a u16 fixed-point
table of the layout: t-SNE's attraction on the grid tier
(``SPH_TSNE_ATTR_PACKED`` "auto") and UMAP's rows tier (``SPH_UMAP_PACKED``
"1").  Here: the table bit for bit (ops/packing.py), the attraction packed
and unpacked through ``tsne_attraction``'s twin against
``_attractive_forces``, a row window against the full call, the grid tier
and the rows tier step by step on both packages' defaults, and, on a card,
the CUDA kernel against its twin.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.models import tsne as jtsne
from sph_tpu.models import umap as jumap
from sph_tpu.ops import knn as jknn
from sph_tpu.ops.math import random_disk_init
from sph_tpu.utils.testdata import create_3d_gaussians
import sph_tpu_torch as T
from sph_tpu_torch.models import tsne as ttsne
from sph_tpu_torch.models import umap as tumap
from sph_tpu_torch.ops import tsne_kernels
from sph_tpu_torch.ops.packing import pack_positions, unpack_positions
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
from test_torch_reference_native import use_reference_native

use_reference_native()

SWITCHES = ("SPH_TSNE_DENSE_P", "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_GRID",
            "SPH_TSNE_GRID_MIN", "SPH_TSNE_GRID_MAX", "SPH_TSNE_P_WIDTH_CAP",
            "SPH_TSNE_GRID_P_WIDTH", "SPH_TSNE_ATTR_PACKED",
            "SPH_TSNE_DISPATCH_BUDGET", "SPH_TSNE_USE_PALLAS",
            "SPH_TSNE_ATTR_FUSE_MAX", "SPH_UMAP_DENSE_MAX",
            "SPH_UMAP_ROWS_WIDTH", "SPH_UMAP_NEG_BUDGET",
            "SPH_UMAP_EDGE_PATH", "SPH_UMAP_DISPATCH_BUDGET",
            "SPH_UMAP_PACKED")

_jax_pack = jax.jit(jumap._pack_positions)
_jax_unpack = jax.jit(jumap._unpack_positions)


def table_bits(table: torch.Tensor) -> np.ndarray:
    """A packed table's words as numpy uint32."""
    return table.numpy().view(np.uint32)


@pytest.fixture(autouse=True)
def defaults(monkeypatch):
    """Every switch unset: both packages on their defaults; one torch
    thread (thousands of small ops beside other test workers)."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(threads)


def _layout(n, npad, seed, scale=5.0, shift=0.0):
    rng = np.random.default_rng(seed)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * scale + shift
    return y


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,npad,scale,shift", [
    (1000, 1000, 5.0, 0.0),        # no pad rows
    (1000, 1024, 5.0, 0.0),        # pad rows of 0 inside the box
    (600, 1024, 3.0, 40.0),        # pad rows of 0 widen the box
    (777, 777, 1e-3, -2.0),        # a narrow box far from 0
    (64, 64, 300.0, 0.0),
    (5, 64, 1e4, 1e4),
])
def test_table_bit_equal_to_jax(n, npad, scale, shift):
    """The words and (lo0, s0, lo1, s1) of the JAX package's padded layout
    (the t-SNE layout holds its pad rows; the UMAP rows tier's are added
    as with_zero), and the unpacked positions, bit for bit."""
    y = _layout(n, npad, seed=n, scale=scale, shift=shift)
    table, prm = _jax_pack(jnp.asarray(y[:, 0]), jnp.asarray(y[:, 1]))
    want = np.asarray(jax.lax.bitcast_convert_type(table, jnp.uint32))
    yt = torch.from_numpy(y)
    full = pack_positions(yt[:, 0], yt[:, 1])
    rows_tier = pack_positions(yt[:n, 0], yt[:n, 1], with_zero=npad > n)
    for (got_t, got_p), rows in ((full, npad), (rows_tier, n)):
        assert np.array_equal(table_bits(got_t), want[:rows])
        assert np.array_equal(got_p.numpy(), np.asarray(prm, np.float32))
    ids = np.random.default_rng(1).integers(0, npad, 500)
    u0, u1 = _jax_unpack(table[ids], prm)
    g0, g1 = unpack_positions(full[0][torch.from_numpy(ids)], full[1])
    assert np.array_equal(g0.numpy(), np.asarray(u0))
    assert np.array_equal(g1.numpy(), np.asarray(u1))


@pytest.mark.parametrize("flat", ["x", "both"])
def test_table_of_a_degenerate_span(flat):
    """All points at one coordinate: the span floors at 1e-30 and every
    word's half is 0, as in the JAX package."""
    y = _layout(300, 300, seed=3)
    y[:, 0] = 2.5
    if flat == "both":
        y[:, 1] = -7.0
    table, prm = _jax_pack(jnp.asarray(y[:, 0]), jnp.asarray(y[:, 1]))
    got_t, got_p = pack_positions(torch.from_numpy(y[:, 0]),
                                  torch.from_numpy(y[:, 1]))
    want = np.asarray(jax.lax.bitcast_convert_type(table, jnp.uint32))
    assert np.array_equal(table_bits(got_t), want)
    assert np.array_equal(got_p.numpy(), np.asarray(prm, np.float32))
    assert np.all(table_bits(got_t) >> 16 == 0)


# ---------------------------------------------------------------------------
# the attraction
# ---------------------------------------------------------------------------

def _sparse_p(n, width, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, n, (n, width)), 1).astype(np.int32)
    idx[:, -3:] = -1                                   # pads at the row ends
    idx[-5:] = -1                                      # rows with no entry
    val = np.where(idx >= 0, rng.random((n, width)), 0).astype(np.float32)
    return idx, val / val.sum()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,npad,width", [(500, 512, 16), (776, 776, 24),
                                          (1000, 1024, 64)])
def test_attraction_matches_jax(n, npad, width, packed):
    """``attractive_forces`` (the kernel's twin on the CPU) against
    ``_attractive_forces`` on the padded layout, packed and not: within
    1e-6 x max|attr| (measured 1.2e-7 unpacked and 1.6e-7 packed; the
    unpacked positions are bit-equal, the weights and row sums round in
    other orders).  The packed force is another function: it moves by
    the quantisation, about span / 65536 a coordinate."""
    idx, val = _sparse_p(npad, width, seed=n)
    idx[n:] = -1
    val[n:] = 0.0
    y = _layout(n, npad, seed=n + 1)
    ref = np.asarray(jtsne._attractive_forces(
        jnp.asarray(y), jnp.asarray(idx), jnp.asarray(val), packed))
    got = ttsne.attractive_forces(torch.from_numpy(y), torch.from_numpy(idx),
                                  torch.from_numpy(val),
                                  packed=packed).numpy()
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= 1e-6 * scale
    other = np.asarray(jtsne._attractive_forces(
        jnp.asarray(y), jnp.asarray(idx), jnp.asarray(val), not packed))
    assert 0 < np.abs(other - ref).max() <= 1e-3 * scale


@pytest.mark.parametrize("packed", [False, True])
def test_attraction_windows_equal_the_full_call(packed):
    """Row windows of P against one call over all rows (the sharded steps'
    form: a shard's rows with row0, the ids global): equal row for row;
    int64 ids give the int32 ids' result."""
    n, width = 1000, 24
    idx, val = _sparse_p(n, width, seed=5)
    y = torch.from_numpy(_layout(n, n, seed=6))
    table = prm = None
    if packed:
        table, prm = pack_positions(y[:, 0], y[:, 1])
    ids, vals = torch.from_numpy(idx), torch.from_numpy(val)
    full = tsne_kernels.tsne_attraction(y, ids, vals, 0, table, prm)
    for r0, r1 in ((0, 250), (250, 500), (500, 1000), (333, 334)):
        part = tsne_kernels.tsne_attraction(y, ids[r0:r1], vals[r0:r1], r0,
                                            table, prm)
        assert torch.equal(part, full[r0:r1])
    wide = tsne_kernels.tsne_attraction(y, ids.long(), vals, 0, table, prm)
    assert torch.equal(wide, full)


def test_attraction_cpu_tensor_takes_twin_and_counts_no_launch():
    n, width = 64, 8
    idx, val = _sparse_p(n, width, seed=1)
    y = torch.from_numpy(_layout(n, n, seed=2))
    before = tsne_kernels.tsne_attraction.launches
    got = tsne_kernels.tsne_attraction(y, torch.from_numpy(idx),
                                       torch.from_numpy(val))
    want = tsne_kernels.tsne_attraction_reference(
        y, torch.from_numpy(idx), torch.from_numpy(val))
    assert torch.equal(got, want)
    assert tsne_kernels.tsne_attraction.launches == before


@pytest.mark.parametrize("bad", ["float_ids", "shape", "window", "half_packed",
                                 "table_dtype"])
def test_attraction_rejects_what_the_kernel_does_not_take(bad):
    n, width = 64, 8
    idx, val = _sparse_p(n, width, seed=1)
    y = torch.from_numpy(_layout(n, n, seed=2))
    ids, vals = torch.from_numpy(idx), torch.from_numpy(val)
    table, prm = pack_positions(y[:, 0], y[:, 1])
    args = {"float_ids": (y, ids.float(), vals, 0, None, None),
            "shape": (y, ids, vals[:, :4], 0, None, None),
            "window": (y, ids, vals, 1, None, None),
            "half_packed": (y, ids, vals, 0, table, None),
            "table_dtype": (y, ids, vals, 0, table.long(), prm)}[bad]
    with pytest.raises((ValueError, TypeError)):
        tsne_kernels.tsne_attraction(*args)


def test_kernel_source_notes_what_it_replaces():
    with open(tsne_kernels.source("tsne_attraction")) as f:
        text = f.read()
    assert "sph_tpu/models/tsne.py::_attractive_forces" in text
    assert "What bounds it: bytes" in text
    assert "tsne_attraction" in tsne_kernels.KERNELS


# ---------------------------------------------------------------------------
# the grid tier on both packages' defaults
# ---------------------------------------------------------------------------

def _grid_pair(defaults):
    """Both computations on the grid tier (forced: the scene has 900
    points) with the packing each package's default gives it there."""
    defaults.setenv("SPH_TSNE_GRID", "1")
    data = create_hyperspectral_scene(30, 30, 16, seed=7).reshape(-1, 16)
    params = J.TsneParameters()
    params.perplexity = 5.0
    tj = J.TsneComputation(params, use_pallas=False)
    tj.set_neighbor_graph(*jknn.knn_bruteforce(data, 16))
    tj._ensure_p()
    p = tj._p
    n = p.num_rows
    init = random_disk_init(n, 0.1, seed=0)
    tj.set_initial_embedding(init)
    tj._init_gradient_descent()
    tt = ttsne.TsneComputation(T.TsneParameters(), device="cpu")
    tt.set_probability_distribution(T.SparseRows(p.indices, p.values, n,
                                                  device="cpu"))
    tt.set_initial_embedding(init)
    tt._init_gradient_descent()
    return tj, tt


@pytest.mark.parametrize("start", [0, 245])
def test_grid_tier_defaults_ten_iterations_step_by_step(defaults, start):
    """No SPH_TSNE_ATTR_PACKED: both packages pack on the grid tier.
    Before each step the port takes the JAX state; each step within 1e-5
    of the scale (tests/test_torch_grid_tsne.py's bound), and the KL."""
    tj, tt = _grid_pair(defaults)
    assert tj._attr_packed and tt.attr_packed and tt.tier == "grid"
    if start:
        tj.continue_gradient_descent(start)
    for _ in range(10):
        s = tj._state
        tt._y = torch.tensor(np.array(s.embedding))
        tt._vel = torch.tensor(np.array(s.velocity))
        tt._gain = torch.tensor(np.array(s.gain))
        tt._iteration = s.iteration
        assert tt._current_grid() == tj._current_grid()
        tt.continue_gradient_descent(1)
        tj.continue_gradient_descent(1)
        s = tj._state
        for got, ref in ((tt._y, s.embedding), (tt._vel, s.velocity),
                         (tt._gain, s.gain)):
            ref = np.asarray(ref)
            scale = float(np.abs(ref).max())
            assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    kl_j, kl_t = tj.kl_divergence(), tt.kl_divergence()
    assert abs(kl_t - kl_j) <= 1e-5 * kl_j


@pytest.mark.parametrize("env,tier,packed", [
    ({}, "dense", False), ({"SPH_TSNE_DENSE_P": "0"}, "exact", False),
    ({"SPH_TSNE_GRID": "1"}, "grid", True),
    ({"SPH_TSNE_GRID": "1", "SPH_TSNE_ATTR_PACKED": "0"}, "grid", False),
    ({"SPH_TSNE_DENSE_P": "0", "SPH_TSNE_ATTR_PACKED": "1"}, "exact", True)])
def test_packing_switch_read_as_the_jax_package_reads_it(defaults, env, tier,
                                                         packed):
    for name, value in env.items():
        defaults.setenv(name, value)
    tj, tt = _pair_small()
    assert tt.tier == tier and tt.attr_packed == packed
    assert bool(tj._attr_packed) == packed


def _pair_small():
    data = create_hyperspectral_scene(8, 8, 8, seed=3).reshape(-1, 8)
    graph = jknn.knn_bruteforce(data, 8)
    tj = J.TsneComputation(use_pallas=False)
    tj.set_neighbor_graph(*graph)
    tj._init_gradient_descent()
    tt = ttsne.TsneComputation(device="cpu")
    tt.set_neighbor_graph(*graph)
    tt._init_gradient_descent()
    return tj, tt


# ---------------------------------------------------------------------------
# UMAP's rows tier on both packages' defaults
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _blobs(n):
    centers = np.array([[0, 0, 0], [14, 0, 0], [0, 14, 0], [9, 9, 9]])
    pos, _ = create_3d_gaussians(n, random_state=9, centers=centers)
    return jknn.knn_bruteforce(pos, 15)


@pytest.mark.parametrize("n,width,budget", [
    (600, "128", "64"),     # the JAX defaults; zero pad rows to 1024
    (600, "8", "64"),       # per-slot draws
    (1024, "16", "32"),     # a power of two: no pad rows in the box
])
def test_rows_tier_defaults_match_epoch_by_epoch(defaults, n, width, budget):
    """SPH_UMAP_PACKED unset: both packages pack the rows tier's two
    gathers.  30 epochs of a 200-epoch schedule, the port taking the JAX
    state before each; each layout within 5e-5 of the scale (the unpacked
    rows test's bound in tests/test_torch_umap.py) and the schedule bit
    for bit."""
    idx, dist = _blobs(n)
    defaults.setenv("SPH_UMAP_DENSE_MAX", "100")
    defaults.setenv("SPH_UMAP_ROWS_WIDTH", width)
    defaults.setenv("SPH_UMAP_NEG_BUDGET", budget)
    init = (np.random.default_rng(7).standard_normal((n, 2))
            * 10).astype(np.float32)
    uj = jumap.UmapComputation(jumap.UmapParameters(num_epochs=200, seed=3))
    ut = tumap.UmapComputation(tumap.UmapParameters(num_epochs=200, seed=3),
                               device="cpu")
    for u in (uj, ut):
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
    assert uj._tier == ut.tier == "rows"
    assert ut._pads == (uj._npad > n)
    w = ut._next_sample.shape[1]
    for _ in range(30):
        ut._y = torch.tensor(np.asarray(uj._y)[:n])
        ut._next_sample = torch.tensor(np.asarray(uj._next_sample)[:n, :w])
        ut.current_epoch = uj.current_epoch
        uj.run_for_epochs(1)
        ut.run_for_epochs(1)
        want = np.asarray(uj._y)[:n]
        assert np.abs(ut._y.numpy() - want).max() <= 5e-5 * np.abs(
            want).max()
        assert np.array_equal(np.asarray(uj._next_sample)[:n, :w],
                              ut._next_sample.numpy())
    assert ut.packed and ut.current_epoch == 30


def test_rows_tier_packing_moves_the_epoch(defaults):
    """Three epochs packed and float32 from one state (epoch 0 moves
    nothing: no edge is due yet) differ by the table's quantisation, a few
    of its steps; SPH_UMAP_PACKED=0 gives the float32 ones."""
    idx, dist = _blobs(600)
    defaults.setenv("SPH_UMAP_DENSE_MAX", "100")
    init = (np.random.default_rng(7).standard_normal((600, 2))
            * 10).astype(np.float32)
    out = {}
    for packed in ("1", "0"):
        defaults.setenv("SPH_UMAP_PACKED", packed)
        u = tumap.UmapComputation(
            tumap.UmapParameters(num_epochs=200, seed=3), device="cpu")
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
        u.run_for_epochs(3)
        assert u.packed == (packed == "1")
        out[packed] = u._y.numpy()
    step = float(np.ptp(init, 0).max()) / 65535.0
    diff = float(np.abs(out["1"] - out["0"]).max())
    assert 0.0 < diff <= 100 * step


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,width", [(20000, 64), (5000, 30), (4096, 1024)])
def test_attraction_cuda_kernel_matches_twin(n, width, packed):
    """The kernel against its twin on the card, within 1e-5 x max|attr|;
    two calls bit-equal; each window of rows bit-equal to the full call's
    rows (W = 30 takes the one-entry-a-lane form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    idx, val = _sparse_p(n, width, seed=n)
    y = torch.from_numpy(_layout(n, n, seed=n + 1)).cuda()
    ids, vals = torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda()
    table = prm = None
    if packed:
        table, prm = pack_positions(y[:, 0], y[:, 1])
    before = tsne_kernels.tsne_attraction.launches
    got = tsne_kernels.tsne_attraction(y, ids, vals, 0, table, prm)
    again = tsne_kernels.tsne_attraction(y, ids, vals, 0, table, prm)
    want = tsne_kernels.tsne_attraction_reference(y, ids, vals, 0, table,
                                                  prm)
    torch.cuda.synchronize()
    assert tsne_kernels.tsne_attraction.launches == before + 2
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)
    half = n // 2
    for r0, r1 in ((0, half), (half, n)):
        part = tsne_kernels.tsne_attraction(
            y, ids[r0:r1].contiguous(), vals[r0:r1].contiguous(), r0, table,
            prm)
        assert torch.equal(part, got[r0:r1])
    with pytest.raises(TypeError):
        tsne_kernels.tsne_attraction(y, ids.long(), vals, 0, table, prm)
