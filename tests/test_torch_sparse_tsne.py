"""The exact sparse-P t-SNE tier of the PyTorch port against the JAX package.

Covers the slice that runs t-SNE from a kNN graph: the plain twin of the
``tsne_repulsion`` kernel against the JAX package's Pallas kernel (interpret
mode on the CPU) and its XLA repulsion, the sparse attraction, ten
iterations of the exact tier step by step, the tier choice, P from a kNN
graph with the whole ``compute_tsne`` run, and the bounded-memory kNN.  The
CUDA kernel itself is held against the twin by the tests marked ``cuda``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
import sph_tpu.ops.pallas.tsne_kernels as jax_kernels
import sph_tpu_torch as T
from sph_tpu.models import tsne as jtsne
from sph_tpu.ops import knn as jknn
from sph_tpu.ops.math import random_disk_init
from sph_tpu_torch.models import tsne as ttsne
from sph_tpu_torch.ops import knn as tknn
from sph_tpu_torch.ops.graph import ensure_self_first
from sph_tpu_torch.ops.tsne_kernels import (tsne_repulsion,
                                            tsne_repulsion_reference,
                                            tsne_repulsion_rows)
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene

TIER_ENV = ("SPH_TSNE_DENSE_P", "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_GRID",
            "SPH_TSNE_GRID_MIN", "SPH_TSNE_P_WIDTH_CAP",
            "SPH_TSNE_ATTR_FUSE_MAX", "SPH_TSNE_ATTR_PACKED",
            "SPH_TSNE_USE_PALLAS")


@pytest.fixture
def clean_env(monkeypatch):
    for name in TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def jax_exact_tier(clean_env):
    """The JAX package's exact tier with its Pallas repulsion in interpret
    mode (the compiled kernel exists only on a TPU)."""
    clean_env.setattr(jax_kernels, "tsne_repulsion", functools.partial(
        jax_kernels.tsne_repulsion, interpret=True))
    clean_env.setenv("SPH_TSNE_DENSE_P", "0")
    return clean_env


def _y(n, npad, seed, garbage=False):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((npad, 2)).astype(np.float32) * 50 if garbage
         else np.zeros((npad, 2), np.float32))
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5
    return y


# ---------------------------------------------------------------------------
# the twin of tsne_repulsion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("n,npad,block", [(200, 256, 128), (640, 1024, 512)])
def test_repulsion_twin_matches_pallas_and_xla(n, npad, block, garbage):
    y = _y(n, npad, seed=n, garbage=garbage)
    rep_p, z_p = jax_kernels.tsne_repulsion(
        jnp.asarray(y), jnp.int32(n), row_block=block, col_block=block,
        interpret=True)
    rep, z = tsne_repulsion(torch.from_numpy(y), n)   # CPU: the twin
    rep = rep.numpy()
    rep_x, z_x = jtsne._repulsive_forces(jnp.asarray(y), jnp.int32(n), block)
    for rep_ref, z_ref in ((np.asarray(rep_p), float(z_p)),
                           (np.asarray(rep_x), float(z_x))):
        assert np.isclose(float(z), z_ref, rtol=1e-5)
        scale = float(np.abs(rep_ref[:n]).max())
        assert np.abs(rep[:n] - rep_ref[:n]).max() <= 1e-5 * scale
    assert np.all(rep[n:] == 0)


def test_repulsion_twin_rows_match_the_full_result():
    n, npad = 300, 384
    y = torch.from_numpy(_y(n, npad, seed=9, garbage=True))
    rep, zrow = tsne_repulsion_reference(y, n)
    for r0, r1 in ((0, 64), (150, 299), (290, 384), (320, 384)):
        rep_r, zrow_r = tsne_repulsion_reference(y, n, rows=(r0, r1))
        assert torch.equal(rep_r, rep[r0:r1])
        assert torch.equal(zrow_r, zrow[r0:r1])
    # small row blocks give the same rows too
    rep_b, zrow_b = tsne_repulsion_reference(y, n, max_elements=1000)
    assert torch.allclose(rep_b, rep, rtol=0, atol=1e-6 * float(
        rep.abs().max())) and torch.allclose(zrow_b, zrow, rtol=1e-6)
    assert torch.all(zrow[n:] == 0)


def test_repulsion_cpu_tensor_takes_twin_and_counts_no_launch():
    y = torch.from_numpy(_y(50, 64, seed=1))
    before = tsne_repulsion.launches
    rep, zrow = tsne_repulsion_rows(y, 50)
    rep_r, zrow_r = tsne_repulsion_reference(y, 50)
    assert tsne_repulsion.launches == before
    assert torch.equal(rep, rep_r) and torch.equal(zrow, zrow_r)


@pytest.mark.parametrize("bad", ["shape", "dtype", "n_valid", "rows"])
def test_repulsion_rejects_what_the_kernel_does_not_take(bad):
    y, n, rows = torch.zeros((64, 2)), 10, None
    if bad == "shape":
        y = torch.zeros((64, 3))
    elif bad == "dtype":
        y = y.double()
    elif bad == "n_valid":
        n = 65
    else:
        rows = (10, 70)
    with pytest.raises((ValueError, TypeError)):
        if rows is None:
            tsne_repulsion(y, n)
        tsne_repulsion_reference(y, n, rows=rows)


# ---------------------------------------------------------------------------
# the sparse attraction
# ---------------------------------------------------------------------------

def _sparse_p(n, width, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, n, (n, width)), 1).astype(np.int32)
    idx[:, -3:] = -1                                   # pads at the row ends
    val = np.where(idx >= 0, rng.random((n, width)), 0).astype(np.float32)
    return idx, val / val.sum()


@pytest.mark.parametrize("n,width,fuse_max", [(512, 16, None),
                                              (776, 24, 4096)])
def test_attractive_forces_match(clean_env, n, width, fuse_max):
    """Fused, and in row pieces: the JAX package's SPH_TSNE_ATTR_FUSE_MAX
    below n x width sends its gather down its row-chunked path, and the
    port's threshold, lowered the same way, cuts its rows into pieces of
    64."""
    if fuse_max:
        clean_env.setenv("SPH_TSNE_ATTR_FUSE_MAX", str(fuse_max))
        clean_env.setattr(ttsne, "ATTR_FUSE_MAX", fuse_max)
        clean_env.setattr(ttsne, "ATTR_PIECE", 64 * width)
        assert ttsne._row_chunk(n, width) == 64
    idx, val = _sparse_p(n, width, seed=n)
    y = _y(n, n, seed=n + 1)
    ref = np.asarray(jtsne._attractive_forces(
        jnp.asarray(y), jnp.asarray(idx), jnp.asarray(val)))
    got = ttsne.attractive_forces(torch.from_numpy(y),
                                  torch.from_numpy(idx.astype(np.int64)),
                                  torch.from_numpy(val)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * float(np.abs(ref).max())


# ---------------------------------------------------------------------------
# the exact sparse tier, step by step
# ---------------------------------------------------------------------------

def _knn_p(rows=32, cols=20):
    """The JAX package's P from the k = 16 kNN graph of a seeded scene, at
    perplexity 5 (a P without such structure, as uniformly random
    neighbours, collapses the embedding to 0 under early exaggeration)."""
    data = create_hyperspectral_scene(rows, cols, 16, seed=7).reshape(-1, 16)
    params = J.TsneParameters()
    params.perplexity = 5.0
    t = J.TsneComputation(params, use_pallas=False)
    t.set_neighbor_graph(*jknn.knn_bruteforce(data, 16))
    t._ensure_p()
    return t._p


@pytest.mark.parametrize("start", [0, 245])
def test_exact_tier_ten_iterations_step_by_step(jax_exact_tier, start):
    """n = 640: block 512, Npad 1024, SPH_TSNE_DENSE_P=0 on both sides.
    Before each step the port takes the JAX state (see test_torch_tsne.py
    for why free-running trajectories part)."""
    p = _knn_p()
    n = p.num_rows
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
    assert not tj._use_dense_p and not tj._use_grid and tj._use_pallas_eff
    assert tt.tier == "exact" and tt._npad == tj._npad == 1024
    assert tt._p_dense is None
    if start:
        tj.continue_gradient_descent(start)
    for _ in range(10):
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
        assert tt._iteration == s.iteration


# ---------------------------------------------------------------------------
# tier choice
# ---------------------------------------------------------------------------

TIER_CASES = [
    (5000, {}), (32768, {}), (32769, {}), (1_000_000, {}),
    (40000, {"SPH_TSNE_GRID": "0"}),
    (1_000_000, {"SPH_TSNE_GRID": "0"}),
    (5000, {"SPH_TSNE_DENSE_P": "0"}),
    (5000, {"SPH_TSNE_GRID": "1"}),
    (40000, {"SPH_TSNE_GRID": "0", "SPH_TSNE_DENSE_P": "1"}),
    (20000, {"SPH_TSNE_DENSE_P_MAX": "10000"}),
    (20000, {"SPH_TSNE_GRID_MIN": "10000"}),
    (20000, {"SPH_TSNE_GRID_MIN": "10000", "SPH_TSNE_GRID": "0",
             "SPH_TSNE_DENSE_P": "0"}),
    (50000, {"SPH_TSNE_GRID_MIN": "100000", "SPH_TSNE_DENSE_P_MAX": "60000"}),
]


class _Stop(Exception):
    pass


def _raise_stop(*args, **kwargs):
    raise _Stop


@pytest.mark.parametrize("n,env", TIER_CASES)
def test_tier_choice_matches_jax(clean_env, n, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    # the JAX package's own choice: its _init_gradient_descent sets the tier
    # and then pads with _ceil_to, where it is stopped before any state
    t = J.TsneComputation(use_pallas=True)
    t.set_probability_distribution(J.SparseRows(
        np.full((n, 1), -1, np.int32), np.zeros((n, 1), np.float32), n))
    clean_env.setattr(jtsne, "_ceil_to", _raise_stop)
    with pytest.raises(_Stop):
        t._init_gradient_descent()
    expected = ("grid" if t._use_grid else
                "dense" if t._use_dense_p else "exact")
    assert ttsne.select_tier(n) == expected


def test_grid_tier_raises_and_grid_off_takes_the_exact_tier(clean_env):
    """Above 32768 points the default is the grid tier (it raised until it
    was ported); SPH_TSNE_GRID=0 takes the exact tier."""
    n = ttsne.DENSE_P_MAX + 1
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    p = T.SparseRows(idx, np.full((n, 2), 0.5, np.float32), n, device="cpu")
    tt = ttsne.TsneComputation(device="cpu")
    tt.set_probability_distribution(p)
    tt.compute(1)
    assert tt.tier == "grid" and tt.grid_history == [(0, 128)]
    assert tt._npad == ttsne.sparse_npad(n) and tt._p_dense is None
    clean_env.setenv("SPH_TSNE_GRID", "0")
    tt._init_gradient_descent()
    assert tt.tier == "exact" and tt._npad == ttsne.sparse_npad(n)
    assert tt._npad % 512 == 0 and tt._p_dense is None


# ---------------------------------------------------------------------------
# t-SNE from a kNN graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_knn():
    img = create_hyperspectral_scene(24, 24, 16, seed=7)
    data = img.reshape(-1, 16)
    idx, dist = jknn.knn_bruteforce(data, 16)
    return idx, dist


def test_p_from_knn_graph_matches(scene_knn):
    idx, dist = scene_knn
    params_j, params_t = J.TsneParameters(), T.TsneParameters()
    params_j.perplexity = params_t.perplexity = 5.0
    tj = J.TsneComputation(params_j, use_pallas=False)
    tj.set_neighbor_graph(idx, dist)
    tj._ensure_p()
    tt = ttsne.TsneComputation(params_t, device="cpu")
    tt.set_neighbor_graph(idx, dist)
    tt._ensure_p()
    pj, pt = tj._p.to_dense(), tt._p.to_dense()
    assert np.array_equal(pj != 0, pt != 0)
    assert np.abs(pj - pt).max() <= 1e-6
    assert np.abs(pt - pt.T).max() == 0


def test_p_width_cap_while_packing_matches_topk_rows(scene_knn):
    """The width cap applied as the symmetrized rows are packed keeps what
    the JAX package's topk_rows keeps from the full rows."""
    from sph_tpu.ops.sparse import symmetrize_tsne as j_sym, topk_rows as j_top
    from sph_tpu_torch.ops.sparse import symmetrize_tsne, topk_rows
    idx, dist = scene_knn
    params = J.TsneParameters()
    params.perplexity = 5.0
    tj = J.TsneComputation(params, use_pallas=False)
    tj.set_neighbor_graph(idx, dist)
    tj._ensure_p()
    full = tj._p
    rows = T.SparseRows(full.indices, full.values, full.num_cols,
                        device="cpu")
    cap = 12
    assert full.width > cap
    capped = symmetrize_tsne(rows, max_width=cap)
    assert capped.width == cap
    ref = topk_rows(symmetrize_tsne(rows), cap)
    assert torch.equal(capped.idx, ref.idx) and torch.equal(capped.val,
                                                            ref.val)
    assert np.array_equal(capped.to_dense(), j_top(j_sym(full), cap)
                          .to_dense())


def test_compute_tsne_from_knn_graph_kl_within_one_percent(clean_env,
                                                           scene_knn):
    """The whole facade on the exact tier from the same kNN graph, against
    the JAX package's exact tier on the CPU (its XLA repulsion).

    Compared after 1000 iterations, not 250: at the end of early
    exaggeration a change of 2e-7 in the initial layout moves either
    package's KL by up to 3 % (1.981-2.040 for the JAX package over six
    such changes), so one run against another says nothing at 1 %; after
    1000 iterations the same six runs agree within 0.5 %."""
    clean_env.setenv("SPH_TSNE_DENSE_P", "0")
    out = []
    threads = torch.get_num_threads()
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        es = P.ComputeEmbeddingSettings()
        es.tsne.num_iterations = 1000
        es.tsne.perplexity = 5.0
        ce = P.ComputeEmbedding(es, **kw)
        # 4000 small torch ops: one thread each keeps parallel test
        # workers from stalling one another's thread pools
        torch.set_num_threads(1)
        try:
            emb = ce.compute_tsne(scene_knn, track_kl=True)
        finally:
            torch.set_num_threads(threads)
        assert emb.shape == (576, 2) and np.all(np.isfinite(emb))
        out.append(ce)
    kl_j, kl_t = out[0].last_kl, out[1].last_kl
    assert abs(kl_t - kl_j) <= 0.01 * kl_j
    assert set(out[1].seconds) == {"set_up", "iterations", "kl"}


# ---------------------------------------------------------------------------
# the kNN in bounded memory
# ---------------------------------------------------------------------------

def _full_row_sort_knn(data, k, metric):
    """The port's kNN before the repair: each block of query rows scored
    against all columns, whole rows stable-sorted."""
    base = torch.from_numpy(tknn._prepare(data, metric))
    sq = tknn.row_dot(base, base)
    ip = base @ base.T
    n = base.shape[0]
    if metric == T.KnnMetric.L2:
        dist = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * ip, min=0.0)
    elif metric == T.KnnMetric.COSINE:
        dist = torch.clamp(2.0 - 2.0 * ip, min=0.0)
    else:
        dist = -ip
    if metric != T.KnnMetric.INNER_PRODUCT:
        dist = torch.where(torch.eye(n, dtype=torch.bool), 0.0, dist)
    sd, si = torch.sort(dist, dim=1, stable=True)
    return si[:, :k].numpy().astype(np.int32), sd[:, :k].numpy()


def _dup_data():
    """Points on a half-integer grid, so that every product and distance is
    exact in float32 whatever the summation order and many distances tie,
    with exact duplicates whose copies straddle 128-column blocks and a
    block of zero vectors (ties at distance 0 and, for the inner product,
    at -0.0)."""
    r = np.random.default_rng(5)
    data = r.integers(0, 4, (400, 12)).astype(np.float32) * 0.5
    for src, dsts in ((3, (120, 127, 128, 129, 255, 256, 390)),
                      (200, (60, 130, 131, 399))):
        data[list(dsts)] = data[src]
    data[300:306] = 0.0
    return data


@pytest.mark.parametrize("budget", [tknn.KNN_MEMORY_BUDGET, 8 * 400 * 16])
def test_knn_matches_jax_streaming_and_full_row_sort(budget):
    data = _dup_data()
    if budget < tknn.KNN_MEMORY_BUDGET:
        assert tknn.knn_row_block(400, budget) == 16
    ij, dj = jknn.knn_bruteforce(data, 16, col_block=128)
    it, dt = tknn.knn_bruteforce(data, 16, device="cpu",
                                 memory_budget=budget)
    assert np.array_equal(ij, it)
    assert np.allclose(dt, dj, rtol=1e-6, atol=0)
    assert {3, 120, 127, 128, 129, 255, 256, 390} <= set(it[3].tolist())
    i_old, d_old = _full_row_sort_knn(data, 16, T.KnnMetric.L2)
    i_old, _, _ = ensure_self_first(i_old, d_old)
    assert np.array_equal(it, i_old)


@pytest.mark.parametrize("metric", [T.KnnMetric.INNER_PRODUCT,
                                    T.KnnMetric.COSINE, T.KnnMetric.L2])
def test_knn_rows_keep_the_full_row_sort_results(metric):
    """The selection at a small row block against the whole-row stable sort
    it replaces, for every metric (raw rows, before self-first)."""
    data = _dup_data()
    base = torch.from_numpy(tknn._prepare(data, metric))
    rows = torch.arange(400)
    i_new, d_new = tknn._knn_rows(base, rows, 16, metric, True,
                                  memory_budget=8 * 400 * 8)
    i_old, d_old = _full_row_sort_knn(data, 16, metric)
    assert np.array_equal(i_new.numpy(), i_old)
    d_old = torch.from_numpy(d_old)
    if metric != T.KnnMetric.INNER_PRODUCT:
        d_old = torch.where(d_old <= tknn._F32_EPS, 0.0, d_old)
        if metric == T.KnnMetric.COSINE:
            d_old = tknn.sqrt(d_old)
    assert torch.equal(d_new, d_old)


@pytest.mark.parametrize("budget,tied_block", [(8 * 400 * 8, 1),
                                               (8 * 400 * 24, 3)])
@pytest.mark.parametrize("metric", [T.KnnMetric.INNER_PRODUCT,
                                    T.KnnMetric.L2])
def test_knn_tied_rows_keyed_in_sub_blocks(metric, budget, tied_block):
    """A zero background ties every row of a block at the k-th distance;
    those rows are keyed whole in sub-blocks from the budget, and the
    result stays that of the whole-row stable sort."""
    data = _dup_data()
    data[100:400] = 0.0
    assert tknn.knn_tied_block(400, budget) == tied_block
    base = torch.from_numpy(tknn._prepare(data, metric))
    i_new, _ = tknn._knn_rows(base, torch.arange(400), 16, metric, True,
                              memory_budget=budget)
    i_old, _ = _full_row_sort_knn(data, 16, metric)
    assert np.array_equal(i_new.numpy(), i_old)


def test_knn_key_orders_like_the_floats():
    d = torch.tensor([[0.5, -0.0, 0.0, -2.0, 1e-30, -1e-30, 3.0, -0.0]])
    cols = torch.arange(d.shape[1])[None, :]
    order = torch.sort(tknn._keys(d, cols), dim=1).values & 0xFFFFFFFF
    assert order.tolist() == [[3, 5, 1, 2, 7, 4, 0, 6]]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n,npad", [(1000, 1024), (5000, 5120)])
def test_repulsion_cuda_kernel_matches_twin(n, npad):
    _need_card()
    y = torch.from_numpy(_y(n, npad, seed=5, garbage=True)).cuda()
    before = tsne_repulsion.launches
    rep, zrow = tsne_repulsion_rows(y, n)
    rep_r, zrow_r = tsne_repulsion_reference(y, n)
    torch.cuda.synchronize()
    assert tsne_repulsion.launches == before + 1
    assert torch.allclose(zrow, zrow_r, rtol=1e-5, atol=0)
    scale = float(rep_r.abs().max())
    assert float((rep - rep_r).abs().max()) <= 1e-5 * scale
    assert torch.all(rep[n:] == 0) and torch.all(zrow[n:] == 0)


@pytest.mark.cuda
def test_kl_on_the_card_takes_z_from_the_kernel():
    _need_card()
    p = _knn_p(20, 15)
    tt = ttsne.TsneComputation(device="cuda")
    tt.set_probability_distribution(T.SparseRows(p.indices, p.values, 300,
                                                  device="cuda"))
    assert tt.tier is None
    tt._init_gradient_descent()
    before = tsne_repulsion.launches
    kl = tt.kl_divergence()
    assert tsne_repulsion.launches == before + 1
    y = tt._y.cpu()
    kl_cpu = ttsne.tsne_kl_divergence(y, tt._p_idx.cpu(), tt._p_val.cpu(),
                                      300)
    assert tt.tier == "dense"
    assert np.isclose(kl, float(kl_cpu), rtol=1e-4)
