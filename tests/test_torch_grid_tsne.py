"""The grid t-SNE tier of the PyTorch port against the JAX package.

``grid_repulsion`` (taps, scatter-add, FFT, gather) against the JAX
package's dense Lagrange-matmul form and against the exact repulsion; the
grid tier step by step and over 1000 iterations with the grid size picked
again at the JAX package's dispatch boundaries.  Both packages run the grid
tier with the float32 attraction gather (``SPH_TSNE_ATTR_PACKED=0``); the
packed default is held in tests/test_torch_packed.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.models import tsne as jtsne
from sph_tpu.ops import knn as jknn
from sph_tpu.ops import tsne_grid as jgrid
from sph_tpu.ops.math import random_disk_init
import sph_tpu_torch as T
from sph_tpu_torch.models import tsne as ttsne
from sph_tpu_torch.ops import tsne_grid as tgrid
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
from test_torch_reference_native import use_reference_native

use_reference_native()

TSNE_ENV = ("SPH_TSNE_DENSE_P", "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_GRID",
            "SPH_TSNE_GRID_MIN", "SPH_TSNE_GRID_MAX", "SPH_TSNE_P_WIDTH_CAP",
            "SPH_TSNE_GRID_P_WIDTH", "SPH_TSNE_ATTR_PACKED",
            "SPH_TSNE_DISPATCH_BUDGET", "SPH_TSNE_USE_PALLAS",
            "SPH_TSNE_ATTR_FUSE_MAX")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small torch ops: one thread each keeps parallel test
    workers from stalling one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def grid_env(monkeypatch):
    """Both packages on the grid tier with unpacked gathers."""
    for name in TSNE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPH_TSNE_GRID", "1")
    monkeypatch.setenv("SPH_TSNE_ATTR_PACKED", "0")
    return monkeypatch


def _layout(n, npad, seed, garbage=False):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((npad, 2)).astype(np.float32) * 50 if garbage
         else np.zeros((npad, 2), np.float32))
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5
    return y


@pytest.mark.parametrize("span", [0.0, 1.0, 10.0, 40.0, 41.0, 100.0, 356.0,
                                  357.0, 1e4])
@pytest.mark.parametrize("max_g", [256, 1024])
def test_pick_grid_size_matches(span, max_g):
    assert (tgrid.pick_grid_size(span, max_g=max_g)
            == jgrid.pick_grid_size(span, max_g=max_g))


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("grid", [128, 256])
def test_grid_repulsion_matches_jax(grid, garbage):
    """Taps, scatter-add and gather against the dense Lagrange matmuls:
    rep within 1e-4 x max|rep| and Z within 1e-5 relative (measured 8e-6
    and 1e-7; the two FFTs and sum orders differ)."""
    n, npad = 1500, 1536
    y = _layout(n, npad, seed=grid, garbage=garbage)
    rep_j, z_j = jgrid.grid_repulsion(jnp.asarray(y), jnp.int32(n), grid)
    rep_t, z_t = tgrid.grid_repulsion(torch.from_numpy(y), n, grid)
    rep_j, rep_t = np.asarray(rep_j), rep_t.numpy()
    assert np.abs(rep_t - rep_j).max() <= 1e-4 * np.abs(rep_j).max()
    assert abs(float(z_t) - float(z_j)) <= 1e-5 * float(z_j)
    assert np.all(rep_t[n:] == 0)


@pytest.mark.parametrize("grid,rep_bound,z_bound", [(128, 5e-3, 2e-4),
                                                    (256, 5e-4, 2e-5)])
def test_grid_interpolation_error_same_bound_for_both(grid, rep_bound,
                                                      z_bound):
    """Both packages against the exact repulsion, held to one bound: the
    cubic interpolation error (measured for both: 3.7e-3 and 1.1e-4 at
    G = 128, h = 0.24; 2.4e-4 and 7.5e-6 at G = 256, h = 0.12, the h^4
    fall of cubic interpolation)."""
    n, npad = 1500, 1536
    y = _layout(n, npad, seed=3)
    rep_e, z_e = jtsne._repulsive_forces(jnp.asarray(y), jnp.int32(n), 512)
    rep_e, z_e = np.asarray(rep_e), float(z_e)
    rep_j, z_j = jgrid.grid_repulsion(jnp.asarray(y), jnp.int32(n), grid)
    rep_t, z_t = tgrid.grid_repulsion(torch.from_numpy(y), n, grid)
    scale = np.abs(rep_e).max()
    for rep, z in ((np.asarray(rep_j), float(z_j)), (rep_t.numpy(),
                                                     float(z_t))):
        assert np.abs(rep - rep_e).max() <= rep_bound * scale
        assert abs(z - z_e) <= z_bound * z_e


def test_grid_repulsion_of_one_point_and_a_degenerate_box():
    """All points on one spot: the box's spacing is floored at 1e-6 and the
    force is 0; Z counts each other point once."""
    y = torch.zeros((8, 2))
    y[:5] = 0.25
    rep, z = tgrid.grid_repulsion(y, 5, 128)
    assert torch.allclose(rep, torch.zeros_like(rep), atol=1e-5)
    assert abs(float(z) - 20.0) <= 1e-4 * 20.0


# ---------------------------------------------------------------------------
# the grid tier
# ---------------------------------------------------------------------------

def _scene_graph(rows=30, cols=30):
    data = create_hyperspectral_scene(rows, cols, 16, seed=7).reshape(-1, 16)
    return jknn.knn_bruteforce(data, 16)


def _pair(graph):
    """The JAX package's P from the graph at perplexity 5, and both
    computations initialised on it from the same layout."""
    params = J.TsneParameters()
    params.perplexity = 5.0
    tj = J.TsneComputation(params, use_pallas=False)
    tj.set_neighbor_graph(*graph)
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


def test_grid_tier_caps_p_as_the_jax_package_does(grid_env):
    grid_env.setenv("SPH_TSNE_GRID_P_WIDTH", "12")
    tj, tt = _pair(_scene_graph())
    assert tj._use_grid and tt.tier == "grid"
    assert tt._npad == tj._npad == 1024 and tt._p_val.shape[1] == 12
    n = tt._n
    dense_j = J.SparseRows(np.asarray(tj._p_idx)[:n], np.asarray(
        tj._p_val)[:n], n).to_dense()
    dense_t = T.SparseRows(tt._p_idx[:n], tt._p_val[:n], n).to_dense()
    assert np.abs(dense_t - dense_j).max() <= 1e-6 * np.abs(dense_j).max()


@pytest.mark.parametrize("start", [0, 245])
def test_grid_tier_ten_iterations_step_by_step(grid_env, start):
    """Before each step the port takes the JAX state (free-running
    trajectories part, see test_torch_tsne.py); each step's result within
    1e-5 of the scale, the grid picked by each side from that state."""
    tj, tt = _pair(_scene_graph())
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


def _knn_sets(e, k=10):
    d = ((e[:, None, :] - e[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, 1)[:, :k]


def test_grid_tier_1000_iterations_with_grid_repicks(grid_env, monkeypatch):
    """The whole facade from one kNN graph, 1000 iterations on both
    packages, dispatch chunks of 16 iterations (SPH_TSNE_DISPATCH_BUDGET on
    the JAX side, the module constant here) and SPH_TSNE_GRID_MAX=256: the
    grid is picked at the same iterations with the same sizes (128, then
    256).  Layouts part point by point, so they are compared by their KL,
    their spans and their 10-NN sets.

    The margins come from the measured spread of the two free-running
    trajectories.  The JAX package's run is not reproducible from process
    to process under load: four identical runs side by side ended at KLs
    0.8596-0.8642, while the port's run ends at the same bits every time
    (0.86866), and the test workers run side by side.  Over 25 runs (scene
    seeds 1-8, the JAX package's native library on and off, alone and side
    by side) the port and the JAX package differed by at most 1.13 % in KL
    (0.52-1.13 % on this scene), 4.06 % in span and shared at least 0.803
    of their 10-NN sets.  So KL within 2.5 % and spans within 8 %, about
    twice the largest difference, and more than 3/4 of the 10-NN sets."""
    graph = _scene_graph()
    npad = ttsne.sparse_npad(graph[0].shape[0])
    grid_env.setenv("SPH_TSNE_GRID_MAX", "256")
    grid_env.setenv("SPH_TSNE_DISPATCH_BUDGET", str(16 * npad))
    monkeypatch.setattr(ttsne, "DISPATCH_BUDGET", 16 * npad)
    picks = []
    picked = J.TsneComputation._current_grid

    def record(self):
        g = picked(self)
        picks.append((self._state.iteration, g))
        return g

    monkeypatch.setattr(J.TsneComputation, "_current_grid", record)
    out = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        es = P.ComputeEmbeddingSettings()
        es.tsne.num_iterations = 1000
        es.tsne.perplexity = 5.0
        ce = P.ComputeEmbedding(es, **kw)
        emb = ce.compute_tsne(graph, track_kl=True)
        assert np.all(np.isfinite(emb))
        out.append((emb, ce))
    (emb_j, ce_j), (emb_t, ce_t) = out
    history = ce_t.last_computation.grid_history
    assert history == picks[:-1]               # the last is the KL's pick
    assert [it for it, _ in history[:6]] == [0, 16, 32, 48, 50, 66]
    assert {g for _, g in history} == {128, 256}
    assert abs(ce_t.last_kl - ce_j.last_kl) <= 0.025 * ce_j.last_kl
    span_j, span_t = np.ptp(emb_j, 0), np.ptp(emb_t, 0)
    assert np.all(np.abs(span_t - span_j) <= 0.08 * span_j)
    a, b = _knn_sets(emb_j), _knn_sets(emb_t)
    shared = np.mean([len(set(a[i]) & set(b[i])) for i in range(len(a))])
    assert shared / 10 > 0.75


def test_packed_gather_is_not_ported(grid_env):
    """Named when the packed gather raised; it is ported since.  With
    SPH_TSNE_ATTR_PACKED=1 the grid tier reads the neighbours from the u16
    table: five steps, the port taking the JAX state before each, each
    within 1e-5 of the scale (the step test's bound above)."""
    grid_env.setenv("SPH_TSNE_ATTR_PACKED", "1")
    tj, tt = _pair(_scene_graph(16, 16))
    assert tj._attr_packed and tt.attr_packed
    for _ in range(5):
        s = tj._state
        tt._y = torch.tensor(np.array(s.embedding))
        tt._vel = torch.tensor(np.array(s.velocity))
        tt._gain = torch.tensor(np.array(s.gain))
        tt._iteration = s.iteration
        tt.continue_gradient_descent(1)
        tj.continue_gradient_descent(1)
        ref = np.asarray(tj._state.embedding)
        assert np.abs(tt._y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("grid", [128, 1024])
def test_grid_repulsion_on_the_card_matches_the_cpu(grid):
    """The same torch ops on the card: cuFFT and atomic scatter-adds sum in
    other orders, so rep within 1e-4 x max|rep| (measured 1.4e-5 at
    G = 1024; the force is a difference of two large fields, y_i phi0 -
    phi_y, so their rounding shows) and Z within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, npad = 20000, 20480
    y = torch.from_numpy(_layout(n, npad, seed=grid, garbage=True))
    rep_c, z_c = tgrid.grid_repulsion(y, n, grid)
    rep_g, z_g = tgrid.grid_repulsion(y.cuda(), n, grid)
    scale = float(rep_c.abs().max())
    assert float((rep_g.cpu() - rep_c).abs().max()) <= 1e-4 * scale
    assert abs(float(z_g) - float(z_c)) <= 1e-5 * float(z_c)
    assert torch.all(rep_g[n:] == 0)
