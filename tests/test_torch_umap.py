"""UMAP in the PyTorch port against the JAX package.

jax's threefry split and randint (the rows tier's negatives), the smooth-knn
memberships, the fuzzy union, and the dense and rows optimizer tiers epoch
by epoch (the port takes the JAX state before each epoch: free-running SGD
trajectories part within a few epochs), then ComputeEmbedding.compute_umap
end to end on the 8x8 fingerprint scene.  The JAX side runs its rows tier
with float32 gathers (SPH_UMAP_PACKED=0), the only ones the port has.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.models import umap as jumap
from sph_tpu.ops import distributions as jdist
from sph_tpu.ops import sparse as jsparse
from sph_tpu.ops.knn import knn_bruteforce
from sph_tpu.utils.testdata import create_3d_gaussians
import sph_tpu_torch as T
from sph_tpu_torch.models import umap as tumap
from sph_tpu_torch.ops import distributions as tdist
from sph_tpu_torch.ops import rng
from sph_tpu_torch.ops import sparse as tsparse

CPU = torch.device("cpu")
UMAP_ENV = ("SPH_UMAP_DENSE_MAX", "SPH_UMAP_ROWS_WIDTH", "SPH_UMAP_NEG_BUDGET",
            "SPH_UMAP_EDGE_PATH", "SPH_UMAP_DISPATCH_BUDGET")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small torch ops: one thread each keeps parallel test
    workers from stalling one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def umap_env(monkeypatch):
    for name in UMAP_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPH_UMAP_PACKED", "0")
    return monkeypatch


@pytest.fixture(scope="module")
def blobs():
    """Four 3-D Gaussian blobs and their k = 15 kNN graph (the fixture of
    tests/test_umap_anchor.py)."""
    centers = np.array([[0, 0, 0], [14, 0, 0], [0, 14, 0], [9, 9, 9]])
    pos, _ = create_3d_gaussians(600, random_state=9, centers=centers)
    idx, dist = knn_bruteforce(pos, 15)
    return pos, idx, dist


# ---------------------------------------------------------------------------
# the random numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 123456, 2 ** 31 - 1])
def test_split_is_bit_equal_to_jax(seed):
    key = jax.random.PRNGKey(seed)
    for num in (2, 3, 5):
        got = rng.split(rng.prng_key(seed), num)
        want = [tuple(int(v) for v in k)
                for k in np.asarray(jax.random.split(key, num))]
        assert got == want


@pytest.mark.parametrize("shape,lo,hi", [
    ((37, 64), 0, 5358),         # the rows tier at Pines level 1
    ((8, 3), 0, 7),
    ((100,), 3, 70000),          # a span above 2^16: the high word drops out
    ((5, 5), 0, 65536),
    ((4, 4), 0, 1),
    ((6,), 0, 2 ** 31 - 1),
    ((3, 2), 5, 5),              # an empty span returns minval
])
@pytest.mark.parametrize("epoch", [0, 499])
def test_randint_is_bit_equal_to_jax(shape, lo, hi, epoch):
    key = jax.random.fold_in(jax.random.PRNGKey(123456), epoch)
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    got = rng.randint(rng.fold_in(rng.prng_key(123456), epoch), shape, lo,
                      hi, CPU)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_randint_with_a_traced_bound_as_the_rows_tier_draws():
    draw = jax.jit(lambda k, n: jax.random.randint(k, (9, 64), 0, n))
    want = np.asarray(draw(jax.random.fold_in(jax.random.PRNGKey(123456),
                                              jnp.int32(3)), jnp.int32(5358)))
    got = rng.randint(rng.fold_in(rng.prng_key(123456), 3), (9, 64), 0,
                      5358, CPU)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# memberships
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [15, 40])
def test_smooth_knn_distributions_bit_equal(blobs, k):
    """Bit for bit with XLA-CPU, at a width inside one 32-term sum window
    and across two; with a short row and zero distances."""
    pos, _, _ = blobs
    idx, dist = knn_bruteforce(pos, k)
    mask = np.ones_like(idx, bool)
    mask[:, 0] = False
    mask[5, 3:] = False
    dist[7, 1:4] = 0.0
    want = np.asarray(jdist.smooth_knn_distributions(jnp.asarray(dist),
                                                     jnp.asarray(mask)))
    got = tdist.smooth_knn_distributions(torch.from_numpy(dist),
                                         torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("row_norm", [False, True])
def test_umap_scheme_of_the_dispatcher(blobs, row_norm):
    """The UMAP branch of distance_rows_to_probabilities: memberships bit
    for bit; the row normalisation within 1e-6 (the JAX package takes that
    sum in numpy, in numpy's order)."""
    _, idx, dist = blobs
    want = jdist.distance_rows_to_probabilities(
        dist, np.ones(idx.shape, bool), J.NormalizationScheme.UMAP,
        ignore_first=True, umap_row_norm=row_norm)
    got = tdist.distance_rows_to_probabilities(
        torch.from_numpy(dist), torch.ones(idx.shape, dtype=torch.bool),
        T.NormalizationScheme.UMAP, ignore_first=True,
        umap_row_norm=row_norm).numpy()
    assert np.all(got[:, 0] == 0)
    if row_norm:
        assert np.abs(got - want).max() <= 1e-6
    else:
        assert np.array_equal(got, want)


def test_symmetrize_umap_bit_equal(blobs):
    _, idx, dist = blobs
    mask = np.ones_like(idx, bool)
    mask[:, 0] = False
    sims = np.array(jdist.smooth_knn_distributions(jnp.asarray(dist),
                                                   jnp.asarray(mask)))
    sims[3, 2] = 0.0                      # a zero entry is no entry
    idx_p = np.where(mask, idx, -1).astype(np.int32)
    want = jsparse.symmetrize_umap(J.SparseRows(idx_p, sims, 600))
    got = tsparse.symmetrize_umap(T.SparseRows(idx_p, sims, 600, device=CPU))
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.values, want.values)


# ---------------------------------------------------------------------------
# the optimizer tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier,width,budget", [
    ("dense", "128", "64"),
    ("rows", "128", "64"),    # the JAX defaults: 64 budgeted negatives a row
    ("rows", "8", "64"),      # 8 slots x 5 < 64: per-slot draws
    ("rows", "16", "32"),     # a row cut to 16 strongest edges, budget 32
])
def test_tiers_match_epoch_by_epoch(umap_env, blobs, tier, width, budget):
    """30 epochs of a 200-epoch schedule from one kNN graph and initial
    layout.  Before each epoch the port takes the JAX state; each epoch's
    layout within 5e-5 of the scale (measured up to 1.04e-5: float32 pow
    differs between XLA and torch) and its schedule bit for bit."""
    _, idx, dist = blobs
    umap_env.setenv("SPH_UMAP_DENSE_MAX", "4096" if tier == "dense" else "100")
    umap_env.setenv("SPH_UMAP_ROWS_WIDTH", width)
    umap_env.setenv("SPH_UMAP_NEG_BUDGET", budget)
    init = (np.random.default_rng(7).standard_normal((600, 2))
            * 10).astype(np.float32)
    uj = jumap.UmapComputation(jumap.UmapParameters(num_epochs=200, seed=3))
    ut = tumap.UmapComputation(tumap.UmapParameters(num_epochs=200, seed=3),
                               device="cpu")
    for u in (uj, ut):
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
    assert uj._tier == ut.tier == tier
    w = ut._next_sample.shape[1]
    assert np.array_equal(np.asarray(uj._next_sample)[:600, :w],
                          ut._next_sample.numpy())
    for _ in range(30):
        ut._y = torch.tensor(np.asarray(uj._y)[:600])
        ut._next_sample = torch.tensor(np.asarray(uj._next_sample)[:600, :w])
        ut.current_epoch = uj.current_epoch
        uj.run_for_epochs(1)
        ut.run_for_epochs(1)
        want = np.asarray(uj._y)[:600]
        assert np.abs(ut._y.numpy() - want).max() <= 5e-5 * np.abs(
            want).max()
        assert np.array_equal(np.asarray(uj._next_sample)[:600, :w],
                              ut._next_sample.numpy())
    assert ut.current_epoch == uj.current_epoch == 30


def test_incremental_calls_run_the_same_epochs(umap_env, blobs):
    """run_for_epochs in pieces (the JAX package's masked fixed-length
    dispatches) gives the layout of one call: keys and schedule follow the
    absolute epoch."""
    _, idx, dist = blobs
    umap_env.setenv("SPH_UMAP_DENSE_MAX", "100")
    init = (np.random.default_rng(8).standard_normal((600, 2))
            * 10).astype(np.float32)
    out = []
    for pieces in ((12,), (3, 5, 4)):
        u = tumap.UmapComputation(tumap.UmapParameters(num_epochs=50, seed=1),
                                  device="cpu")
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
        for p in pieces:
            u.run_for_epochs(p)
        out.append((u.embedding, u.current_epoch))
    assert out[0][1] == out[1][1] == 12
    assert np.array_equal(out[0][0], out[1][0])


def test_ab_epochs_and_schedule_match():
    assert tumap.find_ab(1.0, 0.1) == jumap.find_ab(1.0, 0.1)
    assert [tumap.choose_num_epochs(r, n) for r, n in
            ((-1, 500), (-1, 20000), (300, 5))] == [500, 200, 300]
    w = np.random.default_rng(2).random(50)
    w[3] = 0.0
    assert np.array_equal(tumap.make_epochs_per_sample(w, 500),
                          jumap.make_epochs_per_sample(w, 500))


@pytest.mark.parametrize("env", [{"SPH_UMAP_EDGE_PATH": "1"},
                                 {"SPH_UMAP_PACKED": "1"}])
def test_unported_umap_paths_raise(umap_env, blobs, env):
    for name, value in env.items():
        umap_env.setenv(name, value)
    u = tumap.UmapComputation(device="cpu")
    u.set_neighbor_graph(*blobs[1:])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        u.compute()


def _fingerprint(pkg, size=8, norm=None, **kw):
    from sph_tpu.utils.testdata import create_checker_image
    img = create_checker_image(size, size, channels=4, block=2, noise=0.02)
    data = pkg.scale(pkg.ImageStack.from_array(img).data,
                     pkg.Scaler.STANDARD)
    ihs = pkg.ImageHierarchySettings()
    if norm is not None:
        ihs.norm_knn_distances = getattr(pkg.NormalizationScheme, norm)
    return pkg.ComputeHierarchy(**kw).init(
        data, size, size, ihs=ihs,
        lss=pkg.LevelSimilaritiesSettings(ks=[8]),
        rws=pkg.RandomWalkSettings(num_random_walks=10,
                                   single_walk_length=5, random_seed=1),
        nns=pkg.NearestNeighborsSettings(num_nearest_neighbors=8)).compute()


@pytest.mark.parametrize("size,levels", [(8, [64, 19, 2, 1]),
                                         (16, [256, 46, 8, 1])])
def test_hierarchy_on_umap_memberships(size, levels):
    """The data level normalised with the UMAP scheme (smooth-knn rows,
    row-normalized for the walks, as the JAX package's ImageHierarchy asks
    for): the same levels as the JAX package's."""
    chj = _fingerprint(J, size, "UMAP")
    cht = _fingerprint(T, size, "UMAP", device="cpu")
    assert (cht.image_hierarchy.hierarchy.num_components
            == chj.image_hierarchy.hierarchy.num_components == levels)


@pytest.mark.parametrize("epochs", [10, 500])
def test_compute_umap_end_to_end_on_the_fingerprint(umap_env, epochs):
    """Level 1 of the 8x8 fingerprint ([64, 19, 2, 1]) embedded by both
    packages' ComputeEmbedding.compute_umap on the dense tier, from the same
    initial layout (the spectral init's signs follow ARPACK's random
    start).  A 10-epoch schedule ends within 1e-4 of the scale; over 500
    epochs at 19 points the float32 trajectories part (as t-SNE's do), so
    the full schedule is held to a finite layout of the same spread."""
    chj, cht = _fingerprint(J), _fingerprint(T, device="cpu")
    assert cht.image_hierarchy.hierarchy.num_components == [64, 19, 2, 1]
    init = (np.random.default_rng(4).standard_normal((19, 2))
            * 5).astype(np.float32)
    out = []
    for pkg, ch, kw in ((J, chj, {}), (T, cht, {"device": "cpu"})):
        es = pkg.ComputeEmbeddingSettings()
        es.umap.num_epochs = epochs
        ce = pkg.ComputeEmbedding(es, **kw)
        ce.init_embedding(19, init)
        out.append(ce.compute_umap(ch.level_similarities.get_prob_dist(1)))
    emb_j, emb_t = out
    assert emb_t.shape == (19, 2) and np.all(np.isfinite(emb_t))
    assert ce.last_computation.tier == "dense"
    assert set(ce.seconds) == {"set_up", "epochs"}
    if epochs == 10:
        assert np.abs(emb_t - emb_j).max() <= 1e-4 * np.abs(emb_j).max()
    else:
        spread_j, spread_t = emb_j.std(0).mean(), emb_t.std(0).mean()
        assert 0.5 * spread_j <= spread_t <= 2.0 * spread_j


def test_compute_umap_from_a_knn_graph_with_spectral_init(umap_env, blobs):
    """No initial layout given: the spectral init; the rows tier keeps the
    blobs apart (a 12-NN trustworthiness above 0.9, as the JAX package's
    anchor test asks of its optimizer)."""
    from sklearn.manifold import trustworthiness
    pos, idx, dist = blobs
    umap_env.setenv("SPH_UMAP_DENSE_MAX", "100")
    es = T.ComputeEmbeddingSettings()
    es.umap.num_epochs = 200
    ce = T.ComputeEmbedding(es, device="cpu")
    emb = ce.compute_umap((idx, dist))
    assert ce.last_computation.tier == "rows" and emb.shape == (600, 2)
    assert set(ce.seconds) == {"set_up", "epochs"}
    assert trustworthiness(pos, emb, n_neighbors=12) > 0.9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["dense", "rows"])
def test_umap_epochs_on_the_card_match_the_cpu(umap_env, blobs, tier):
    """Ten epochs on the card, each from the CPU's state before it (free
    trajectories part within a few epochs): the same draws (threefry on
    int64 words) and the same schedule; each layout within 5e-5 of its
    scale (sums in other orders, the card's pow)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, idx, dist = blobs
    umap_env.setenv("SPH_UMAP_DENSE_MAX", "4096" if tier == "dense" else "100")
    init = (np.random.default_rng(7).standard_normal((600, 2))
            * 10).astype(np.float32)
    us = []
    for dev in ("cpu", "cuda"):
        u = tumap.UmapComputation(tumap.UmapParameters(num_epochs=200,
                                                       seed=3), device=dev)
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
        us.append(u)
    uc, ug = us
    for _ in range(10):
        ug._y = uc._y.cuda()
        ug._next_sample = uc._next_sample.cuda()
        ug.current_epoch = uc.current_epoch
        uc.run_for_epochs(1)
        ug.run_for_epochs(1)
        want = uc._y.numpy()
        assert np.abs(ug._y.cpu().numpy() - want).max() <= 5e-5 * np.abs(
            want).max()
        assert torch.equal(ug._next_sample.cpu(), uc._next_sample)
