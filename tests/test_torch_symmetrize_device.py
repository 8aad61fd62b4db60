"""The port's device-path symmetrizations against the JAX package's
``_symmetrize_p_device_dispatch`` on JAX-CPU, bit for bit: the t-SNE
average and the UMAP fuzzy union, with the row-width cap and the
reverse-entry cap biting (low SPH_SYM_FLAT_BUDGET, SPH_SYM_P_WIDTH_CAP and
SPH_SYM_WREV_MAX on a matrix with hub columns and tied values) and with
neither biting; the doubling loop's final reverse width; and which rows
the port's level similarities mark as the JAX package's device-resident
ones (the rule that picks the path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.ops import sparse as jsp
from sph_tpu.utils.logging import set_level as jset_level
import sph_tpu_torch as T
from sph_tpu_torch.ops import sparse as tsp
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
from test_torch_reference_native import use_reference_native

use_reference_native()

CPU = torch.device("cpu")
CAPS = ("SPH_SYM_FLAT_BUDGET", "SPH_SYM_P_WIDTH_CAP", "SPH_SYM_WREV_MAX")


@pytest.fixture(autouse=True)
def quiet_one_thread(monkeypatch):
    for name in CAPS:
        monkeypatch.delenv(name, raising=False)
    jset_level("WARNING")
    set_level("WARNING")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hub_rows(n: int, width: int, hubs: int, seed: int, ties: bool):
    """n rows of 1..width distinct ascending columns, about a third of them
    among `hubs` hub columns (so those columns' in-degree runs far past the
    rest), no self entry; values in (0, 1], quantized to eighths when
    `ties` so that equal values meet in one hub's reverse entries."""
    r = np.random.default_rng(seed)
    idx = np.full((n, width), -1, np.int32)
    val = np.zeros((n, width), np.float32)
    for i in range(n):
        m = int(r.integers(1, width + 1))
        pool = np.setdiff1d(np.arange(n), [i])
        hub = r.choice(np.setdiff1d(np.arange(hubs), [i]),
                       min(m // 3 + 1, hubs - 1), replace=False)
        rest = r.choice(np.setdiff1d(pool, hub), m - hub.size, replace=False)
        cols = np.sort(np.concatenate([hub, rest]))
        idx[i, :m] = cols
        v = r.random(m).astype(np.float32)
        if ties:
            v = np.ceil(v * 8.0).astype(np.float32) / 8.0
        val[i, :m] = v / v.sum() if not ties else v
    return idx, val


def jax_device(idx, val, mode: str):
    sr = jsp.SparseRows(jnp.asarray(idx), jnp.asarray(val), idx.shape[0])
    assert sr.device_only
    out = jsp._symmetrize_p_device_dispatch(sr, mode)
    return np.asarray(out.indices), np.asarray(out.values)


def assert_rows_equal(got: tsp.SparseRows, want_idx, want_val):
    """The port's rows (exact width) equal the JAX rows (bucketed width)
    bit for bit; the JAX package's extra columns are padding."""
    w = got.width
    assert w <= want_idx.shape[1]
    assert np.array_equal(got.indices, want_idx[:, :w])
    assert np.array_equal(got.values.view(np.int32),
                          want_val[:, :w].view(np.int32))
    assert (want_idx[:, w:] == -1).all() and (want_val[:, w:] == 0).all()


def in_degree(idx, val) -> np.ndarray:
    ok = (idx >= 0) & (val != 0)
    return np.bincount(idx[ok], minlength=idx.shape[0])


@pytest.mark.parametrize("mode", ["tsne", "umap"])
@pytest.mark.parametrize("ties", [False, True])
def test_both_caps_bite(monkeypatch, mode, ties):
    """Width cap 8 over rows up to 12 wide (budget 1000 elements), reverse
    entries capped at 16 a row while the hubs take far more."""
    idx, val = hub_rows(300, 12, hubs=6, seed=3 + ties, ties=ties)
    monkeypatch.setenv("SPH_SYM_FLAT_BUDGET", "1000")
    monkeypatch.setenv("SPH_SYM_P_WIDTH_CAP", "8")
    monkeypatch.setenv("SPH_SYM_WREV_MAX", "16")
    assert in_degree(idx, val).max() > 16
    want = jax_device(idx, val, mode)
    rows = tsp.SparseRows(idx, val, 300, device=CPU)
    got = (tsp.symmetrize_tsne if mode == "tsne" else tsp.symmetrize_umap)(
        rows, device_path=True)
    assert_rows_equal(got, *want)
    # the caps did bite: fewer entries than the exact (host) union
    host = (tsp.symmetrize_tsne if mode == "tsne" else tsp.symmetrize_umap)(
        tsp.SparseRows(idx, val, 300, device=CPU))
    assert got.nnz() < host.nnz()


@pytest.mark.parametrize("mode", ["tsne", "umap"])
def test_reverse_cap_alone_bites(monkeypatch, mode):
    """The default width cap and budget, reverse entries capped at 32: hub
    rows shed only their faintest reverse entries."""
    idx, val = hub_rows(400, 16, hubs=4, seed=5, ties=True)
    monkeypatch.setenv("SPH_SYM_WREV_MAX", "32")
    want = jax_device(idx, val, mode)
    got = (tsp.symmetrize_tsne if mode == "tsne" else tsp.symmetrize_umap)(
        tsp.SparseRows(idx, val, 400, device=CPU), device_path=True)
    assert_rows_equal(got, *want)


@pytest.mark.parametrize("mode", ["tsne", "umap"])
def test_no_cap_bites(mode):
    """Default caps on a 600-row matrix: the device path is the exact union,
    equal to the JAX device path's; the port's host path has its entries
    and, for the union, values up to the one rounding of a * b that the
    device path fuses away (an ulp at most)."""
    idx, val = hub_rows(600, 10, hubs=40, seed=7, ties=False)
    assert in_degree(idx, val).max() <= 1024
    want = jax_device(idx, val, mode)
    sym = tsp.symmetrize_tsne if mode == "tsne" else tsp.symmetrize_umap
    got = sym(tsp.SparseRows(idx, val, 600, device=CPU), device_path=True)
    assert_rows_equal(got, *want)
    host = sym(tsp.SparseRows(idx, val, 600, device=CPU))
    assert np.array_equal(host.indices, got.indices)
    ulps = np.abs(host.values.view(np.int32).astype(np.int64)
                  - got.values.view(np.int32))
    assert ulps.max() <= (0 if mode == "tsne" else 1)


def test_host_union_differs_where_the_reverse_cap_bites(monkeypatch):
    """Before the device path, the port took the exact (host) union on such
    rows and counted more memberships than the JAX package's device path,
    as at Pines level 0 (2988314 against 2987706); the device path counts
    the JAX package's."""
    idx, val = hub_rows(300, 12, hubs=6, seed=11, ties=False)
    monkeypatch.setenv("SPH_SYM_WREV_MAX", "16")
    want_idx, _ = jax_device(idx, val, "umap")
    want = int((want_idx >= 0).sum())
    host = tsp.symmetrize_umap(tsp.SparseRows(idx, val, 300, device=CPU))
    dev = tsp.symmetrize_umap(tsp.SparseRows(idx, val, 300, device=CPU),
                              device_path=True)
    assert host.nnz() > want
    assert dev.nnz() == want


@pytest.mark.parametrize("n,width,max_in,cap,want", [
    (300, 12, 40, "16", 16),        # small bucket: starts at the cap
    (300, 12, 5, "", 512),          # default cap 1024 > the bucket's 512
    (5000, 20, 70, "", 128),        # start 64, one doubling
    (5000, 20, 10, "", 64),         # start 64, no loss
    (21025, 91, 2000, "", 1024),    # Pines level 0: doubles to the cap
    (21025, 91, 2000, "0", 2048),   # no cap: to the in-degree's width
])
def test_reverse_width_matches_the_doubling_loop(monkeypatch, n, width,
                                                 max_in, cap, want):
    if cap:
        monkeypatch.setenv("SPH_SYM_WREV_MAX", cap)
    assert tsp.reverse_width(n, width, max_in) == want


def test_reverse_width_equals_jax_on_hub_rows(monkeypatch):
    """The final width the JAX loop reaches (its result's width bound) and
    the port's rule agree where the cap stops the doubling at 64."""
    idx, val = hub_rows(3000, 8, hubs=3, seed=13, ties=False)
    monkeypatch.setenv("SPH_SYM_WREV_MAX", "64")
    assert in_degree(idx, val).max() > 64
    assert tsp.reverse_width(3000, 8, int(in_degree(idx, val).max())) == 64
    want = jax_device(idx, val, "umap")
    got = tsp.symmetrize_umap(tsp.SparseRows(idx, val, 3000, device=CPU),
                              device_path=True)
    assert_rows_equal(got, *want)


# ---------------------------------------------------------------------------
# which rows the JAX package holds on its device
# ---------------------------------------------------------------------------

RESIDENCY_CASES = [
    # (component sim, handling, pairwise walk sims, normalization)
    ("NEIGH_WALKS", "MERGE_RW_ONLY", True, "TSNE"),
    ("NEIGH_WALKS", "MERGE_RW_ONLY", False, "UMAP"),
    ("NEIGH_WALKS", "MERGE_RW_NEW_WALKS", False, "TSNE"),
    ("NEIGH_WALKS_SINGLE_OVERLAP", "MERGE_RW_NEW_WALKS_AND_KNN", True,
     "TSNE"),
    ("NEIGH_WALKS", "MERGE_DATA_NEW_WALKS", False, "TSNE"),
    ("NEIGH_OVERLAP", "MERGE_RW_ONLY", True, "TSNE"),
]


def _hierarchy(pkg, cs, handling, pair, norm, device_kw):
    img = create_hyperspectral_scene(20, 16, 8, seed=3)
    data = pkg.scale(pkg.ImageStack.from_array(img).data, pkg.Scaler.STANDARD)
    sim = getattr(pkg.ComponentSim, cs)
    ch = pkg.ComputeHierarchy(**device_kw).init(
        data, 20, 16,
        ihs=pkg.ImageHierarchySettings(
            component_sim=sim, rw_handling=getattr(pkg.RandomWalkHandling,
                                                   handling),
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_reduction=98.0),
        lss=pkg.LevelSimilaritiesSettings(
            component_sim=sim, ks=[16], random_walk_pair_sims=pair,
            normalize_prob_dist=getattr(pkg.NormalizationScheme, norm)),
        rws=pkg.RandomWalkSettings(num_random_walks=20, single_walk_length=8,
                                   random_seed=2),
        nns=pkg.NearestNeighborsSettings(num_nearest_neighbors=16))
    ch.compute()
    return ch


@pytest.mark.parametrize("case", RESIDENCY_CASES,
                         ids=["-".join(map(str, c)) for c in RESIDENCY_CASES])
def test_level_rows_marked_as_the_jax_package_holds_them(case):
    """Each level takes the device path (``LevelSimilarities.device_path``)
    exactly where the JAX package's rows are device-resident when it
    symmetrizes them, and the symmetrized rows then equal the JAX
    package's."""
    jch = _hierarchy(J, *case, {})
    tch = _hierarchy(T, *case, {"device": "cpu"})
    jls, tls = jch.level_similarities, tch.level_similarities
    want = [bool(p.device_only) for p in jls.prob_dists]
    got = [tls.device_path(level) for level in range(len(tls.prob_dists))]
    assert got == want
    assert want[0] is True
    mode = "tsne" if case[3] == "TSNE" else "umap"
    for level in (0, 1):
        jp, tp = jls.prob_dists[level], tls.prob_dists[level]
        js = (jsp.symmetrize_tsne if mode == "tsne"
              else jsp.symmetrize_umap)(jp)
        ts = (tsp.symmetrize_tsne if mode == "tsne"
              else tsp.symmetrize_umap)(tp,
                                        device_path=tls.device_path(level))
        assert ts.nnz() == int(((js.indices >= 0) & (js.values != 0)).sum())


def test_host_reads_do_not_change_the_path():
    """Reading a level's rows on the host (as a check or an export does)
    changes neither the level's path nor what the symmetrizations
    compute: the path is the level's, decided when its rows were made."""
    tch = _hierarchy(T, *RESIDENCY_CASES[0], {"device": "cpu"})
    tls = tch.level_similarities
    paths = list(tls.device_paths)
    p0 = tls.prob_dists[0]
    before = tsp.symmetrize_umap(p0, device_path=tls.device_path(0))
    p0.indices, p0.values, p0.to_dense()
    assert tls.device_paths == paths and tls.device_path(0)
    after = tsp.symmetrize_umap(p0, device_path=tls.device_path(0))
    assert torch.equal(before.idx, after.idx)
    assert torch.equal(before.val, after.val)
