"""The port's sharded paths (sph_tpu_torch.parallel) against the JAX
package's (sph_tpu.parallel) on the CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py,
the port's on ``[torch.device("cpu")] * 8``, eight logical shards.
Tolerances, each the bar of the JAX package's own tests where it has one:

- multi_scene_stage1: kNN ids equal; distances and probabilities within
  1e-6 relative (XLA-CPU and torch sum the products in other orders);
  walk rows bit-equal under CONSTANT weights (NORMAL ones sum a row's
  visits in another order, ROADMAP);
- multi_scene_hierarchy: every scene's levels equal;
- multi_scene_tsne after 60 iterations: within 1e-3 x max|y|
  (tests/test_parallel.py:102's run length);
- sharded_knn: ids equal;
- one step of the sharded exact and grid t-SNE: within 1e-5 and 1e-3 x
  max|y| of the JAX package's eight-shard step;
- sharded UMAP: each of 10 epochs from the JAX state and key within
  1e-4 x max|y| (the two packages' float32 pow differ in the last bit,
  and free-running SGD trajectories part within a few epochs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_tpu.parallel import mesh as jmesh
from sph_tpu.parallel import sharded as jsh
from sph_tpu.settings import (ImportanceWeighting, NormalizationScheme,
                              RandomWalkSettings)
from sph_tpu.utils.testdata import create_3d_gaussians, create_checker_image
import sph_tpu_torch as T
from sph_tpu_torch import parallel as tpar
from sph_tpu_torch.ops import rng
from sph_tpu_torch.ops import tsne_kernels
from sph_tpu_torch.parallel import mesh as tmesh
from sph_tpu_torch.parallel import sharded as tsh
from test_torch_reference_native import use_reference_native

use_reference_native()

CPU = torch.device("cpu")
MESH8 = [CPU] * 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene_batch(s=4, side=10, channels=6):
    """tests/test_parallel.py's scenes: checker images with noise."""
    return np.stack([
        create_checker_image(side, side, channels=channels, block=5,
                             noise=0.02, seed=100 + i
                             ).reshape(side * side, channels)
        for i in range(s)]).astype(np.float32), side, side


def _rws(weighting=ImportanceWeighting.CONSTANT):
    return RandomWalkSettings(num_random_walks=8, single_walk_length=4,
                              random_seed=3, importance_weighting=weighting)


def _trws(rws):
    return T.RandomWalkSettings(
        num_random_walks=rws.num_random_walks,
        single_walk_length=rws.single_walk_length,
        random_seed=rws.random_seed,
        importance_weighting=T.ImportanceWeighting(
            rws.importance_weighting.value))


def test_mesh_and_exports():
    import sph_tpu.parallel as J
    assert tpar.__all__ == J.__all__
    m = tmesh.as_mesh([CPU, CPU])
    assert m.size == 2 and m.axis_names == ("data",)
    x = torch.arange(12.0).reshape(6, 2)
    parts = tpar.shard_rows(m, x)
    assert [tuple(p.shape) for p in parts] == [(3, 2), (3, 2)]
    assert torch.equal(torch.cat(parts), x)
    assert all(torch.equal(r, x) for r in tpar.replicate(m, x))
    with pytest.raises(ValueError):
        tpar.shard_rows(m, torch.zeros(5, 2))


def test_no_card_raises_without_cpu_devices(monkeypatch):
    """make_mesh() and a mesh left to default need a card; a CPU mesh
    does not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    pos = np.random.default_rng(0).standard_normal((40, 3)).astype(
        np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.sharded_knn(pos, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.multi_scene_stage1(pos[None], 4, mesh=[torch.device("cuda")])
    assert tpar.sharded_knn(pos, 4, [CPU] * 2)[0].shape == (40, 4)


def _jax_umap_stage1(datas, k, rws):
    """The JAX function's UMAP branch, scene by scene outside shard_map:
    inside it, smooth_knn_distributions' scan carry is not cast to the
    mesh axis and jax refuses to trace it (ROADMAP).  The same functions
    on the same kNN rows, which do not depend on the normalisation."""
    from sph_tpu.ops.distributions import smooth_knn_distributions
    from sph_tpu.ops.walks import (_accumulate, _postprocess, _simulate,
                                   derive_prune_value)
    ref = jsh.multi_scene_stage1(datas, k, rws=None,
                                 norm=NormalizationScheme.TSNE)
    probs, widx, wval = [], [], []
    for i in range(datas.shape[0]):
        dist = jnp.asarray(ref["dist"][i])
        m2 = jnp.ones(dist.shape, bool).at[:, 0].set(False)
        p = smooth_knn_distributions(dist, m2)
        ps = jnp.sum(p, axis=1, keepdims=True)
        p = jnp.where(ps > 0, p / jnp.maximum(ps, 1e-38), 0.0)
        probs.append(np.asarray(p))
        if rws is None:
            continue
        w, length = rws.num_random_walks, rws.single_walk_length
        width = min(rws.max_row_nnz or min(w * length, 2048), w * length,
                    dist.shape[0])
        visited = _simulate(jnp.asarray(ref["idx"][i]), p,
                            jnp.uint32(rws.random_seed + i), w, length)
        a, b = _accumulate(visited, w, length,
                           rws.importance_weighting.value, width)
        a, b = _postprocess(a, b, jnp.float32(derive_prune_value(rws)),
                            rws.remove_diagonal, rws.normalize)
        widx.append(np.asarray(a))
        wval.append(np.asarray(b))
    ref["probs"] = np.stack(probs)
    if rws is not None:
        ref["walks_idx"], ref["walks_val"] = np.stack(widx), np.stack(wval)
    return ref


@pytest.mark.parametrize("norm", ["tsne", "linear", "umap"])
@pytest.mark.parametrize("walks", [True, False])
def test_multi_scene_stage1_matches(norm, walks):
    datas, _, _ = _scene_batch()
    k = 8
    rws = _rws() if walks else None
    jnorm = NormalizationScheme(norm)
    if norm == "umap":
        ref = _jax_umap_stage1(datas, k, rws)
    else:
        ref = jsh.multi_scene_stage1(datas, k, rws=rws, norm=jnorm)
    got = tsh.multi_scene_stage1(datas, k, rws=_trws(rws) if walks else None,
                                 norm=T.NormalizationScheme(norm),
                                 mesh=MESH8)
    assert np.array_equal(got["idx"], ref["idx"])
    for key in ("dist", "probs"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0)
    if walks:
        assert np.array_equal(got["walks_idx"], ref["walks_idx"])
        assert np.array_equal(got["walks_val"], ref["walks_val"])
    else:
        assert got["walks_idx"] is None and got["walks_val"] is None


def test_multi_scene_stage1_width_and_seeds():
    """The output width min(cap, w L, n) and the per-scene seeds
    seed_base + i: scene 1 under seed_base 5 is scene 0 under 6."""
    datas, _, _ = _scene_batch(s=2)
    rws = T.RandomWalkSettings(num_random_walks=40, single_walk_length=5,
                               random_seed=1,
                               importance_weighting=T.ImportanceWeighting
                               .CONSTANT)
    a = tsh.multi_scene_stage1(datas, 8, rws=rws, mesh=[CPU], seed_base=5)
    b = tsh.multi_scene_stage1(datas[1:], 8, rws=rws, mesh=[CPU],
                               seed_base=6)
    assert a["walks_idx"].shape == (2, 100, 100)
    assert np.array_equal(a["walks_idx"][1], b["walks_idx"][0])
    assert np.array_equal(a["walks_val"][1], b["walks_val"][0])


def _hier_settings(pkg, ks=8):
    ihs = pkg.ImageHierarchySettings(
        component_sim=pkg.ComponentSim.NEIGH_WALKS, merge_multiple=False,
        use_percentile=False)
    rws = pkg.RandomWalkSettings(
        num_random_walks=10, single_walk_length=5, random_seed=1,
        importance_weighting=pkg.ImportanceWeighting.CONSTANT)
    lss = pkg.LevelSimilaritiesSettings(
        component_sim=pkg.ComponentSim.NEIGH_WALKS, ks=[ks],
        random_walk_pair_sims=True,
        normalize_prob_dist=pkg.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=pkg.NormalizationScheme.TSNE)
    return ihs, rws, lss


def test_multi_scene_hierarchy_levels_match():
    import sph_tpu as J
    datas, rows, cols = _scene_batch()
    ihs, rws, lss = _hier_settings(J)
    ref = jsh.multi_scene_hierarchy(datas, rows, cols, k=8, ihs=ihs,
                                    rws=rws, lss=lss)
    ihs, rws, lss = _hier_settings(T)
    got = tsh.multi_scene_hierarchy(datas, rows, cols, 8, ihs=ihs, rws=rws,
                                    lss=lss, mesh=MESH8)
    assert len(got) == len(ref) == 4
    for (gih, gls), (rih, rls) in zip(got, ref):
        assert (list(gih.hierarchy.num_components)
                == list(rih.hierarchy.num_components))
        for lvl in range(gih.hierarchy.num_levels):
            assert gls.get_prob_dist(lvl).num_rows == (
                rls.get_prob_dist(lvl).num_rows)


def test_set_preparations_skips_the_walks(monkeypatch):
    """With a preset, compute() takes the given probabilities and walks and
    simulates none."""
    from sph_tpu_torch.models import image_hierarchy as tih
    datas, rows, cols = _scene_batch(s=1)
    _, rws, _ = _hier_settings(T)
    st = tsh.multi_scene_stage1(datas, 8, rws=rws, mesh=[CPU])
    g = T.KnnGraph(st["idx"][0], st["dist"][0])
    ih = T.ImageHierarchy(g, datas[0], rows, cols, device="cpu")
    ih.set_settings(_hier_settings(T)[0], rws)
    pd = T.SparseRows(np.where(st["probs"][0] > 0, st["idx"][0], -1),
                      st["probs"][0], rows * cols, device="cpu")
    walks = T.SparseRows(st["walks_idx"][0], st["walks_val"][0], rows * cols,
                         device="cpu")
    ih.set_preparations(pd, walks)
    calls = []
    monkeypatch.setattr(tih, "do_random_walks",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tih, "distance_rows_to_probabilities",
                        lambda *a, **k: calls.append(a))
    ih.compute()
    assert not calls
    assert ih.data_level_probdist is pd
    assert ih.hierarchy.random_walks[0] is walks


def _probdist(n=96, k=10, seed=3):
    """tests/test_parallel.py's probdist: a two-blob symmetric joint P."""
    from sph_tpu.ops.distributions import gaussian_row_distributions
    from sph_tpu.ops.knn import knn_bruteforce
    from sph_tpu.ops.sparse import SparseRows, symmetrize_tsne
    pos, labels = create_3d_gaussians(
        n, random_state=seed, centers=np.array([[0, 0, 0], [10, 0, 0]]))
    idx, dist = knn_bruteforce(pos, k)
    p = gaussian_row_distributions(jnp.asarray(dist ** 2),
                                   jnp.ones_like(idx, dtype=bool),
                                   jnp.float32(3.0), ignore_first=True)
    return symmetrize_tsne(SparseRows(idx.astype(np.int32), np.asarray(p),
                                      n)), labels


def test_multi_scene_tsne_matches_after_60_iterations():
    """Within 1e-3 x max|y| after 5 iterations, the window of
    tests/test_parallel.py's own trajectory comparison; the two packages'
    repulsions sum in other orders, and the gains' sign tests part the
    trajectories exponentially after that (measured on this P: 1.4e-6 apart
    after 1 iteration, 5.4e-4 after 5, 0.03 after 10, 20 after 20).  After
    60 iterations, tests/test_parallel.py:102's run, what the JAX test asks:
    finite layouts, and the seeds seed + i give scenes that differ."""
    p, _ = _probdist()
    s = 8                    # the JAX function shards scenes over 8 devices
    pi = np.stack([p.indices] * s)
    pv = np.stack([p.values] * s)
    ref = jsh.multi_scene_tsne(pi, pv, 5, jmesh.make_mesh())
    before = tsne_kernels.tsne_repulsion.launches
    got = tsh.multi_scene_tsne(pi, pv, 5, mesh=MESH8)
    assert tsne_kernels.tsne_repulsion.launches == before   # the twin
    assert got.shape == (s, 96, 2)
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= 1e-3 * scale
    embs = tsh.multi_scene_tsne(pi, pv, 60, mesh=MESH8)
    assert embs.shape == (s, 96, 2) and np.all(np.isfinite(embs))
    assert not np.allclose(embs[0], embs[1])


def test_multi_scene_tsne_scene_equals_a_one_scene_call():
    p, _ = _probdist()
    pi = np.stack([p.indices] * 3)
    pv = np.stack([p.values * (1 + i) for i in range(3)])
    batch = tsh.multi_scene_tsne(pi, pv, 30, mesh=[CPU])
    one = tsh.multi_scene_tsne(pi[2:], pv[2:], 30, mesh=[CPU], seed=2)
    assert np.array_equal(batch[2], one[0])


def test_sharded_knn_ids_match():
    pos, _ = create_3d_gaussians(300, random_state=2,
                                 centers=np.array([[0, 0, 0], [6, 6, 6]]))
    ji, jd = jsh.sharded_knn(pos, 8, jmesh.make_mesh())
    ti, td = tpar.sharded_knn(pos, 8, MESH8)
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)


def _one_step_inputs():
    from sph_tpu.models.tsne import TsneParameters, default_exaggeration
    from sph_tpu.ops.math import random_disk_init
    p, _ = _probdist()
    n = p.num_rows
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = [params.eta, params.momentum, params.final_momentum,
            params.mom_switching_iter, params.exaggeration_factor,
            params.remove_exaggeration_iter, params.exponential_decay_iter,
            params.minimum_gain]
    y0 = random_disk_init(n, 0.1, 0)
    pi = p.indices.astype(np.int32)
    pv = (p.values / p.values.sum()).astype(np.float32)
    return n, pvec, y0, pi, pv


@pytest.mark.parametrize("tier,rel", [("exact", 1e-5), ("grid", 1e-3)])
def test_sharded_tsne_step_matches(tier, rel):
    n, pvec, y0, pi, pv = _one_step_inputs()
    jm = jmesh.make_mesh()
    if tier == "exact":
        jstep = jsh.make_sharded_tsne_step(jm)
        tstep = tpar.make_sharded_tsne_step(MESH8)
    else:
        jstep = jsh.make_sharded_grid_tsne_step(jm, 32)
        tstep = tpar.make_sharded_grid_tsne_step(MESH8, 32)
    jz = np.zeros((n, 2), np.float32)
    jy, jv, jg = jstep(*(jmesh.shard_rows(jm, jnp.asarray(a)) for a in
                         (y0, jz, np.ones_like(jz), pi, pv)),
                       jnp.int32(n), jnp.asarray(pvec, jnp.float32),
                       jnp.int32(0))
    ty, tv, tg = tstep(*(tpar.shard_rows(MESH8, torch.as_tensor(a)) for a in
                         (y0, jz, np.ones_like(jz), pi.astype(np.int64),
                          pv)), n, pvec, 0)
    ty = torch.cat(ty).numpy()
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(ty - np.asarray(jy)).max() <= rel * scale
    assert np.array_equal(torch.cat(tg).numpy(), np.asarray(jg))


@pytest.mark.parametrize("entry", ["exact", "grid"])
def test_sharded_tsne_runs_and_separates(entry):
    p, labels = _probdist()
    if entry == "exact":
        emb = tpar.sharded_tsne(p.indices, p.values, 150, MESH8)
    else:
        emb = tpar.sharded_grid_tsne(p.indices, p.values, 150, MESH8,
                                     grid=32)
    assert emb.shape == (96, 2) and np.all(np.isfinite(emb))
    cents = np.stack([emb[labels == c].mean(0) for c in range(2)])
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[c],
                                    axis=1).mean() for c in range(2)])
    assert np.linalg.norm(cents[0] - cents[1]) / intra > 1.5


def _memberships(n=128):
    from sph_tpu.ops.distributions import smooth_knn_distributions
    from sph_tpu.ops.knn import knn_bruteforce
    from sph_tpu.ops.sparse import SparseRows, symmetrize_umap
    pos, lab = create_3d_gaussians(
        n, random_state=0, centers=np.array([[0, 0, 0], [8, 8, 8]]))
    idx, dist = knn_bruteforce(pos.astype(np.float32), 8)
    mask = np.ones_like(idx, bool)
    mask[:, 0] = False
    sims = np.asarray(smooth_knn_distributions(jnp.asarray(dist),
                                               jnp.asarray(mask)))
    rows = symmetrize_umap(SparseRows(
        np.where(mask, idx, -1).astype(np.int32), sims, len(pos)))
    return np.asarray(rows.indices), np.asarray(rows.values), lab


def test_sharded_umap_epochs_match_step_by_step():
    """Ten epochs, the port taking the JAX package's state and key before
    each, over eight shards of the edge list."""
    from sph_tpu.models.umap import find_ab
    mi, mv, _ = _memberships()
    n = mi.shape[0]
    mask = (mi >= 0) & (mv > 0)
    src = np.broadcast_to(np.arange(n)[:, None], mi.shape)[mask]
    dst = mi[mask]
    w = mv[mask]
    eps = (500 / (500 * w / w.max())).astype(np.float32)
    e = len(src)
    epad = -(-e // 8) * 8
    src_p, dst_p = np.pad(src, (0, epad - e)), np.pad(dst, (0, epad - e))
    eps_p = np.pad(eps, (0, epad - e))
    nxt = np.pad(eps, (0, epad - e), constant_values=np.inf)
    a, b = find_ab()
    y = np.random.default_rng(4).standard_normal((n, 2)).astype(
        np.float32) * 5
    jm = jmesh.make_mesh()
    jep = jsh.make_sharded_umap_epoch(jm)
    tep = tpar.make_sharded_umap_epoch(MESH8)
    key = jax.random.PRNGKey(7)
    shard = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(
        "data"))
    jargs = [jax.device_put(jnp.asarray(x), shard)
             for x in (src_p.astype(np.int32), dst_p.astype(np.int32),
                       eps_p)]
    targs = tsh._shard_tensors(MESH8, [src_p.astype(np.int64),
                                       dst_p.astype(np.int64), eps_p],
                               [torch.int64, torch.int64, torch.float32])
    jnxt = jax.device_put(jnp.asarray(nxt), shard)
    for ep in range(1, 11):
        alpha = 1.0 - ep / 500
        tnxt = tsh._shard_tensors(MESH8, [np.asarray(jnxt)],
                                  [torch.float32])[0]
        ty, tnxt = tep(torch.as_tensor(y), *targs, tnxt, ep, alpha, a, b,
                       rng.fold_in(rng.prng_key(7), ep), n)
        jy, jnxt = jep(jnp.asarray(y), *jargs, jnxt, jnp.float32(ep),
                       jnp.float32(alpha), jnp.float32(a), jnp.float32(b),
                       jax.random.fold_in(key, ep), jnp.int32(n))
        y = np.asarray(jy)
        assert np.abs(ty.numpy() - y).max() <= 1e-4 * np.abs(y).max()
        assert np.array_equal(torch.cat(tnxt).numpy(), np.asarray(jnxt))


def test_sharded_umap_finite_and_clustered():
    mi, mv, lab = _memberships()
    emb = tpar.sharded_umap(mi, mv, num_epochs=60, mesh=MESH8)
    assert emb.shape == (128, 2) and np.all(np.isfinite(emb))
    c0, c1 = emb[lab == 0].mean(0), emb[lab == 1].mean(0)
    spread0 = np.linalg.norm(emb[lab == 0] - c0, axis=1).mean()
    assert np.linalg.norm(c0 - c1) > spread0
    # one shard or eight: the same edges, other sums and negative streams
    emb1 = tpar.sharded_umap(mi, mv, num_epochs=60, mesh=[CPU])
    assert np.all(np.isfinite(emb1))
