"""The port's LZ4 codec, archives and stage cache against the JAX
package's: equal LZ4 bytes, archives either package writes read by the
other, the cache's parameter JSON byte-equal with its refusals (stale
settings, version, parent chain), and ComputeHierarchy with an active cache
run twice on a 16x16 scene, the second run loading all three stages."""

import json
import os

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu import native as jnative
from sph_tpu.utils import cache as jcache
from sph_tpu.utils import fileio as jfio
import sph_tpu_torch as T
from sph_tpu_torch import native as tnative
from sph_tpu_torch.utils import cache as tcache
from sph_tpu_torch.utils import fileio as tfio
from test_torch_reference_native import use_reference_native

use_reference_native()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small torch ops: one thread each keeps parallel test
    workers from stalling one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(3)
    if kind == "empty":
        return b""
    if kind == "random":
        return rng.integers(0, 256, 100_003, dtype=np.uint8).tobytes()
    if kind == "repetitive":
        return (b"superpixel hierarchy " * 9000)[:180_001]
    # float32 labels and distances: what the caches hold
    return np.sort(rng.random(50_000).astype(np.float32)).tobytes()


@pytest.mark.parametrize("kind", ["empty", "random", "repetitive", "floats"])
def test_lz4_bytes_equal_to_the_jax_package(kind):
    raw = _payload(kind)
    comp = tnative.lz4_compress(raw)
    assert comp == jnative.lz4_compress(raw)
    assert tnative.lz4_compress_bound(len(raw)) == int(
        jnative.get_lib().lz4_compress_bound(len(raw)))
    assert tnative.lz4_decompress(comp, len(raw)) == raw


def test_lz4_decompress_raises_on_a_corrupt_block():
    raw = _payload("repetitive")
    comp = bytearray(tnative.lz4_compress(raw))
    with pytest.raises(ValueError, match="corrupt"):
        tnative.lz4_decompress(bytes(comp[:len(comp) // 2]), len(raw))


def _graphs():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 40, (40, 6)).astype(np.int32)
    idx[:, 0] = np.arange(40)
    dist = np.sort(rng.random((40, 6)).astype(np.float32), axis=1)
    dist[:, 0] = 0.0
    counts = rng.integers(1, 7, 40).astype(np.int32)
    return idx, dist, counts


def _write_read(pkg_fio, kind, path, obj=None):
    """Write (obj given) or read an archive of `kind` with one package."""
    if kind == "vec":
        return (pkg_fio.write_compressed_vec(path, obj) if obj is not None
                else pkg_fio.read_compressed_vec(path))
    if kind == "vec_of_vec":
        return (pkg_fio.write_compressed_vec_of_vec(path, obj)
                if obj is not None
                else pkg_fio.read_compressed_vec_of_vec(path))
    if kind == "dict":
        return (pkg_fio.write_dict(path, obj) if obj is not None
                else pkg_fio.read_dict(path))
    raise ValueError(kind)


def _objects():
    rng = np.random.default_rng(7)
    return {
        "vec": rng.random(3001).astype(np.float32),
        "vec_of_vec": [np.arange(n, dtype=np.int64) * 3 for n in (0, 5, 17)],
        "dict": {"a": rng.integers(0, 9, (7, 3)).astype(np.int32),
                 "b": rng.random((4,)).astype(np.float32),
                 "c": np.array([12])},
    }


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    return np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("chunk", [None, "1000"])
@pytest.mark.parametrize("kind", ["vec", "vec_of_vec", "dict"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_archives_read_across_packages(tmp_path, monkeypatch, writer, kind,
                                       chunk):
    """One package writes, both read equal; the files are byte-equal (one
    chunk, or many of 1000 bytes)."""
    if chunk:
        monkeypatch.setenv("SPH_FILEIO_CHUNK", chunk)
    obj = _objects()[kind]
    mine, other = (tfio, jfio) if writer == "port" else (jfio, tfio)
    _write_read(mine, kind, str(tmp_path / "a.sph4"), obj)
    _write_read(other, kind, str(tmp_path / "b.sph4"), obj)
    for reader in (tfio, jfio):
        assert _equal(obj, _write_read(reader, kind, str(tmp_path / "a.sph4")))
    assert (tmp_path / "a.sph4").read_bytes() == (
        tmp_path / "b.sph4").read_bytes()


def test_graph_and_sparse_row_archives_read_across_packages(tmp_path):
    idx, dist, counts = _graphs()
    tfio.write_knn_graph(str(tmp_path / "k"), T.KnnGraph(idx, dist))
    g = jfio.read_knn_graph(str(tmp_path / "k"))
    assert np.array_equal(g.indices, idx) and np.array_equal(g.distances,
                                                             dist)
    jfio.write_padded_graph(str(tmp_path / "p"),
                            J.PaddedGraph(idx, dist, counts))
    g = tfio.read_padded_graph(str(tmp_path / "p"))
    assert (np.array_equal(g.indices, idx) and np.array_equal(g.counts,
                                                              counts))
    rows = T.SparseRows(idx, dist, 40, device="cpu")
    tfio.write_sparse_rows(str(tmp_path / "s"), rows)
    back = jfio.read_sparse_rows(str(tmp_path / "s"))
    assert back.num_cols == 40
    assert np.array_equal(back.indices, rows.indices)
    assert np.array_equal(back.values, rows.values)
    again = tfio.read_sparse_rows(str(tmp_path / "s"), device="cpu")
    assert np.array_equal(again.values, rows.values)


def test_zlib_archives_of_the_jax_package_read(tmp_path, monkeypatch):
    """Without its native library the JAX package writes codec 0 (zlib);
    the port reads those archives."""
    monkeypatch.setattr(jnative, "lz4_compress", lambda raw: None)
    obj = _objects()["dict"]
    jfio.write_dict(str(tmp_path / "z.sph4"), obj)
    with open(tmp_path / "z.sph4", "rb") as f:
        assert f.read(9)[8] == 0          # the codec byte
    assert _equal(obj, tfio.read_dict(str(tmp_path / "z.sph4")))


def _knn_settings(P, k=8):
    return P.NearestNeighborsSettings(num_nearest_neighbors=k,
                                      symmetric_neighbors=True)


def test_stage_cache_parameter_json_byte_equal(tmp_path):
    payload = {"x": np.arange(5)}
    for P, mod, sub in ((T, tcache, "t"), (J, jcache, "j")):
        c = mod.StageCache(str(tmp_path / sub), "scene")
        settings = (P.ImageHierarchySettings(), P.RandomWalkSettings())
        c.write("ihs", settings, payload)
        c.write("nns", _knn_settings(P), payload)
    for stage in ("ihs", "nns"):
        name = f"scene_{stage}_params.json"
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()


def test_stage_cache_refuses_stale_settings_and_versions(tmp_path):
    c = tcache.StageCache(str(tmp_path), "scene")
    c.write("nns", _knn_settings(T), {"x": np.arange(3)})
    assert not c.loaded("nns")       # written, not loaded
    assert c.load("nns", _knn_settings(T, k=9)) is None
    assert not c.loaded("nns")
    got = c.load("nns", _knn_settings(T))
    assert np.array_equal(got["x"], np.arange(3)) and c.loaded("nns")
    params = tmp_path / "scene_nns_params.json"
    stored = json.loads(params.read_text())
    stored["## VERSION ##"] = "0.9"
    params.write_text(json.dumps(stored))
    assert c.load("nns", _knn_settings(T)) is None


def test_stage_cache_parent_chain(tmp_path):
    """A child stage loads only after its parent loaded; a parent written
    afresh invalidates it."""
    c = tcache.StageCache(str(tmp_path), "scene")
    ihs = (T.ImageHierarchySettings(), T.RandomWalkSettings())
    c.write("nns", _knn_settings(T), {"x": np.arange(2)})
    c.write("ihs", ihs, {"y": np.arange(2)})
    assert c.load("ihs", ihs, depends_on="nns") is None
    assert c.load("nns", _knn_settings(T)) is not None
    assert c.load("ihs", ihs, depends_on="nns") is not None
    c.write("nns", _knn_settings(T), {"x": np.arange(2)})
    assert c.load("ihs", ihs, depends_on="nns") is None
    c.mark("nns", True)
    assert c.load("ihs", ihs, depends_on="nns") is not None


# ---------------------------------------------------------------------------
# ComputeHierarchy with an active cache
# ---------------------------------------------------------------------------

SIDE = 16


def _hierarchy(P, cache_dir, knn_dir=None, **kw):
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(SIDE, SIDE, 6, seed=3)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.NONE)
    cache = P.CacheSettings(path=str(cache_dir), file_name="scene",
                            cache_active=True)
    knn = (None if knn_dir is None else P.CacheSettings(
        path=str(knn_dir), file_name="scene", cache_active=True))
    ch = P.ComputeHierarchy(**kw).init(
        data, SIDE, SIDE,
        ihs=P.ImageHierarchySettings(
            component_sim=P.ComponentSim.NEIGH_WALKS, min_reduction=98.0),
        lss=P.LevelSimilaritiesSettings(
            component_sim=P.ComponentSim.NEIGH_WALKS, ks=[16],
            compute_symmetric_prob_dist=P.NormalizationScheme.TSNE),
        rws=P.RandomWalkSettings(num_random_walks=20, single_walk_length=6,
                                 random_seed=1),
        nns=P.NearestNeighborsSettings(
            num_nearest_neighbors=16, symmetric_neighbors=True,
            neighbor_connect_components=True),
        cache=cache, knn_cache=knn)
    return ch.compute()


def _dense_probdists(ch):
    ls = ch.level_similarities
    return [ls.get_prob_dist(i).to_dense()
            for i in range(ch.image_hierarchy.hierarchy.num_levels)]


def _loaded(ch, stages=("nns", "ihs", "lss")):
    return [bool(ch._cache._loaded_ok.get(s)) for s in stages]


@pytest.fixture(scope="module")
def cached_runs(tmp_path_factory):
    """The port run twice on one cache, and the JAX package once on its
    own."""
    root = tmp_path_factory.mktemp("cache")
    first = _hierarchy(T, root / "port", device="cpu")
    second = _hierarchy(T, root / "port", device="cpu")
    jax_run = _hierarchy(J, root / "jax")
    return root, first, second, jax_run


def test_second_run_loads_all_three_stages(cached_runs):
    _, first, second, _ = cached_runs
    assert _loaded(first) == [False, False, False]
    assert _loaded(second) == [True, True, True]
    assert second.knn_loaded_from_cache and not first.knn_loaded_from_cache
    h1 = first.image_hierarchy.hierarchy
    h2 = second.image_hierarchy.hierarchy
    assert h1.num_components == h2.num_components and h1.num_levels > 2
    for a, b in zip(h1.pixel_components, h2.pixel_components):
        assert np.array_equal(a, b)
    for a, b in zip(h1.not_merged, h2.not_merged):
        assert np.array_equal(a, b)
    assert h2.settings == h1.settings
    for a, b in zip(h1.random_walks, h2.random_walks):
        assert a.device.type == b.device.type == "cpu"
        assert np.array_equal(a.to_dense(), b.to_dense())
    # the connected-component labels go into the settings as after stage 1
    assert (second.image_hierarchy.component_labels is None) == (
        first.image_hierarchy.component_labels is None)
    assert second._ihs.min_num_comp == first._ihs.min_num_comp
    assert second.image_hierarchy.data_level_probdist.device.type == "cpu"


def test_cached_probdists_equal_the_first_run_and_the_jax_package(
        cached_runs):
    _, first, second, jax_run = cached_runs
    assert (jax_run.image_hierarchy.hierarchy.num_components
            == first.image_hierarchy.hierarchy.num_components)
    for a, b, c in zip(_dense_probdists(first), _dense_probdists(second),
                       _dense_probdists(jax_run)):
        assert np.array_equal(a, b)
        assert np.abs(a - c).max() <= 1e-6


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_caches_load_in_the_other_package(cached_runs, tmp_path, direction):
    """The JAX package's cache loads in the port and the port's in the
    JAX package: all three stages, with the writer's probdists."""
    import shutil
    root, first, _, jax_run = cached_runs
    src, writer = ((root / "jax", jax_run) if direction == "jax_to_port"
                   else (root / "port", first))
    shutil.copytree(src, tmp_path / "c")
    if direction == "jax_to_port":
        ch = _hierarchy(T, tmp_path / "c", device="cpu")
    else:
        ch = _hierarchy(J, tmp_path / "c")
    assert _loaded(ch) == [True, True, True]
    for a, b in zip(_dense_probdists(writer), _dense_probdists(ch)):
        assert np.array_equal(a, b)


def test_shared_knn_cache_mirrors_into_the_run_cache(tmp_path):
    """A separate kNN cache (run_evaluation's): a second run under a new run
    cache loads the kNN stage, and the run cache's later stages compute
    afresh; a third run on the same run cache loads everything."""
    a = _hierarchy(T, tmp_path / "run1", tmp_path / "knn", device="cpu")
    b = _hierarchy(T, tmp_path / "run2", tmp_path / "knn", device="cpu")
    c = _hierarchy(T, tmp_path / "run2", tmp_path / "knn", device="cpu")
    assert not a.knn_loaded_from_cache and _loaded(a) == [False] * 3
    assert b.knn_loaded_from_cache and _loaded(b) == [True, False, False]
    assert _loaded(c) == [True, True, True]
    assert not os.path.exists(tmp_path / "run1" / "scene_nns_params.json")
    for x, y in zip(_dense_probdists(a), _dense_probdists(c)):
        assert np.array_equal(x, y)
