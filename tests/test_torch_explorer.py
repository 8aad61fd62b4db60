"""The port's explorer (sph_tpu_torch.vis_interactive, .vis_server)
against the JAX package's on the CPU: the exported page byte for byte, and
every live endpoint's answer on the 10x10 checker of
tests/test_vis_server.py, with the error paths.

/api/walks re-runs the walks with NORMAL step weights.  The JAX package
sorts each row's visits with an unstable sort before summing their
weights, so its sums run in an order the port (a stable sort) does not
copy: the walk ids are equal and the values within 2e-6 (1e-7 apart
before rounding to 6 places).  Every other answer is equal."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.utils.logging import set_level as jset_level
from sph_tpu.vis_interactive import export_explorer as jexport
from sph_tpu.vis_server import ExplorerServer as JServer
import sph_tpu_torch as T
from sph_tpu_torch.utils.jscheck import check_js_syntax
from sph_tpu_torch.utils.logging import set_level
from sph_tpu_torch.utils.testdata import create_checker_image
from sph_tpu_torch.vis_interactive import export_explorer as texport
from sph_tpu_torch.vis_server import ExplorerServer as TServer
from test_torch_reference_native import use_reference_native

use_reference_native()


def checker(P, handling="merge_rw_only", **kw):
    """tests/test_vis_server.py's hierarchy: the 10x10 checker, NEIGH_WALKS
    with pair similarities, 10 walks of 5 steps, k = 8."""
    img = create_checker_image(10, 10, channels=4, block=5, noise=0.02)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
    return P.ComputeHierarchy(**kw).init(
        data, 10, 10,
        ihs=P.ImageHierarchySettings(
            component_sim=P.ComponentSim.NEIGH_WALKS,
            rw_handling=P.RandomWalkHandling(handling)),
        lss=P.LevelSimilaritiesSettings(
            component_sim=P.ComponentSim.NEIGH_WALKS, ks=[8],
            random_walk_pair_sims=True),
        rws=P.RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                                 random_seed=1),
        nns=P.NearestNeighborsSettings(num_nearest_neighbors=8)).compute()


@pytest.fixture(scope="module")
def pair():
    jset_level("WARNING")
    set_level("WARNING")
    jch, tch = checker(J), checker(T, device="cpu")
    assert (tch.image_hierarchy.hierarchy.num_components
            == jch.image_hierarchy.hierarchy.num_components)
    return jch, tch


@pytest.fixture(scope="module")
def served(pair):
    jch, tch = pair
    js, ts = JServer(jch), TServer(tch, device="cpu")
    urls = js.start(), ts.start()
    yield urls, ts
    js.stop()
    ts.stop()


def get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


@pytest.mark.parametrize("handling", ["merge_rw_only", "merge_rw_new_walks"])
def test_exported_page_byte_equal(handling, pair, tmp_path):
    """The static export with level 1's embedding, from both packages'
    hierarchies of the same settings; the embedded script passes the JAX
    package's JS checker."""
    if handling == "merge_rw_only":
        jch, tch = pair
    else:
        jch, tch = checker(J, handling), checker(T, handling, device="cpu")
    n = tch.image_hierarchy.hierarchy.num_components[1]
    emb = {1: np.random.default_rng(0).standard_normal(
        (n, 2)).astype(np.float32)}
    want = open(jexport(jch, emb, str(tmp_path / "j.html")), "rb").read()
    got = open(texport(tch, emb, str(tmp_path / "t.html")), "rb").read()
    assert got == want
    html = got.decode()
    assert check_js_syntax(html.split("<script>")[1].split(
        "</script>")[0]) > 100
    data = json.loads(html.split("const DATA = ")[1].split(";\n")[0])
    assert data["levels"]["1"]["walks"] and data["levels"]["1"]["edges"]


@pytest.mark.parametrize("path", [
    "", "api/meta", "api/knn?level=0&k=8", "api/knn?level=1&k=4",
    "api/knn?level=1&k=2", "api/knn?level=2&k=99",
    "api/path?level=1&a=0&b=3&k=6", "api/path?level=0&a=0&b=99",
    "api/path?level=1&a=2&b=2"])
def test_endpoint_equal(path, served):
    (uj, ut), _ = served
    want, got = get(uj + path), get(ut + path)
    assert got[0] == want[0] == 200
    assert got[1] == want[1]


@pytest.mark.parametrize("query", ["level=1&num=20&len=5",
                                   "level=0&num=20&len=5&seed=3",
                                   "level=2&num=600&len=200"])
def test_walks_endpoint_equal(query, served):
    (uj, ut), _ = served
    want = json.loads(get(uj + "api/walks?" + query)[1])
    got = json.loads(get(ut + "api/walks?" + query)[1])
    assert {k: v for k, v in got.items() if k != "walks"} == {
        k: v for k, v in want.items() if k != "walks"}
    assert len(got["walks"]) == len(want["walks"])
    for (gc, gv), (wc, wv) in zip(got["walks"], want["walks"]):
        assert gc == wc
        assert np.abs(np.array(gv) - np.array(wv)).max(initial=0) <= 2e-6


@pytest.mark.parametrize("path,code", [
    ("api/knn?level=99&k=4", 400), ("api/knn?level=-1&k=4", 400),
    ("api/knn?level=1", 400), ("api/walks?level=1&num=x&len=5", 400),
    ("api/path?level=1&a=0&b=999", 400), ("api/nope", 404)])
def test_error_paths_equal(path, code, served):
    (uj, ut), _ = served
    want, got = get(uj + path), get(ut + path)
    assert got[0] == want[0] == code
    assert got[1] == want[1]


def test_above_the_cap_and_internal_errors(pair, monkeypatch):
    """A level above max_live_components answers 400; any other failure
    500 with the error's name."""
    _, tch = pair
    srv = TServer(tch, device="cpu", max_live_components=50)
    url = srv.start()
    try:
        status, body = get(url + "api/knn?level=0&k=8")
        assert status == 400 and b"capped at 50" in body
        assert get(url + "api/knn?level=1&k=8")[0] == 200

        def boom(*a, **kw):
            raise RuntimeError("device lost")

        monkeypatch.setattr(srv, "walks", boom)
        status, body = get(url + "api/walks?level=1&num=5&len=5")
        assert status == 500
        assert json.loads(body) == {"error": "RuntimeError: device lost"}
    finally:
        srv.stop()


def test_server_needs_a_device(pair):
    """Without device= the server takes the card, and raises the port's
    device error without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServer(pair[1])
