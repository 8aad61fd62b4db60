"""Live hierarchy explorer server: on-demand recompute on the card.

Port of sph_tpu/vis_server.py (reference: the interactive half of
vis/Renderer.cpp:467-551: as the user drags the k / walk-parameter sliders,
the explorer recomputes the kNN graph and the random walks live instead of
browsing a precomputed export).  Plain HTTP and JSON over the port's own
ops, on `device` (the card unless the caller names another).

Endpoints (JSON):
  GET /                         the explorer UI (live controls enabled)
  GET /api/meta                 dims, level sizes, live capability flags
  GET /api/knn?level&k          fresh component kNN at a new k
                                (ops/component_knn.knn_walks: the level's
                                walk rows under the Bhattacharyya metric)
  GET /api/walks?level&num&len[&seed]
                                fresh random walks with new parameters
                                (ops/walks.do_random_walks over the level's
                                transition rows)
  GET /api/path?level&a&b[&k]   shortest path a->b over the live kNN graph
                                (-log similarity weights, scipy Dijkstra:
                                the reference's path overlay semantics)

A bad level, node id or parameter answers 400, any other failure 500.

Usage:
    from sph_tpu_torch.vis_server import ExplorerServer
    srv = ExplorerServer(ch, embeddings={1: emb}, device="cuda")
    url = srv.start()            # http://127.0.0.1:<port>/
    ...
    srv.stop()

or blocking: ``serve_explorer(ch, port=8765)``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .device import DeviceLike, resolve_device
from .settings import ImportanceWeighting, RandomWalkSettings
from .utils.logging import Log

# recompute endpoints refuse levels above this component count: a live
# slider drag should answer in about a second, not re-run a 100k-point stage
MAX_LIVE_COMPONENTS = 30_000


class _ApiError(ValueError):
    pass


class ExplorerServer:
    """Holds a computed ComputeHierarchy and serves the live explorer; the
    recomputes run on `device`, one at a time."""

    def __init__(self, ch, embeddings: Optional[Dict[int, np.ndarray]] = None,
                 title: str = "sph_tpu live explorer",
                 max_live_components: int = MAX_LIVE_COMPONENTS,
                 device: DeviceLike = None):
        self._ch = ch
        self._h = ch.image_hierarchy.hierarchy
        self._embeddings = embeddings or {}
        self._title = title
        self._max_live = int(max_live_components)
        self.device = resolve_device(device)
        self._html: Optional[bytes] = None
        self._walk_cache: dict = {}
        self._knn_cache: dict = {}
        self._lock = threading.Lock()  # one device recompute at a time
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ data

    def _page(self) -> bytes:
        if self._html is None:
            from .vis_interactive import (build_explorer_data,
                                          render_explorer_html)
            data = build_explorer_data(self._ch, self._embeddings,
                                       self._title, live=True)
            self._html = render_explorer_html(data).encode()
        return self._html

    def _level_walks(self, level: int):
        """The level's walk rows (transition matrix) on the server's
        device; the level's probability rows where the hierarchy was built
        without walk similarities (both are 'similarity from this
        component', which is what Renderer.cpp's overlays paint)."""
        from .ops.sparse import SparseRows
        h = self._h
        n = int(h.num_components[level])
        rows = None
        if level < len(h.random_walks):
            w = h.random_walks[level]
            if w is not None and w.num_rows == n:
                rows = w
        if rows is None:
            try:
                pd = self._ch.level_similarities.get_prob_dist(level)
            except Exception:
                pd = None
            if pd is not None and pd.num_rows == n:
                rows = pd
        if rows is None:
            raise _ApiError(f"level {level} has no walk or probability rows")
        return SparseRows(rows.idx, rows.val, rows.num_cols,
                          device=self.device)

    def _check_level(self, level: int) -> int:
        if not 0 <= level < self._h.num_levels:
            raise _ApiError(f"level {level} out of range "
                            f"[0, {self._h.num_levels})")
        n = int(self._h.num_components[level])
        if n > self._max_live:
            raise _ApiError(f"level {level} has {n} components; live "
                            f"recompute is capped at {self._max_live}")
        return n

    def meta(self) -> dict:
        h = self._h
        return {
            "title": self._title,
            "live": True,
            "rows": int(h.settings.num_rows),
            "cols": int(h.settings.num_cols),
            "num_levels": int(h.num_levels),
            "num_components": [int(c) for c in h.num_components],
            "max_live_components": self._max_live,
        }

    def knn(self, level: int, k: int) -> dict:
        """Fresh component kNN at this k (Renderer.cpp:467-499 recomputes
        kNN whenever the k slider moves)."""
        n = self._check_level(level)
        k = max(2, min(int(k), n))
        key = (level, k)
        if key not in self._knn_cache:
            from .ops.component_knn import knn_walks
            with self._lock:
                ids, dists = knn_walks(self._level_walks(level), k)
            self._knn_cache[key] = (ids, dists)
        ids, dists = self._knn_cache[key]
        edges = []
        for i in range(n):
            for j in range(1, ids.shape[1]):     # slot 0 is self
                t = int(ids[i, j])
                if t < 0 or t <= i or t >= n:
                    continue
                sim = max(0.0, 1.0 - float(dists[i, j]))
                edges.append([i, t, round(sim, 6)])
        return {"level": level, "k": k, "edges": edges}

    def walks(self, level: int, num: int, length: int,
              seed: int = 1) -> dict:
        """Fresh random walks with new parameters (Renderer.cpp:500-551
        reruns doRandomWalks when the walk sliders move).  The rows are
        normalized in numpy's float32 sums first, as the JAX package
        normalizes its host-side walk rows."""
        n = self._check_level(level)
        num = max(1, min(int(num), 500))
        length = max(1, min(int(length), 100))
        key = (level, num, length, seed)
        if key not in self._walk_cache:
            from .ops.sparse import SparseRows, host_normalize
            from .ops.walks import do_random_walks
            rws = RandomWalkSettings(
                num_random_walks=num, single_walk_length=length,
                importance_weighting=ImportanceWeighting.NORMAL,
                random_seed=int(seed))
            with self._lock:
                rows = self._level_walks(level)
                src = SparseRows(rows.idx, host_normalize(
                    rows.indices, rows.values), rows.num_cols)
                out = do_random_walks(src, rws)
                idx, val = out.indices, out.values
            self._walk_cache[key] = (idx, val)
        idx, val = self._walk_cache[key]
        rows = []
        for i in range(n):
            ok = idx[i] >= 0
            rows.append([[int(c) for c in idx[i][ok]],
                         [round(float(v), 6) for v in val[i][ok]]])
        return {"level": level, "num": num, "len": length, "walks": rows}

    def path(self, level: int, a: int, b: int, k: int = 16) -> dict:
        """Dijkstra a->b over the live kNN graph with -log(sim) weights
        (the reference's shortest-path overlay, Renderer.cpp:573-579)."""
        n = self._check_level(level)
        if not (0 <= a < n and 0 <= b < n):
            raise _ApiError(f"node ids out of range [0, {n})")
        import scipy.sparse as sp
        from scipy.sparse.csgraph import dijkstra
        e = self.knn(level, k)["edges"]
        if not e:
            return {"level": level, "a": a, "b": b, "path": [],
                    "distance": None}
        ea = np.array([x[0] for x in e])
        eb = np.array([x[1] for x in e])
        w = -np.log(np.maximum(np.array([x[2] for x in e]), 1e-12))
        g = sp.coo_matrix((np.concatenate([w, w]),
                           (np.concatenate([ea, eb]),
                            np.concatenate([eb, ea]))),
                          shape=(n, n)).tocsr()
        dist, pred = dijkstra(g, indices=a, return_predecessors=True)
        if not np.isfinite(dist[b]):
            return {"level": level, "a": a, "b": b, "path": [],
                    "distance": None}
        node, chain = b, [b]
        while node != a:
            node = int(pred[node])
            chain.append(node)
        chain.reverse()
        return {"level": level, "a": a, "b": b, "path": chain,
                "distance": round(float(dist[b]), 6)}

    # ------------------------------------------------------------ lifecycle

    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Start serving in a daemon thread; returns the URL."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                Log.debug("vis_server: " + fmt % args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                try:
                    if u.path in ("/", "/index.html"):
                        self._send(200, server._page(),
                                   "text/html; charset=utf-8")
                        return
                    if u.path == "/api/meta":
                        out = server.meta()
                    elif u.path == "/api/knn":
                        out = server.knn(int(q["level"]), int(q["k"]))
                    elif u.path == "/api/walks":
                        out = server.walks(int(q["level"]), int(q["num"]),
                                           int(q["len"]),
                                           int(q.get("seed", 1)))
                    elif u.path == "/api/path":
                        out = server.path(int(q["level"]), int(q["a"]),
                                          int(q["b"]),
                                          int(q.get("k", 16)))
                    else:
                        self._send(404, b'{"error": "not found"}',
                                   "application/json")
                        return
                    self._send(200, json.dumps(out).encode(),
                               "application/json")
                except (_ApiError, KeyError, ValueError) as exc:
                    self._send(400, json.dumps(
                        {"error": str(exc)}).encode(), "application/json")
                except Exception as exc:  # noqa: BLE001 — report, don't die
                    Log.error("vis_server: %s", exc)
                    self._send(500, json.dumps(
                        {"error": f"{type(exc).__name__}: {exc}"}).encode(),
                        "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        url = f"http://{host}:{self._httpd.server_address[1]}/"
        Log.info("vis_server: live explorer at %s", url)
        return url

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def serve_explorer(ch, embeddings: Optional[Dict[int, np.ndarray]] = None,
                   host: str = "127.0.0.1", port: int = 8765,
                   device: DeviceLike = None):
    """Blocking convenience wrapper: serve until interrupted."""
    srv = ExplorerServer(ch, embeddings, device=device)
    url = srv.start(host, port)
    print(f"live explorer: {url} (ctrl-c to stop)")
    try:
        while True:
            threading.Event().wait(3600)
    except KeyboardInterrupt:
        srv.stop()
