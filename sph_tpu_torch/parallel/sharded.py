"""Sharded kNN, t-SNE and UMAP, and batches of scenes, over a device list.

Port of sph_tpu/parallel/sharded.py.  The JAX package runs each of these as
one ``shard_map`` program over a mesh, with ``all_gather``, ``psum``,
``pmin`` and ``pmax`` between the shards.  Here the shards are tensors on
the devices of a mesh (mesh.py), the program is a loop over them, and the
collectives are moves and sums in shard order:

* kNN: each shard scores its row block against every point; nothing is
  reduced.
* t-SNE, exact: each shard gathers y, computes its rows' repulsion against
  every column (the ``tsne_repulsion`` kernel with a row window), Z is the
  sum of the shards' row sums, the attraction runs over the shard's P rows
  with global column ids, and the re-centring mean is a sum over shards.
* t-SNE, grid: the bounding box is a min and max over shards, each shard
  deposits its points' charges, the charge grids are summed over shards,
  the FFT convolution runs once and each shard interpolates its points.
* UMAP: the edge list is sharded; each shard's attraction updates are
  summed over shards and applied, then each negative round's, every round
  reading the positions the last one left.  The negatives of shard d in
  round r come from fold_in(fold_in(key, r), d): the JAX package's own
  departure from the one-device stream, copied.
* Scenes: independent scenes of one size run side by side, each on one
  device; a device's scenes run as a leading batch axis (``torch.bmm`` for
  the kNN products, one ``tsne_repulsion`` launch for all of them).

Every entry point takes ``mesh``: a Mesh, a list of devices (a device may
repeat, one logical shard each) or None for ``make_mesh()``, which needs a
card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.tsne import TsneParameters, attractive_forces, \
    default_exaggeration
from ..ops.knn import KNN_MEMORY_BUDGET, _bottom_k
from ..ops.numerics import (_fma, flush_subnormals, pow, row_dot,
                            row_sum, sqrt)
from ..ops.tsne_grid import (_BIG, _MARGIN, field_grids, grid_deposit,
                             grid_interpolate, pick_grid_size)
from ..ops.tsne_kernels import tsne_repulsion_rows
from .mesh import MeshLike, as_mesh

# the multi-scene t-SNE's row block (sharded.py:411)
SCENE_TSNE_BLOCK = 512
# bytes a device's batch of scenes may hold in the stage-1 kNN's tiles
SCENE_MEMORY_BUDGET = 1 << 31
# multi_scene_stage1's squared-distance clamp before the square root
# (sharded.py:652), not knn.py's float32 epsilon
SCENE_D2_ZERO = 1.2e-7


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sum_in_order(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The psum of the port: the shards' parts added in shard order on
    `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _params_vec(params_vec) -> list[float]:
    """The 8 schedule numbers of the JAX step's params_vec, as float32
    values: eta, momentum, final momentum, momentum switch, exaggeration,
    exaggeration removal, decay iterations, minimum gain."""
    vals = [float(np.float32(v)) for v in np.asarray(params_vec).ravel()]
    if len(vals) != 8:
        raise ValueError(f"params_vec needs 8 numbers, got {len(vals)}")
    return vals


def params_vector(params: TsneParameters) -> list[float]:
    """TsneParameters as the JAX step's params_vec."""
    return _params_vec([params.eta, params.momentum, params.final_momentum,
                        params.mom_switching_iter,
                        params.exaggeration_factor,
                        params.remove_exaggeration_iter,
                        params.exponential_decay_iter, params.minimum_gain])


def _schedule(pv: list[float], it: int) -> tuple[float, float]:
    """(exaggeration, momentum) at iteration `it`, in float32 as the JAX
    step computes them on the device."""
    f32 = np.float32
    eta, mom0, mom1, mom_switch, exag_f, remove, decay_iter, _ = map(f32, pv)
    itf = f32(it)
    decay = np.exp(f32(-4.6) * max(itf - remove, f32(0.0))
                   / max(decay_iter, f32(1.0)), dtype=np.float32)
    exag = f32(1.0) + (exag_f - f32(1.0)) * (f32(1.0) if itf < remove
                                             else decay)
    return float(exag), float(mom0 if itf < mom_switch else mom1)


def _descend(y, vel, gain, grad, pv: list[float], momentum: float, row_ok):
    """Gains, momentum and the step; rows not valid held at 0 (the mean is
    taken by the caller)."""
    same = torch.sign(grad) == torch.sign(vel)
    gain = torch.clamp(torch.where(same, gain * 0.8, gain + 0.2),
                       min=pv[7])
    vel = momentum * vel - pv[0] * gain * grad
    return torch.where(row_ok, y + vel, 0.0), vel, gain


def _recentre(ys: list, n_valid: int, row_oks: list, devices) -> list:
    """Subtract the global mean of the valid rows (a sum over shards)."""
    mean = _sum_in_order([y.sum(0) for y in ys], devices[0]) / max(
        float(n_valid), 1.0)
    return [torch.where(ok, y - mean.to(y.device), 0.0)
            for y, ok in zip(ys, row_oks)]


def _shard_tensors(mesh, arrays, dtypes):
    """Each numpy array split over the mesh's shards along dim 0."""
    m = as_mesh(mesh)
    out = []
    for a, dt in zip(arrays, dtypes):
        step = a.shape[0] // m.size
        out.append([torch.as_tensor(np.ascontiguousarray(
            a[i * step:(i + 1) * step]), dtype=dt, device=d)
            for i, d in enumerate(m.devices)])
    return out


# ---------------------------------------------------------------------------
# sharded kNN
# ---------------------------------------------------------------------------

def sharded_knn(data: np.ndarray, k: int, mesh: MeshLike = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN with rows sharded over the mesh (JAX: sharded_knn).

    Each shard holds a row block and every point; the k smallest squared
    distances in (distance, column) order, the square root, then the
    self-first fix on the host.  The self distance is not forced to 0 and
    no epsilon is cleaned, as in the JAX function.  Returns (indices
    [N, k] int32, distances [N, k] float32)."""
    from ..ops.graph import ensure_self_first
    m = as_mesh(mesh)
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    npad = _ceil_to(n, 8 * m.size)
    shard_n = npad // m.size
    idx = np.zeros((npad, k), np.int64)
    dist = np.zeros((npad, k), np.float32)
    for s, dev in enumerate(m.devices):
        r0, r1 = s * shard_n, min((s + 1) * shard_n, n)
        if r0 >= r1:
            continue
        base = torch.as_tensor(data, device=dev)
        sq = row_dot(base, base)
        block = max(8, KNN_MEMORY_BUDGET // (8 * max(n, 1)) // 8 * 8)
        for b0 in range(r0, r1, block):
            b1 = min(b0 + block, r1)
            d2 = torch.add(sq[b0:b1, None], sq[None, :])
            d2.sub_((base[b0:b1] @ base.T).mul_(2.0)).clamp_(min=0.0)
            top = _bottom_k(d2, k, KNN_MEMORY_BUDGET)
            idx[b0:b1] = top.cpu().numpy()
            dist[b0:b1] = sqrt(d2.gather(1, top)).cpu().numpy()
    out_i, out_d, _ = ensure_self_first(idx[:n].astype(np.int32),
                                        dist[:n])
    return out_i.astype(np.int32), out_d.astype(np.float32)


# ---------------------------------------------------------------------------
# sharded t-SNE, exact repulsion
# ---------------------------------------------------------------------------

def make_sharded_tsne_step(mesh: MeshLike = None):
    """The multi-shard t-SNE step (JAX: make_sharded_tsne_step).

    Returns step(y, vel, gain, p_idx, p_val, n_valid, params_vec, it) ->
    (y, vel, gain): each state argument a list of row shards on the mesh's
    devices (``shard_rows``), P rows [shard, R] with global column ids
    (int32 on a card: ``tsne_attraction`` takes them so).
    The repulsion of a shard's rows is ``tsne_repulsion`` with that row
    window over the gathered y: the kernel on a card, its twin on the CPU.
    """
    m = as_mesh(mesh)

    def step(y, vel, gain, p_idx, p_val, n_valid, params_vec, it):
        pv = _params_vec(params_vec)
        n_valid = int(n_valid)
        exag, momentum = _schedule(pv, int(it))
        shard_n = y[0].shape[0]
        fulls, reps, zs, attrs = [], [], [], []
        for s, dev in enumerate(m.devices):
            y_full = torch.cat([ys.to(dev) for ys in y])
            row0 = s * shard_n
            rep, zrow = tsne_repulsion_rows(y_full, n_valid,
                                            rows=(row0, row0 + shard_n))
            fulls.append(y_full)
            reps.append(rep)
            zs.append(zrow.sum())
            attrs.append(attractive_forces(y_full, p_idx[s], p_val[s],
                                            row0))
        z = _sum_in_order(zs, m.devices[0])
        out_y, out_v, out_g, oks = [], [], [], []
        for s, dev in enumerate(m.devices):
            zd = torch.clamp(z.to(dev), min=1e-12)
            grad = 4.0 * (exag * attrs[s] - reps[s] / zd)
            ok = (torch.arange(shard_n, device=dev)
                  + s * shard_n < n_valid)[:, None]
            ys, vs, gs = _descend(y[s], vel[s], gain[s], grad, pv, momentum,
                                  ok)
            out_y.append(ys)
            out_v.append(vs)
            out_g.append(gs)
            oks.append(ok)
        return _recentre(out_y, n_valid, oks, m.devices), out_v, out_g

    return step


def _tsne_state(p_indices, p_values, m, seed: int, params):
    """Padded, normalised P and the initial layout, sharded."""
    from ..ops.math import random_disk_init
    n, r = p_indices.shape
    npad = _ceil_to(n, 8 * m.size)
    params = params or TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    y0 = np.zeros((npad, 2), np.float32)
    y0[:n] = random_disk_init(n, 0.1, seed)
    pi = np.full((npad, r), -1, np.int32)      # the attraction kernel's ids
    pv = np.zeros((npad, r), np.float32)
    pi[:n] = p_indices
    pv[:n] = p_values / max(p_values.sum(), 1e-12)
    y, vel, gain, pis, pvs = _shard_tensors(
        m, [y0, np.zeros_like(y0), np.ones_like(y0), pi, pv],
        [torch.float32] * 3 + [torch.int32, torch.float32])
    return n, y0, y, vel, gain, pis, pvs, params_vector(params)


def sharded_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                 num_iterations: int, mesh: MeshLike = None, seed: int = 0,
                 params: Optional[TsneParameters] = None) -> np.ndarray:
    """A whole multi-shard t-SNE on the symmetrised joint P rows [N, R]
    (JAX: sharded_tsne).  Returns the [N, 2] layout."""
    m = as_mesh(mesh)
    n, _, y, vel, gain, pis, pvs, pvec = _tsne_state(
        p_indices, p_values, m, seed, params)
    step = make_sharded_tsne_step(m)
    for it in range(num_iterations):
        y, vel, gain = step(y, vel, gain, pis, pvs, n, pvec, it)
    return torch.cat([s.cpu() for s in y]).numpy()[:n]


# ---------------------------------------------------------------------------
# sharded t-SNE, grid repulsion
# ---------------------------------------------------------------------------

def make_sharded_grid_tsne_step(mesh: MeshLike = None, grid: int = 128):
    """The multi-shard step of the grid tier (JAX:
    make_sharded_grid_tsne_step), with ``step``'s arguments and results.

    The box is the min and max of the valid rows over shards; each shard
    deposits its valid points' charges (``grid_deposit``, the fixed-order
    deposit: the kernel on a card), the grids are summed in shard order,
    the fields are convolved once and each shard interpolates its own
    points (``grid_interpolate``), its phi_z sums added in shard order."""
    m = as_mesh(mesh)
    usable = float(grid - 2 * _MARGIN - 1)

    def step(y, vel, gain, p_idx, p_val, n_valid, params_vec, it):
        pv = _params_vec(params_vec)
        n_valid = int(n_valid)
        exag, momentum = _schedule(pv, int(it))
        shard_n = y[0].shape[0]
        dev0 = m.devices[0]
        live = [max(0, min(shard_n, n_valid - s * shard_n))
                for s in range(m.size)]
        los = [torch.where(torch.arange(shard_n, device=ys.device)[:, None]
                           < c, ys, _BIG).amin(0) for ys, c in zip(y, live)]
        his = [torch.where(torch.arange(shard_n, device=ys.device)[:, None]
                           < c, ys, -_BIG).amax(0) for ys, c in zip(y, live)]
        lo = torch.stack([v.to(dev0) for v in los]).amin(0)
        hi = torch.stack([v.to(dev0) for v in his]).amax(0)
        h = torch.clamp((hi - lo) / usable, min=1e-6)
        charges = []
        for s, dev in enumerate(m.devices):
            if live[s]:
                charges.append(grid_deposit(y[s][:live[s]], lo.to(dev),
                                            h.to(dev), grid))
        total = _sum_in_order(charges, dev0)
        fields_on: dict = {}
        reps, zs = [], []
        for s, dev in enumerate(m.devices):
            if dev not in fields_on:
                fields_on[dev] = field_grids(total.to(dev), h.to(dev), grid)
            rep, z_s = grid_interpolate(fields_on[dev], y[s], live[s],
                                        lo.to(dev), h.to(dev))
            reps.append(rep)
            zs.append(z_s)
        z = torch.clamp(_sum_in_order(zs, dev0) - float(n_valid), min=1e-12)
        out_y, out_v, out_g, oks = [], [], [], []
        for s, dev in enumerate(m.devices):
            y_full = torch.cat([ys.to(dev) for ys in y])
            attr = attractive_forces(y_full, p_idx[s], p_val[s],
                                     s * shard_n)
            grad = 4.0 * (exag * attr - reps[s] / z.to(dev))
            ok = (torch.arange(shard_n, device=dev) < live[s])[:, None]
            ys, vs, gs = _descend(y[s], vel[s], gain[s], grad, pv, momentum,
                                  ok)
            out_y.append(ys)
            out_v.append(vs)
            out_g.append(gs)
            oks.append(ok)
        return _recentre(out_y, n_valid, oks, m.devices), out_v, out_g

    return step


def sharded_grid_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                      num_iterations: int, mesh: MeshLike = None,
                      seed: int = 0, grid: int = 0,
                      params: Optional[TsneParameters] = None) -> np.ndarray:
    """A whole multi-shard grid-tier t-SNE (JAX: sharded_grid_tsne).
    grid=0 picks the grid from the layout's span (pad rows included) x 1.3
    every 50 iterations, as the JAX function does."""
    m = as_mesh(mesh)
    n, y0, y, vel, gain, pis, pvs, pvec = _tsne_state(
        p_indices, p_values, m, seed, params)
    fixed_grid = grid > 0
    if not fixed_grid:
        grid = pick_grid_size(float(np.ptp(y0[:n]).max()) + 1.0)
    steps: dict = {}
    it = 0
    while it < num_iterations:
        if not fixed_grid:
            yall = torch.cat([s.to(m.devices[0]) for s in y])
            span = float((yall.amax(0) - yall.amin(0)).max())
            grid = pick_grid_size(max(span, 1.0) * 1.3)
        if grid not in steps:
            steps[grid] = make_sharded_grid_tsne_step(m, grid)
        stop = min(it + 50, num_iterations)
        while it < stop:
            y, vel, gain = steps[grid](y, vel, gain, pis, pvs, n, pvec, it)
            it += 1
    return torch.cat([s.cpu() for s in y]).numpy()[:n]


# ---------------------------------------------------------------------------
# multi-scene batched t-SNE (BASELINE config 5)
# ---------------------------------------------------------------------------

def _scene_groups(s: int, m) -> list[tuple[torch.device, int, int]]:
    """Scenes in contiguous groups, one a shard (the JAX package pads S to
    a multiple of the mesh and gives each device S / devices)."""
    per = -(-s // m.size)
    return [(d, i * per, min((i + 1) * per, s))
            for i, d in enumerate(m.devices) if i * per < s]


class _LiveAttraction:
    """The sparse attraction sum_j p_ij w_ij (y_i - y_j) over P's live
    entries only, for rows whose P lies in a padded [rows, R] layout: the
    live entries in row order, each row's terms summed one after another
    (``torch.segment_reduce``: a fixed order, with no atomics, and a row's
    sum the same whatever rows come with it).  A batch of scenes' P is
    padded to its widest row (2087 entries on the card's 16 Pines-sized
    scenes, most rows far shorter), so the padded gather of
    ``attractive_forces`` would spend most of its work on pads."""

    def __init__(self, p_idx: torch.Tensor, p_val: torch.Tensor):
        live = p_idx >= 0
        self.rows = live.nonzero()[:, 0]
        self.cols = p_idx[live]
        self.vals = p_val[live]
        self.lengths = live.sum(1)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        d = y[self.rows] - y[self.cols]
        d0, d1 = d[:, 0], d[:, 1]
        w = 1.0 / (1.0 + d0 * d0 + d1 * d1)
        return torch.segment_reduce((self.vals * w)[:, None] * d, "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True, initial=0.0)


def multi_scene_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                     num_iterations: int, mesh: MeshLike = None,
                     seed: int = 0) -> np.ndarray:
    """Batched t-SNE of S independent scenes (JAX: multi_scene_tsne):
    p_indices / p_values [S, N, R] each scene's symmetric P rows, returns
    [S, N, 2].

    Each scene runs the exact sparse-P iteration (the JAX package's
    ``tsne_iterations(..., use_pallas=False)``) from random_disk_init(N,
    0.1, seed + i), with P padded to a multiple of 512 rows and normalised
    per scene.  An iteration on a device takes one attraction over its
    scenes' rows together (column ids offset by each scene's row base;
    over P's live entries, ``_LiveAttraction``) and one ``tsne_repulsion``
    launch for all its scenes; Z and the mean are summed scene by scene,
    so that scene i's bits are those of an S = 1 call with seed + i."""
    from ..ops.math import random_disk_init
    m = as_mesh(mesh)
    p_indices = np.asarray(p_indices)
    p_values = np.asarray(p_values, np.float32)
    s, n, r = p_indices.shape
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pv = params_vector(params)
    block = SCENE_TSNE_BLOCK if n > SCENE_TSNE_BLOCK else _ceil_to(n, 8)
    npad = _ceil_to(n, block)
    out = np.zeros((s, n, 2), np.float32)
    mass = np.maximum(p_values.sum(axis=(1, 2), keepdims=True), 1e-12)
    for dev, s0, s1 in _scene_groups(s, m):
        g = s1 - s0
        y0 = np.zeros((g, npad, 2), np.float32)
        for i in range(g):
            y0[i, :n] = random_disk_init(n, 0.1, seed + s0 + i)
        pi = np.full((g, npad, r), -1, np.int64)
        pvals = np.zeros((g, npad, r), np.float32)
        pi[:, :n] = p_indices[s0:s1]
        pvals[:, :n] = p_values[s0:s1] / mass[s0:s1]
        offs = (np.arange(g, dtype=np.int64) * npad)[:, None, None]
        attraction = _LiveAttraction(
            torch.as_tensor(np.where(pi >= 0, pi + offs, -1).reshape(
                g * npad, r), device=dev),
            torch.as_tensor(pvals.reshape(g * npad, r), device=dev))
        y = torch.as_tensor(y0, device=dev)
        vel = torch.zeros_like(y)
        gain = torch.ones_like(y)
        row_ok = (torch.arange(npad, device=dev) < n)[None, :, None]
        for it in range(num_iterations):
            exag, momentum = _schedule(pv, it)
            attr = attraction(y.reshape(g * npad, 2)).reshape(g, npad, 2)
            rep, zrow = tsne_repulsion_rows(y, n)
            z = torch.stack([torch.clamp(zrow[i].sum(), min=1e-12)
                             for i in range(g)])
            grad = 4.0 * (exag * attr - rep / z[:, None, None])
            y, vel, gain = _descend(y, vel, gain, grad, pv, momentum,
                                    row_ok)
            mean = torch.stack([y[i].sum(0) for i in range(g)]) / max(
                float(n), 1.0)
            y = torch.where(row_ok, y - mean[:, None, :], 0.0)
        out[s0:s1] = y[:, :n].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# sharded UMAP (edge-parallel epochs)
# ---------------------------------------------------------------------------

def make_sharded_umap_epoch(mesh: MeshLike = None, neg_rate: int = 5):
    """One UMAP epoch with the edge list sharded over the mesh (JAX:
    make_sharded_umap_epoch).

    Returns epoch(y, src, dst, eps, nxt, epoch_i, alpha, a, b, key,
    n_valid) -> (y, nxt): y [N, 2] replicated (one tensor, copied to each
    device), src / dst / eps / nxt lists of edge shards, key a threefry key
    pair (ops/rng.py).  Each shard's updates land on a zero [N] vector in
    edge order (models/umap.FoldLayout); the vectors are summed over
    shards and added to y."""
    from ..models.umap import FoldLayout, _attract_coeff, _clip4, _sq_len
    from ..ops import rng
    m = as_mesh(mesh)
    layouts: dict = {}

    def folds(s, src, dst, n):
        key = (s, src.data_ptr(), dst.data_ptr(), n)
        if key not in layouts:
            layouts[key] = (FoldLayout(src, n), FoldLayout(dst, n))
        return layouts[key]

    def epoch(y, src, dst, eps, nxt, epoch_i, alpha, a, b, key, n_valid):
        n = y.shape[0]
        alpha, a, b = (float(np.float32(v)) for v in (alpha, a, b))
        dev0 = m.devices[0]
        actives = [t <= float(epoch_i) for t in nxt]
        parts = [[], []]
        for s, dev in enumerate(m.devices):
            sf, df = folds(s, src[s], dst[s], n)
            diff = y.to(dev)[src[s]] - y.to(dev)[dst[s]]
            gc = _attract_coeff(_sq_len(diff[:, 0], diff[:, 1]), a, b)
            keep = torch.where(actives[s], alpha, 0.0)
            s0 = keep * _clip4(gc * diff[:, 0])
            s1 = keep * _clip4(gc * diff[:, 1])
            zero = torch.zeros(n, dtype=torch.float32, device=dev)
            parts[0].append(df.add(sf.add(zero, s0), -s0))
            parts[1].append(df.add(sf.add(zero, s1), -s1))
        y = y + torch.stack([_sum_in_order(p, dev0) for p in parts], 1)
        for r in range(neg_rate):
            parts = [[], []]
            for s, dev in enumerate(m.devices):
                sf, _ = folds(s, src[s], dst[s], n)
                k = rng.fold_in(rng.fold_in(key, r), s)
                negs = rng.randint(k, (src[s].numel(),), 0, int(n_valid),
                                   dev)
                diff = y.to(dev)[src[s]] - y.to(dev)[negs]
                e2 = _sq_len(diff[:, 0], diff[:, 1])
                gcn = (2.0 * b) / ((0.001 + e2) * _fma(a, pow(e2, b), 1.0))
                # a coincident pair takes clip(0) = 0 here, where the
                # one-device epoch pushes it by 4 (JAX: sharded.py:486-488)
                keep = torch.where(actives[s] & (negs != src[s]), alpha, 0.0)
                r0 = keep * _clip4(gcn * diff[:, 0])
                r1 = keep * _clip4(gcn * diff[:, 1])
                zero = torch.zeros(n, dtype=torch.float32, device=dev)
                parts[0].append(sf.add(zero, r0))
                parts[1].append(sf.add(zero, r1))
            y = y + torch.stack([_sum_in_order(p, dev0) for p in parts], 1)
        nxt = [torch.where(act, t + e, t)
               for act, t, e in zip(actives, nxt, eps)]
        return y, nxt

    return epoch


def sharded_umap(p_indices: np.ndarray, p_values: np.ndarray,
                 num_epochs: int = 0, mesh: MeshLike = None, seed: int = 0,
                 params=None) -> np.ndarray:
    """A whole multi-shard UMAP on symmetric membership rows [N, R] (the
    fuzzy union already applied; JAX: sharded_umap).  The schedule and the
    layout come from the edge-list tier's set-up, pinned by argument; pad
    edges never fall due.  Returns the [N, 2] layout."""
    from ..models.umap import UmapComputation, UmapParameters
    from ..ops import rng
    from ..ops.sparse import SparseRows
    m = as_mesh(mesh)
    dev0 = m.devices[0]
    uc = UmapComputation(dataclasses.replace(params or UmapParameters()),
                         device=dev0)
    if num_epochs:
        uc.params.num_epochs = num_epochs
    uc.params.seed = seed
    uc.set_memberships(SparseRows(np.asarray(p_indices, np.int64),
                                  np.asarray(p_values, np.float32),
                                  p_indices.shape[0], device=dev0))
    uc.init_optimization(edge_path=True)

    e = int(uc._src.numel())
    epad = _ceil_to(max(e, 1), m.size)
    pad = epad - e
    src = np.pad(uc._src.cpu().numpy(), (0, pad))
    dst = np.pad(uc._dst.cpu().numpy(), (0, pad))
    eps = np.pad(uc._eps.cpu().numpy(), (0, pad))
    nxt = np.pad(uc._next_sample.cpu().numpy(), (0, pad),
                 constant_values=np.inf)
    src_s, dst_s, eps_s, nxt_s = _shard_tensors(
        m, [src, dst, eps, nxt],
        [torch.int64, torch.int64, torch.float32, torch.float32])
    step = make_sharded_umap_epoch(m, uc.params.negative_sample_rate)
    key = rng.prng_key(seed)
    y = uc._y.to(dev0)
    for ep in range(uc.n_epochs):
        alpha = uc.params.initial_alpha * (1.0 - ep / uc.n_epochs)
        y, nxt_s = step(y, src_s, dst_s, eps_s, nxt_s, ep, alpha, uc._a,
                        uc._b, rng.fold_in(key, ep), uc._n)
    return y.cpu().numpy()


# ---------------------------------------------------------------------------
# scene-parallel stage 1: kNN + data-level probdist + random walks
# ---------------------------------------------------------------------------

def _scene_knn(x: torch.Tensor, k: int, n: int,
               memory_budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stage-1 kNN of a batch of scenes x [g, N, D] (JAX:
    multi_scene_stage1's one_scene): squared distances with the self pair
    forced to 0, the k smallest in (distance, column) order, values at or
    below 1.2e-7 taken as 0, the square root.  Rows in blocks of the
    memory budget, all scenes of the batch at once."""
    g = x.shape[0]
    dev = x.device
    sq = torch.stack([row_dot(x[i], x[i]) for i in range(g)])
    rows = max(8, memory_budget // (12 * g * max(n, 1)) // 8 * 8)
    out_i = torch.empty((g, n, k), dtype=torch.int64, device=dev)
    out_d = torch.empty((g, n, k), dtype=torch.float32, device=dev)
    xt = x.transpose(1, 2)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        d2 = torch.add(sq[:, r0:r1, None], sq[:, None, :])
        d2.sub_(torch.bmm(x[:, r0:r1], xt).mul_(2.0)).clamp_(min=0.0)
        ar = torch.arange(r1 - r0, device=dev)
        d2[:, ar, ar + r0] = 0.0
        flat = d2.reshape(g * (r1 - r0), n)
        top = _bottom_k(flat, k, memory_budget)
        top_d = flat.gather(1, top)
        top_d = sqrt(torch.where(top_d <= SCENE_D2_ZERO, 0.0, top_d))
        out_i[:, r0:r1] = top.reshape(g, r1 - r0, k)
        out_d[:, r0:r1] = top_d.reshape(g, r1 - r0, k)
        del d2, flat
    return out_i, out_d


def _self_first(idx: torch.Tensor, dist: torch.Tensor):
    """The self-first fix on the device, rows of each scene self-indexed
    (JAX: ops/graph.ensure_self_first_body)."""
    n, k = idx.shape[-2:]
    ar = torch.arange(n, device=idx.device)[:, None]
    is_self = idx == ar
    has_self = is_self.any(-1, keepdim=True)
    already = idx[..., :1] == ar
    swap = ~already & has_self
    shift = ~already & ~has_self
    sw_i = torch.where(is_self, idx[..., :1], idx)
    sw_d = torch.where(is_self, dist[..., :1], dist)
    sh_i = torch.cat([idx[..., :1], idx[..., :-1]], -1)
    sh_d = torch.cat([dist[..., :1], dist[..., :-1]], -1)
    out_i = torch.where(swap, sw_i, torch.where(shift, sh_i, idx))
    out_d = torch.where(swap, sw_d, torch.where(shift, sh_d, dist))
    out_i[..., 0] = ar[:, 0]
    out_d[..., 0] = torch.where(already[..., 0], dist[..., 0], 0.0)
    return out_i, out_d


def _scene_probs(dist: torch.Tensor, norm) -> torch.Tensor:
    """Data-level probabilities of [rows, k] distance rows (JAX: the three
    branches of multi_scene_stage1, sharded.py:655-666)."""
    from ..ops.distributions import (gaussian_row_distributions,
                                     linear_row_distributions,
                                     smooth_knn_distributions)
    from ..settings import NormalizationScheme
    mask = torch.ones_like(dist, dtype=torch.bool)
    if norm == NormalizationScheme.TSNE:
        # the JAX function does not bucket its k columns: above 32 XLA sums
        # them in its windows over k, at or below 32 in one fused chain (the
        # bucketed width 32 gives that chain)
        return gaussian_row_distributions(dist, mask, -1.0,
                                          ignore_first=True,
                                          sum_width=max(dist.shape[1], 32))
    m2 = mask.clone()
    m2[:, 0] = False
    if norm == NormalizationScheme.LINEAR:
        return linear_row_distributions(dist, m2)
    probs = smooth_knn_distributions(dist, m2)
    ps = row_sum(probs)[:, None]
    # XLA-CPU flushes the subnormal quotients of the same program
    return flush_subnormals(torch.where(
        ps > 0, probs / torch.clamp(ps, min=1e-38), 0.0))


def multi_scene_stage1(datas: np.ndarray, k: int, rws=None, norm=None,
                       mesh: MeshLike = None,
                       seed_base: Optional[int] = None):
    """Batched stage 1 over S same-shape scenes (JAX: multi_scene_stage1):
    each scene's exact kNN, data-level probabilities and data-level random
    walks.  The reference evaluates scenes one after another
    (RunEvaluation.cpp:148-172).

    datas [S, N, D] float32.  Returns numpy arrays: idx / dist [S, N, k]
    (self first, ascending, square-rooted L2), probs [S, N, k] (per `norm`,
    the self column ignored), walks_idx / walks_val [S, N, Wo] (None when
    `rws` is None), Wo = min(cap, walks x length, N) with cap =
    max_row_nnz or min(walks x length, 2048).  Scene i's walks draw from
    seed uint32(seed_base + i), seed_base the walk seed by default.  The
    kNN of a device's scenes runs batched (``torch.bmm``) in row blocks of
    SCENE_MEMORY_BUDGET bytes; its kNN here is this function's own arithmetic
    (no symmetrisation, no component connection), not compute_knn's."""
    from ..ops.walks import (accumulate, derive_prune_value, postprocess,
                             simulate)
    from ..settings import NormalizationScheme
    if norm is None:
        norm = NormalizationScheme.TSNE
    m = as_mesh(mesh)
    datas = np.ascontiguousarray(datas, dtype=np.float32)
    s, n, d = datas.shape
    if rws is not None:
        w = int(rws.num_random_walks)
        length = int(rws.single_walk_length)
        cap = rws.max_row_nnz or min(w * length, 2048)
        out_width = min(cap, w * length, n)
        prune_value = derive_prune_value(rws)
        if seed_base is None:
            seed_base = int(rws.random_seed)
    seeds = (np.arange(s, dtype=np.uint32)
             + np.uint32(seed_base or 0)).astype(np.int64)
    out = {"idx": np.zeros((s, n, k), np.int32),
           "dist": np.zeros((s, n, k), np.float32),
           "probs": np.zeros((s, n, k), np.float32),
           "walks_idx": None, "walks_val": None}
    if rws is not None:
        out["walks_idx"] = np.full((s, n, out_width), -1, np.int32)
        out["walks_val"] = np.zeros((s, n, out_width), np.float32)
    # a scene's data, its kNN rows and their probabilities on the device
    per_scene = n * (4 * d + 16 * k)
    for dev, g0, g1 in _scene_groups(s, m):
        step = max(1, min(g1 - g0, SCENE_MEMORY_BUDGET // max(per_scene, 1)))
        for c0 in range(g0, g1, step):
            c1 = min(c0 + step, g1)
            x = torch.as_tensor(datas[c0:c1], device=dev)
            idx, dist = _self_first(*_scene_knn(x, k, n, SCENE_MEMORY_BUDGET))
            del x
            g = c1 - c0
            probs = _scene_probs(dist.reshape(g * n, k), norm).reshape(
                g, n, k)
            out["idx"][c0:c1] = idx.to(torch.int32).cpu().numpy()
            out["dist"][c0:c1] = dist.cpu().numpy()
            out["probs"][c0:c1] = probs.cpu().numpy()
            if rws is None:
                continue
            for i in range(g):
                visited = simulate(idx[i], probs[i], int(seeds[c0 + i]), w,
                                   length)
                widx, wval = accumulate(
                    visited, w, length, rws.importance_weighting.value,
                    out_width)
                del visited
                widx, wval = postprocess(widx, wval, prune_value,
                                         rws.remove_diagonal, rws.normalize)
                out["walks_idx"][c0 + i] = widx.to(torch.int32).cpu().numpy()
                out["walks_val"][c0 + i] = wval.cpu().numpy()
    return out


def multi_scene_hierarchy(datas: np.ndarray, rows: int, cols: int, k: int,
                          ihs=None, rws=None, lss=None,
                          mesh: MeshLike = None,
                          seconds: Optional[dict] = None):
    """Batched stage 1, then each scene's Borůvka levels and level
    similarities (JAX: multi_scene_hierarchy): the scenes' stage-1 outputs
    go in through ``ImageHierarchy.set_preparations``.  Returns a list of
    (ImageHierarchy, LevelSimilarities or None), one a scene, each on its
    shard's device.  The reference runs the scenes strictly one after
    another (RunEvaluation.cpp:148-172).  `seconds`, when given, receives
    the wall seconds of the batched stage 1 ("stage1") and of each scene's
    levels and level similarities ("levels", a list)."""
    import time
    from ..models.image_hierarchy import ImageHierarchy
    from ..models.level_similarities import LevelSimilarities
    from ..ops.graph import KnnGraph
    from ..ops.sparse import SparseRows
    from ..settings import ImageHierarchySettings, RandomWalkSettings
    m = as_mesh(mesh)
    ihs = ihs or ImageHierarchySettings()
    rws = rws or RandomWalkSettings()
    s, n, _ = datas.shape
    if n != rows * cols:
        raise ValueError(f"{n} points per scene, not {rows} x {cols}")
    t = time.perf_counter()
    stage1 = multi_scene_stage1(datas, k, rws=rws,
                                norm=ihs.norm_knn_distances, mesh=m)
    timed = {"stage1": time.perf_counter() - t, "levels": []}
    devices = {i: dev for dev, g0, g1 in _scene_groups(s, m)
               for i in range(g0, g1)}
    results = []
    for i in range(s):
        t = time.perf_counter()
        dev = devices[i]
        g = KnnGraph(stage1["idx"][i], stage1["dist"][i])
        ih = ImageHierarchy(g, datas[i], rows, cols, device=dev)
        ih.set_settings(ihs, rws)
        probs = stage1["probs"][i]
        pd = SparseRows(np.where(probs > 0, stage1["idx"][i], -1), probs, n,
                        device=dev)
        walks = SparseRows(stage1["walks_idx"][i], stage1["walks_val"][i],
                           n, device=dev)
        ih.set_preparations(pd, walks)
        ih.compute()
        ls = None
        if lss is not None:
            ls = LevelSimilarities(ih.hierarchy, g, datas[i],
                                   dataclasses.replace(lss), device=dev)
            ls.set_image_hierarchy(ih)
            ls.compute()
        results.append((ih, ls))
        timed["levels"].append(time.perf_counter() - t)
    if seconds is not None:
        seconds.update(timed)
    return results
