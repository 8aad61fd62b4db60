"""t-SNE forces on the card: the CUDA kernels and their plain twins.

Replaces the two TPU kernels of sph_tpu/ops/pallas/tsne_kernels.py:

- ``tsne_forces_dense`` (``csrc/tsne_forces_dense.cu``): attraction and
  repulsion over a dense joint P, every iteration of the dense-P tier;
- ``tsne_repulsion`` (``csrc/tsne_repulsion.cu``): the exact all-pairs
  repulsion, every iteration of the exact sparse-P tier and the Z of the
  KL divergence on the card;

and the JAX package's XLA attraction over P's support
(sph_tpu/models/tsne.py ``_attractive_forces``, no Pallas source):

- ``tsne_attraction`` (``csrc/tsne_attraction.cu``): the sparse
  attraction, float32 or from the u16-packed table, every iteration of the
  grid and exact tiers and of the sharded steps;

and the point work of the JAX package's grid repulsion
(sph_tpu/ops/tsne_grid.py ``deposit_charges`` and ``interpolate_fields``,
no Pallas source), whose wrappers live in ops/tsne_grid.py and are
re-exported here:

- ``grid_deposit`` (``csrc/grid_deposit.cu``) and ``grid_interpolate``
  (``csrc/grid_interpolate.cu``): the charges onto the grid and the fields
  back at the points, every iteration of the grid tier.

Each ``.cu`` under ``csrc/`` is compiled with nvcc for sm_90a into its own
content-hashed shared library in ``_build/`` (``ops/cuda_build.py``: all
missing ones at once, one nvcc each, the geodesic relax kernel of
``ops/shortest_path.py`` included), with a plain C entry point loaded with
ctypes.  The sources note what bounds each kernel and how it is laid out.

A wrapper launches its kernel for CUDA tensors and counts each launch in
``<wrapper>.launches``.  A CPU tensor goes to the ``*_reference`` twin, the
same sums as plain torch ops; a CUDA tensor never does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

# the build helpers, re-exported here under their old names
from .cuda_build import (NVCC_FLAGS, _P, _launch, _library,  # noqa: F401
                         _nvcc, build, library_path, sm_count, source)

# the t-SNE kernels, each with its wrapper below or in ops/tsne_grid.py
KERNELS = ("tsne_forces_dense", "tsne_repulsion", "tsne_attraction",
           "grid_deposit", "grid_interpolate")


def _check_y(name: str, y: torch.Tensor, n_valid: int):
    if y.dim() != 2 or y.shape[1] != 2:
        raise ValueError(f"{name}: y must be [Npad, 2], got "
                         f"{tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"{name}: y must be float32, got {y.dtype}")
    if not 0 <= n_valid <= y.shape[0]:
        raise ValueError(f"{name}: n_valid {n_valid} outside "
                         f"[0, {y.shape[0]}]")


def _check_kernel_device(name: str, *tensors: torch.Tensor):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


# ---------------------------------------------------------------------------
# tsne_forces_dense
# ---------------------------------------------------------------------------

FORCES_ROWS = 8             # rows a block: 4 warps of 2 (csrc kRows)
FORCES_STEP = 128           # columns a warp reads in one step
FORCES_MIN_SPLIT = 512      # fewest columns a column split takes
FORCES_MAX_SPLIT = 16384    # most columns a block takes
FORCES_BLOCKS_PER_SM = 1    # blocks a plan aims at for each SM
FORCES_SUMS = 7             # s2, ax, ay, z, sa, bx, by


@dataclass(frozen=True)
class ForcesPlan:
    """How ``csrc/tsne_forces_dense.cu`` cuts the [npad, npad] tile for one
    n_valid: ``tiles`` row tiles of FORCES_ROWS rows by ``splits`` column
    ranges of ``split_cols`` columns over the live columns (the last range
    ends at n_valid rounded up to FORCES_STEP); one block each, of which a
    tile of pad rows runs only its first."""
    tiles: int
    splits: int
    split_cols: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def forces_plan(n_valid: int, npad: int, sms: int = 132,
                blocks_per_sm: int = FORCES_BLOCKS_PER_SM,
                max_split: int = FORCES_MAX_SPLIT) -> ForcesPlan:
    """Row tiles alone where the tiles that hold a real row give each SM
    `blocks_per_sm` blocks; otherwise each such tile's live columns are
    split into ranges of at least FORCES_MIN_SPLIT columns (a multiple of
    FORCES_STEP) until they do.  Ranges are cut to at most `max_split`
    columns, so that the last wave of a large call is short
    (``scripts/forces_readout.py --plans`` times other plans; PERF.md has
    the comparison).  npad: a multiple of FORCES_STEP."""
    live_rows = max(min(int(n_valid), npad), 1)
    live_tiles = -(-live_rows // FORCES_ROWS)
    cols = -(-live_rows // FORCES_STEP) * FORCES_STEP
    want = max(-(-blocks_per_sm * sms // live_tiles), -(-cols // max_split))
    splits = min(max(want, 1), max(cols // FORCES_MIN_SPLIT, 1))
    split_cols = -(-cols // (splits * FORCES_STEP)) * FORCES_STEP
    return ForcesPlan(npad // FORCES_ROWS, -(-cols // split_cols), split_cols)


class DenseForces:
    """Caller-owned outputs and workspace of ``tsne_forces_dense`` for one
    Npad on one device: ``attr``, ``rep`` [npad, 2] and ``z`` (0-d), which
    every call with these buffers overwrites, and on a card the kernel's
    workspace: the blocks' partial row sums, the rows' z and the
    tickets (0 between calls: the blocks that take them reset them).  One
    stream at a time may use it.  Allocate it once a run (the dense tier's
    t-SNE does) and pass it as ``out``.  The launch plan is
    ``forces_plan(n_valid, npad, <the card's SMs>, blocks_per_sm,
    max_split)``, made once for each n_valid; ``plan`` is the last one
    launched."""

    def __init__(self, npad: int, device,
                 blocks_per_sm: int = FORCES_BLOCKS_PER_SM,
                 max_split: int = FORCES_MAX_SPLIT):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.npad = int(npad)
        self.device = device
        self.attr = torch.empty((npad, 2), dtype=torch.float32, device=device)
        self.rep = torch.empty((npad, 2), dtype=torch.float32, device=device)
        self._z = torch.empty(1, dtype=torch.float32, device=device)
        self.z = self._z[0]
        self._p = None
        self.plan = None
        if device.type != "cuda":
            return
        if npad % FORCES_STEP:
            raise ValueError(f"tsne_forces_dense: Npad {npad} is not a "
                             f"multiple of {FORCES_STEP}")
        self._sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        self._split_args = (blocks_per_sm, max_split)
        self._part = torch.empty(0, dtype=torch.float32, device=device)
        # the rows' z, then the sums of pairs of row tiles
        self._zrow = torch.empty(npad + npad // (2 * FORCES_ROWS),
                                 dtype=torch.float32, device=device)
        # a ticket for each row tile, the last pair, each pair of tiles
        self._tickets = torch.zeros(
            npad // FORCES_ROWS + 1 + npad // (2 * FORCES_ROWS),
            dtype=torch.int32, device=device)
        self._fn = getattr(_library("tsne_forces_dense"),
                           "tsne_forces_dense_launch")
        # the current stream's handle without building a Stream object
        self._stream = torch._C._cuda_getCurrentRawStream
        self._args = {}         # n_valid -> (plan, the launch's arguments)

    def _launch_args(self, n_valid: int) -> tuple:
        """The plan and the launch's arguments after y, P, npad and n_valid,
        made once for each n_valid (the workspace grows to the widest)."""
        plan = forces_plan(n_valid, self.npad, self._sms, *self._split_args)
        need = plan.splits * FORCES_SUMS * self.npad
        if need > self._part.numel():
            self._part = torch.empty(need, dtype=torch.float32,
                                     device=self.device)
            self._args.clear()
        args = (plan, (plan.splits, plan.split_cols, self.attr.data_ptr(),
                       self.rep.data_ptr(), self._z.data_ptr(),
                       self._part.data_ptr(), self._zrow.data_ptr(),
                       self._tickets.data_ptr()))
        self._args[n_valid] = args
        return args

    def _check_p(self, p_dense: torch.Tensor):
        """P's checks, once for each P tensor (the dense tier passes one P
        every iteration)."""
        if p_dense is self._p:
            return
        npad = self.npad
        if tuple(p_dense.shape) != (npad, npad):
            raise ValueError(f"tsne_forces_dense: P must be [{npad}, {npad}],"
                             f" got {tuple(p_dense.shape)}")
        if p_dense.dtype != torch.float32:
            raise TypeError("tsne_forces_dense: y and P must be float32")
        if p_dense.device != self.device:
            raise ValueError("tsne_forces_dense: P lies on "
                             f"{p_dense.device}, the buffers on {self.device}")
        if not p_dense.is_contiguous() or p_dense.data_ptr() % 16:
            raise ValueError("tsne_forces_dense: P must be contiguous and "
                             "16-byte aligned")
        self._p = p_dense

    def launch(self, y: torch.Tensor, p_dense: torch.Tensor, n_valid: int):
        """One kernel launch on the current stream: only what can change
        from call to call is checked (y; P when it is another tensor)."""
        self._check_p(p_dense)
        if (y.shape != (self.npad, 2) or y.dtype != torch.float32
                or not y.is_cuda or not y.is_contiguous()
                or y.data_ptr() % 16):
            _check_y("tsne_forces_dense", y, n_valid)
            raise ValueError("tsne_forces_dense: y must be a contiguous, "
                             f"16-byte aligned [{self.npad}, 2] float32 "
                             "tensor on the buffers' card")
        if not 0 <= n_valid <= self.npad:
            raise ValueError(f"tsne_forces_dense: n_valid {n_valid} outside "
                             f"[0, {self.npad}]")
        plan, args = (self._args.get(n_valid)
                      or self._launch_args(n_valid))
        self.plan = plan
        index = self.device.index
        if index == torch.cuda.current_device() and y.get_device() == index:
            err = self._fn(y.data_ptr(), p_dense.data_ptr(), self.npad,
                           n_valid, *args, self._stream(index))
        elif y.get_device() == index:
            with torch.cuda.device(index):
                err = self._fn(y.data_ptr(), p_dense.data_ptr(), self.npad,
                               n_valid, *args, self._stream(index))
        else:
            raise ValueError(f"tsne_forces_dense: y lies on {y.device}, the "
                             f"buffers on {self.device}")
        if err != 0:
            raise RuntimeError("tsne_forces_dense: launch failed with CUDA "
                               f"error {err}")


def _check_inputs(y: torch.Tensor, p_dense: torch.Tensor, n_valid: int):
    npad = y.shape[0]
    _check_y("tsne_forces_dense", y, n_valid)
    if tuple(p_dense.shape) != (npad, npad):
        raise ValueError(f"tsne_forces_dense: P must be [{npad}, {npad}], "
                         f"got {tuple(p_dense.shape)}")
    if p_dense.dtype != torch.float32:
        raise TypeError("tsne_forces_dense: y and P must be float32")
    if y.device != p_dense.device:
        raise ValueError("tsne_forces_dense: y and P lie on different "
                         f"devices ({y.device}, {p_dense.device})")


def tsne_forces_dense(y: torch.Tensor, p_dense: torch.Tensor, n_valid: int,
                      out: DenseForces = None):
    """Fused attraction and repulsion over a dense joint P.

    y [Npad, 2], p_dense [Npad, Npad] (zero off the support and on pads),
    n_valid the number of real rows -> (attr [Npad, 2], rep [Npad, 2],
    Z 0-d tensor), on the card Z summed in the kernel in a fixed order
    (csrc/tsne_forces_dense.cu).  Pad rows come out 0.  out: a
    ``DenseForces`` of y's Npad and device, whose buffers the results are
    (allocated here when None; the next call with the same ``out``
    overwrites them).  A CPU tensor takes the twin.
    """
    n_valid = int(n_valid)
    if y.is_cuda:
        if out is None:
            out = DenseForces(y.shape[0], y.device)
        out.launch(y, p_dense, n_valid)
        tsne_forces_dense.launches += 1
        return out.attr, out.rep, out.z
    if y.device.type != "cpu":
        raise ValueError(f"tsne_forces_dense: no kernel for {y.device}")
    attr, rep, z = tsne_forces_dense_reference(y, p_dense, n_valid)
    if out is None:
        return attr, rep, z
    out.attr.copy_(attr)
    out.rep.copy_(rep)
    out.z.copy_(z)
    return out.attr, out.rep, out.z


tsne_forces_dense.launches = 0


def forces_rcp_mismatches(device="cuda", lo: int = 0x3F800000,
                          hi: int = 0x7E800000) -> int:
    """How many float32 x, as bit patterns in [lo, hi) (by default every
    float in [1, 2^126)), the kernel's reciprocal (csrc ``rcp_ge1``) gives
    other bits for than IEEE 1 / x (``__frcp_rn``): one launch of
    ``tsne_forces_dense_rcp_check`` on the card."""
    fn = _library("tsne_forces_dense").tsne_forces_dense_rcp_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, _P, _P]
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        err = fn(lo, hi - lo, count.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("tsne_forces_dense_rcp_check: launch failed with "
                           f"CUDA error {err}")
    return int(count)


def tsne_forces_dense_reference(y: torch.Tensor, p_dense: torch.Tensor,
                                n_valid: int, row_block: int = 1024):
    """The plain PyTorch twin: the same seven row sums over row blocks of
    the dense tile, on whatever device the tensors lie, and Z as torch's
    sum of the rows' z.  The kernel adds the rows' z in another fixed
    order (csrc/tsne_forces_dense.cu); the twin keeps torch's, because the
    dense tier's CPU trajectory turns on Z's last bit (one ulp of Z moves
    the KL after 250 iterations of tests/test_torch_pipeline.py's scene by
    8-29 %)."""
    n_valid = int(n_valid)
    _check_inputs(y, p_dense, n_valid)
    npad = y.shape[0]
    ids = torch.arange(npad, device=y.device)
    col_ok = ids < n_valid
    yx, yy = y[:, 0], y[:, 1]
    sums = torch.zeros((7, npad), dtype=torch.float32, device=y.device)
    for r0 in range(0, npad, row_block):
        r1 = min(r0 + row_block, npad)
        rows = ids[r0:r1, None]
        dx = yx[r0:r1, None] - yx[None, :]
        dy = yy[r0:r1, None] - yy[None, :]
        w = 1.0 / (1.0 + dx * dx + dy * dy)
        valid = (rows != ids[None, :]) & col_ok[None, :] & (rows < n_valid)
        w = torch.where(valid, w, 0.0)
        pw = torch.where(valid, p_dense[r0:r1], 0.0) * w
        w2 = w * w
        sums[:, r0:r1] = torch.stack([
            w2.sum(1), (w2 * yx).sum(1), (w2 * yy).sum(1), w.sum(1),
            pw.sum(1), (pw * yx).sum(1), (pw * yy).sum(1)])
    s2, ax, ay, zrow, sa, bx, by = sums
    row_ok = (ids < n_valid)[:, None]
    rep = torch.where(row_ok, torch.stack([s2 * yx - ax, s2 * yy - ay], 1),
                      0.0)
    attr = torch.where(row_ok, torch.stack([sa * yx - bx, sa * yy - by], 1),
                       0.0)
    return attr, rep, zrow.sum()


# ---------------------------------------------------------------------------
# tsne_repulsion
# ---------------------------------------------------------------------------

REPULSION_TILE = 512         # rows a block: 128 threads of 4 rows
REPULSION_CHUNK = 128        # columns a partial sum; a split is a multiple
REPULSION_UNITS_PER_SM = 32  # units a plan aims at for each SM


@dataclass(frozen=True)
class RepulsionPlan:
    """How ``csrc/tsne_repulsion.cu`` cuts the n_valid x n_valid pairs:
    ``tiles`` row tiles of REPULSION_TILE rows by ``splits`` column ranges
    of ``split_cols`` columns (the last one ends at n_valid); one block for
    each (tile, split), ``blocks`` in all."""
    n_valid: int
    tiles: int
    split_cols: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def unit(self, block: int):
        """(row_lo, row_hi, col_lo, col_hi) of a block, as the kernel
        derives them from its index."""
        tile, split = divmod(block, self.splits)
        return (tile * REPULSION_TILE,
                min((tile + 1) * REPULSION_TILE, self.n_valid),
                split * self.split_cols,
                min((split + 1) * self.split_cols, self.n_valid))


def repulsion_plan(n_valid: int, sms: int = 132) -> RepulsionPlan:
    """The launch plan for n_valid points on a card of `sms` SMs: split the
    columns until there are REPULSION_UNITS_PER_SM units an SM (many small
    units leave no ragged last wave), in splits of whole chunks."""
    if n_valid == 0:
        return RepulsionPlan(0, 0, REPULSION_CHUNK, 1)
    tiles = -(-n_valid // REPULSION_TILE)
    splits = min(-(-REPULSION_UNITS_PER_SM * sms // tiles),
                 -(-n_valid // REPULSION_CHUNK))
    split_cols = -(-n_valid // splits)
    split_cols = -(-split_cols // REPULSION_CHUNK) * REPULSION_CHUNK
    return RepulsionPlan(n_valid, tiles, split_cols, -(-n_valid // split_cols))


def tsne_repulsion_blocks_per_sm() -> int:
    """Blocks of the kernel resident on one SM of the current card, from
    the CUDA occupancy calculator."""
    fn = _library("tsne_repulsion").tsne_repulsion_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = []
    blocks = fn()
    if blocks < 0:
        raise RuntimeError(f"tsne_repulsion: occupancy query failed with "
                           f"CUDA error {-blocks}")
    return blocks


def _check_scenes_y(y: torch.Tensor, n_valid: int):
    """y [Npad, 2] or [S, Npad, 2] float32 with 0 <= n_valid <= Npad."""
    if y.dim() == 3:
        if y.shape[0] < 1:
            raise ValueError("tsne_repulsion: no scenes")
        _check_y("tsne_repulsion", y[0], n_valid)
    else:
        _check_y("tsne_repulsion", y, n_valid)


def _window(npad: int, rows) -> tuple[int, int]:
    r0, r1 = (0, npad) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= npad:
        raise ValueError(f"tsne_repulsion: rows {rows} outside [0, {npad}]")
    return r0, r1


def tsne_repulsion_rows(y: torch.Tensor, n_valid: int, rows=None):
    """Exact all-pairs repulsion per row: y [Npad, 2] (any Npad >= n_valid;
    rows at or past n_valid may hold anything) -> (rep [Npad, 2], zrow
    [Npad]) with rep_i = sum_j w_ij^2 (y_i - y_j) and zrow_i = sum_j w_ij
    over j != i, j < n_valid.  Pad rows come out 0.  The kernel on a CUDA
    tensor (counted in ``tsne_repulsion.launches``), launched by
    ``repulsion_plan`` for the card; the twin on a CPU one.

    y [S, Npad, 2] holds S scenes of one n_valid, all in one launch: rep
    [S, Npad, 2], zrow [S, Npad].  rows=(r0, r1) computes only those rows,
    against every column: rep [..., r1 - r0, 2], zrow [..., r1 - r0].  The
    plan comes from n_valid alone, so each row's result is bit-equal to the
    one-scene, all-rows call's.
    """
    n_valid = int(n_valid)
    _check_scenes_y(y, n_valid)
    if y.device.type == "cpu":
        return tsne_repulsion_reference(y, n_valid, rows=rows)
    _check_kernel_device("tsne_repulsion", y)
    if y.data_ptr() % 8:
        raise ValueError("tsne_repulsion: y must be 8-byte aligned")
    scenes = y.shape[0] if y.dim() == 3 else 1
    npad = y.shape[-2]
    r0, r1 = _window(npad, rows)
    plan = repulsion_plan(n_valid, sm_count(y.device))
    lead = y.shape[:-2]
    rep = torch.empty((*lead, r1 - r0, 2), dtype=torch.float32,
                      device=y.device)
    zrow = torch.empty((*lead, r1 - r0), dtype=torch.float32,
                       device=y.device)
    scratch = (torch.empty((scenes, plan.splits, r1 - r0, 3),
                           dtype=torch.float32, device=y.device)
               if plan.splits > 1 else None)
    _launch("tsne_repulsion", y.device, y.data_ptr(), scenes, npad, n_valid,
            r0, r1, plan.split_cols, plan.splits,
            None if scratch is None else scratch.data_ptr(), rep.data_ptr(),
            zrow.data_ptr())
    tsne_repulsion.launches += 1
    return rep, zrow


def tsne_repulsion(y: torch.Tensor, n_valid: int):
    """Exact all-pairs repulsion: y [Npad, 2] -> (rep [Npad, 2], Z 0-d
    tensor), Z = sum_{i != j} w_ij summed from the per-row partials outside
    the kernel, as the TPU kernel's caller sums them."""
    rep, zrow = tsne_repulsion_rows(y, n_valid)
    return rep, zrow.sum()


tsne_repulsion.launches = 0


def tsne_repulsion_reference(y: torch.Tensor, n_valid: int, rows=None,
                             max_elements: int = 1 << 26):
    """The plain PyTorch twin of ``tsne_repulsion_rows``, in the direct
    difference form of the TPU kernel, over row blocks of at most
    `max_elements` pairs.

    rows=(r0, r1) computes only those rows (against all columns) and returns
    (rep [r1 - r0, 2], zrow [r1 - r0]); y [S, Npad, 2] gives each scene's,
    stacked.  The weights are float32, as in the kernel; the row sums are
    taken in float64 and rounded once, so that a comparison measures the
    kernel's summation error and not the twin's.
    """
    n_valid = int(n_valid)
    _check_scenes_y(y, n_valid)
    if y.dim() == 3:
        outs = [tsne_repulsion_reference(ys, n_valid, rows, max_elements)
                for ys in y]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    r0, r1 = _window(y.shape[0], rows)
    dev = y.device
    rep = torch.zeros((r1 - r0, 2), dtype=torch.float32, device=dev)
    zrow = torch.zeros(r1 - r0, dtype=torch.float32, device=dev)
    cx, cy = y[:n_valid, 0], y[:n_valid, 1]
    cols = torch.arange(n_valid, device=dev)
    block = max(1, max_elements // max(n_valid, 1))
    f64 = torch.float64
    for b0 in range(r0, min(r1, n_valid), block):
        b1 = min(b0 + block, r1, n_valid)
        bx, by = y[b0:b1, 0:1], y[b0:b1, 1:2]
        dx = bx - cx[None, :]
        dy = by - cy[None, :]
        w = 1.0 / (1.0 + (dx * dx + dy * dy))
        self_pair = cols[None, :] == torch.arange(b0, b1, device=dev)[:, None]
        w = torch.where(self_pair, 0.0, w)
        w2 = w * w
        s2 = w2.sum(1, dtype=f64)
        ax = (w2 * cx[None, :]).sum(1, dtype=f64)
        ay = (w2 * cy[None, :]).sum(1, dtype=f64)
        rep[b0 - r0:b1 - r0] = torch.stack(
            [s2 * bx[:, 0].to(f64) - ax, s2 * by[:, 0].to(f64) - ay],
            1).float()
        zrow[b0 - r0:b1 - r0] = w.sum(1, dtype=f64).float()
    return rep, zrow


# ---------------------------------------------------------------------------
# tsne_attraction
# ---------------------------------------------------------------------------

# gathered entries up to which the twin takes all rows at once, and the size
# of each row piece above it (the JAX package's _attractive_forces defaults)
ATTR_FUSE_MAX = 1 << 25
ATTR_PIECE = 1 << 23


def attraction_chunk(npts: int, width: int, fuse_max: int = ATTR_FUSE_MAX,
                     piece: int = ATTR_PIECE) -> int:
    """Rows a piece of the twin's gather: all rows up to `fuse_max`
    entries, else pieces of about `piece` entries (a multiple of 8 rows).
    The pieces bound memory and leave the result as it is."""
    if npts * width <= fuse_max:
        return max(npts, 1)
    rows8 = -(-npts // 8) * 8
    return min(max((piece // width) // 8 * 8, 8), rows8)


def _check_attraction(y: torch.Tensor, p_idx: torch.Tensor,
                      p_val: torch.Tensor, row0: int, table, prm):
    name = "tsne_attraction"
    _check_y(name, y, 0)
    if p_idx.dim() != 2 or tuple(p_val.shape) != tuple(p_idx.shape):
        raise ValueError(f"{name}: P ids {tuple(p_idx.shape)} and values "
                         f"{tuple(p_val.shape)} must be one [rows, W] shape")
    if p_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: P ids must be int32, got {p_idx.dtype}")
    if p_val.dtype != torch.float32:
        raise TypeError(f"{name}: P values must be float32, got "
                        f"{p_val.dtype}")
    if not 0 <= row0 <= y.shape[0] - p_idx.shape[0]:
        raise ValueError(f"{name}: rows {row0} .. {row0 + p_idx.shape[0]} "
                         f"outside y's {y.shape[0]}")
    if (table is None) != (prm is None):
        raise ValueError(f"{name}: a packed call takes both table and prm")
    if table is not None:
        if table.dtype != torch.int32 or tuple(table.shape) != (y.shape[0],):
            raise ValueError(f"{name}: the table must be int32 [{y.shape[0]}]"
                             f", got {table.dtype} {tuple(table.shape)}")
        if prm.dtype != torch.float32 or prm.numel() != 4:
            raise ValueError(f"{name}: prm must be float32 (lo0, s0, lo1, "
                             "s1)")
    devices = {t.device for t in (y, p_idx, p_val, table, prm)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")


def tsne_attraction(y: torch.Tensor, p_idx: torch.Tensor,
                    p_val: torch.Tensor, row0: int = 0, table=None,
                    prm=None, chunk: int = 0) -> torch.Tensor:
    """The sparse attraction sum_j p_ij w_ij (y_i - y_j) over P's support.

    y [Npad, 2] float32; p_idx [rows, W] int32 (-1 pads) and p_val [rows, W]
    float32 are the P rows of the points row0 .. row0 + rows of y (a row
    shard, whose column ids are global) -> attr [rows, 2].  With table and
    prm from ``ops.packing.pack_positions`` (over all of y's rows) the
    neighbours' positions are read from the u16 table, as the JAX package's
    packed gather reads them.  The kernel on a CUDA tensor (counted in
    ``tsne_attraction.launches``); on a CPU one the twin, in row pieces of
    `chunk` rows (0: ``attraction_chunk``).
    """
    row0 = int(row0)
    _check_attraction(y, p_idx, p_val, row0, table, prm)
    if y.device.type == "cpu":
        return tsne_attraction_reference(y, p_idx, p_val, row0, table, prm,
                                         chunk)
    _check_kernel_device("tsne_attraction", y, p_idx, p_val,
                         *((table, prm) if table is not None else ()))
    if p_idx.dtype != torch.int32:
        raise TypeError("tsne_attraction: the kernel takes int32 P ids (cast "
                        "them once at set-up)")
    rows, width = p_idx.shape
    out = torch.empty((rows, 2), dtype=torch.float32, device=y.device)
    _launch("tsne_attraction", y.device, y.data_ptr(),
            None if table is None else table.data_ptr(),
            None if prm is None else prm.data_ptr(), p_idx.data_ptr(),
            p_val.data_ptr(), rows, width, row0, out.data_ptr())
    tsne_attraction.launches += 1
    return out


tsne_attraction.launches = 0


def tsne_attraction_reference(y: torch.Tensor, p_idx: torch.Tensor,
                              p_val: torch.Tensor, row0: int = 0, table=None,
                              prm=None, chunk: int = 0) -> torch.Tensor:
    """The plain PyTorch twin of ``tsne_attraction`` (JAX:
    ``_attractive_forces``, packed or not), on whatever device the tensors
    lie, in row pieces that bound the gathered [rows, W] buffers."""
    from .packing import unpack_positions
    row0 = int(row0)
    _check_attraction(y, p_idx, p_val, row0, table, prm)
    npts, width = p_idx.shape
    out = torch.empty((npts, 2), dtype=torch.float32, device=y.device)
    chunk = chunk or attraction_chunk(npts, width)
    for r0 in range(0, npts, chunk):
        r1 = min(r0 + chunk, npts)
        ids = p_idx[r0:r1]
        safe = torch.clamp(ids, min=0)
        if table is None:
            n0, n1 = y[:, 0][safe], y[:, 1][safe]
        else:
            n0, n1 = unpack_positions(table[safe], prm)
        d0 = y[row0 + r0:row0 + r1, 0:1] - n0
        d1 = y[row0 + r0:row0 + r1, 1:2] - n1
        w = 1.0 / (1.0 + d0 * d0 + d1 * d1)
        coef = torch.where(ids >= 0, p_val[r0:r1] * w, 0.0)
        out[r0:r1, 0] = (coef * d0).sum(1)
        out[r0:r1, 1] = (coef * d1).sum(1)
    return out


# the grid tier's kernels, whose wrappers and twins live beside the FFT
from .tsne_grid import grid_deposit, grid_interpolate  # noqa: E402,F401
