#!/usr/bin/env python3
"""Time the grid tier's charge deposit on one CUDA card.

    python3 scripts/grid_deposit_readout.py [--out FILE]

At 10^6 points on four synthetic layouts (a 16-cluster mixture spanning
+-35, as the 1M t-SNE ends; a wide and a narrow Gaussian; a crowded one,
most points within 0.05 of 16 centres) and grid sizes 128-1024, times
four designs with CUDA events and checks that five calls give the same
bits:

- ``kernel``: sph_tpu_torch.ops.tsne_grid.grid_deposit, the CUDA kernel
  (csrc/grid_deposit.cu) after the keys and the stable sort, timed also
  with DEPOSIT_DENSE_POINTS set to each of DENSE (the cells above it are
  summed in pieces), with its keys and sort alone;
- ``twin``: its plain twin's deposit from the taps (deposit_charges: a
  sort by base cell, the inputs gathered once in that order, segment
  sums in pieces, then 16 shifted adds), which the kernel equals bit for
  bit;
- ``index_add``: one index_add_ of the 16 c weighted charges (the deposit
  before the twin, which adds with atomics);
- ``segment_shifted_adds``: one segment sum a cell over charges gathered
  after they are built, added onto the grid as 16 shifted planes (the
  first fixed-order design, slower).

Prints one JSON line per (layout, grid) and the card's nvidia-smi line;
writes them to --out (default out/grid_deposit_readout.jsonl).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1_000_000
CASES = (("mixture_35", 128), ("mixture_35", 256), ("mixture_35", 1024),
         ("gauss_30", 512), ("gauss_3", 128), ("crowded", 256))


def charges48(q, wx, wy):
    """[c, 48] weighted tap charges wy * (q * wx) of the charges q [c, 3],
    laid out (q, du, dv)."""
    qx = q[:, :, None] * wx[:, None, :]
    return (wy[:, None, :, None] * qx[:, :, None, :]).reshape(-1, 48)


def unit_charges(y):
    """[c, 3] charges (1, y_x, y_y)."""
    import torch
    ones = torch.ones((y.shape[0], 1), dtype=y.dtype, device=y.device)
    return torch.cat([ones, y], 1)


def index_add(y, cells, wx, wy, grid):
    import torch
    c = y.shape[0]
    src = charges48(unit_charges(y), wx, wy).view(c, 3, 16).transpose(1, 2)
    out = torch.zeros((grid * grid, 3), dtype=y.dtype, device=y.device)
    out.index_add_(0, cells.reshape(-1), src.reshape(c * 16, 3))
    return out.T.reshape(3, grid, grid)


def segment_sums(y, cells, wx, wy, grid):
    import torch
    base = cells[:, 0]
    order = torch.sort(base, stable=True).indices
    bounds = torch.searchsorted(
        base[order], torch.arange(grid * grid + 1, device=y.device))
    src = charges48(unit_charges(y), wx, wy)[order]
    return torch.segment_reduce(src, "sum", offsets=bounds, axis=0,
                                initial=0.0)


def segment_shifted_adds(y, cells, wx, wy, grid):
    import torch
    taps = segment_sums(y, cells, wx, wy, grid).T.reshape(3, 4, 4, grid,
                                                          grid)
    out = torch.zeros((3, grid + 3, grid + 3), dtype=y.dtype,
                      device=y.device)
    for du in range(4):
        for dv in range(4):
            out[:, du:du + grid, dv:dv + grid] += taps[:, du, dv]
    return out[:, :grid, :grid]


DENSE = (0, 4, 16, 64)


def kernel_steps(y, lo, h, grid, ms) -> dict:
    """Milliseconds of grid_deposit's keys and stable sort alone, of the
    whole call at each DENSE threshold (each bit-equal to the default's),
    and the cells' load."""
    import torch
    from sph_tpu_torch.ops import tsne_grid as G
    base = G.base_cells(G.grid_coords(y, lo, h), grid)
    counts = torch.bincount(base, minlength=grid * grid)
    want = G.grid_deposit(y, lo, h, grid)
    out = {"keys_and_sort": ms(lambda: torch.sort(G.base_cells(
        G.grid_coords(y, lo, h), grid), stable=True))}
    default = G.DEPOSIT_DENSE_POINTS
    try:
        for dense in DENSE:
            G.DEPOSIT_DENSE_POINTS = dense
            out[f"dense_{dense}"] = ms(lambda: G.grid_deposit(y, lo, h,
                                                              grid))
            if not torch.equal(G.grid_deposit(y, lo, h, grid), want):
                raise AssertionError(f"grid_deposit: dense {dense} gives "
                                     "other bits")
    finally:
        G.DEPOSIT_DENSE_POINTS = default
    out["points_in_fullest_cell"] = int(counts.max())
    out["occupied_cells"] = int((counts > 0).sum())
    out["cells_above_default_dense"] = int(
        (counts > G.DEPOSIT_DENSE_POINTS).sum())
    return out


def layouts(seed: int = 0) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-30, 30, (16, 2))
    mix = centres[rng.integers(0, 16, N)] + rng.standard_normal((N, 2)) * 2.5
    crowd = mix.copy()
    crowd[: N * 9 // 10] = (centres[rng.integers(0, 16, N * 9 // 10)]
                            + rng.standard_normal((N * 9 // 10, 2)) * 0.05)
    return {"mixture_35": mix.astype(np.float32),
            "crowded": crowd.astype(np.float32),
            "gauss_30": (rng.standard_normal((N, 2)) * 30).astype(np.float32),
            "gauss_3": (rng.standard_normal((N, 2)) * 3).astype(np.float32)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "grid_deposit_readout.jsonl"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grid_deposit_readout: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from sph_tpu_torch.ops import tsne_grid as G
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    def ms(fn):
        return chip_smoke.cuda_ms(fn, 20, 3)

    emit({"nvidia_smi": chip_smoke.nvidia_smi_line(), "n": N})
    ys = layouts()
    for name, grid in CASES:
        y = torch.from_numpy(ys[name]).cuda()
        lo, h = G.grid_box(y, N, grid)
        cells, wx, wy = G.grid_taps(y, lo, h, grid)
        ref = index_add(y, cells, wx, wy, grid)
        row = {"layout": name, "grid": grid,
               "kernel_steps_ms": kernel_steps(y, lo, h, grid, ms)}
        for design, fn in (
                ("kernel", lambda *_: G.grid_deposit(y, lo, h, grid)),
                ("twin", G.deposit_charges),
                ("index_add", index_add),
                ("segment_shifted_adds", segment_shifted_adds)):
            outs = [fn(y, cells, wx, wy, grid) for _ in range(5)]
            row[design] = {
                "ms": ms(lambda: fn(y, cells, wx, wy, grid)),
                "bits_equal_5_calls": all(torch.equal(outs[0], o)
                                          for o in outs[1:]),
                "max_rel_vs_index_add": float(
                    (outs[0] - ref).abs().max() / ref.abs().max())}
        row["kernel"]["bits_equal_twin"] = bool(torch.equal(
            G.grid_deposit(y, lo, h, grid),
            G.deposit_charges(y, cells, wx, wy, grid)))
        if not row["kernel"]["bits_equal_twin"]:
            raise AssertionError(f"grid_deposit differs from its twin at "
                                 f"{name}, G = {grid}")
        emit(row)
        del y, cells, wx, wy, ref
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
