#!/usr/bin/env python3
"""walk_row_sort's variants side by side on the card, in turns.

    python3 scripts/walk_sort_variants.py [--variant NAME:CONST=V,...]...
        [--other NAME:SOURCE]... [--parent SOURCE] [--shapes NAME,...]
        [--repeats 5] [--out FILE]

Builds csrc/walk_row_sort.cu as it stands ("current") and once more for
each --variant, with the named `constexpr int` constants of the source
set to other values (e.g. ``--variant w16:kWarpsPerBlock=16``), each
--other from its own SOURCE with the same C interface, and, with --parent,
a kernel of the earlier C interface (keys, rows, cols, sorted keys, order,
stream: no scratch) from SOURCE, each into a temporary directory.  On
each shape (walk-like rows near their start point, as
chip_smoke.walk_like_rows makes them, or chip_smoke's synthetic rows with
the median-of-3 adversary) it times every kernel by CUDA events, twice,
in the order A B ... B A, checks that every kernel's order and sorted
keys equal the current kernel's on every row, and holds 256 sampled rows
of the current kernel against the twin (native/xla_sort.cpp).  Prints
one JSON line a shape and the card's nvidia-smi line, and writes them to
--out (default out/walk_sort_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = {
    "walk_like_21025x500": ("walk_like", 21025, 500),
    "synthetic_500": ("synthetic", 16, 500),
    "synthetic_4096": ("synthetic", 16, 4096),
    "walk_like_64x4096": ("walk_like", 64, 4096),
    "walk_like_64x50000": ("walk_like", 64, 50000),
    "walk_like_5358x50000": ("walk_like", 5358, 50000),
}


def build(src_text: str, out_dir: str, name: str) -> str:
    from sph_tpu_torch.ops import cuda_build
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(src_text)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                    src], check=True)
    return lib


def with_constants(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"no constexpr int {name} in the source")
    return text


def loader(lib_path: str, parent: bool):
    import torch
    fn = ctypes.CDLL(lib_path).walk_row_sort_launch
    fn.restype = ctypes.c_int
    p = ctypes.c_void_p
    fn.argtypes = ([p, ctypes.c_longlong, ctypes.c_int, p, p, p] if parent
                   else [p, ctypes.c_longlong, ctypes.c_int, p, p, p, p])

    def call(keys, bufs):
        rows, cols = keys.shape
        order, out, scratch = bufs
        extra = () if parent else (scratch.data_ptr(),)
        err = fn(keys.data_ptr(), rows, cols, out.data_ptr(),
                 order.data_ptr(), *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")
        return order, out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--parent")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "walk_sort_variants.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("walk_sort_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sph_tpu_torch import native
    from sph_tpu_torch.ops import cuda_build, walk_sort
    cs.DEV = "cuda"

    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    with open(cuda_build.source("walk_row_sort")) as f:
        text = f.read()
    tmp = tempfile.mkdtemp(prefix="walk_sort_variants_")
    kernels = {"current": loader(build(text, tmp, "current"), False)}
    for spec in args.variant:
        name, _, assigns = spec.partition(":")
        consts = dict(a.split("=") for a in assigns.split(","))
        kernels[name] = loader(build(with_constants(text, consts), tmp,
                                     name), False)
        emit({"variant": name, "constants": consts})
    for spec in args.other:
        name, _, path = spec.partition(":")
        with open(path) as f:
            kernels[name] = loader(build(f.read(), tmp, name), False)
        emit({"other": name, "source": path})
    if args.parent:
        with open(args.parent) as f:
            kernels["parent"] = loader(build(f.read(), tmp, "parent"), True)
    names = list(kernels)

    for shape in args.shapes.split(","):
        kind, rows, cols = SHAPES[shape]
        keys = (cs.walk_like_rows(rows, cols) if kind == "walk_like"
                else cs.walk_sort_synthetic(walk_sort, cols, rows))
        keys = keys.to(torch.int32).contiguous()
        r, c = keys.shape
        bufs = (torch.empty((r, c), dtype=torch.int64, device="cuda"),
                torch.empty((r, c), dtype=torch.int32, device="cuda"),
                torch.empty((r, c), dtype=torch.int32, device="cuda"))
        ref_order, ref_keys = (t.clone() for t in kernels["current"](
            keys, bufs))
        torch.cuda.synchronize()
        pick = np.random.default_rng(1).choice(r, min(256, r), replace=False)
        want, want_keys = native.xla_sort_order(keys[pick].cpu().numpy())
        twin_rows_differ = int(
            (ref_order[pick].cpu().numpy() != want).any(1).sum()
            + (ref_keys[pick].cpu().numpy() != want_keys).any(1).sum())
        equal = {}
        for name in names:
            order, out = kernels[name](keys, bufs)
            equal[name] = bool(torch.equal(order, ref_order)
                               and torch.equal(out, ref_keys))
        wide = c > 10000 and r > 1000
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            reps = 1 if name == "parent" and c > 3072 else args.repeats
            ms[name].append(cs.cuda_ms(lambda: kernels[name](keys, bufs),
                                       calls=reps, warmup=0 if wide else 1))
        torch_ms = cs.cuda_ms(lambda: torch.sort(keys, dim=1, stable=True),
                              calls=args.repeats, warmup=1)
        emit({"shape": shape, "rows": r, "cols": c, "ms": ms,
              "torch_sort_stable_ms": torch_ms,
              **cs.walk_sort_bound(r, c),
              "equal_to_current": equal,
              "current_vs_twin_sampled_rows": len(pick),
              "current_vs_twin_rows_differ": twin_rows_differ})
        if twin_rows_differ or not all(equal.values()):
            raise AssertionError(f"{shape}: a kernel differs")
        del keys, bufs, ref_order, ref_keys
        torch.cuda.empty_cache()
    emit({"device": cs.nvidia_smi_line()})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
