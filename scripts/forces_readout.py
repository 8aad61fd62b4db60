#!/usr/bin/env python3
"""What the built tsne_forces_dense kernel is, and how fast, on one CUDA card.

    python3 scripts/forces_readout.py [--repo CHECKOUT] [--out FILE]

Builds ``csrc/tsne_forces_dense.cu`` of the sph_tpu_torch in CHECKOUT (this
one by default; another checkout, such as an older commit unpacked with
``git archive``, to compare versions on the same card) and prints JSON
lines:

- ``resources``: the kernel's registers, stack, shared and local memory
  (``cuobjdump --dump-resource-usage``);
- ``sass``: the innermost loops that take reciprocals (``cuobjdump -sass``),
  each with its instructions, its ``MUFU.RCP`` count and the instructions
  a reciprocal, which is the issue slots a pair;
- ``times``: the wrapper at chip_smoke.py's FORCES_SHAPES on this
  checkout's seeded P (``random_joint_p``): ms a call over back-to-back
  calls (CUDA events; the host's cost shows where it is the larger, as
  in the dense tier's loop), the device time a call of each kernel the
  call launches (``torch.profiler``; "not measured" where it reports
  none), and the bytes bound.  A checkout whose wrapper takes caller-owned
  buffers (``DenseForces``) is called with them, an older one without;
- ``plans`` (with ``--plans``, a checkout with ``forces_plan``): the same
  times under other launch plans, each ``BLOCKS_PER_SM:MAX_SPLIT`` (0 for
  no cut), e.g. ``--plans 1:16384,1:0,8:0``;

then the ``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_ms(fn, calls: int = 20) -> dict:
    """Device milliseconds a call of each CUDA kernel `fn` launches, from
    torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0.0)
        if total:
            out[e.key[:80]] = total / calls / 1e3
    return out or {"all": "not measured"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--out", default=None)
    ap.add_argument("--plans", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("forces_readout: no CUDA device", file=sys.stderr)
        return 2
    cs = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    readout = _load("repulsion_readout",
                    os.path.join(REPO, "scripts", "repulsion_readout.py"))
    sys.path.insert(0, os.path.abspath(args.repo))
    from sph_tpu_torch.ops import tsne_kernels as K
    with open(K.source("tsne_forces_dense"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    library = K.build("tsne_forces_dense")["tsne_forces_dense"]
    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, library], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    lines = [{"readout": "resources", "repo": os.path.abspath(args.repo),
              "source_sha256": digest,
              "kernels": readout.resource_usage(dump("--dump-resource-usage"))},
             {"readout": "sass", "source_sha256": digest,
              "loops": readout.sass_loops(dump("-sass"))}]
    buffers = getattr(K, "DenseForces", None)
    times = []
    for i, (n, npad) in enumerate(cs.FORCES_SHAPES):
        y, p = cs.random_joint_p(n, npad, seed=11 + i)
        if buffers is not None:
            out = buffers(npad, y.device)

            def call():
                return K.tsne_forces_dense(y, p, n, out=out)
        else:
            def call():
                return K.tsne_forces_dense(y, p, n)
        times.append({"n": n, "npad": npad, "ms": cs.cuda_ms(call, 200),
                      "device_ms": device_ms(call),
                      **cs.forces_bound(n, npad)})
        del y, p
    lines.append({"readout": "times", "source_sha256": digest,
                  "caller_owned_buffers": buffers is not None,
                  "times": times})
    plans = []
    for spec in filter(None, args.plans.split(",")):
        per_sm, max_split = (int(v) for v in spec.split(":"))
        for i, (n, npad) in enumerate(cs.FORCES_SHAPES):
            y, p = cs.random_joint_p(n, npad, seed=11 + i)
            out = buffers(npad, y.device, per_sm, max_split or 1 << 30)
            ms = cs.cuda_ms(lambda: K.tsne_forces_dense(y, p, n, out=out),
                            200)
            plans.append({"plan_spec": spec, "n": n, "npad": npad,
                          "blocks": out.plan.blocks,
                          "splits": out.plan.splits, "ms": ms,
                          **cs.forces_bound(n, npad)})
            del y, p, out
    if plans:
        lines.append({"readout": "plans", "source_sha256": digest,
                      "times": plans})
    text = "\n".join([json.dumps(line) for line in lines]
                     + [cs.nvidia_smi_line()])
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
