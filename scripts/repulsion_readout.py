#!/usr/bin/env python3
"""What the built tsne_repulsion kernel is, and how fast, on one CUDA card.

    python3 scripts/repulsion_readout.py [--repo CHECKOUT] [--out FILE]

Builds ``csrc/tsne_repulsion.cu`` of the sph_tpu_torch in CHECKOUT (this
one by default; another checkout, such as an older commit unpacked with
``git archive``, to compare versions on the same card) and prints JSON
lines:

- ``resources``: each kernel's registers, stack, shared and local memory
  (``cuobjdump --dump-resource-usage``), and the blocks resident on an SM
  where the library reports them;
- ``sass``: the innermost loops that take reciprocals (``cuobjdump -sass``),
  each with its instructions, its ``MUFU.RCP`` count and the instructions
  a reciprocal, which in the pair loop is the issue slots a pair; the
  unmasked pair loop is the one with the fewest;
- ``times``: ``tsne_repulsion_rows`` at the shapes of chip_smoke.py's
  REPULSION_SHAPES (CUDA events, the default launch plan), each with its
  operations bound, its SFU floor and its issue floor at the SASS count,
  at the card's SM count and maximum SM clock;

then the ``nvidia-smi --query-gpu=name,power.limit`` line.  A loop shape
the parser does not find is reported, not raised.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path so that CHECKOUT's own
    copy is not the one imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sass_loops(text: str) -> dict:
    """The innermost loops of each function in `cuobjdump -sass` output
    that take reciprocals (MUFU.RCP): for each, its instructions (NOPs left
    out), its reciprocals, and the instructions a reciprocal.  A loop is a
    branch back to an address at or before its own; innermost, when it
    holds no other."""
    funcs, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn is not None:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, insts in funcs.items():
        loops = []
        for addr, op in insts:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if b and int(b.group(1), 16) <= addr:
                loops.append((int(b.group(1), 16), addr))
        inner = [lp for lp in loops if not any(
            lp[0] <= o[0] and o[1] <= lp[1] and o != lp for o in loops)]
        found = []
        for lo, hi in sorted(inner):
            body = [op for a, op in insts
                    if lo <= a <= hi and not op.startswith("NOP")]
            rcp = sum("MUFU.RCP" in op for op in body)
            if rcp:
                found.append({"instructions": len(body), "rcp": rcp,
                              "slots_per_pair": len(body) / rcp})
        if found:
            out[fn] = found
    return out


def resource_usage(text: str) -> dict:
    """Each function's registers, stack, shared and local bytes from
    `cuobjdump --dump-resource-usage` output."""
    kernels, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                      line)
        if m and fn:
            kernels[fn] = {"registers": int(m.group(1)),
                           "stack": int(m.group(2)),
                           "shared_bytes": int(m.group(3)),
                           "local_bytes": int(m.group(4))}
    return kernels


def issue_floor_ms(n: int, slots_per_pair: float, sms: int,
                   clock_hz: float) -> float:
    """`slots_per_pair` warp instructions a pair, one a clock on each of an
    SM's 4 schedulers, 32 pairs a warp instruction."""
    return slots_per_pair * float(n) * n / (32 * 4 * sms * clock_hz) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("repulsion_readout: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.repo))
    from sph_tpu_torch.ops import tsne_kernels as K
    with open(K.source("tsne_repulsion"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    library = K.build("tsne_repulsion")["tsne_repulsion"]
    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, library], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    lines = []
    blocks = getattr(K, "tsne_repulsion_blocks_per_sm", None)
    lines.append({"readout": "resources", "source_sha256": digest,
                  "kernels": resource_usage(dump("--dump-resource-usage")),
                  "blocks_per_sm": blocks() if blocks else "not reported"})
    loops = sass_loops(dump("-sass"))
    pair = [lp for fn, found in loops.items() if "repulsion" in fn
            for lp in found]
    slots = min((lp["slots_per_pair"] for lp in pair), default=None)
    lines.append({"readout": "sass", "source_sha256": digest,
                  "loops": loops, "pair_loop_slots_per_pair": slots})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = cs.sm_clock_hz()
    times = []
    for n, npad, calls, _, _ in cs.REPULSION_SHAPES:
        y = torch.from_numpy(cs.repulsion_layout(n, npad, seed=n)).cuda()
        times.append({
            "n": n, "npad": npad, "calls_timed": calls,
            "ms": cs.cuda_ms(lambda: K.tsne_repulsion_rows(y, n), calls,
                             warmup=min(10, calls // 10)),
            "bound_ms": cs.repulsion_bound(n, npad)["bound_ms"],
            "sfu_floor_ms": cs.sfu_floor_ms(n, sms, clock_hz),
            "issue_floor_ms": (issue_floor_ms(n, slots, sms, clock_hz)
                               if slots else "no pair loop found")})
        del y
    lines.append({"readout": "times", "source_sha256": digest, "sms": sms,
                  "sm_clock_hz": clock_hz, "times": times})
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
