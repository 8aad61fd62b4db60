#!/usr/bin/env python3
"""tsne_forces_dense of one checkout against its twin, timed, on one card.

    python3 scripts/forces_ab.py [CHECKOUT]

Loads the sph_tpu_torch of CHECKOUT (this one by default; another, such as
an older commit unpacked with ``git archive``, to compare versions on the
same card: run parent, change, change, parent in one call), and prints one
JSON line a shape with ``chip_smoke.check_forces_kernel``'s result (the
twin's checks, ms a call into caller-owned buffers, the launch plan, the
bound) and its share of the bound, at chip_smoke.py's FORCES_SHAPES and
four more path shapes, then the ``nvidia-smi`` name and power limit.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the paths' other shapes: scene_overlap's level 1, salinas_euclid's level
# 1, the Pines main path's level 1, rgb_geo's level 3
MORE_SHAPES = ((16198, 16384), (25244, 25600), (5358, 6144), (657, 768))


def main() -> int:
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else REPO)
    sys.path.insert(0, checkout)
    sys.path.insert(1, REPO)
    import torch
    if not torch.cuda.is_available():
        print("forces_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import sph_tpu_torch
    if not os.path.abspath(sph_tpu_torch.__file__).startswith(checkout):
        raise RuntimeError(f"loaded {sph_tpu_torch.__file__}, not the "
                           f"checkout {checkout}")
    for i, (n, npad) in enumerate(tuple(cs.FORCES_SHAPES) + MORE_SHAPES):
        out = cs.check_forces_kernel(n, npad, seed=11 + i, calls=200,
                                     plain_calls=2)
        out.pop("plain_ms")
        print(json.dumps({"checkout": checkout, **out,
                          "share_of_bound": out["bound_ms"] / out["ms"]}),
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
