#!/usr/bin/env python3
"""Whether two versions of tsne_forces_dense give the same bits, on one card.

    python3 scripts/forces_bits.py save CHECKOUT FILE
    python3 scripts/forces_bits.py compare FILE_A FILE_B

``save`` loads the sph_tpu_torch of CHECKOUT and writes its (attr, rep, Z)
at chip_smoke.py's FORCES_SHAPES and the driver's small shapes, each on
``random_joint_p``'s seeded inputs, to FILE (torch.save); ``compare``
prints, for each shape of two such files, ``bits_equal`` or ``DIFFER`` and
both Z.  A redesign whose bits equal the last version's cannot move a
trajectory that a gate holds.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the driver's small levels (eval_record: 118 / 256, 1041 / 2048, 4096 /
# 4096) and scene_overlap's and salinas_euclid's level 1
MORE_SHAPES = ((118, 256), (1041, 2048), (4096, 4096), (25244, 25600),
               (16198, 16384))


def save(checkout: str, path: str) -> None:
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    sys.path.insert(1, REPO)
    import torch
    import chip_smoke as cs
    import sph_tpu_torch
    if not os.path.abspath(sph_tpu_torch.__file__).startswith(checkout):
        raise RuntimeError(f"loaded {sph_tpu_torch.__file__}, not the "
                           f"checkout {checkout}")
    from sph_tpu_torch.ops.tsne_kernels import (DenseForces,
                                                tsne_forces_dense)
    out = {}
    for i, (n, npad) in enumerate(tuple(cs.FORCES_SHAPES) + MORE_SHAPES):
        y, p = cs.random_joint_p(n, npad, seed=11 + i)
        got = tsne_forces_dense(y, p, n, out=DenseForces(npad, y.device))
        out[f"{n}/{npad}"] = [t.detach().cpu().clone() for t in got]
    torch.save(out, path)


def compare(path_a: str, path_b: str) -> None:
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    for key in a:
        same = all(torch.equal(x, y) for x, y in zip(a[key], b[key]))
        print(key, "bits_equal" if same else "DIFFER", float(a[key][2]),
              float(b[key][2]), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "save":
        save(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
