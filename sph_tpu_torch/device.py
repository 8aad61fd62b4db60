"""Device resolution and float32 precision for the PyTorch port.

Every entry point that allocates takes an explicit ``device``.  The default
is ``torch.device("cuda")``; when no card is visible the default raises
instead of carrying on on the CPU.  The CPU runs only where a caller names it
(``device="cpu"``), as the parity tests do.

Precision: the JAX package runs every distance and Bhattacharyya product at
``Precision.HIGHEST`` (sph_tpu/ops/knn.py:88-91, ops/sparse.py:689,
models/tsne.py:89-105), and the kNN order and the merge argmins depend on
it.  Importing this module therefore switches TF32 off for matmuls and
convolutions, so a float32 product stays float32 on the card.

Randomness: the main path needs no ``torch.Generator``.  Its numpy RNG sites
(the Borůvka tie-break seed, models/image_hierarchy.py, and the t-SNE disk
init, ops/math.py) stay numpy and are called exactly as in the JAX package,
so they give the same numbers.  The random walks draw from ``ops/rng.py``, a
counter-based threefry2x32 that reproduces jax's bits.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

DeviceLike = Union[str, torch.device, None]


def require_cuda() -> torch.device:
    """The CUDA device, or a clear error when none is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sph_tpu_torch: no CUDA device is visible. The port defaults to "
            "device='cuda'; pass device='cpu' to run on the CPU.")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA (and raises without a card); anything else is
    taken as given."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev

