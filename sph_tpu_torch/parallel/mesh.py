"""Device meshes of the port: a list of devices in one process.

Port of sph_tpu/parallel/mesh.py.  The JAX package lays arrays over a
``jax.sharding.Mesh`` and reduces with ICI collectives inside ``shard_map``.
Here a mesh is the ordered list of the ``torch.device``s that hold the
shards, all in this process: a shard is a tensor on its device, an
all-gather is a concatenation in shard order, and a psum is a sum over the
shards in shard order.  There is no ``torch.distributed`` and no NCCL.

A device may appear more than once: each appearance is one logical shard,
as the JAX tests get eight shards from eight virtual host devices.  So the
sharded paths run on one card (``[cuda] * 2``) or on the CPU
(``[torch.device("cpu")] * 8``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from ..device import require_cuda


@dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis mesh, in shard order."""

    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


MeshLike = Union[Mesh, Sequence, None]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    """The first `n_devices` visible CUDA devices (all when None); raises
    the port's device error when no card is visible."""
    require_cuda()
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)),
                (axis_name,))


def as_mesh(mesh: MeshLike = None) -> Mesh:
    """A Mesh from a Mesh, a list of devices (repeats allowed) or None
    (``make_mesh()``); a CUDA device in the list needs a card."""
    if mesh is None:
        return make_mesh()
    if isinstance(mesh, Mesh):
        devices = mesh.devices
    else:
        devices = tuple(torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if any(d.type == "cuda" for d in devices):
        require_cuda()
    names = mesh.axis_names if isinstance(mesh, Mesh) else ("data",)
    return Mesh(tuple(devices), names)


def shard_rows(mesh: MeshLike, x: torch.Tensor) -> list[torch.Tensor]:
    """x [N, ...] split along dim 0 into equal blocks, block i on device i
    (N must divide by the mesh size)."""
    m = as_mesh(mesh)
    n = x.shape[0]
    if n % m.size:
        raise ValueError(f"shard_rows: {n} rows do not split over "
                         f"{m.size} shards")
    step = n // m.size
    return [x[i * step:(i + 1) * step].to(d).contiguous()
            for i, d in enumerate(m.devices)]


def replicate(mesh: MeshLike, x: torch.Tensor) -> list[torch.Tensor]:
    """x copied to each device of the mesh, one copy a shard."""
    return [x.to(d) for d in as_mesh(mesh).devices]
