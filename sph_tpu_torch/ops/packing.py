"""Layout positions packed into u16 fixed point, two to a 32-bit word.

The JAX package's t-SNE attraction on the grid tier and its UMAP rows tier
fetch both coordinates of a neighbour with one gather from such a table
(sph_tpu/models/tsne.py:171-190 and sph_tpu/models/umap.py:177-199, the
same arithmetic): each coordinate is quantised over the layout's bounding
box, ``q = round((y - lo) / s)`` with ``s = max(hi - lo, 1e-30) / 65535``,
and the word is ``(q0 << 16) | q1``.  The error is uniform, span / 65536,
which a force that reads position differences needs (a floating format's
error grows with |y|).

These are the port's copy, bit for bit with XLA-CPU: it folds the division
by the constant 65535 into a multiplication by its float32 reciprocal, and
contracts the unpack ``q * s + lo`` into one fused multiply-add.  Both
round half to even.  The table is an int32 tensor holding the words' bits
(torch has few uint32 operations); the CUDA attraction kernel reads it as
uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .numerics import _fma

# XLA-CPU turns `x / 65535.0` into `x * (1 / 65535)` rounded to float32
_INV_65535 = float(np.float32(1.0) / np.float32(65535.0))
_LOW16 = 0xFFFF


def _quantise(v: torch.Tensor, with_zero: bool):
    lo, hi = v.amin(), v.amax()
    if with_zero:
        lo = torch.clamp(lo, max=0.0)
        hi = torch.clamp(hi, min=0.0)
    s = torch.clamp(hi - lo, min=1e-30) * _INV_65535
    q = torch.round((v - lo) / s).to(torch.int64)
    return q, lo, s


def pack_positions(y0: torch.Tensor, y1: torch.Tensor,
                   with_zero: bool = False):
    """Coordinates y0, y1 [N] float32 -> (table [N] int32, the bits of
    (q0 << 16) | q1; prm [4] float32, (lo0, s0, lo1, s1)), on their device.

    with_zero=True takes the bounding box as if rows of 0 stood beside
    the N given: the JAX package packs its padded layout, whose pad rows
    hold 0, where the port keeps no pad rows.
    """
    q0, lo0, s0 = _quantise(y0, with_zero)
    q1, lo1, s1 = _quantise(y1, with_zero)
    words = (q0 << 16) | q1
    table = torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)
    return table, torch.stack([lo0, s0, lo1, s1]).to(torch.float32)


def unpack_positions(g: torch.Tensor, prm: torch.Tensor):
    """Words gathered from a ``pack_positions`` table -> the two
    coordinates, each ``fma(q, s, lo)`` in float32."""
    g = g.to(torch.int64)
    q0 = ((g >> 16) & _LOW16).to(torch.float32)
    q1 = (g & _LOW16).to(torch.float32)
    return _fma(q0, prm[1], prm[0]), _fma(q1, prm[3], prm[2])
