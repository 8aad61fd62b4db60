"""Counter-based threefry2x32, bit-exact with jax's default PRNG.

The random walks (ops/walks.py) draw ``jax.random.uniform(fold_in(PRNGKey(
seed), t), (n,))`` in the JAX package, and UMAP's rows tier its negatives
with ``jax.random.randint``, with ``jax_threefry_partitionable`` on (the
default since jax 0.5).  Without the same bits the walks, and so the whole
hierarchy, diverge from the first Borůvka step.  This module rebuilds those
draws (jax/_src/prng.py: threefry2x32 lowering, ``threefry_fold_in``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``;
jax/_src/random.py: ``uniform``, ``_randint``):

- ``PRNGKey(s)`` is the pair ``(s >> 32, s & 0xFFFFFFFF)``;
- ``fold_in(k, t)`` is ``threefry2x32(k, (0, t))``, and key i of
  ``split(k)`` is ``threefry2x32(k, (0, i))``;
- bits for shape (n,) are ``threefry2x32(k, (hi(i), lo(i)))`` over the flat
  index i, combined as ``bits1 ^ bits2``;
- uniform is ``float32((bits >> 9) | 0x3F800000) - 1``.

torch has no full uint32 arithmetic, so the words live in int64 tensors and
are masked to 32 bits after every add and rotate.  Keys are pairs of Python
ints; the same code runs on Python ints and on tensors.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0, x1):
    """The threefry-2x32 hash (20 rounds) of the count words (x0, x1) under
    `key`; works on Python ints or int64 tensors holding uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed) for a non-negative seed."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key, 0, data & _M32)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """jax.random.split(key, num): key i is threefry2x32(key, (0, i))."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key: tuple[int, int], n: int,
                device: torch.device) -> torch.Tensor:
    """32 random bits per element for shape (n,) (or any shape of n
    elements, flat in row-major order), as int64 in [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _M32)
    return b0 ^ b1


def randint(key: tuple[int, int], shape: tuple[int, ...], minval: int,
            maxval: int, device: torch.device) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) for int32 values
    (jax/_src/random.py _randint): two words of bits from the halves of
    split(key), folded into the span with uint32 arithmetic that wraps.
    Returns int64 values in [minval, maxval)."""
    n = math.prod(shape)
    k1, k2 = split(key)
    higher = random_bits(k1, n, device)
    lower = random_bits(k2, n, device)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((higher % span) * multiplier + lower % span) & _M32
    return (minval + offset % span).reshape(shape)


def uniform(key: tuple[int, int], n: int,
            device: torch.device) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) in [0, 1), float32."""
    bits = random_bits(key, n, device)
    one_exp = (bits >> 9) | 0x3F800000
    return one_exp.to(torch.int32).view(torch.float32) - 1.0
