"""float32 sums, exp and log computed the way XLA's CPU backend computes them.

The hierarchy's decisions (kNN order, the perplexity search's tolerance
test, Borůvka argmins, walk draws near a CDF boundary) can turn on the last
bit of a float32 result.  The JAX package, run on the CPU, sums as XLA's CPU
backend does and takes exp and log from XLA's own polynomials.  These
helpers reproduce both, so the port's CPU results match the JAX package's
bit for bit on equal inputs.  Every step is a plain float32 operation in a
fixed order (fused multiply-adds are formed exactly in float64), so a CUDA
tensor gets the same bits as a CPU one.

- ``row_sum``: XLA rewrites a reduction longer than 32 into sums over
  windows of 32 (the row zero-padded evenly at both ends to a multiple of
  32), each window added left to right, then reduces the window sums the
  same way.
- ``row_dot``: a sum of products.  Over at most 32 terms XLA keeps the
  multiply inside the reduction's loop and contracts each step into one
  fused multiply-add, left to right, except over 5 to 8 terms, where it
  adds the rounded products left to right; over more than 32 it sums the
  rounded products as ``row_sum`` does.
- ``fused_row_sum``: a row sum fused with its elementwise producer (UMAP's
  rows tier).  Over 32 terms XLA-CPU vectorises it: eight running sums,
  entry j into sum j mod 8, then the eight added as a tree (halves); over
  at most 16 it adds left to right, and over more than
  32 it sums windows as ``row_sum`` does (measured at 8, 16, 32 and 128).
- ``cumsum``: XLA's cumulative sum runs left to right inside chunks of 16;
  the chunk totals are scanned the same way and added back.
- ``np_row_sum``: numpy's own float32 row sum (``x.sum(axis=1)``), for
  the few sums the JAX package takes in numpy: pairwise, with eight
  running sums over blocks of at most 128 and halves above that.
- ``sqrt``: correctly rounded, as XLA's is (torch's CPU kernel is not
  always).
- ``exp`` / ``log``: XLA's CPU range reduction and Cephes polynomials, with
  the multiply-adds the CPU code generator fuses, and with results below
  2^-126 flushed to zero as XLA's CPU runtime does.
- ``pow``: XLA-CPU calls the C library's powf; so does this on the CPU
  (native/libm_pow.c).  On the card it is torch's pow: the one helper here
  whose CUDA bits differ from its CPU bits.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

_SUM_WINDOW = 32
_CUMSUM_CHUNK = 16


def _sum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def row_sum(x: torch.Tensor, width: int = 0) -> torch.Tensor:
    """Sum over the last axis in XLA-CPU association (see module doc).

    width > n: sum as if the rows were first zero-padded at the end to
    `width` (the JAX package pads rows to power-of-two widths before some
    sums, which moves the window boundaries)."""
    if width > x.shape[-1]:
        x = F.pad(x, (0, width - x.shape[-1]))
    n = x.shape[-1]
    if n <= _SUM_WINDOW:
        return _sum_left_to_right(x)
    m = -(-n // _SUM_WINDOW)
    pad = m * _SUM_WINDOW - n
    xp = F.pad(x, (pad // 2, pad - pad // 2))
    return row_sum(_sum_left_to_right(
        xp.reshape(*x.shape[:-1], m, _SUM_WINDOW)))


def fused_row_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's order for a row sum fused with its producer (see module
    doc): at width 32 eight running sums, entry j into sum j mod 8, added
    in halves; else ``row_sum``."""
    if x.shape[-1] != _SUM_WINDOW:
        return row_sum(x)
    acc = _sum_left_to_right(x.reshape(*x.shape[:-1], -1, 8)
                             .transpose(-1, -2))
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n < 8:
        return _sum_left_to_right(x)
    if n <= 128:
        full = n - n % 8
        r = x[..., :8]
        for i in range(8, full, 8):
            r = r + x[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(full, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(x[..., :n2]) + _pairwise_sum(x[..., n2:])


def np_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(axis=-1)`` in numpy's float32 association (see module
    doc)."""
    return _pairwise_sum(x)


def row_dot(a: torch.Tensor, b: torch.Tensor, width: int = 0
            ) -> torch.Tensor:
    """sum(a * b) over the last axis in XLA-CPU association (see module
    doc); `width` as in ``row_sum``."""
    n = max(width, a.shape[-1])
    if n > _SUM_WINDOW or 5 <= n <= 8:
        return row_sum(flush_subnormals(a * b), width)
    acc = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for j in range(a.shape[-1]):     # zero padding adds nothing to the chain
        acc = flush_subnormals(_fma(a[..., j], b[..., j], acc))
    return acc


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis in XLA-CPU association."""
    n = x.shape[-1]
    if n <= _CUMSUM_CHUNK:
        if n == 0:
            return x.clone()
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1)
    m = -(-n // _CUMSUM_CHUNK)
    xp = F.pad(x, (0, m * _CUMSUM_CHUNK - n))
    local = cumsum(xp.reshape(*x.shape[:-1], m, _CUMSUM_CHUNK))
    totals = cumsum(local[..., -1])
    carry = F.pad(totals[..., :-1], (1, 0))
    out = local + carry[..., None]
    return out.reshape(*x.shape[:-1], m * _CUMSUM_CHUNK)[..., :n]


# ---------------------------------------------------------------------------
# exp and log (constants: XLA's CPU polynomial approximations)
# ---------------------------------------------------------------------------

_F32_TINY = 2.0 ** -126


def _f32(v: float) -> float:
    """A constant rounded to float32, as the compiled code holds it."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product and sum are exact in float64
    and rounded once.  Python-float operands must already be float32
    values."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, which rounds
    innocuously for sqrt); subnormal inputs count as 0."""
    return torch.sqrt(flush_subnormals(x).double()).float()


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero, as XLA's CPU and TPU backends do."""
    return torch.where(torch.abs(x) < _F32_TINY, 0.0, x)


_EXP_P = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 0.5))
_LOG2E = _f32(1.44269504088896341)
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(-2.12194440e-4)


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend computes it."""
    x = torch.clamp(x, _f32(-87.8), _f32(88.8))
    fx = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(fx, -_LN2_HI, x)
    r = _fma(fx, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush_subnormals(y * scale)


def exp_unfused(x: torch.Tensor) -> torch.Tensor:
    """``exp``'s arithmetic with every multiply and add rounded on its own:
    what LLVM leaves when it evaluates XLA-CPU's exp of a constant at
    compile time (the fused multiply-adds of ``exp`` are formed only in
    code that runs)."""
    x = torch.clamp(x, _f32(-87.8), _f32(88.8))
    fx = torch.clamp(torch.floor(x * _LOG2E + 0.5), -127.0, 127.0)
    r = x - fx * _LN2_HI
    r = r - fx * _LN2_LO
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = y * r + c
    y = (y * (r * r) + r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush_subnormals(y * scale)


_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_SQRT_HALF = _f32(0.707106781186547524)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it (0 -> -inf,
    negative -> nan, +inf -> +inf; subnormals count as 0)."""
    x = flush_subnormals(x)
    xc = torch.clamp(x, min=_F32_TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, e * _LN2_LO)
    out = _fma(e, _LN2_HI, _fma(m2, -0.5, m) + y)
    out = torch.where(x == 0, -torch.inf, out)
    out = torch.where(x == torch.inf, torch.inf, out)
    return torch.where((x < 0) | torch.isnan(x), torch.nan, out)


def pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 x ** e for a scalar exponent taken as float32, as XLA-CPU
    computes it (the C library's powf) on the CPU; torch.pow on the card."""
    e = _f32(e)
    if x.device.type != "cpu":
        return torch.pow(x, e)
    from ..native import powf
    return torch.from_numpy(powf(x.detach().contiguous().numpy(), e))
