"""Timing helpers (reference: sph/utils/Timer.hpp — ScopedTimer RAII and the
`utils::timer` lambda wrapper).  PyTorch returns before a CUDA device has
finished, so `block=True` synchronises the card before the clock is read."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Callable

import torch

from .logging import Log

# ---------------------------------------------------------------------------
# accumulating phase timers (enable with SPH_PHASE_TIMERS=1): host-side
# attribution of pipeline wall-clock — which stage/level phase the time goes
# to.  Device work launched asynchronously is charged to whichever phase
# waits on it, so sums match end-to-end wall time.
# ---------------------------------------------------------------------------

_PHASES: dict[str, list] = {}


def phases_enabled() -> bool:
    return os.environ.get("SPH_PHASE_TIMERS") == "1"


@contextmanager
def phase(name: str, sync=None):
    """Charge the block's wall seconds to `name`.  sync: a device whose
    queued work the block's seconds include (a CUDA device is synchronised
    at both ends, so the phase reads its own device time)."""
    if not phases_enabled():
        yield
        return
    cuda = sync is not None and torch.device(sync).type == "cuda"
    if cuda:
        torch.cuda.synchronize(sync)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(sync)
        dt = time.perf_counter() - t0
        ent = _PHASES.setdefault(name, [0.0, 0])
        ent[0] += dt
        ent[1] += 1


def phase_report(reset: bool = True, min_s: float = 0.0) -> str:
    rows = sorted(_PHASES.items(), key=lambda kv: -kv[1][0])
    lines = [f"{tot:9.3f}s  x{cnt:<5d} {name}"
             for name, (tot, cnt) in rows if tot >= min_s]
    if reset:
        _PHASES.clear()
    return "\n".join(lines)


def phase_totals(reset: bool = True) -> dict[str, float]:
    """Seconds accumulated by each phase name (see ``phase``)."""
    out = {name: tot for name, (tot, _) in _PHASES.items()}
    if reset:
        _PHASES.clear()
    return out


@contextmanager
def scoped_timer(name: str, verbose: bool = True):
    """RAII-style timer (reference: Timer.hpp:48-60)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if verbose:
            Log.info("%s took %.3f s", name, dt)


def timer(fn: Callable[[], Any], name: str = "", block: bool = True):
    """Time a callable, returning (result, seconds).

    With block=True the CUDA device (when one is in use) is synchronised
    before the clock stops, so asynchronous launches do not fake the
    measurement.
    """
    t0 = time.perf_counter()
    result = fn()
    if block and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if name:
        Log.info("%s took %.3f s", name, dt)
    return result, dt
