"""Profiling and debug-mode helpers.

Port of sph_tpu/utils/profiling.py in torch's idiom.  Reference §5.1:
ScopedTimer RAII timers and Catch2 BENCHMARK blocks; here ``torch.profiler``
traces (``trace``, ``annotate``) beside the wall-clock timers of
utils/timer.py.  Reference §5.2: debug builds switch OpenMP off, so that
serial execution is the ground truth (CommonDefinitions.hpp:10-14).  The
JAX package's analogue runs op by op with jit off; torch runs op by op
already, so the nearest meaning here is ``ground_truth_mode``: the
deterministic algorithms for its scope, where a card's atomics would
otherwise add in no fixed order.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch

from .logging import Log


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of a region, the card's kernels
    included where one is visible, into `log_dir` (TensorBoard's trace
    format; default: sph_tpu_torch_trace under the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "sph_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    Log.info("profiler: tracing to %s", log_dir)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


@contextlib.contextmanager
def ground_truth_mode():
    """``torch.use_deterministic_algorithms(True)`` for the scope (the
    setting before it is restored after): an op without a deterministic
    version raises instead of running."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def annotate(name: str):
    """A named profiler region (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of the card, or None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
