"""Phase metrics, traces and the kernels' sanitize mode.

  - `phase_timer(name, nnz=...)`: wall-clock phase counters (symbolic /
    factor / solve), aggregated into a process-wide registry with work/s
    where a work size is given. Device work is asynchronous: a region that
    ends in it and must be timed to its end passes `barrier=`, a callable
    that waits for it (`torch.cuda.synchronize`); the solvers pass none.
  - `profile_trace(logdir)`: `torch.profiler` around the region, its trace
    written into `logdir` (TensorBoard / Perfetto JSON).
  - `sanitize()`: the kernels' debugging mode, the counterpart of the JAX
    package's Pallas interpret mode. Inside it every kernel wrapper checks
    its plan's index streams on the host before the launch and synchronizes
    after it, so that a bad index raises before it is read and an
    asynchronous CUDA error raises at its launch, naming the kernel. The
    kernels still run: the plain versions are never swapped in.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, Optional

from ..ops.cuda_build import sanitize

__all__ = ["phase_timer", "profile_trace", "sanitize", "get_metrics",
           "reset_metrics"]


class _Phase:
    __slots__ = ("calls", "seconds", "work")

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.work = 0  # nnz or flops attributed to the phase


_registry: Dict[str, _Phase] = collections.defaultdict(_Phase)


@contextlib.contextmanager
def phase_timer(name: str, nnz: int = 0, barrier: Optional[Callable] = None):
    """Time a phase; `barrier()` (if given) runs inside the timed region to
    wait for asynchronous device work before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if barrier is not None:
            barrier()
        p = _registry[name]
        p.calls += 1
        p.seconds += time.perf_counter() - t0
        p.work += nnz


def get_metrics() -> Dict[str, dict]:
    """Snapshot: {phase: {calls, seconds, work, work_per_s}}."""
    out = {}
    for name, p in _registry.items():
        out[name] = {
            "calls": p.calls,
            "seconds": p.seconds,
            "work": p.work,
            "work_per_s": (p.work / p.seconds) if p.seconds > 0 and p.work else None,
        }
    return out


def reset_metrics() -> None:
    _registry.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed region with `torch.profiler` (host operators,
    and the card's activity when there is one) and write its trace into
    `logdir` (`tensorboard_trace_handler`: `<worker>.<time>.pt.trace.json`)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
