"""Phase metrics, spans, traces and the kernels' sanitize mode.

  - `phase_timer(name, nnz=...)`: a span. Every use adds its wall seconds
    (and a work size where one is given) to a process-wide registry of
    phases (`get_metrics`), with work/s; `t.seconds` holds the span's own
    duration after it closes. Device work is asynchronous: a span that
    ends in it and must be timed to its end passes `barrier=`, a callable
    that waits for it (`device_barrier(device)`). The barrier runs only
    while the recorder is on, so that with it off no span synchronizes.
  - `recording()` / `spans()`: the recorder, off by default. While it is
    on, every span also appends one record to a bounded in-memory buffer:
    its name, start and end in `time.time_ns()` (the clock `torch.profiler`
    stamps its events on), the index of its parent (the innermost span
    open when it started), the request id of the enclosing `serve.request`
    span and one small integer attribute. A full buffer drops new records
    and counts them in `spans.dropped`.
  - `profile_trace(logdir)`: `torch.profiler` around the region, its trace
    written into `logdir` (TensorBoard / Perfetto JSON).
  - `sanitize()`: the kernels' debugging mode, the counterpart of the JAX
    package's Pallas interpret mode. Inside it every kernel wrapper checks
    its plan's index streams on the host before the launch and synchronizes
    after it, so that a bad index raises before it is read and an
    asynchronous CUDA error raises at its launch, naming the kernel. The
    kernels still run: the plain versions are never swapped in.

Spans come from one thread at a time, as the registry does.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from ..ops.cuda_build import sanitize

__all__ = ["phase_timer", "profile_trace", "sanitize", "get_metrics",
           "reset_metrics", "recording", "spans", "device_barrier", "Span"]

CAPACITY = 1 << 16  # records the recorder keeps by default


class _Phase:
    __slots__ = ("calls", "seconds", "work")

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.work = 0  # nnz or flops attributed to the phase


_registry: Dict[str, _Phase] = collections.defaultdict(_Phase)


class Span(NamedTuple):
    """One record of the recorder."""

    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: int  # index in spans() of the enclosing span, -1 for none
    request: Optional[int]  # id of the enclosing serve.request span
    attr: Optional[int]


class _Recorder:
    __slots__ = ("on", "buf", "capacity", "top", "request", "requests")

    def __init__(self):
        self.on = False
        self.buf: List[Optional[tuple]] = []
        self.capacity = CAPACITY
        self.top = -1  # index of the innermost open span
        self.request: Optional[int] = None
        self.requests = 0  # request ids handed out


_rec = _Recorder()


class phase_timer:
    """Time a phase (a context manager); `barrier()` (if given, and only
    while the recorder is on) runs inside the timed region to wait for
    asynchronous device work before the clock stops. `attr` is the span's
    integer attribute in the recorder; `request=True` makes the span a
    request, whose id the spans inside it carry."""

    __slots__ = ("name", "nnz", "barrier", "attr", "request", "seconds",
                 "_t0", "_idx", "_buf", "_parent", "_req", "_prev")

    def __init__(self, name: str, nnz: int = 0,
                 barrier: Optional[Callable] = None, *,
                 attr: Optional[int] = None, request: bool = False):
        self.name, self.nnz, self.barrier = name, nnz, barrier
        self.attr, self.request = attr, request
        self.seconds = None
        self._idx = None  # None: not recorded

    def __enter__(self):
        rec = _rec
        if rec.on:
            buf = self._buf = rec.buf
            idx = len(buf)
            if idx < rec.capacity:
                buf.append(None)  # filled in when the span closes
            else:
                idx = -1
                spans.dropped += 1
            self._idx, self._parent = idx, rec.top
            rec.top = idx
            if self.request:
                self._prev = rec.request
                rec.request = rec.requests
                rec.requests += 1
            self._req = rec.request
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        idx = self._idx
        if idx is not None and self.barrier is not None:
            self.barrier()
        t1 = time.time_ns()
        if idx is not None:
            rec = _rec
            rec.top = self._parent
            if self.request:
                rec.request = self._prev
            if idx >= 0:
                self._buf[idx] = (self.name, self._t0, t1, self._parent,
                                  self._req, self.attr)
        self.seconds = (t1 - self._t0) / 1e9
        p = _registry[self.name]
        p.calls += 1
        p.seconds += self.seconds
        p.work += self.nnz
        return False


@contextlib.contextmanager
def recording(capacity: int = CAPACITY):
    """Turn the recorder on for the enclosed region, with a fresh buffer
    of `capacity` records (request ids from 0, `spans.dropped` 0). The
    records stay readable (`spans()`) until the next recording starts.
    Entered while the recorder is on, it changes nothing."""
    rec = _rec
    if rec.on:
        yield
        return
    rec.buf, rec.capacity, rec.top = [], int(capacity), -1
    rec.request, rec.requests = None, 0
    spans.dropped = 0
    rec.on = True
    try:
        yield
    finally:
        rec.on = False
        rec.top, rec.request = -1, None


def spans() -> List[Optional[Span]]:
    """The records of the last recording, in the order their spans
    started (None for a span still open). `spans.dropped` counts the
    records a full buffer refused."""
    return [None if r is None else Span(*r) for r in _rec.buf]


spans.dropped = 0


def device_barrier(device) -> Optional[Callable]:
    """The barrier that times a span to the end of `device`'s queued work:
    `torch.cuda.synchronize(device)` on a CUDA device, None elsewhere."""
    import torch

    dev = torch.device(device)
    return (functools.partial(torch.cuda.synchronize, dev)
            if dev.type == "cuda" else None)


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
