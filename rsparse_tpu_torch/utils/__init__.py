"""Aux subsystems: phase metrics and spans, traces, the kernels' sanitize
mode and checkpoints. The reference has none of these (no timers, no
logging, no factor caching); they follow the JAX package's `rsparse_tpu.utils`.
"""

from .profiling import (phase_timer, profile_trace, sanitize, get_metrics,
                        reset_metrics, recording, spans, device_barrier, Span)
from .checkpoint import save_symbolic, load_symbolic, save_factor, load_factor

__all__ = [
    "phase_timer",
    "profile_trace",
    "sanitize",
    "get_metrics",
    "reset_metrics",
    "recording",
    "spans",
    "device_barrier",
    "Span",
    "save_symbolic",
    "load_symbolic",
    "save_factor",
    "load_factor",
]
