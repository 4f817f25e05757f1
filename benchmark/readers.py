"""The arithmetic of the per-layer metrics, shared by the reader files
under `metrics/` (one file per metric name; a quantity that two kinds of
cell report under different names has one file for each name). Each
function takes the profiled stretch `r` (see `metrics/__init__.py`) and
returns None where there is nothing to read."""

import re

from benchmark import peaks


def _ns(acts, patterns):
    return sum(e - s for name, s, e in acts
               if any(re.search(p, name) for p in patterns))


def per_item(r, counter):
    """A launch counter's rise per item."""
    return r.counters.get(counter, 0) / r.items if r.items else None


def build_seconds(r):
    """The serve handle's own build seconds, summed."""
    bs = getattr(r, "build_seconds", None)
    return float(sum(bs.values())) if bs else None


def roofline_share(r, counter, patterns):
    """Percent: the least time of every sweep launched (the serve chain's
    sweeps, each counted by `peaks.sweep_work` from the factor's CSC, B
    and the dtype) over the device time the trace gives the activities
    matching `patterns`."""
    chain = getattr(r, "chain_work", None)
    if r.acts is None or not chain:
        return None
    launches = r.counters.get(counter, 0)
    dev_ns = _ns(r.acts, patterns)
    if not launches or launches % len(chain) or not dev_ns:
        return None
    least = sum(peaks.least_seconds(b, f, dt)[0] for b, f, dt in chain)
    return 100.0 * least * (launches // len(chain)) / (dev_ns / 1e9)


def ms_per_item(r, patterns):
    """Device milliseconds per item of the activities matching `patterns`."""
    if r.acts is None or not r.items:
        return None
    ns = _ns(r.acts, patterns)
    return ns / 1e6 / r.items if ns else None


def idle_share(r):
    """Percent: 1 - (the union of the device's activity intervals) / (the
    stretch's host wall)."""
    if r.acts is None or not r.wall_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.wall_s)


def ops_per_item(r):
    """Device activities (kernels, copies, fills) per item."""
    if r.acts is None or not r.items:
        return None
    return len(r.acts) / r.items


def busy_ms_per_item(r):
    """Milliseconds per item in which the device ran anything."""
    if r.acts is None or not r.items:
        return None
    return r.busy_s * 1e3 / r.items
