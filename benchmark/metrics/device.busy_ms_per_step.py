"""Milliseconds per step in which the device ran anything: the union of
its activity intervals over the stretch, per step."""

from benchmark import readers


def read(r):
    return readers.busy_ms_per_item(r)
