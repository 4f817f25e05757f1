"""Seconds of the numeric multifrontal factorization in the run (the
program's `factor.numeric` spans, which only the handle's build opens)."""

from benchmark import spans


def read(r):
    return spans.phase_seconds("factor.numeric")
