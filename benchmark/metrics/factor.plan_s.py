"""Seconds of the multifrontal planner in the run (the program's
`factor.plan` spans, which only the handle's build opens)."""

from benchmark import spans


def read(r):
    return spans.phase_seconds("factor.plan")
