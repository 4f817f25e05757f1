"""Seconds of the multifrontal factorization's wide fronts in the run (the
program's `factor.fronts` spans, inside `factor.numeric`: the tree of
supernodal fronts that a skeleton with a wide supernode is factored as).
Without the span recorder on, the span ends when the last front is
queued on the card, not when it has run. A program without the span
reads None."""

from benchmark import spans


def read(r):
    return spans.phase_seconds("factor.fronts")
