"""The serve handle's own build seconds (`h.build_seconds`: analysis,
factorization, probe, handle), summed; paid in set-up."""

from benchmark import readers


def read(r):
    return readers.build_seconds(r)
