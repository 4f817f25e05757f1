"""Sweep-kernel launches per request over the stretch (program counter
`sptrsv_multi.launches`): the serve chain's sweeps times one plus the
refinement steps each request took."""

from benchmark import readers


def read(r):
    return readers.per_item(r, "sptrsv_multi")
