"""Device activities (kernels, copies, fills) per step, from the trace:
the launches that the host-driven factorization and the solves make."""

from benchmark import readers


def read(r):
    return readers.ops_per_item(r)
