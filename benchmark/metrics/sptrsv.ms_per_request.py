"""Device milliseconds of the sweep kernel per request, from the trace."""

from benchmark import readers

COUNTER = "sptrsv_multi"
PATTERNS = ("sweep_kernel",)  # the triangular-solve layer's activities


def read(r):
    return readers.ms_per_item(r, PATTERNS)
