"""The sweep kernel's share of its roofline over the stretch: the least
time of every sweep launched (the larger of its bytes over the HBM
bandwidth and its operations over the dtype's peak, counted from the
factor's CSC, B and the dtype by `peaks.sweep_work`), over the device time
the trace gives those launches."""

from benchmark import readers

COUNTER = "sptrsv_multi"
PATTERNS = ("sweep_kernel",)  # the triangular-solve layer's activities


def read(r):
    return readers.roofline_share(r, COUNTER, PATTERNS)
