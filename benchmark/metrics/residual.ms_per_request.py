"""Device milliseconds of the SpMM kernel per request, from the trace: the
serve handle's refinement residuals B - AX in the kernel's residual form.
A program whose residual runs elsewhere launches no such kernel and reads
None."""

from benchmark import readers

COUNTER = "spmm_csr"
PATTERNS = ("spmm_rows",)  # the SpMM kernel's activities


def read(r):
    return readers.ms_per_item(r, PATTERNS)
