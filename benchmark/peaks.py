"""The card's published peaks and the least time of a piece of work.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3, 700 W): 3.35 TB/s of
HBM bandwidth; 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside
the tensor cores, which a triangular sweep does not use. A card set below
700 W runs slower than these; the run prints its power limit beside the
shares it reports.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"float32": 4, "float64": 8}
INDEX_BYTES = 4  # int32 holds every row index and pointer at these sizes


def least_seconds(nbytes: float, flops: float, dtype: str):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the bandwidth and the operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(n: int, nnz: int, nrhs: int, dtype: str):
    """(bytes, operations) that one triangular solve of X[n, nrhs] needs,
    counted from the factor's CSC alone (n columns, nnz entries with the
    diagonal): every value, row index and column pointer read once, X read
    once and written once; 2 operations per off-diagonal entry and 1 per
    diagonal entry, per right-hand side. Whatever kernel runs the sweep is
    held to this same work."""
    item = ITEM_BYTES[dtype]
    nbytes = nnz * (item + INDEX_BYTES) + (n + 1) * INDEX_BYTES \
        + 2 * n * nrhs * item
    return nbytes, (2 * (nnz - n) + n) * nrhs
