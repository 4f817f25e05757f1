"""SpMM-kernel launches per request over the stretch (program counter
`spmm_csr.launches`): the serve handle's refinement residuals B - AX
that ran as one launch of the kernel's residual form, one a refinement
check. A program whose residual runs elsewhere reads 0."""

from benchmark import readers


def read(r):
    return readers.per_item(r, "spmm_csr")
