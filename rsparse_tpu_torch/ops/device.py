"""Value passes of the L2 sparse ops, as plain torch on the caller's device.

Each function takes value tensors and the int64 index tensors of an
`ops.plan` plan, all on one device, and returns a new tensor there. The
JAX package's `segment_sum` becomes `index_add_` into a zero tensor (on a
CUDA device the adds are atomic, so the order of a sum varies from run to
run at rounding level).
"""

from __future__ import annotations

import torch


def spgemm_values(ax, bx, a_idx, b_idx, seg, nnz: int) -> torch.Tensor:
    """C.x = segment_sum(A.x[a_idx] * B.x[b_idx], seg)."""
    prods = ax[a_idx] * bx[b_idx]
    return prods.new_zeros(nnz).index_add_(0, seg, prods)


def add_values(ax, bx, alpha: float, beta: float, seg, nnz: int) -> torch.Tensor:
    """C.x = segment_sum([alpha * A.x, beta * B.x], seg)."""
    vals = torch.cat([alpha * ax, beta * bx])
    return vals.new_zeros(nnz).index_add_(0, seg, vals)


def gather_values(x, perm) -> torch.Tensor:
    return x[perm]


def gaxpy(ax, rows, cols, x, y, m: int) -> torch.Tensor:
    """r = A*x + y via per-entry gather + segment-sum over rows.

    Reference semantics: src/lib.rs:411-421.
    """
    vals = ax * x[cols]
    return y + vals.new_zeros(m).index_add_(0, rows, vals)


def norm1(ax, cols, n: int) -> torch.Tensor:
    """1-norm = max column abs-sum (reference src/lib.rs:771-782)."""
    a = ax.abs()
    sums = a.new_zeros(n).index_add_(0, cols, a)
    return sums.max() if n > 0 else a.new_zeros(())


def spmv_csc(a, x, y=None) -> torch.Tensor:
    """r = A@x (+ y) for a `data.CSCDevice` a, on its device.

    Each entry's column comes from the pointer array by a searchsorted, and
    the products are summed into their rows by `index_add`, so the result
    carries autograd gradients for x, y and a.x. Reference semantics:
    gaxpy, src/lib.rs:411-421.
    """
    e = torch.arange(a.i.shape[0], device=a.p.device)
    cols = torch.searchsorted(a.p, e, right=True) - 1
    vals = a.x * x[cols]
    r = vals.new_zeros(a.m).index_add(0, a.i, vals)
    return r if y is None else r + y


def scpmat_values(alpha: float, ax) -> torch.Tensor:
    return ax + alpha


def scxmat_values(alpha: float, ax) -> torch.Tensor:
    return ax * alpha
