"""L2 sparse primitive ops (host): permutation vectors.

Same names and semantics as the reference crate root (src/lib.rs). The rest
of the L2 ops (add, multiply, transpose, gaxpy, ...) arrive with the ops
slice; the sweep kernel lives in `ops.sptrsv_cuda`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["ipvec", "pvec", "pinvert"]


def ipvec(n: int, p: Optional[np.ndarray], b, x) -> None:
    """x(P) = b (reference src/lib.rs:2151-2159); writes into x in place."""
    b = np.asarray(b)
    if p is not None:
        x[np.asarray(p[:n], dtype=np.int64)] = b[:n]
    else:
        x[:n] = b[:n]


def pvec(n: int, p: Optional[np.ndarray], b, x) -> None:
    """x = b(P) (reference src/lib.rs:2244-2251); writes into x in place."""
    b = np.asarray(b)
    if p is not None:
        x[:n] = b[np.asarray(p[:n], dtype=np.int64)]
    else:
        x[:n] = b[:n]


def pinvert(p: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    """Pinv = P' (reference src/lib.rs:2196-2209); None = identity."""
    if p is None:
        return None
    pinv = np.zeros(n, dtype=np.int64)
    pinv[np.asarray(p[:n], dtype=np.int64)] = np.arange(n)
    return pinv
