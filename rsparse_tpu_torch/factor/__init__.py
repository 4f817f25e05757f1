"""L4' numeric factorization: lu.

Dispatch between the device path (torch on the caller's device: the
multifrontal LU, or the level-scheduled LU below `config.mf_min_n`) and the
native host engine (C++, reference-exact, used for `config.backend ==
"host"` and as the fallback when device pivoting is rejected). `chol` and
`qr` arrive with their slices.
"""

from __future__ import annotations

import torch

from ..config import config
from ..data import Nmrc, Sprs, Symb
from ..symbolic import native
from .lu_device import lu_device

__all__ = ["lu"]


def lu(a: Sprs, s: Symb, tol: float, *, device="cuda") -> Nmrc:
    """(L,U,pinv) = lu(A) given `sqr` analysis (reference src/lib.rs:519-622).

    Factors in float64 on `device`; L and U values come back as tensors on
    `device` (patterns and pinv as numpy arrays). Raises NoPivotError if no
    pivot can be found. `s._lu_route` records the route taken.

    >>> from rsparse_tpu_torch import Sprs, sqr
    >>> from rsparse_tpu_torch.factor import lu
    >>> a = Sprs.new_from_vec([[1.0, 3.0], [2.0, 4.0]])
    >>> nm = lu(a, sqr(a, -1, False), 1.0, device="cpu")  # tol=1: strict pivot
    >>> [int(v) for v in nm.pinv]  # row 1 (|2| > |1|) pivots first
    [1, 0]
    """
    n = a.n
    dev = torch.device(device)
    if config.backend == "host":
        mfp = getattr(s, "_mf_lu_plan", None)
        if mfp is not None and not isinstance(mfp, str):
            # host factors invalidate the device front cache
            mfp.__dict__.pop("_cache_tree", None)
        Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
            n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q, tol, s.lnz, s.unz
        )
        s._lu_route = "host"
    else:
        Lp, Li, Lx, Up, Ui, Ux, pinv = lu_device(a, s, tol, dev)
    nm = Nmrc()
    nm.l = Sprs(int(Lp[n]), n, n, Lp, Li, None)
    nm.l.x = torch.as_tensor(Lx, device=dev)
    nm.u = Sprs(int(Up[n]), n, n, Up, Ui, None)
    nm.u.x = torch.as_tensor(Ux, device=dev)
    nm.pinv = pinv
    s.lnz = int(Lp[n])  # reference mutates s with the actual counts
    s.unz = int(Up[n])
    return nm
