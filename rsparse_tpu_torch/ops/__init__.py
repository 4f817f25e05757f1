"""L2 sparse primitive ops: add, multiply (SpGEMM), transpose, gaxpy,
gaxpy_multi, norm, scalar ops, permute/symperm, ipvec/pvec, fkeep,
sprs_print, and `chain` (an op pipeline's value passes back to back on one
device).

Same names and semantics as the reference crate root (src/lib.rs) and the
JAX package's `rsparse_tpu.ops`. Each op pairs a host plan (`ops.plan`,
numpy, cached per sparsity pattern) with a value pass (`ops.device`, torch
on `device`, the card unless the caller asks for another). The ops take
and return host `Sprs`; `gaxpy` returns a list and `gaxpy_multi` a tensor
on `device`. `config.backend == "host"` keeps the whole op in numpy.
`gaxpy_multi` runs the streaming SpMM of `ops.spmm_cuda` (a CUDA kernel on
the card, its plain torch version on the CPU).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import config
from ..data import Sprs
from . import device as dev
from . import plan as _plan
from .plan import device_cache
from .spmm_cuda import spmm_fn, spmm_plan_cached

__all__ = [
    "add",
    "multiply",
    "transpose",
    "gaxpy",
    "gaxpy_multi",
    "norm",
    "scpmat",
    "scxmat",
    "permute",
    "symperm",
    "ipvec",
    "pvec",
    "pinvert",
    "fkeep",
    "sprs_print",
    "chain",
    "ChainExpr",
]


def _on_host() -> bool:
    return config.backend == "host"


def _vals(a: Sprs, d: torch.device, whole: bool = False) -> torch.Tensor:
    """A's stored values (the first nnz, or all nzmax) as a tensor on d."""
    return torch.as_tensor(a.x if whole else a.x[: a.nnz()], device=d)


def _ix(plan, field: str, d: torch.device) -> torch.Tensor:
    """An index array of a plan as an int64 tensor on d, kept on the plan."""
    return device_cache(plan, "_dev_" + field, d, lambda: torch.as_tensor(
        np.asarray(getattr(plan, field), np.int64), device=d))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def add(a: Sprs, b: Sprs, alpha: float = 1.0, beta: float = 1.0, *,
        device="cuda") -> Sprs:
    """C = alpha*A + beta*B (reference src/lib.rs:247-271).

    Output pattern is the structural union; rows within each column are
    sorted ascending (canonical form — the reference leaves scatter order).

    >>> from rsparse_tpu_torch import Sprs, add
    >>> a = Sprs.new_from_vec([[2.0, 2.0], [1.0, 4.0]])
    >>> b = Sprs.new_from_vec([[2.0, 4.0], [3.0, 4.0]])
    >>> add(a, b, 1.0, 1.0, device="cpu").to_dense()
    [[4.0, 6.0], [4.0, 8.0]]
    """
    p = _plan.add_plan(a, b)
    anz, bnz = a.nnz(), b.nnz()
    if _on_host():
        cx = np.zeros(p.nnz, dtype=a.x.dtype)
        np.add.at(cx, p.seg, np.concatenate([alpha * a.x[:anz], beta * b.x[:bnz]]))
        return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i, cx)
    d = torch.device(device)
    cx = dev.add_values(_vals(a, d), _vals(b, d), alpha, beta,
                        _ix(p, "seg", d), p.nnz)
    return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i, _host(cx))


def multiply(a: Sprs, b: Sprs, *, device="cuda") -> Sprs:
    """C = A*B, ESC SpGEMM (reference Gustavson: src/lib.rs:713-748).

    The output is in canonical order (rows ascending within each column),
    as the JAX package's ESC path gives it.

    >>> from rsparse_tpu_torch import Sprs, multiply
    >>> a = Sprs.new_from_vec([[1.0, 2.0], [3.0, 4.0]])
    >>> multiply(a, Sprs.eye(2), device="cpu").to_dense()
    [[1.0, 2.0], [3.0, 4.0]]
    """
    if a.n != b.m:
        raise ValueError(
            f"dimension mismatch: A is {a.m}x{a.n}, B is {b.m}x{b.n}")
    p = _plan.spgemm_plan(a, b)
    if _on_host():
        cx = np.zeros(p.nnz, dtype=a.x.dtype)
        if len(p.seg):
            np.add.at(cx, p.seg, a.x[p.a_idx] * b.x[p.b_idx])
        return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i, cx)
    d = torch.device(device)
    cx = dev.spgemm_values(_vals(a, d), _vals(b, d), _ix(p, "a_idx", d),
                           _ix(p, "b_idx", d), _ix(p, "seg", d), p.nnz)
    return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i, _host(cx))


def _gathered(p, a: Sprs, device) -> Sprs:
    """Sprs of plan p's pattern with values a.x[p.perm] (transpose,
    permute, symperm)."""
    if _on_host():
        cx = a.x[: a.nnz()][p.perm]
    else:
        d = torch.device(device)
        cx = _host(dev.gather_values(_vals(a, d), _ix(p, "perm", d)))
    return Sprs(len(p.out_i), p.m, p.n, p.out_p, p.out_i, cx)


def transpose(a: Sprs, *, device="cuda") -> Sprs:
    """C = A' by stable counting sort (reference src/lib.rs:1178-1197).

    >>> from rsparse_tpu_torch import Sprs, transpose
    >>> a = Sprs.new_from_vec([[1.0, 2.0], [0.0, 3.0]])
    >>> transpose(a, device="cpu").to_dense()
    [[1.0, 0.0], [2.0, 3.0]]
    """
    return _gathered(_plan.transpose_plan(a), a, device)


def gaxpy(a: Sprs, x, y, *, device="cuda") -> list:
    """r = A*x + y (reference src/lib.rs:411-421).

    >>> from rsparse_tpu_torch import Sprs, gaxpy
    >>> a = Sprs.new_from_vec([[1.0, 2.0], [3.0, 4.0]])
    >>> [float(v) for v in gaxpy(a, [1.0, 1.0], [0.0, 0.0], device="cpu")]
    [3.0, 7.0]
    """
    nz = a.nnz()
    cols = _plan.col_ids(a.p, a.n)
    if _on_host():
        r = np.asarray(y, dtype=a.x.dtype).copy()
        np.add.at(r, a.i[:nz], a.x[:nz] * np.asarray(x, dtype=a.x.dtype)[cols])
        return list(r)
    d = torch.device(device)
    t = lambda v, dt: torch.as_tensor(np.asarray(v, dtype=dt), device=d)
    r = dev.gaxpy(_vals(a, d), t(a.i[:nz], np.int64), t(cols, np.int64),
                  t(x, a.x.dtype), t(y, a.x.dtype), a.m)
    return list(_host(r))


def gaxpy_multi(a: Sprs, X, Y=None, *, device="cuda") -> torch.Tensor:
    """R = A@X (+ Y) for a dense RHS batch X [n, B], in A's value dtype.

    The batched extension of the reference's single-RHS gaxpy
    (src/lib.rs:411-421). Y is [m, B], or [m] for a per-row addend added
    to every column. X and Y may be numpy arrays or tensors; R is a tensor
    on `device`. The product is the streaming SpMM of `ops.spmm_cuda`: on a
    CUDA device its kernel (float32 and float64), on the CPU its plain
    torch version.
    """
    d = torch.device(device)
    Xt = torch.as_tensor(X, device=d)
    if Xt.dim() != 2 or Xt.shape[0] != a.n:
        raise ValueError(f"X must be [n={a.n}, B], got {tuple(Xt.shape)}")
    nrhs = Xt.shape[1]
    Yt = None
    if Y is not None:
        Yt = torch.as_tensor(Y, device=d)
        if Yt.dim() == 1 and Yt.shape[0] == a.m:
            Yt = Yt[:, None]  # per-row addend (gaxpy-style), every column
        elif tuple(Yt.shape) != (a.m, nrhs):
            raise ValueError(
                f"Y must be [m={a.m}, {nrhs}] or [m], got {tuple(Yt.shape)}")
    vals = _vals(a, d)
    R = spmm_fn(spmm_plan_cached(a))(vals, Xt.to(vals.dtype))
    return R if Yt is None else R + Yt.to(R.dtype)


def norm(a: Sprs, *, device="cuda") -> float:
    """1-norm (max column abs-sum), reference src/lib.rs:771-782.

    >>> from rsparse_tpu_torch import Sprs, norm
    >>> norm(Sprs.new_from_vec([[1.0, -5.0], [2.0, 1.0]]), device="cpu")
    6.0
    """
    if a.n == 0 or a.nnz() == 0:
        return 0.0
    cols = _plan.col_ids(a.p, a.n)
    if _on_host():
        return float(np.bincount(cols, weights=np.abs(a.x[: a.nnz()]), minlength=a.n).max())
    d = torch.device(device)
    return float(dev.norm1(_vals(a, d), torch.as_tensor(cols, device=d), a.n))


def scpmat(alpha: float, a: Sprs, *, device="cuda") -> Sprs:
    """C = alpha + A on stored entries (reference src/lib.rs:1019-1029)."""
    if _on_host():
        cx = alpha + a.x
    else:
        cx = _host(dev.scpmat_values(alpha, _vals(a, torch.device(device), True)))
    return Sprs(a.nzmax, a.m, a.n, a.p.copy(), a.i.copy(), cx)


def scxmat(alpha: float, a: Sprs, *, device="cuda") -> Sprs:
    """C = alpha * A on stored entries (reference src/lib.rs:1062-1072)."""
    if _on_host():
        cx = alpha * a.x
    else:
        cx = _host(dev.scxmat_values(alpha, _vals(a, torch.device(device), True)))
    return Sprs(a.nzmax, a.m, a.n, a.p.copy(), a.i.copy(), cx)


def permute(a: Sprs, pinv: Optional[np.ndarray], q: Optional[np.ndarray], *,
            device="cuda") -> Sprs:
    """C = A(P,Q) (reference src/lib.rs:2163-2192)."""
    return _gathered(_plan.permute_plan(a, pinv, q), a, device)


def symperm(a: Sprs, pinv: Optional[np.ndarray], *, device="cuda") -> Sprs:
    """C = A(p,p) of the upper-triangular part (reference src/lib.rs:2369-2408)."""
    return _gathered(_plan.symperm_plan(a, pinv), a, device)


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


def fkeep(a: Sprs, f: Callable[[int, int, float], bool]) -> int:
    """In-place filter of entries by predicate (reference src/lib.rs:2075-2095)."""
    nz = a.nnz()
    rows = a.i[:nz]
    cols = _plan.col_ids(a.p, a.n)
    keep = np.fromiter(
        (f(int(rows[k]), int(cols[k]), float(a.x[k])) for k in range(nz)),
        dtype=bool,
        count=nz,
    )
    kept_before = np.concatenate([[0], np.cumsum(keep)])
    a.p = kept_before[a.p[: a.n + 1]].astype(np.int64)
    a.i = a.i[:nz][keep]
    a.x = a.x[:nz][keep]
    a.nzmax = int(a.x.size)
    return int(a.p[a.n])


def sprs_print(a: Sprs, brief: bool = False, *, device="cuda") -> None:
    """Debug pretty-printer (reference src/lib.rs:1076-1104); the 1-norm
    is computed on `device`."""
    print(f"{a.m}-by-{a.n}, nzmax: {a.nzmax} nnz: {a.p[a.n]}, 1-norm: {norm(a, device=device)}")
    for j in range(a.n):
        print(f"      col {j} : locations {a.p[j]} to {a.p[j + 1] - 1}")
        for q in range(int(a.p[j]), int(a.p[j + 1])):
            print(f"            {a.i[q]} : {a.x[q]}")
            if brief and q > 20:
                print("  ...")
                return


from .chain import ChainExpr, chain  # noqa: E402  (device op chaining)
