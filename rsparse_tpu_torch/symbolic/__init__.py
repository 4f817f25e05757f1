"""L3' symbolic analysis: orderings + elimination structures, host-side.

The graph algorithms (AMD, etree, postorder, column counts, vcount) are
sequential pointer-chasing code, so they run once per sparsity pattern in
native C++ (`symbolic.native`). Their outputs (permutations, pointers, level
schedules) become the index tensors the device factorization consumes.

Drivers mirror the reference:
  - `schol(a, order)`  (reference src/lib.rs:968-986)
  - `sqr(a, order, qr)` (reference src/lib.rs:1114-1140)
with `order` in {-1 natural, 0 Chol: amd(A+A'), 1 LU: amd(A'A minus dense
rows), 2 QR: amd(A'A)} (reference src/lib.rs:1324-1355).
"""

from __future__ import annotations

import numpy as np

from ..data import Sprs, Symb
from .. import ops
from . import native

__all__ = ["schol", "sqr", "amd", "etree", "post", "counts", "vcount",
           "native"]


def amd(a: Sprs, order: int):
    """Fill-reducing ordering of A+A' / A'A (reference src/lib.rs:1292-1752)."""
    return native.amd(order, a.m, a.n, a.p, a.i[: a.nnz()])


def etree(a: Sprs, ata: bool = False) -> np.ndarray:
    return native.etree(a.m, a.n, a.p, a.i[: a.nnz()], ata)


def post(n: int, parent: np.ndarray) -> np.ndarray:
    return native.post(n, parent)


def counts(a: Sprs, parent, post_, ata: bool) -> np.ndarray:
    """Column counts of chol(A) or, with `ata`, of chol(A'A) (reference
    src/lib.rs:1797-1897)."""
    return native.counts(a.m, a.n, a.p, a.i[: a.nnz()], parent, post_, ata)


def vcount(a: Sprs, parent):
    """(pinv, m2, vnz): the QR row permutation with fictitious rows, the row
    count with them, and V's entry count (reference src/lib.rs:2450-2530)."""
    return native.vcount(a.m, a.n, a.p, a.i[: a.nnz()], parent)


def _symperm_host(a: Sprs, pinv) -> Sprs:
    """symperm with host-side value application: the symbolic phase is
    once-per-pattern setup, so values move with numpy here. Pattern logic is
    the shared planner (ops.plan.symperm_plan, reference
    src/lib.rs:2369-2408)."""
    from ..ops.plan import symperm_plan

    p = symperm_plan(a, pinv)
    return Sprs(len(p.out_i), p.m, p.n, p.out_p, p.out_i,
                np.asarray(a.x[: a.nnz()])[p.perm])


def _permute_host(a: Sprs, pinv, q) -> Sprs:
    """permute with host-side value application (see _symperm_host)."""
    from ..ops.plan import permute_plan

    p = permute_plan(a, pinv, q)
    return Sprs(len(p.out_i), p.m, p.n, p.out_p, p.out_i,
                np.asarray(a.x[: a.nnz()])[p.perm])


def schol(a: Sprs, order: int) -> Symb:
    """Ordering + symbolic analysis for Cholesky (reference src/lib.rs:968-986).

    Extension: when a fill-reducing ordering is in play (order >= 0) the
    permutation is composed with the elimination-tree postorder. This leaves
    solutions unchanged (any symmetric permutation is admissible) but makes
    every contiguous index tail ancestor-closed — the property the device
    factorization's trailing-dense supernode relies on. Natural order
    (order < 0) stays untouched for exact reference parity.
    """
    n = a.n
    s = Symb()
    p = amd(a, order)
    s.pinv = ops.pinvert(p, n)
    c = _symperm_host(a, s.pinv)
    s.parent = native.etree(c.m, c.n, c.p, c.i[: c.nnz()], False)
    pst = native.post(n, s.parent)
    if p is not None and not np.array_equal(pst, np.arange(n)):
        # compose: new permutation p' = p[post]; redo the analysis on the
        # postordered system (its own postorder is then the identity)
        p = np.asarray(p, dtype=np.int64)[pst]
        s.pinv = ops.pinvert(p, n)
        c = _symperm_host(a, s.pinv)
        s.parent = native.etree(c.m, c.n, c.p, c.i[: c.nnz()], False)
        pst = native.post(n, s.parent)
    cnt = native.counts(c.m, c.n, c.p, c.i[: c.nnz()], s.parent, pst, False)
    s.cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=s.cp[1:])
    s.unz = int(s.cp[n])
    s.lnz = s.unz
    return s


def sqr(a: Sprs, order: int, qr: bool) -> Symb:
    """Ordering + symbolic analysis for LU/QR (reference src/lib.rs:1114-1140)."""
    s = Symb()
    s.q = amd(a, order)
    if qr:
        c = _permute_host(a, None, s.q) if order >= 0 else a
        s.parent = native.etree(c.m, c.n, c.p, c.i[: c.nnz()], True)
        pst = native.post(a.n, s.parent)
        s.cp = native.counts(c.m, c.n, c.p, c.i[: c.nnz()], s.parent, pst, True)
        s.pinv, s.m2, s.lnz = native.vcount(c.m, c.n, c.p, c.i[: c.nnz()], s.parent)
        s.unz = int(np.sum(s.cp[: a.n]))
    else:
        s.unz = 4 * a.nnz() + a.n  # nnz guess (reference src/lib.rs:1135-1136)
        s.lnz = s.unz
    return s
