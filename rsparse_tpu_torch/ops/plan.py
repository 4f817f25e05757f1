"""Host-side symbolic planners (vectorized numpy, no per-entry loops).

Every sparse op splits into a *plan* (pattern + gather/scatter index arrays,
computed once per sparsity pattern) and a numeric pass that applies it to the
values. This slice needs the permutation planners that the symbolic analysis
and the multifrontal LU planner call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..data import Sprs


def col_ids(p: np.ndarray, n: int) -> np.ndarray:
    """Expand CSC column pointers to a per-entry column-index array."""
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(p[: n + 1]))


@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """C = A(P,Q): column gather + row relabel (reference src/lib.rs:2163-2192).

    Output keeps the reference's entry order: column k of C is column q[k] of
    A verbatim with rows relabelled through pinv (NOT re-sorted).
    """

    m: int
    n: int
    perm: np.ndarray  # gather input positions
    out_p: np.ndarray
    out_i: np.ndarray


def permute_plan(a: Sprs, pinv: Optional[np.ndarray], q: Optional[np.ndarray]) -> PermutePlan:
    nz = a.nnz()
    cnt = np.diff(a.p[: a.n + 1])
    if q is not None:
        q = np.asarray(q, dtype=np.int64)
        new_cnt = cnt[q]
        out_p = np.zeros(a.n + 1, dtype=np.int64)
        np.cumsum(new_cnt, out=out_p[1:])
        starts = a.p[:-1][q]
        offs = np.repeat(starts, new_cnt)
        within = np.arange(nz, dtype=np.int64) - np.repeat(out_p[:-1], new_cnt)
        perm = offs + within
    else:
        out_p = a.p[: a.n + 1].copy()
        perm = np.arange(nz, dtype=np.int64)
    rows = a.i[:nz][perm]
    if pinv is not None:
        rows = np.asarray(pinv, dtype=np.int64)[rows]
    return PermutePlan(a.m, a.n, perm, out_p, rows)


def symperm_plan(a: Sprs, pinv: Optional[np.ndarray]) -> PermutePlan:
    """C = A(p,p), upper-triangular part only (reference src/lib.rs:2369-2408).

    Keeps the reference's exact output entry order (two-pass count+fill over
    columns, entries appended in input scan order per output column).
    """
    nz = a.nnz()
    n = a.n
    rows = a.i[:nz]
    cols = col_ids(a.p, n)
    keep = rows <= cols  # upper triangular of A
    rows = rows[keep]
    cols = cols[keep]
    src = np.nonzero(keep)[0]
    if pinv is not None:
        pv = np.asarray(pinv, dtype=np.int64)
        r2 = pv[rows]
        c2 = pv[cols]
    else:
        r2, c2 = rows, cols
    out_col = np.maximum(r2, c2)
    out_row = np.minimum(r2, c2)
    # reference fills in input scan order per output column -> stable sort
    order = np.argsort(out_col, kind="stable")
    out_p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(out_col, minlength=n), out=out_p[1:])
    return PermutePlan(n, n, src[order], out_p, out_row[order])


def device_cache(obj, name: str, device, build):
    """`build()` cached on a host plan object, once per device.

    Plans hold numpy arrays; the torch tensors made from them for one
    device are kept in `obj.__dict__[name]`, keyed by the device, so repeat
    calls reuse them (frozen dataclasses included)."""
    cache = obj.__dict__.setdefault(name, {})
    key = str(device)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = build()
    return hit
