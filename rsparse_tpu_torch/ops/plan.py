"""Host-side symbolic planners (vectorized numpy, no per-entry loops).

Every sparse op splits into a *plan* (pattern + gather/scatter index arrays,
computed once per sparsity pattern) and a numeric pass that applies it to the
values (`ops.device`, torch on the caller's device). The planners are copies
of the JAX package's (`rsparse_tpu/ops/plan.py`), kept identical so that
both packages give the same patterns and entry orders.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..data import Sprs


def col_ids(p: np.ndarray, n: int) -> np.ndarray:
    """Expand CSC column pointers to a per-entry column-index array."""
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(p[: n + 1]))


# ---------------------------------------------------------------------------
# Pattern-keyed plan cache: repeated add/multiply/transpose on one sparsity
# pattern skip the O(nnz log nnz) replanning. Keyed by a content fingerprint
# of (m, n, p, i) — O(nnz) hashing, ~20x cheaper than the argsort it avoids —
# so it is robust to in-place pattern mutation (trim/fkeep).
# ---------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_PLAN_CACHE_CAP = 128


def pattern_key(a: Sprs) -> tuple:
    nz = a.nnz()
    return (a.m, a.n, int(nz),
            hash(np.ascontiguousarray(a.p[: a.n + 1]).tobytes()),
            hash(np.ascontiguousarray(a.i[:nz]).tobytes()))


def _cached_plan(op: str, make, *mats: Sprs):
    key = (op,) + tuple(pattern_key(m) for m in mats)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = make(*mats)
        _PLAN_CACHE[key] = plan
        if len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    return plan


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Static plan for C = A @ B (ESC: expand -> sort -> compress).

    The reference's Gustavson scatter (src/lib.rs:713-748) uses a dense
    workspace per output column. ESC instead expands all (A(i,k), B(k,j))
    products with gather indices, then sums them into the precomputed
    output pattern (one `index_add_`), in the canonical sorted entry order.
    """

    m: int
    n: int
    a_idx: np.ndarray  # [E] gather into A.x
    b_idx: np.ndarray  # [E] gather into B.x
    seg: np.ndarray  # [E] output position per expanded product
    out_p: np.ndarray  # [n+1]
    out_i: np.ndarray  # [nnzC]
    nnz: int


def spgemm_plan(a: Sprs, b: Sprs) -> SpGEMMPlan:
    """Cached wrapper: one plan per (pattern(A), pattern(B))."""
    return _cached_plan("spgemm", _spgemm_plan_build, a, b)


def _spgemm_plan_build(a: Sprs, b: Sprs) -> SpGEMMPlan:
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: A is {a.m}x{a.n}, B is {b.m}x{b.n}")
    anz = a.nnz()
    bnz = b.nnz()
    acnt = np.diff(a.p[: a.n + 1])  # entries per A column
    b_cols = col_ids(b.p, b.n)
    b_rows = a.p[:-1][b.i[:bnz]] if anz else np.zeros(bnz, dtype=np.int64)
    reps = acnt[b.i[:bnz]] if bnz else np.zeros(0, dtype=np.int64)
    E = int(reps.sum())
    if E == 0:
        return SpGEMMPlan(
            a.m,
            b.n,
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(b.n + 1, np.int64),
            np.zeros(0, np.int64),
            0,
        )
    b_idx = np.repeat(np.arange(bnz, dtype=np.int64), reps)
    starts = np.repeat(b_rows, reps)  # A column start per product
    offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
    within = np.arange(E, dtype=np.int64) - np.repeat(offs, reps)
    a_idx = starts + within
    rows = a.i[a_idx]
    cols = np.repeat(b_cols, reps)
    keys = cols * np.int64(a.m) + rows
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_seg = np.empty(E, dtype=bool)
    new_seg[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_seg[1:])
    seg_sorted = np.cumsum(new_seg) - 1
    seg = np.empty(E, dtype=np.int64)
    seg[order] = seg_sorted
    uk = sk[new_seg]
    out_i = uk % a.m
    out_cols = uk // a.m
    out_p = np.zeros(b.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(out_cols, minlength=b.n), out=out_p[1:])
    return SpGEMMPlan(a.m, b.n, a_idx, b_idx, seg, out_p, out_i, int(uk.size))


@dataclasses.dataclass(frozen=True)
class AddPlan:
    """Static plan for C = alpha*A + beta*B (structural union).

    Reference: src/lib.rs:247-271 (per-column double scatter).
    """

    m: int
    n: int
    seg: np.ndarray  # [anz+bnz] output position per input entry (A then B)
    out_p: np.ndarray
    out_i: np.ndarray
    nnz: int


def add_plan(a: Sprs, b: Sprs) -> AddPlan:
    """Cached wrapper: one plan per (pattern(A), pattern(B))."""
    return _cached_plan("add", _add_plan_build, a, b)


def _add_plan_build(a: Sprs, b: Sprs) -> AddPlan:
    # The reference indexes with A's m and B's n without checking shapes
    # (src/lib.rs:249-255); we validate.
    if a.m != b.m or a.n != b.n:
        raise ValueError(f"dimension mismatch: {a.m}x{a.n} + {b.m}x{b.n}")
    anz, bnz = a.nnz(), b.nnz()
    rows = np.concatenate([a.i[:anz], b.i[:bnz]])
    cols = np.concatenate([col_ids(a.p, a.n), col_ids(b.p, b.n)])
    keys = cols * np.int64(a.m) + rows
    E = keys.size
    if E == 0:
        return AddPlan(a.m, b.n, np.zeros(0, np.int64), np.zeros(b.n + 1, np.int64), np.zeros(0, np.int64), 0)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_seg = np.empty(E, dtype=bool)
    new_seg[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_seg[1:])
    seg_sorted = np.cumsum(new_seg) - 1
    seg = np.empty(E, dtype=np.int64)
    seg[order] = seg_sorted
    uk = sk[new_seg]
    out_i = uk % a.m
    out_cols = uk // a.m
    out_p = np.zeros(b.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(out_cols, minlength=b.n), out=out_p[1:])
    return AddPlan(a.m, b.n, seg, out_p, out_i, int(uk.size))


@dataclasses.dataclass(frozen=True)
class TransposePlan:
    """C = A' via stable counting sort by row (reference src/lib.rs:1178-1197).

    `perm` maps output entry position -> input entry position, so the
    numeric step is a single gather.
    """

    m: int  # of C (= a.n)
    n: int  # of C (= a.m)
    perm: np.ndarray
    out_p: np.ndarray
    out_i: np.ndarray


def transpose_plan(a: Sprs) -> TransposePlan:
    """Cached wrapper: one plan per pattern(A)."""
    return _cached_plan("transpose", _transpose_plan_build, a)


def _transpose_plan_build(a: Sprs) -> TransposePlan:
    nz = a.nnz()
    rows = a.i[:nz]
    cols = col_ids(a.p, a.n)
    perm = np.argsort(rows, kind="stable")  # == reference counting sort order
    out_p = np.zeros(a.m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=a.m), out=out_p[1:])
    return TransposePlan(a.n, a.m, perm, out_p, cols[perm])


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
