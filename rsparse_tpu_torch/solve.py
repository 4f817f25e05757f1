"""L5' solvers: batched triangular solves and the `lusol_serve` handle.

Triangular solves run as level-scheduled sweeps: the column DAG of a
triangular factor becomes *level sets* (host, native C++), and one sweep
walks the levels in order, all columns of a level at once. On a CUDA tensor
the sweep is the hand-written kernel of `ops.sptrsv_cuda`; on a CPU tensor
it is that module's plain torch version.

Conventions preserved from the reference:
  - L: the diagonal is the FIRST entry of each column (src/lib.rs:425-427).
  - U: the diagonal is the LAST entry of each column (src/lib.rs:1232).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data import Sprs, Symb
from .ops.plan import col_ids
from .ops.sptrsv_cuda import sptrsv_multi
from .symbolic import native

__all__ = [
    "TriPlan", "DenseSplit", "tri_plan",
    "lsolve_multi", "ltsolve_multi", "usolve_multi", "utsolve_multi",
    "lusol_serve",
]


# ---------------------------------------------------------------------------
# Level-scheduled SpTRSV plans
# ---------------------------------------------------------------------------


# Smallest dense block that `tri_plan` solves as one super-level (columns).
DENSE_MIN = 64


@dataclasses.dataclass(frozen=True)
class DenseSplit:
    """A fully dense triangle D of the solve's dependency DAG, solved as one
    super-level ahead of (`first`) or after the other columns' levels.

    D is closed under predecessors when it goes first and under successors
    when it goes last, so the other columns' levels (`rest`, a level
    schedule over the columns outside D) never wait on it mid-way."""

    k: int  # |D|
    first: bool
    cols: np.ndarray  # [k] D's columns in solve order
    diag: np.ndarray  # [k] diagonal positions in T.x, in solve order
    # the strict triangle, k(k-1)/2 entries:
    #   x[cols[dst]] -= T.x[pos] * x[cols[src]]
    tri_pos: np.ndarray
    tri_dst: np.ndarray  # solve-order index, > tri_src
    tri_src: np.ndarray
    # D's entries into rows outside D: after the triangle in the scatter
    # form (x[row] -= v * x[cols[idx]]), before it in the gather form
    # (x[cols[idx]] -= v * x[row])
    out_pos: np.ndarray
    out_row: np.ndarray
    out_idx: np.ndarray
    rest: "TriPlan"  # level schedule of the columns outside D


@dataclasses.dataclass(frozen=True)
class TriPlan:
    """Flattened level schedule for one triangular matrix + solve kind."""

    n: int
    nlev: int
    emax: int  # max off-diagonal entries in any level
    wmax: int  # max columns in any level
    # flattened, sorted by level
    ent_pos: np.ndarray  # position of entry in T.x
    ent_row: np.ndarray  # row index of entry
    ent_col: np.ndarray  # column of entry
    ent_slot: np.ndarray  # column slot within its level (gather kinds)
    ent_off: np.ndarray  # [nlev+1] level offsets into ent_*
    col_id: np.ndarray  # columns sorted by level
    col_diag: np.ndarray  # diag position in T.x per sorted column
    col_off: np.ndarray  # [nlev+1] level offsets into col_*
    # computes `dense` at its first use (None: the plan has no split)
    split: Optional[Callable[[], Optional[DenseSplit]]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @functools.cached_property
    def dense(self) -> Optional[DenseSplit]:
        """The dense block as one super-level, and the other columns
        re-levelled (None: no dense block of DENSE_MIN columns; the levels
        above are the whole schedule). Found at first use, so that the
        plain level loop never pays for it."""
        return self.split() if self.split is not None else None

    def remap_positions(self, pos: np.ndarray) -> "TriPlan":
        """The same plan with every position into T.x mapped through `pos`
        (for a factor stored inside a larger value array)."""
        m = lambda a: pos[a].astype(np.int32)

        def split():
            d = self.dense
            return None if d is None else dataclasses.replace(
                d, diag=m(d.diag), tri_pos=m(d.tri_pos), out_pos=m(d.out_pos),
                rest=d.rest.remap_positions(pos))

        return dataclasses.replace(self, ent_pos=m(self.ent_pos),
                                   col_diag=m(self.col_diag), split=split)


def _schedule(n: int, lev: np.ndarray, cols: np.ndarray, diag_pos, pos,
              erows, ecols) -> TriPlan:
    """Level schedule of the columns `cols` (ascending) at levels lev[cols]
    (compacted to 0..nlev-1), with the off-diagonal entries (pos, erows,
    ecols) of those columns grouped by the level of their column."""
    uniq, clev = np.unique(lev[cols], return_inverse=True)
    nlev = max(len(uniq), 1)
    lv = np.zeros(n, dtype=np.int64)
    lv[cols] = clev
    corder = cols[np.argsort(clev, kind="stable")]
    col_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(clev, minlength=nlev), out=col_off[1:])
    elev = lv[ecols]
    eorder = np.argsort(elev, kind="stable")
    ent_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(elev, minlength=nlev), out=ent_off[1:])
    # slot of each entry's column within its level (for gather-form kinds)
    slot_of_col = np.zeros(n, dtype=np.int64)
    slot_of_col[corder] = (np.arange(len(cols))
                           - np.repeat(col_off[:-1], np.diff(col_off)))
    emax = int(np.diff(ent_off).max()) if len(pos) else 0
    wmax = int(np.diff(col_off).max()) if len(cols) else 0
    return TriPlan(
        n=n,
        nlev=nlev,
        emax=max(emax, 1),
        wmax=max(wmax, 1),
        ent_pos=pos[eorder].astype(np.int32),
        ent_row=erows[eorder].astype(np.int32),
        ent_col=ecols[eorder].astype(np.int32),
        ent_slot=slot_of_col[ecols[eorder]].astype(np.int32),
        ent_off=ent_off.astype(np.int32),
        col_id=corder.astype(np.int32),
        col_diag=diag_pos[corder].astype(np.int32),
        col_off=col_off.astype(np.int32),
    )


def _grow_chain(n: int, src: np.ndarray, dst: np.ndarray,
                lev: np.ndarray) -> list:
    """Grow a dense chain backward from the deepest sink of the DAG
    (src -> dst): each step adds a node whose successors are exactly the
    chain so far, the deepest (largest `lev`) of them. Returns the nodes in
    the order added (last in dependency order first); the chain is closed
    under successors and, in reverse, a fully dense triangle."""
    outdeg = np.bincount(src, minlength=n)
    sinks = np.nonzero(outdeg == 0)[0]
    if not len(sinks):
        return []
    order = np.argsort(dst, kind="stable")
    pp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=pp[1:])
    preds = src[order]
    cnt = np.zeros(n, dtype=np.int64)  # successors already in the chain
    inchain = np.zeros(n, dtype=bool)
    u = int(sinks[np.argmax(lev[sinks])])
    chain = [u]
    inchain[u] = True
    while True:
        pr = preds[pp[u]: pp[u + 1]]
        np.add.at(cnt, pr, 1)
        m = len(chain)
        cand = pr[(cnt[pr] == m) & (outdeg[pr] == m) & ~inchain[pr]]
        if not len(cand):
            return chain
        u = int(cand[np.argmax(lev[cand])])
        chain.append(u)
        inchain[u] = True


def _dense_split(t: Sprs, kind: int, lev: np.ndarray, diag_pos, pos, erows,
                 ecols) -> Optional[DenseSplit]:
    """Find the largest dense triangle D (>= DENSE_MIN columns) that can go
    first or last in the solve, from the pattern alone; None if there is
    none. Tries both: a chain closed under successors (last), and one
    closed under predecessors (first, grown on the reversed DAG)."""
    n = t.n
    if n < DENSE_MIN:
        return None
    nz = t.nnz()
    scatter = kind in (0, 1)
    src, dst = (ecols, erows) if scatter else (erows, ecols)
    # levels of the reversed DAG: kinds 0 <-> 2 and 1 <-> 3 on one matrix
    lev_rev = native.tri_levels(n, t.p, t.i[:nz], kind ^ 2)
    last = _grow_chain(n, src, dst, lev)[::-1]
    first = _grow_chain(n, dst, src, lev_rev)
    is_first = len(first) > len(last)
    order = np.asarray(first if is_first else last, dtype=np.int64)
    k = len(order)
    if k < DENSE_MIN:
        return None
    idx = np.full(n, -1, dtype=np.int64)
    idx[order] = np.arange(k)
    ind = idx >= 0
    inner = ind[erows] & ind[ecols]
    a, b = idx[src[inner]], idx[dst[inner]]
    if (len(a) != k * (k - 1) // 2 or not np.all(a < b)
            or len(np.unique(b * k + a)) != len(a)):
        return None  # duplicate entries: not one value per triangle slot
    outm = ind[ecols] & ~ind[erows]
    # the rest: columns outside D, levelled without D's edges
    keep = np.zeros(nz, dtype=bool)
    keep[diag_pos] = True
    keep[pos[~(ind[erows] | ind[ecols])]] = True
    cols_all = col_ids(t.p, n)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols_all[keep], minlength=n), out=rp[1:])
    rlev = native.tri_levels(n, rp, t.i[:nz][keep], kind)
    em = ~ind[ecols]
    rest = _schedule(n, rlev, np.nonzero(~ind)[0], diag_pos, pos[em],
                     erows[em], ecols[em])
    i32 = lambda v: np.ascontiguousarray(v, dtype=np.int32)
    return DenseSplit(
        k=k, first=bool(is_first), cols=i32(order), diag=i32(diag_pos[order]),
        tri_pos=i32(pos[inner]), tri_dst=i32(b), tri_src=i32(a),
        out_pos=i32(pos[outm]), out_row=i32(erows[outm]),
        out_idx=i32(idx[ecols[outm]]), rest=rest)


def tri_plan(t: Sprs, kind: int) -> TriPlan:
    """kind: 0=lsolve, 1=usolve (scatter form), 2=ltsolve, 3=utsolve (gather).

    The level fields are the whole level schedule (the JAX package's);
    `dense` adds the kernel's schedule when the factor has a dense block
    (found when first read)."""
    n = t.n
    nz = t.nnz()
    lev = native.tri_levels(n, t.p, t.i[:nz], kind)
    lower_diag = kind in (0, 2)  # diag first for L, last for U
    diag_pos = t.p[:-1] if lower_diag else t.p[1:] - 1
    # off-diagonal entries and their columns
    cols = col_ids(t.p, n)
    pos = np.arange(nz, dtype=np.int64)
    offd = np.ones(nz, dtype=bool)
    offd[diag_pos] = False
    pos = pos[offd]
    ecols = cols[offd]
    erows = t.i[:nz][offd].astype(np.int64)
    plan = _schedule(n, lev, np.arange(n, dtype=np.int64), diag_pos, pos,
                     erows, ecols)
    return dataclasses.replace(plan, split=lambda: _dense_split(
        t, kind, lev, diag_pos, pos, erows, ecols))


# ---------------------------------------------------------------------------
# Batched triangular solves
# ---------------------------------------------------------------------------


def _sweep_device(X, device) -> torch.device:
    """Where a batched solve runs: `device` when given, else X's device when
    X is a tensor, else the card."""
    if device is None:
        device = X.device if isinstance(X, torch.Tensor) else "cuda"
    return torch.device(device)


def _tri_solve_multi(t: Sprs, X, kind: int, plan: Optional[TriPlan] = None,
                     device=None) -> torch.Tensor:
    """Batched dense-RHS triangular solve of X [n, B] in the factor's dtype.

    `device`: where the sweep runs; None = X's device when X is a tensor,
    else the card. Returns the solved [n, B] tensor on that device."""
    p = plan or tri_plan(t, kind)
    device = _sweep_device(X, device)
    tx = torch.as_tensor(t.x[: t.nnz()], device=device)
    Xt = torch.as_tensor(X, device=device).to(tx.dtype)
    return sptrsv_multi(tx, Xt, p, kind)


def lsolve_multi(l: Sprs, X, plan: Optional[TriPlan] = None, *, device=None):
    """Batched Lx=b over the RHS columns of X [n, B]."""
    return _tri_solve_multi(l, X, 0, plan, device)


def ltsolve_multi(l: Sprs, X, plan: Optional[TriPlan] = None, *, device=None):
    """Batched L'x=b over the RHS columns of X [n, B]."""
    return _tri_solve_multi(l, X, 2, plan, device)


def usolve_multi(u: Sprs, X, plan: Optional[TriPlan] = None, *, device=None):
    """Batched Ux=b over the RHS columns of X [n, B]."""
    return _tri_solve_multi(u, X, 1, plan, device)


def utsolve_multi(u: Sprs, X, plan: Optional[TriPlan] = None, *, device=None):
    """Batched U'x=b over the RHS columns of X [n, B]."""
    return _tri_solve_multi(u, X, 3, plan, device)


# ---------------------------------------------------------------------------
# Serving handle
# ---------------------------------------------------------------------------


def _host_spmm(a: Sprs, X: np.ndarray) -> np.ndarray:
    """R = A @ X for X [n, B], vectorized host numpy (IR residuals)."""
    nz = a.nnz()
    cols = col_ids(a.p, a.n)
    R = np.zeros((a.m, X.shape[1]), dtype=np.float64)
    np.add.at(R, a.i[:nz], a.x[:nz][:, None] * X[cols])
    return R


def _make_serve_handle(n: int, chain, pin, pout, Mi, Mj, Mx, refine: int,
                       device):
    """Build a device-resident batched solve handle `h(B[n, nrhs]) -> X`.

    chain: [(TriPlan, vals_f64, kind), ...] — float32 SpTRSV sweeps run in
    order. pin/pout: row permutations (Bp[pin[i]] = B[i] on the way in,
    X[i] = Xs[pout[i]] on the way out; None = identity). (Mi, Mj, Mx): COO
    of the f64 residual matrix in ORIGINAL row order — up to `refine`
    iterative-refinement steps run on device against it. The factor values
    and index tensors stay on `device` across calls."""
    dev = torch.device(device)
    sweeps = [(plan, torch.as_tensor(vals, device=dev).to(torch.float32), kind)
              for plan, vals, kind in chain]
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    pin_d = ix(pin) if pin is not None else None
    pout_d = ix(pout) if pout is not None else None
    Mi_d, Mj_d = ix(Mi), ix(Mj)
    Mx_d = torch.as_tensor(np.asarray(Mx, np.float64), device=dev)

    def solve_full(R):
        Rp = R if pin_d is None else torch.zeros_like(R).index_copy_(0, pin_d, R)
        Z = Rp.to(torch.float32)
        for plan, v32, kind in sweeps:  # X^T views between the sweeps
            Z = sptrsv_multi(v32, Z, plan, kind, contiguous=False)
        Xs = Z.to(torch.float64, memory_format=torch.contiguous_format)
        return Xs if pout_d is None else Xs[pout_d]

    def amul(X):
        return torch.zeros_like(X).index_add_(0, Mi_d, Mx_d[:, None] * X[Mj_d])

    def handle(B):
        B64 = torch.as_tensor(B, device=dev).to(torch.float64)
        X = solve_full(B64)
        r = B64 - amul(X)
        rmax = float(r.abs().max())
        scale = max(float(B64.abs().max()), 1.0)
        # early-exit refinement: up to `refine` steps, keep the best
        # iterate, stop once converged or stagnant — well-conditioned
        # systems exit after one check, weak static-pivot factors (element
        # growth) get the extra contractions they need
        k, prev = 0, float("inf")
        while k < refine and rmax > 1e-13 * scale and rmax < prev:
            X2 = X + solve_full(r)
            r2 = B64 - amul(X2)
            rmax2 = float(r2.abs().max())
            if rmax2 < rmax:
                X, r = X2, r2
            prev, rmax, k = rmax, min(rmax2, rmax), k + 1
        handle.last_residual = rmax
        return X

    handle.last_residual = None
    return handle


def lusol_serve(a: Sprs, order: int = 1, tol: float = 1e-6, *,
                sym: Optional[Symb] = None, refine: int = 8, device="cuda"):
    """Device-resident batched LU solve handle: `h(B[n, nrhs]) -> X` with
    lusol semantics (reference src/lib.rs:672-683: P from partial pivoting,
    Q from the fill-reducing column ordering).

    One symbolic analysis + one f64 factorization on `device`, then every
    `h(B)` call runs two float32 SpTRSV sweeps (L then U) and up to `refine`
    early-exit steps of f64 iterative refinement against A, on `device`. B
    may be a numpy array or a tensor; X is an f64 tensor on `device`.
    `h.last_residual` holds the final residual max, `h.factor_route` says
    which factors the handle serves ("device_mf", "device_level", "host" or
    "host_exact" after a failed factor-quality probe), and `h.build_seconds`
    the wall time of each build phase."""
    from .factor import lu
    from .symbolic import sqr

    dev = torch.device(device)
    t0 = time.perf_counter()
    n = a.n
    s = sym if sym is not None else sqr(a, order, False)
    t1 = time.perf_counter()
    nm = lu(a, s, tol, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    lmat, umat = nm.l, nm.u
    route = s._lu_route
    pin = np.asarray(nm.pinv, np.int64) if nm.pinv is not None else None
    nz = a.nnz()
    # Factor-quality probe: static-pivot element growth can leave the MF
    # factors too weak for the handle's refinement to contract (it stalls
    # at ~growth*eps). One f64 sweep pair on a probe RHS measures the
    # factor's actual solve accuracy; if it misses, rebuild the chain from
    # the host engine's exact partial-pivoting factors (the same escape the
    # lusol driver uses, moved to build time so every h(B) call is
    # accurate).
    rngp = np.random.default_rng(0)
    bp = rngp.standard_normal((n, 2))
    zp = np.zeros_like(bp)
    if pin is not None:
        zp[pin] = bp
    else:
        zp[:] = bp
    p0, p1 = tri_plan(lmat, 0), tri_plan(umat, 1)
    zt = _tri_solve_multi(lmat, zp, 0, p0, device=dev)
    zp = _tri_solve_multi(umat, zt, 1, p1, device=dev).cpu().numpy()
    xp = np.zeros_like(zp)
    if s.q is not None:
        xp[np.asarray(s.q, np.int64)] = zp
    else:
        xp[:] = zp
    probe_res = float(np.abs(_host_spmm(a, xp) - bp).max())
    if probe_res > 1e-8 * max(1.0, float(np.abs(bp).max())):
        Lp2, Li2, Lx2, Up2, Ui2, Ux2, pv = native.lu_numeric(
            n, a.p, a.i[:nz], a.x[:nz], s.q, tol, s.lnz, s.unz)
        lmat = Sprs(len(Lx2), n, n, Lp2, Li2, np.asarray(Lx2))
        umat = Sprs(len(Ux2), n, n, Up2, Ui2, np.asarray(Ux2))
        pin = np.asarray(pv, np.int64)
        route = "host_exact"
        p0, p1 = tri_plan(lmat, 0), tri_plan(umat, 1)
    t3 = time.perf_counter()
    # out[q[i]] = xs[i]  <=>  out[j] = xs[qinv[j]]
    pout = (np.argsort(np.asarray(s.q, np.int64))
            if s.q is not None else None)
    Mi = a.i[:nz]
    Mj = col_ids(a.p, n)
    Mx = np.asarray(a.x[:nz], np.float64)
    h = _make_serve_handle(
        n, [(p0, lmat.x[: lmat.nnz()], 0), (p1, umat.x[: umat.nnz()], 1)],
        pin, pout, Mi, Mj, Mx, refine, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    h.sym = s
    h.factor_route = route
    h.build_seconds = {"analysis": t1 - t0, "factor": t2 - t1,
                       "probe": t3 - t2, "handle": t4 - t3}
    return h
