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
import time
from typing import Optional

import numpy as np
import torch

from .data import Sprs, Symb
from .ops.plan import col_ids
from .ops.sptrsv_cuda import sptrsv_multi
from .symbolic import native

__all__ = [
    "TriPlan", "tri_plan",
    "lsolve_multi", "ltsolve_multi", "usolve_multi", "utsolve_multi",
    "lusol_serve",
]


# ---------------------------------------------------------------------------
# Level-scheduled SpTRSV plans
# ---------------------------------------------------------------------------


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


def tri_plan(t: Sprs, kind: int) -> TriPlan:
    """kind: 0=lsolve, 1=usolve (scatter form), 2=ltsolve, 3=utsolve (gather)."""
    n = t.n
    nz = t.nnz()
    lev = native.tri_levels(n, t.p, t.i[:nz], kind)
    nlev = int(lev.max()) + 1 if n else 1
    corder = np.argsort(lev, kind="stable")
    col_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(lev, minlength=nlev), out=col_off[1:])
    lower_diag = kind in (0, 2)  # diag first for L, last for U
    diag_pos = t.p[:-1] if lower_diag else t.p[1:] - 1
    col_diag = diag_pos[corder]
    # off-diagonal entries, grouped by the level of their column
    cols = col_ids(t.p, n)
    pos = np.arange(nz, dtype=np.int64)
    offd = np.ones(nz, dtype=bool)
    offd[diag_pos] = False
    pos = pos[offd]
    ecols = cols[offd]
    erows = t.i[:nz][offd]
    elev = lev[ecols]
    eorder = np.argsort(elev, kind="stable")
    ent_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(elev, minlength=nlev), out=ent_off[1:])
    # slot of each entry's column within its level (for gather-form kinds)
    slot_of_col = np.empty(n, dtype=np.int64)
    slot_of_col[corder] = np.arange(n) - np.repeat(col_off[:-1], np.diff(col_off))
    emax = int(np.diff(ent_off).max()) if nlev and nz > n else 0
    wmax = int(np.diff(col_off).max()) if n else 0
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
        col_diag=col_diag.astype(np.int32),
        col_off=col_off.astype(np.int32),
    )


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
        for plan, v32, kind in sweeps:
            Z = sptrsv_multi(v32, Z, plan, kind)
        Xs = Z.to(torch.float64)
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
    zt = _tri_solve_multi(lmat, zp, 0, device=dev)
    zp = _tri_solve_multi(umat, zt, 1, device=dev).cpu().numpy()
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
    t3 = time.perf_counter()
    p0 = tri_plan(lmat, 0)
    p1 = tri_plan(umat, 1)
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
