"""L5' solvers: triangular solves, the lusol/cholsol/qrsol solvers and
the serve handles.

Triangular solves run as level-scheduled sweeps: the column DAG of a
triangular factor becomes *level sets* (host, native C++), and one sweep
walks the levels in order, all columns of a level at once. On a CUDA tensor
the sweep is the hand-written kernel of `ops.sptrsv_cuda`; on a CPU tensor
it is that module's plain torch version. The single-RHS solves
(`lsolve`, ...) run one sweep with B = 1 (or the native engine with
`config.backend == "host"`); the batched ones (`lsolve_multi`, ...) one
sweep over all columns.

`lusol`, `cholsol` and `qrsol` keep the reference's signatures,
`order`/`tol` semantics, error types and in-place overwrite of `b`. At or
above `config.mf_min_n` lusol and cholsol first run a one-shot on the
device: the multifrontal factorization, its front solves and early-exit
f64 iterative refinement (`_lu_one_shot`, `_chol_one_shot`), with the host
engine's exact factors as the escape when refinement falls short. Below it, or
when the multifrontal plan does not apply or LU's pivot margin rejects the
static pivots, they factor with `factor.lu`/`factor.chol` and run the
single-RHS solves. `lusol_serve`/`cholsol_serve`/`qrsol_serve` build a
device-resident handle for batches of right-hand sides: float32 sweeps of
the whole factor through the kernel plus f64 refinement (CSNE steps for
`qrsol_serve`). The batched drivers `cholsol_multi`, `lusol_multi` and
`qrsol_multi` answer B[n, nrhs] on one factorization (the multifrontal
tree, a cached serve handle, or f64 sweeps over all columns), and
`cholsol_ir` factors A's values rounded to a lower precision and refines
in f64. The batched-values drivers `cholsol_vals`, `lusol_vals` and
`qrsol_vals` answer K systems of one pattern (values [K, nnz]) with one
multifrontal factorization and solve of all K on the device. `qrsol` runs the
multifrontal QR at or above `config.mf_min_n` (the tree's Qᵀb or Q·x and
one R sweep, held to an acceptance gate, the host engine's exact QR as the
escape), `factor.qr` and the reference's apply below it; `qrsol_ls` solves
the same problems by corrected seminormal equations.

Conventions preserved from the reference:
  - L: the diagonal is the FIRST entry of each column (src/lib.rs:425-427).
  - U: the diagonal is the LAST entry of each column (src/lib.rs:1232).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import ops
from .config import config
from .data import Nmrc, Sprs, Symb
from .factor import _card, _values_fp, device_values, require_square
from .ops.plan import _cached_plan, col_ids, device_cache
from .ops.snode import SnodePlan, snode_panels, snode_schedule
from .ops.sptrsv_cuda import prepare, sptrsv_multi
from .symbolic import native
from .utils.profiling import device_barrier, phase_timer

__all__ = [
    "TriPlan", "DenseSplit", "tri_plan",
    "lsolve", "ltsolve", "usolve", "utsolve",
    "lsolve_multi", "ltsolve_multi", "usolve_multi", "utsolve_multi",
    "lusol", "cholsol", "lusol_serve", "cholsol_serve",
    "happly_dense", "qrsol", "qrsol_ls",
    "cholsol_multi", "lusol_multi", "qrsol_multi", "qrsol_serve", "cholsol_ir",
    "cholsol_vals", "lusol_vals", "qrsol_vals",
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
    # computes `snode` at its first use (None: kinds 1 and 3)
    supernodes: Optional[Callable[[], Optional[SnodePlan]]] = (
        dataclasses.field(default=None, repr=False, compare=False))

    @functools.cached_property
    def dense(self) -> Optional[DenseSplit]:
        """The dense block as one super-level, and the other columns
        re-levelled (None: no dense block of DENSE_MIN columns; the levels
        above are the whole schedule). Found at first use, so that the
        plain level loop never pays for it."""
        return self.split() if self.split is not None else None

    @functools.cached_property
    def snode(self) -> Optional[SnodePlan]:
        """The supernodal schedule of an L sweep (kinds 0 and 2; see
        `ops.snode`), for the kernel's "supernodal" variant; None for kinds
        1 and 3 and for a pattern it does not take. Found at first use,
        from the pattern alone; both kinds share one analysis of it."""
        return self.supernodes() if self.supernodes is not None else None

    def remap_positions(self, pos: np.ndarray) -> "TriPlan":
        """The same plan with every position into T.x mapped through `pos`
        (for a factor stored inside a larger value array)."""
        m = lambda a: pos[a].astype(np.int32)

        def split():
            d = self.dense
            return None if d is None else dataclasses.replace(
                d, diag=m(d.diag), tri_pos=m(d.tri_pos), out_pos=m(d.out_pos),
                rest=d.rest.remap_positions(pos))

        def supernodes():
            sp = self.snode
            return None if sp is None else dataclasses.replace(
                sp, panels=dataclasses.replace(sp.panels,
                                               vpos=m(sp.panels.vpos)))

        return dataclasses.replace(self, ent_pos=m(self.ent_pos),
                                   col_diag=m(self.col_diag), split=split,
                                   supernodes=supernodes)


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
    `dense` adds the kernel's schedule when the factor has a dense block,
    `snode` the supernodal one of an L sweep (each found when first
    read)."""
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
    return dataclasses.replace(
        plan, split=lambda: _dense_split(t, kind, lev, diag_pos, pos, erows,
                                         ecols),
        supernodes=(lambda: _supernodes(t, kind)) if kind in (0, 2) else None)


def _supernodes(t: Sprs, kind: int) -> Optional[SnodePlan]:
    """`TriPlan.snode` of L = t for kind 0 or 2: the panels, cached on the
    pattern (`ops.plan`) so that the two kinds of one factor share them."""
    pn = _cached_plan("snode", lambda a: snode_panels(a.n, a.p, a.i), t)
    return None if pn is None else snode_schedule(pn, kind)


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
# Single-RHS triangular solves
# ---------------------------------------------------------------------------


def _writable(a: np.ndarray) -> np.ndarray:
    """`a` itself if it is a writable ndarray, else a copy (a numpy view of
    a tensor or of a caller's buffer may be read-only)."""
    return a if a.flags.writeable else a.copy()


def _host_values(v) -> np.ndarray:
    """A factor's values as a host array (they may be a tensor on a card)."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tri_solve(t: Sprs, x, kind: int, plan: Optional[TriPlan] = None,
               device="cuda", tx: Optional[torch.Tensor] = None) -> np.ndarray:
    """One RHS: the native engine when `config.backend == "host"`, else one
    SpTRSV sweep with B = 1 on `device`, in the factor's dtype. `tx`: t's
    values already on `device` (a factorization's `device_values`), else
    t.x is uploaded. Returns a new writable host array."""
    nz = t.nnz()
    if config.backend == "host":
        xv = np.array(x, dtype=np.float64)  # the engine solves in place
        fn = [native.lsolve_host, native.usolve_host, native.ltsolve_host,
              native.utsolve_host][kind]
        fn(t.n, t.p, t.i[:nz], _host_values(t.x[:nz]), xv)
        return xv
    p = plan or tri_plan(t, kind)
    dev = torch.device(device)
    if tx is None:
        tx = torch.as_tensor(t.x[:nz], device=dev)
    X = torch.as_tensor(np.array(x, dtype=np.float64), device=dev)
    return sptrsv_multi(tx, X.to(tx.dtype)[:, None], p, kind)[:, 0].cpu().numpy()


def _writeback(x_obj, sol: np.ndarray):
    """Mirror the reference's in-place overwrite of b where possible."""
    if isinstance(x_obj, list):
        # list slice-assign GROWS when sol is longer — the reference's
        # Vec resize semantics (underdetermined qrsol returns n > m values)
        x_obj[: len(sol)] = [float(v) for v in sol]
    elif (isinstance(x_obj, np.ndarray) and x_obj.flags.writeable
          and len(sol) <= len(x_obj)):
        # a fixed-size ndarray cannot grow; when the solution is longer
        # (underdetermined qrsol) the caller gets it from the return value
        x_obj[: len(sol)] = sol
    return x_obj if isinstance(x_obj, (list, np.ndarray)) else sol


def lsolve(l: Sprs, x, *, device="cuda"):
    """Solve Lx=b, diag first entry per column (reference src/lib.rs:464-471).

    >>> from rsparse_tpu_torch import Sprs, lsolve
    >>> l = Sprs.new_from_vec([[2.0, 0.0], [1.0, 4.0]])
    >>> [round(float(v), 6) for v in lsolve(l, [2.0, 5.0], device="cpu")]
    [1.0, 1.0]
    """
    sol = _tri_solve(l, x, 0, device=device)
    _writeback(x, sol)
    return sol


def ltsolve(l: Sprs, x, *, device="cuda"):
    """Solve L'x=b (reference src/lib.rs:505-512).

    >>> from rsparse_tpu_torch import Sprs, ltsolve
    >>> l = Sprs.new_from_vec([[2.0, 0.0], [1.0, 4.0]])
    >>> [round(float(v), 6) for v in ltsolve(l, [3.0, 4.0], device="cpu")]
    [1.0, 1.0]
    """
    sol = _tri_solve(l, x, 2, device=device)
    _writeback(x, sol)
    return sol


def usolve(u: Sprs, x, *, device="cuda"):
    """Solve Ux=b, diag last entry per column (reference src/lib.rs:1230-1237).

    >>> from rsparse_tpu_torch import Sprs, usolve
    >>> u = Sprs.new_from_vec([[2.0, 1.0], [0.0, 4.0]])
    >>> [round(float(v), 6) for v in usolve(u, [3.0, 4.0], device="cpu")]
    [1.0, 1.0]
    """
    sol = _tri_solve(u, x, 1, device=device)
    _writeback(x, sol)
    return sol


def utsolve(u: Sprs, x, *, device="cuda"):
    """Solve U'x=b (reference src/lib.rs:1271-1278).

    >>> from rsparse_tpu_torch import Sprs, utsolve
    >>> u = Sprs.new_from_vec([[2.0, 1.0], [0.0, 4.0]])
    >>> [round(float(v), 6) for v in utsolve(u, [2.0, 5.0], device="cpu")]
    [1.0, 1.0]
    """
    sol = _tri_solve(u, x, 3, device=device)
    _writeback(x, sol)
    return sol


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


def _coo_amul(Mi: torch.Tensor, Mj: torch.Tensor, Mx: torch.Tensor,
              rows: Optional[int] = None):
    """X [k, B] -> A @ X for the COO matrix (Mi, Mj, Mx) with `rows` rows
    (default k: square) (f64 residuals). With K instances' values Mx
    [K, nnz] (one pattern), X [K, k, B] -> [K, rows, B]."""
    return lambda X: X.new_zeros(
        X.shape[:-2] + (X.shape[-2] if rows is None else rows, X.shape[-1])
    ).index_add_(-2, Mi, Mx[..., None] * X[..., Mj, :])


def _csr_amul(Mi, Mj, Mx, rows: int, cols: int, device):
    """`f(X [cols, B], sub=None)` -> A @ X, or sub - A @ X, for the f64 COO
    matrix (Mi, Mj, Mx) of shape rows x cols: one launch of the SpMM kernel
    (`ops.spmm_cuda.spmm_csr`) on A's CSR copy, whose values and index
    streams are kept on `device`."""
    plan = ops.spmm_cuda.spmm_plan_coo(Mi, Mj, rows, cols)
    vals = torch.as_tensor(np.asarray(Mx, np.float64)[plan.perm], device=device)
    return lambda X, sub=None: ops.spmm_cuda.spmm_csr(vals, X, plan, sub=sub)


def _amax(t: torch.Tensor):
    """max|t| over the last two dimensions, read back: a float, or an array
    [K] for K instances (t [K, rows, B]). Each call is one host-device
    synchronization: a `refine.readback` span, counted on
    `_amax.readbacks`."""
    _amax.readbacks += 1
    with phase_timer("refine.readback"):
        v = (t.abs().amax((-2, -1)) if t.dim() >= 2 else t.abs().amax())
        v = v.cpu().numpy()
    return float(v) if v.ndim == 0 else v


_amax.readbacks = 0  # host reads of max|.| (refinement's synchronizations)


def _host_spmm_t(a: Sprs, R: np.ndarray) -> np.ndarray:
    """Z = A' @ R for R [m, B] via A's own entry stream (no transpose),
    host numpy: one segment sum per column of A."""
    nz = a.nnz()
    Z = np.zeros((a.n, R.shape[1]), dtype=np.float64)
    if nz:
        prod = np.asarray(a.x[:nz], np.float64)[:, None] * R[a.i[:nz]]
        full = np.nonzero(np.diff(a.p))[0]
        Z[full] = np.add.reduceat(prod, a.p[full], axis=0)
    return Z


def _refine(correct, resid, B64: torch.Tensor, steps: int, first=None):
    """X = correct(first) (first: B64 when None), then up to `steps` steps
    X += correct(r) with r = resid(X), keeping the best iterate and
    stopping once converged (max|r| <= 1e-13 max(1, max|B64|)) or stagnant.
    The square solves pass their solve and resid(X) = B - AX; the CSNE
    handle (`qrsol_serve`) the Gram solve (then A' for m < n) and the
    least-squares gradient A'(B - AX) (B - AX for m < n). Reads max|r|
    back once per step. Returns (X, max|r| as a float).

    B64 [K, n, B] holds K instances (the batched-values solvers): each
    keeps its own best iterate and stops on its own, the steps run while
    any instance is active, and each step reads the K maxima back at once;
    max|r| is then an array [K]."""
    X = correct(B64 if first is None else first)
    r = resid(X)
    rmax = np.asarray(_amax(r))
    scale = np.maximum(np.asarray(_amax(B64)), 1.0)
    # well-conditioned systems exit after one check; weak static-pivot
    # factors (element growth) get the extra contractions they need
    k, prev = 0, np.full_like(rmax, np.inf)
    active = (rmax > 1e-13 * scale) & (rmax < prev)
    while k < steps and active.any():
        X2 = X + correct(r)
        r2 = resid(X2)
        rmax2 = np.asarray(_amax(r2))
        better = active & (rmax2 < rmax)
        if better.all():
            X, r = X2, r2
        elif better.any():  # keep each instance's best iterate
            keep = torch.as_tensor(better, device=X.device)[..., None, None]
            X, r = torch.where(keep, X2, X), torch.where(keep, r2, r)
        prev = np.where(active, rmax, prev)
        rmax = np.where(active, np.minimum(rmax2, rmax), rmax)
        k += 1
        active &= (rmax > 1e-13 * scale) & (rmax < prev)
    return X, (float(rmax) if rmax.ndim == 0 else rmax)


def _permuted(solve, p: Optional[torch.Tensor]):
    """R -> P' solve(P R) for the row permutation p (Z[p[i]] = R[i] on the
    way in, X[i] = Y[p[i]] on the way out; None = identity). Rows are the
    next-to-last dimension of R (a leading one may hold instances)."""
    if p is None:
        return solve
    return lambda R: solve(
        torch.zeros_like(R).index_copy_(-2, p, R))[..., p, :]


def _make_serve_handle(n: int, chain, pin, pout, Mi, Mj, Mx, refine: int,
                       device, m: Optional[int] = None):
    """Build a device-resident batched solve handle `h(B) -> X`.

    chain: [(TriPlan, f64 values (array or tensor), kind), ...] — float32
    SpTRSV sweeps run in order. pin/pout: row permutations (Bp[pin[i]] =
    B[i] on the way in, X[i] = Xs[pout[i]] on the way out; None =
    identity). (Mi, Mj, Mx): COO of the f64 matrix A in ORIGINAL row order.
    Square (m None): the chain solves A, and h(B[n, nrhs]) runs it and up
    to `refine` iterative-refinement steps against A. Rectangular (A is
    m x n, `qrsol_serve`): the chain solves the Gram matrix (A'A for
    m >= n, AA' for m < n), and h(B[m, nrhs]) -> X[n, nrhs] runs up to
    `refine` corrected-seminormal-equation steps against A. Every step
    runs on `device`, in `_refine`'s one loop. On a CUDA device each
    product with A or A' is one launch of the SpMM kernel on its CSR copy
    (`_csr_amul`), the residual B - AX in its residual form; elsewhere
    `_coo_amul`.

    This is also the counterpart of the JAX package's `_chain_prep`: the
    float32 values of each sweep are made here once, and the kernel's
    per-sweep index streams, the specs of the chain and the value prepass
    (`ops.sptrsv_cuda._values`) are cached with the plans at the first
    sweep; a sweep that will take the supernodal variant gets its
    schedule, streams and value prepass here (`ops.sptrsv_cuda.prepare`).
    The factor values and index tensors stay on `device` across calls;
    `h.chain` holds the sweeps as (TriPlan, float32 values, kind)."""
    dev = torch.device(device)
    sweeps = [(plan, torch.as_tensor(vals, device=dev).to(torch.float32), kind)
              for plan, vals, kind in chain]
    for plan, v32, kind in sweeps:
        prepare(v32, plan, kind)
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    pin_d = ix(pin) if pin is not None else None
    pout_d = ix(pout) if pout is not None else None
    rows = n if m is None else m
    if dev.type == "cuda":
        amul = _csr_amul(Mi, Mj, Mx, rows, n, dev)  # A
        atmul = (None if m is None  # A' (rectangular only)
                 else _csr_amul(Mj, Mi, Mx, n, rows, dev))
        minus_ax = lambda X, S: amul(X, sub=S)
    else:
        Mi_d, Mj_d = ix(Mi), ix(Mj)
        Mx_d = torch.as_tensor(np.asarray(Mx, np.float64), device=dev)
        amul = _coo_amul(Mi_d, Mj_d, Mx_d, m)  # A
        atmul = _coo_amul(Mj_d, Mi_d, Mx_d, n)  # A' (rectangular only)
        minus_ax = lambda X, S: S - amul(X)

    def solve_full(R):
        with phase_timer("serve.sweeps"):
            Rp = (R if pin_d is None
                  else torch.zeros_like(R).index_copy_(0, pin_d, R))
            Z = Rp.to(torch.float32)
            for plan, v32, kind in sweeps:  # X^T views between the sweeps
                Z = sptrsv_multi(v32, Z, plan, kind, contiguous=False)
            Xs = Z.to(torch.float64, memory_format=torch.contiguous_format)
            return Xs if pout_d is None else Xs[pout_d]

    tall = m is None or m >= n
    correct = solve_full if tall else lambda r: atmul(solve_full(r))

    def handle(B):
        shape = np.shape(B)
        with phase_timer("serve.request", request=True,
                         attr=shape[-1] if len(shape) > 1 else 1):
            B64 = torch.as_tensor(B, device=dev).to(
                torch.float64, memory_format=torch.contiguous_format)
            # least squares: the gradient A'(B - AX); else A X = B (the
            # minimum norm's X = A'(AA')^-1 B)
            lsq = m is not None and tall

            def resid(X):
                with phase_timer("serve.residual"):
                    R = minus_ax(X, B64)
                    return atmul(R) if lsq else R

            X, rmax = _refine(correct, resid, B64, refine,
                              atmul(B64) if lsq else None)
        handle.last_residual = rmax
        return X

    handle.last_residual = None
    handle.chain = sweeps
    return handle


def _sweeps_fit(sweeps, device) -> bool:
    """Whether the sweep kernel takes every (plan, kind) of `sweeps` in
    float32 on `device` for any number of RHS columns
    (`ops.sptrsv_cuda.launch_config` at one column: a dense block that
    fits its shared memory); always True off a card, where the plain sweep
    takes any plan. The counterpart of the JAX package's
    `pallas_sweep_available`."""
    from .ops.sptrsv_cuda import launch_config

    if torch.device(device).type != "cuda":
        return True
    try:
        for plan, kind in sweeps:
            launch_config(plan, torch.float32, device, kind, 1)
    except ValueError:
        return False
    return True


def _serve_enabled(device) -> bool:
    """Whether the batched drivers take the serving path on `device`
    (`config.serve_mixed`: "auto" on a CUDA device, "force" anywhere)."""
    return (config.serve_mixed == "force"
            or (config.serve_mixed == "auto"
                and torch.device(device).type == "cuda"))


def _chol_tri_plans(s: Symb, nm: Nmrc):
    """The sweep plans (kinds 0 and 2) of nm.l, cached on the analysis per
    factor route (the factor's pattern is fixed per analysis and route)."""
    tc = s.__dict__.setdefault("_tri_cache", {})
    key = getattr(s, "_chol_route", None)
    if key not in tc:
        tc[key] = (tri_plan(nm.l, 0), tri_plan(nm.l, 2))
    return tc[key]


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
    the wall time of each build phase. A non-square A raises ValueError."""
    from .factor import lu
    from .symbolic import sqr

    require_square(a, "lusol_serve")
    dev = torch.device(device)
    n = a.n
    with phase_timer("serve.build.analysis") as t_analysis:
        s = sym if sym is not None else sqr(a, order, False)
    with phase_timer("serve.build.factor") as t_factor:
        nm = lu(a, s, tol, device=dev)
        _synchronize(dev)
    with phase_timer("serve.build.probe") as t_probe:
        lx, ux, pin, route, p0, p1 = _lu_probed(a, s, nm, tol, dev)
    with phase_timer("serve.build.handle") as t_handle:
        # out[q[i]] = xs[i]  <=>  out[j] = xs[qinv[j]]
        pout = (np.argsort(np.asarray(s.q, np.int64))
                if s.q is not None else None)
        nz = a.nnz()
        h = _make_serve_handle(n, [(p0, lx, 0), (p1, ux, 1)], pin, pout,
                               a.i[:nz], col_ids(a.p, n),
                               np.asarray(a.x[:nz], np.float64), refine, dev)
        _synchronize(dev)
    h.sym = s
    h.factor_route = route
    h.build_seconds = {"analysis": t_analysis.seconds,
                       "factor": t_factor.seconds,
                       "probe": t_probe.seconds, "handle": t_handle.seconds}
    return h


def _synchronize(dev: torch.device) -> None:
    """Wait for `dev`'s queued work (a CUDA device; nothing elsewhere)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lu_probed(a: Sprs, s: Symb, nm: Nmrc, tol: float, dev):
    """The LU serve handle's factor-quality probe. Static-pivot element
    growth can leave the MF factors too weak for the handle's refinement
    to contract (it stalls at ~growth*eps). One f64 sweep pair on a probe
    RHS measures the factor's actual solve accuracy; if it misses, the
    chain is rebuilt from the host engine's exact partial-pivoting factors
    (the same escape the lusol driver uses, moved to build time so every
    h(B) call is accurate). Returns (L's and U's values on dev, the row
    permutation, the route, L's and U's sweep plans)."""
    n, nz = a.n, a.nnz()
    lmat, umat = nm.l, nm.u
    lx, ux = device_values(nm, "l", dev), device_values(nm, "u", dev)
    route = s._lu_route
    pin = np.asarray(nm.pinv, np.int64) if nm.pinv is not None else None
    rngp = np.random.default_rng(0)
    bp = rngp.standard_normal((n, 2))
    zp = np.zeros_like(bp)
    if pin is not None:
        zp[pin] = bp
    else:
        zp[:] = bp
    p0, p1 = tri_plan(lmat, 0), tri_plan(umat, 1)
    zt = sptrsv_multi(lx, torch.as_tensor(zp, device=dev), p0, 0)
    zp = sptrsv_multi(ux, zt, p1, 1).cpu().numpy()
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
        lx, ux = (torch.as_tensor(lmat.x, device=dev),
                  torch.as_tensor(umat.x, device=dev))
        pin = np.asarray(pv, np.int64)
        route = "host_exact"
        p0, p1 = tri_plan(lmat, 0), tri_plan(umat, 1)
    return lx, ux, pin, route, p0, p1


def _chol_serve_handle(a: Sprs, s: Symb, nm: Nmrc, refine: int, dev):
    """The SPD serve handle on Cholesky factors nm of a (analysis s): the
    L then L' float32 sweeps and refinement against the symmetrized
    matrix chol factored."""
    lx = device_values(nm, "l", dev)
    # P b enters as Bp[pinv[i]] = b[i] (ipvec) and leaves as x[i] =
    # Xs[pinv[i]] (pvec): pin = pout = pinv in the handle's convention
    pinv = np.asarray(s.pinv, np.int64) if s.pinv is not None else None
    Mi, Mj, Mx = _sym_coo(a, s.pinv)
    p0, p2 = _chol_tri_plans(s, nm)
    return _make_serve_handle(a.n, [(p0, lx, 0), (p2, lx, 2)], pinv, pinv,
                              Mi, Mj, Mx, refine, dev)


def cholsol_serve(a: Sprs, order: int = 0, *, sym: Optional[Symb] = None,
                  refine: int = 8, device="cuda"):
    """Device-resident batched SPD solve handle: `h(B[n, nrhs]) -> X` with
    chol semantics (the factorization, and hence the refinement, uses the
    symmetrized upper triangle of PAP', as the reference's cholsol does,
    src/lib.rs:377-389; for symmetric A that is A).

    One symbolic analysis + one f64 factorization on `device`, then every
    `h(B)` call runs two float32 SpTRSV sweeps (L then L') and up to
    `refine` early-exit steps of f64 iterative refinement against the
    symmetrized matrix, on `device`. B may be a numpy array or a tensor; X
    is an f64 tensor on `device`. `h.last_residual` holds the final
    residual max, `h.factor_route` the factor's route (`s._chol_route`)
    and `h.build_seconds` the wall time of each build phase. No reference
    counterpart (the reference is single-RHS)."""
    from .factor import chol
    from .symbolic import schol

    dev = torch.device(device)
    with phase_timer("serve.build.analysis") as t_analysis:
        s = sym if sym is not None else schol(a, order)
    with phase_timer("serve.build.factor") as t_factor:
        nm = chol(a, s, device=dev)
        _synchronize(dev)
    with phase_timer("serve.build.handle") as t_handle:
        h = _chol_serve_handle(a, s, nm, refine, dev)
        _synchronize(dev)
    h.sym = s
    h.factor_route = s._chol_route
    h.build_seconds = {"analysis": t_analysis.seconds,
                       "factor": t_factor.seconds,
                       "handle": t_handle.seconds}
    return h


# ---------------------------------------------------------------------------
# A\b solvers (reference src/lib.rs:377-389, 672-683)
# ---------------------------------------------------------------------------


def _lu_refine_body(plan, n: int, B64: torch.Tensor, cache, Mi, Mj, Mx,
                    pin: torch.Tensor, q: Optional[torch.Tensor],
                    steps: int):
    """MF-LU solve of B64 [n, nrhs] on its device, then up to `steps`
    early-exit keep-best f64 refinement steps against the COO matrix
    (Mi, Mj, Mx) in original row order. pin: row permutation (Z[pin[i]] =
    R[i]); q: column permutation (X[q[i]] = Y[i]) or None. Returns
    (X [n, nrhs] f64, max|r|, max|X|), the last two as floats. K instances
    (`lusol_vals`): B64 [K, n, nrhs], a cache tree of K, Mx [K, nnz] and
    pin [K, n] (each instance's own pivots), the maxima [K] arrays."""
    from .factor.frontal_lu import _solve_lu_mf_dev

    ft = cache[1].dtype

    def solve_once(R):  # original row order -> original column order
        Z = (torch.zeros_like(R).index_copy_(-2, pin, R) if pin.dim() == 1
             else torch.zeros_like(R).scatter_(
                 -2, pin[..., None].expand(R.shape), R))
        Y = _solve_lu_mf_dev(plan, Z.to(ft), cache).to(torch.float64)
        return Y if q is None else torch.zeros_like(Y).index_copy_(-2, q, Y)

    amul = _coo_amul(Mi, Mj, Mx)
    X, rmax = _refine(solve_once, lambda X: B64 - amul(X), B64, steps)
    return X, rmax, _amax(X)


def _lu_mf_solve_fused(a: Sprs, s, pinv: np.ndarray, mfp, Bm: np.ndarray,
                       steps: int):
    """The MF-LU solve + up to `steps` f64 refinement steps on the device
    of the factors cached by the last `lu_mf` (`_lu_refine_body`), ending
    in one readback of X. Returns (X [n, nrhs], final residual max,
    max|X|); the caller checks the residual and takes the host engine's
    exact factors when refinement fell short."""
    tree = mfp.__dict__["_cache_tree"]
    dev = tree[1].device
    n, nz = a.n, a.nnz()
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    Mi, Mj = device_cache(mfp, "_fused_solve_pattern", dev, lambda: (
        ix(a.i[:nz]), ix(col_ids(a.p, n))))
    # values and permutations refresh per call (sym reuse changes values;
    # pivoting can change pinv); the pattern tensors stay on the plan
    Mx = torch.as_tensor(np.asarray(a.x[:nz], np.float64), device=dev)
    q = ix(s.q) if s.q is not None else None
    B64 = torch.as_tensor(np.asarray(Bm, np.float64), device=dev)
    X, rmax, xmax = _lu_refine_body(mfp, n, B64, tree, Mi, Mj, Mx, ix(pinv),
                                    q, steps)
    return X.cpu().numpy(), rmax, xmax


def _lu_one_shot(a: Sprs, s, Bm: np.ndarray, tol: float, steps: int = 10,
                 device="cuda"):
    """The whole pivoting-LU solve on `device`: the multifrontal
    factorization (threshold pivoting inside fronts, the pivot perms
    composed on the host after one readback, `lu_mf`), then the tree
    solves and up to `steps` early-exit f64 refinement steps
    (`_lu_mf_solve_fused`: the JAX package's 4 device steps and 6 host
    steps as one loop on the device).

    The reference tol rule (src/lib.rs:587-589) is enforced by `lu_mf`'s
    accept rule: a zero pivot, or a worst pivot margin below 1e-10, sets
    `s._static_rejected` and returns None, so the caller falls through to
    the host engine's exact partial pivoting. Returns (X [n, nrhs] f64,
    rmax, xmax) on acceptance, with the factor tree cached on the plan;
    None below `config.mf_min_n` or without a plan."""
    from .factor.frontal_lu import lu_mf

    if a.n < config.mf_min_n or getattr(s, "_static_rejected", False):
        return None
    mfp = _lu_mf_plan(a, s)
    if mfp is None:
        return None
    with phase_timer("factor.numeric", barrier=device_barrier(device)):
        out = lu_mf(a, s, mfp, tol, torch.device(device))
    if out is None:
        s._static_rejected = True
        return None
    s._lu_route = "device_mf"
    return _lu_mf_solve_fused(a, s, out[-1], mfp, Bm, steps)


def _lu_mf_plan(a: Sprs, s):
    """s's multifrontal LU plan, built at first use from a (its static
    pivoting prep reads a's values); None when it does not apply."""
    from .errors import NoPivotError
    from .factor.frontal_lu import build_lu_mf_plan

    mfp = getattr(s, "_mf_lu_plan", "unset")
    if isinstance(mfp, str):
        try:
            with phase_timer("factor.plan"):
                mfp = build_lu_mf_plan(a, s)
        except (NoPivotError, ValueError):
            mfp = None
        s._mf_lu_plan = mfp
    return mfp


def _host_lu(a: Sprs, s, tol: float) -> Nmrc:
    """The host engine's exact LU with partial pivoting (the reference's
    pivot sequence), its values host arrays."""
    n, nz = a.n, a.nnz()
    Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
        n, a.p, a.i[:nz], a.x[:nz], s.q, tol, s.lnz, s.unz)
    nm = Nmrc()
    nm.l = Sprs(len(Lx), n, n, Lp, Li, Lx)
    nm.u = Sprs(len(Ux), n, n, Up, Ui, Ux)
    nm.pinv = pinv
    return nm


def _refined(rmax: float, b: np.ndarray, xmax: float) -> bool:
    """Whether a one-shot's refined residual reached 1e-10 of its scale."""
    return rmax <= 1e-10 * max(float(np.abs(b).max()), xmax, 1.0)


def lusol(a: Sprs, b, order: int = 1, tol: float = 1e-6,
          *, sym: Optional[Symb] = None, device="cuda"):
    """x = A\\b via LU with partial pivoting; b overwritten with the solution
    (reference src/lib.rs:672-683). A non-square A raises ValueError.

    `sym` (extension): reuse a previous `sqr(a, order, False)` analysis
    (and its device plans) across solves with the same sparsity pattern.
    `device`: where the factorization and solves run. When the device
    one-shot's refinement falls short, the host engine factors instead
    (`s._lu_route` reads "host_exact") and the solves stay on `device`.

    >>> from rsparse_tpu_torch import Sprs, lusol
    >>> a = Sprs.new_from_vec([[2.0, 1.0], [4.0, 5.0]])
    >>> [round(float(v), 6) for v in lusol(a, [3.0, 9.0], 1, 1e-6, device="cpu")]
    [1.0, 1.0]
    """
    from .factor import lu
    from .symbolic import sqr

    require_square(a, "lusol")
    n = a.n
    with phase_timer("lusol.symbolic", nnz=a.nnz()):
        s = sym if sym is not None else sqr(a, order, False)
    bb = np.asarray(b, dtype=np.float64)
    shot = None
    if config.backend != "host":
        with phase_timer("lusol.oneshot", nnz=a.nnz()):
            shot = _lu_one_shot(a, s, bb[:, None], tol, device=device)
        if shot is not None:
            X, rmax, xmax = shot
            if _refined(rmax, bb, xmax):
                out = _writable(X[:, 0])
                _writeback(b, out)
                return out
    barrier = device_barrier(device)
    with phase_timer("lusol.factor", nnz=a.nnz(), barrier=barrier):
        if shot is not None:  # growth or conditioning the pivot margin missed
            nm = _host_lu(a, s, tol)
            s._lu_route = "host_exact"
        else:
            nm = lu(a, s, tol, device=device)
    with phase_timer("lusol.solve", nnz=s.lnz + s.unz, barrier=barrier):
        x = np.zeros(n, dtype=np.float64)
        ops.ipvec(n, nm.pinv, bb, x)  # x = P*b
        x = _tri_solve(nm.l, x, 0, device=device,
                       tx=device_values(nm, "l", device))  # x = L\x
        x = _tri_solve(nm.u, x, 1, device=device,
                       tx=device_values(nm, "u", device))  # x = U\x
        out = np.zeros(n, dtype=np.float64)
        ops.ipvec(n, s.q, x, out)  # b = Q*x
    _writeback(b, out)
    return out


def _sym_maps(a: Sprs, pinv):
    """Host maps of C = triu(PAP') (reference symperm, src/lib.rs:2369-2408)
    and of the symmetrized matrix chol factors: (perm, Mi, Mj, mxmap) with
    C.x = A.x[perm], and the COO (Mi, Mj) in ORIGINAL row order with values
    A.x[mxmap] (C mirrored below its diagonal)."""
    from .ops.plan import symperm_plan

    sp_ = symperm_plan(a, pinv)
    perm = np.asarray(sp_.perm, np.int64)
    ci = np.asarray(sp_.out_i, np.int64)
    cj = col_ids(sp_.out_p, a.n)
    offd = ci != cj
    Mi = np.concatenate([ci, cj[offd]])
    Mj = np.concatenate([cj, ci[offd]])
    mxmap = np.concatenate([perm, perm[offd]])
    if pinv is not None:
        porder = np.argsort(np.asarray(pinv, np.int64))
        Mi, Mj = porder[Mi], porder[Mj]
    return perm, Mi, Mj, mxmap


def _sym_coo(a: Sprs, pinv):
    """COO (original row order) of the SYMMETRIZED matrix chol factors —
    triu(PAP') mirrored below the diagonal (reference cholsol semantics:
    symperm keeps triu). Every chol-family refinement residual targets
    this matrix, not the full stored A (which may differ below the
    diagonal)."""
    _, Mi, Mj, mxmap = _sym_maps(a, pinv)
    return Mi, Mj, np.asarray(a.x[: a.nnz()], np.float64)[mxmap]


def _chol_oneshot_maps(a: Sprs, s, device):
    """Cached maps of the one-shot SPD solve on `device`: `perm` takes A's
    values onto the system the MF plan was built on (C = triu(PAP') with an
    ordering, A as stored for natural order: chol reads only its triu
    entries), `mxmap` gathers the symmetrized residual values from A.x, and
    the residual's (Mi, Mj) and pinv as device tensors. Pattern work done
    once per Symb; per call only two gathers remain."""

    def make():
        perm, Mi, Mj, mxmap = _sym_maps(a, s.pinv)
        if s.pinv is None:
            perm = np.arange(a.nnz(), dtype=np.int64)
        ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
        return (perm, mxmap, ix(Mi), ix(Mj),
                ix(s.pinv) if s.pinv is not None else None)

    return device_cache(s, "_oneshot_maps", device, make)


def _chol_values(a: Sprs, s, mfp, device):
    """(Cx, Mx) on `device`: the factor input and the residual values,
    cached on the plan while A's values are unchanged (repeated solves
    with sym reuse skip the gathers and uploads)."""
    fp = _values_fp(a)
    hit = mfp.__dict__.get("_oneshot_vals")
    if hit is None or hit[0] != (fp, str(device)):
        perm, mxmap = _chol_oneshot_maps(a, s, device)[:2]
        ax = np.asarray(a.x[: a.nnz()], np.float64)
        hit = ((fp, str(device)), torch.as_tensor(ax[perm], device=device),
               torch.as_tensor(ax[mxmap], device=device))
        mfp.__dict__["_oneshot_vals"] = hit
    return hit[1], hit[2]


def _chol_mf_solve_fused(a: Sprs, s, mfp, Bm: np.ndarray, steps: int):
    """Cholesky mirror of `_lu_mf_solve_fused`: ipvec, the MF tree solves
    of the factors cached by the last factorization and up to `steps`
    early-exit f64 refinement steps against the SYMMETRIZED matrix chol
    factored (`_sym_coo`), on the factor tree's device, ending in one
    readback of X. Returns (X, rmax, xmax)."""
    from .factor.frontal import _solve_mf_dev

    tree = mfp.__dict__["_cache_tree"]
    dev = tree[1].device
    _, _, Mi, Mj, p = _chol_oneshot_maps(a, s, dev)
    _, Mx = _chol_values(a, s, mfp, dev)
    ft = tree[1].dtype
    solve_once = _permuted(  # original order in and out
        lambda Z: _solve_mf_dev(mfp, Z.to(ft), tree).to(torch.float64), p)
    B64 = torch.as_tensor(np.asarray(Bm, np.float64), device=dev)
    amul = _coo_amul(Mi, Mj, Mx)
    X, rmax = _refine(solve_once, lambda X: B64 - amul(X), B64, steps)
    return X.cpu().numpy(), rmax, float(X.abs().max())


def _chol_one_shot(a: Sprs, s, Bm: np.ndarray, steps: int = 10,
                   device="cuda"):
    """The whole SPD solve on `device`: the permuted values, the
    multifrontal factorization (its smallest pivot read back once:
    NotPositiveDefiniteError when it is not positive), then the tree solves
    and up to `steps` early-exit f64 refinement steps
    (`_chol_mf_solve_fused`). Returns (X [n, nrhs] f64, rmax, xmax) with
    the factor tree cached on the plan, or None below
    `config.mf_min_n` or when no multifrontal plan applies."""
    from .factor.frontal import _chol_mf_factor

    if a.n < config.mf_min_n:
        return None
    mfp = _chol_mf_plan(a, s)
    if mfp is None:
        return None
    dev = _card(device)  # the factors' device
    with phase_timer("factor.numeric", barrier=device_barrier(dev)):
        _chol_mf_factor(_chol_values(a, s, mfp, dev)[0], mfp)
    s._chol_route = "device_mf"
    return _chol_mf_solve_fused(a, s, mfp, Bm, steps)


def _chol_mf_plan(a: Sprs, s):
    """s's multifrontal Cholesky plan, built at first use on a's pattern
    (triu(PAP'), or A as stored for natural order: chol reads its triu
    entries); None when it does not apply."""
    from .factor.frontal import build_mf_plan
    from .symbolic import _symperm_host

    mfp = getattr(s, "_mf_plan", "unset")
    if isinstance(mfp, str):
        c = _symperm_host(a, s.pinv) if s.pinv is not None else a
        with phase_timer("factor.plan"):
            mfp = s._mf_plan = build_mf_plan(c, s)
    return mfp


def _host_chol(a: Sprs, s) -> Nmrc:
    """The host engine's exact Cholesky of triu(PAP'), its values a host
    array."""
    from .symbolic import _symperm_host

    n = a.n
    c = _symperm_host(a, s.pinv) if s.pinv is not None else a
    Lp, Li, Lx = native.chol_numeric(n, c.p, c.i[: c.nnz()],
                                     c.x[: c.nnz()], s.parent, s.cp)
    nm = Nmrc()
    nm.l = Sprs(len(Lx), n, n, Lp, Li, Lx)
    return nm


def cholsol(a: Sprs, b, order: int = 0, *, sym: Optional[Symb] = None,
            device="cuda"):
    """x = A\\b for SPD A via Cholesky; b overwritten with the solution
    (reference src/lib.rs:377-389). Raises NotPositiveDefiniteError.

    `sym` (extension): pass a Symb from a previous `schol(a, order)` to
    reuse the ordering and the device plans across solves with the same
    sparsity pattern. `device`: where the factorization and solves run.
    When the device one-shot's refinement falls short, the host engine
    factors instead (`s._chol_route` reads "host_exact") and the solves
    stay on `device`.

    >>> from rsparse_tpu_torch import Sprs, cholsol
    >>> a = Sprs.new_from_vec([[4.0, 1.0], [1.0, 3.0]])
    >>> b = [6.0, 5.0]
    >>> [round(float(v), 6) for v in cholsol(a, b, 0, device="cpu")]
    [1.181818, 1.272727]
    >>> [round(v, 6) for v in b]  # b overwritten, reference semantics
    [1.181818, 1.272727]
    """
    from .factor import chol
    from .symbolic import schol

    n = a.n
    with phase_timer("cholsol.symbolic", nnz=a.nnz()):
        s = sym if sym is not None else schol(a, order)
    bb = np.asarray(b, dtype=np.float64)
    shot = None
    if config.backend != "host":
        with phase_timer("cholsol.oneshot", nnz=s.lnz):
            shot = _chol_one_shot(a, s, bb[:, None], device=device)
        if shot is not None:
            X, rmax, xmax = shot
            if _refined(rmax, bb, xmax):
                out = _writable(X[:, 0])
                _writeback(b, out)
                return out
    barrier = device_barrier(device)
    with phase_timer("cholsol.factor", nnz=s.lnz, barrier=barrier):
        if shot is not None:  # the device tree cannot recover this system
            nm = _host_chol(a, s)
            s._chol_route = "host_exact"
        else:
            nm = chol(a, s, device=device)
    with phase_timer("cholsol.solve", nnz=2 * s.lnz, barrier=barrier):
        x = np.zeros(n, dtype=np.float64)
        ops.ipvec(n, s.pinv, bb, x)  # x = P*b
        lx = device_values(nm, "l", device)
        x = _tri_solve(nm.l, x, 0, device=device, tx=lx)  # x = L\x
        x = _tri_solve(nm.l, x, 2, device=device, tx=lx)  # x = L'\x
        out = np.zeros(n, dtype=np.float64)
        ops.pvec(n, s.pinv, x, out)  # b = P'*x
    _writeback(b, out)
    return out


# ---------------------------------------------------------------------------
# QR solvers (reference src/lib.rs:927-956) and CSNE least squares
# ---------------------------------------------------------------------------


def happly_dense(v: Sprs, k: int, beta: float, x: np.ndarray) -> None:
    """x -= v * (beta * v'x) for the k-th sparse Householder vector
    (reference src/lib.rs:2099-2111), on the host."""
    lo, hi = int(v.p[k]), int(v.p[k + 1])
    rows = v.i[lo:hi]
    tau = beta * float(np.dot(v.x[lo:hi], x[rows]))
    x[rows] -= v.x[lo:hi] * tau


def _qr_host(a: Sprs, s: Symb, q):
    """The host engine's exact QR of `a` under ordering `q`, the one
    s.parent/pinv/m2 describe. Returns (V, beta, R) with V and R as Sprs."""
    nz = a.nnz()
    Vp, Vi, Vx, Rp, Ri, Rx, beta = native.qr_numeric(
        a.m, a.n, a.p, a.i[:nz], a.x[:nz], q, s.parent, s.pinv, s.m2,
        s.lnz + 8, s.unz + 8)
    return (Sprs(len(Vx), s.m2, a.n, Vp, Vi, Vx), beta,
            Sprs(len(Rx), s.m2, a.n, Rp, Ri, Rx))


def _qr_ls_host_exact(a: Sprs, s: Symb, bb: np.ndarray, q) -> np.ndarray:
    """Reference-exact least-squares solve through the host engine (qr +
    ipvec/happly/usolve, src/lib.rs:931-942), the escape when the device
    tree misses the acceptance gate. Returns x in the order `q`, which must
    be the ordering s.parent/pinv/cp/m2 describe (a multifrontal plan's
    `q_host`; s.q then holds the postorder-composed one, and mixing the two
    overruns the C++ engine's buffers)."""
    V, beta, R = _qr_host(a, s, q)
    xx = np.zeros(s.m2)
    xx[np.asarray(s.pinv[: a.m], np.int64)] = bb[: a.m]
    native.qr_ls_apply(a.n, V.p, V.i, V.x, beta, R.p, R.i, R.x, xx)
    return xx[: a.n]


def _qr_mn_host_exact(at: Sprs, s: Symb, bb: np.ndarray, q) -> np.ndarray:
    """Reference-exact minimum-norm solve through the host engine (QR of
    A', pvec/utsolve/happly reversed/pvec, src/lib.rs:943-955), the escape
    of the underdetermined branch. Returns x [n] in original row order. `q`:
    as in `_qr_ls_host_exact`."""
    V, beta, R = _qr_host(at, s, q)
    m, n = at.n, at.m  # A's dimensions
    x = np.zeros(s.m2)
    ops.pvec(m, q, bb, x)
    xv = np.ascontiguousarray(x[:m])
    native.utsolve_host(m, R.p, R.i, R.x, xv)
    x[:m] = xv
    for k in range(m - 1, -1, -1):
        happly_dense(V, k, float(beta[k]), x)
    out = np.zeros(n, dtype=np.float64)
    ops.pvec(n, s.pinv, x, out)
    return out


def _qr_mf_try(a: Sprs, s: Symb, device):
    """The multifrontal QR plan of `a`, factored on `device` with A's
    current values (refactored when the values or the device change), or
    None below `config.mf_min_n`, with `config.backend == "host"` or when
    the plan does not apply."""
    from .factor.frontal_qr import _qr_mf_factor

    plan = _qr_mf_plan(a, s)
    if plan is not None:
        dev = _card(device)
        # the cached tree holds A's values: sym reuse with refreshed values
        # refactors (value fingerprint)
        key = (_values_fp(a), str(dev))
        if plan.__dict__.get("_cache_fp") != key:
            nz = a.nnz()
            _qr_mf_factor(torch.as_tensor(np.asarray(a.x[:nz], np.float64),
                                          device=dev), plan)
            plan.__dict__["_cache_fp"] = key
    return plan


def _qr_mf_plan(a: Sprs, s: Symb):
    """s's multifrontal QR plan, built at first use on a's pattern, or None
    below `config.mf_min_n`, with `config.backend == "host"` or when the
    plan does not apply."""
    from .factor.frontal_qr import build_qr_mf_plan

    if a.n < config.mf_min_n or config.backend == "host":
        return None
    plan = getattr(s, "_mf_qr_plan", "unset")
    if isinstance(plan, str):
        plan = s._mf_qr_plan = build_qr_mf_plan(a, s)
    return plan


def _q_host(plan) -> Optional[np.ndarray]:
    """The ordering the host engine needs after a plan build: plan.q_host,
    None only when the plan committed no ordering (natural order)."""
    assert plan.q_host is not None or plan.q is None, "plan lost its q_host"
    return plan.q_host


def qrsol(a: Sprs, b, order: int = 2, *, sym: Optional[Symb] = None,
          device="cuda"):
    """x = A\\b via QR; least squares when m >= n, minimum norm (QR of A')
    when m < n; b overwritten with the solution (a list grows to n values,
    a fixed ndarray shorter than x is left as it is) (reference
    src/lib.rs:927-956).

    At or above `config.mf_min_n` both branches run the multifrontal tree
    on `device` (factor/frontal_qr.py), held to the acceptance gate:
    max|A'(b - Ax)| <= 1e-8 max(1, max|A'b|) (least squares) or
    max|b - Ax| <= 1e-8 max(1, max|b|) (minimum norm); when it fails, the
    host engine's exact Householder QR answers. Below it, `factor.qr`
    (level-scheduled on `device`) and the reference's apply. `s._qr_route`
    reads "device_mf", "host_exact", "device_level" or "host".

    `sym` (extension, as for lusol/cholsol): reuse an analysis across
    solves with one sparsity pattern: `sqr(a, order, True)` when m >= n,
    `sqr(transpose(a), order, True)` when m < n.

    >>> from rsparse_tpu_torch import Sprs, qrsol
    >>> a = Sprs.new_from_vec([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0]])
    >>> x = qrsol(a, [1.0, 4.0, 3.0], 2, device="cpu")  # least squares
    >>> [round(float(v), 6) for v in x[:2]]
    [1.0, 2.0]
    """
    from .factor import qr
    from .factor.frontal_qr import qrsol_mf_ls, qrsol_mf_mn
    from .symbolic import sqr

    n, m = a.n, a.m
    bb = np.asarray(b, dtype=np.float64)
    if m >= n:
        s = sym if sym is not None else sqr(a, order, True)
        mfq = _qr_mf_try(a, s, device)
        if mfq is not None:
            xp, gmax, gscale = qrsol_mf_ls(a, s, mfq, bb[:m])
            qcols, s._qr_route = mfq.q, "device_mf"
            if not gmax <= 1e-8 * gscale:  # NaN fails too
                qcols, s._qr_route = _q_host(mfq), "host_exact"
                xp = _qr_ls_host_exact(a, s, bb[:m], qcols)
            out = np.zeros(n, dtype=np.float64)
            ops.ipvec(n, qcols, xp, out)
            _writeback(b, out)
            return out
        nm = qr(a, s, device=device)
        x = np.zeros(s.m2, dtype=np.float64)
        ops.ipvec(m, s.pinv, bb[:m], x)  # x(0:m-1) = P*b
        for k in range(n):
            happly_dense(nm.l, k, float(nm.b[k]), x)
        x[:n] = _tri_solve(nm.u, x[:n], 1, device=device,
                           tx=device_values(nm, "u", device))  # x = R\x
        out = np.zeros(n, dtype=np.float64)
        ops.ipvec(n, s.q, x, out)  # b(0:n-1) = Q*x
    else:
        at = ops.transpose(a, device="cpu")  # underdetermined: QR of A'
        s = sym if sym is not None else sqr(at, order, True)
        mfq = _qr_mf_try(at, s, device)
        if mfq is not None:
            out, rmax = qrsol_mf_mn(at, s, mfq, bb[:m])
            s._qr_route = "device_mf"
            if not rmax <= 1e-8 * max(1.0, float(np.abs(bb[:m]).max())):
                s._qr_route = "host_exact"
                out = _qr_mn_host_exact(at, s, bb[:m], _q_host(mfq))
            _writeback(b, out)
            return out
        nm = qr(at, s, device=device)
        x = np.zeros(s.m2, dtype=np.float64)
        ops.pvec(m, s.q, bb, x)  # x = Q'*b
        x[:m] = _tri_solve(nm.u, x[:m], 3, device=device,
                           tx=device_values(nm, "u", device))  # x = R'\x
        for k in range(m - 1, -1, -1):
            happly_dense(nm.l, k, float(nm.b[k]), x)
        out = np.zeros(n, dtype=np.float64)
        ops.pvec(n, s.pinv, x, out)  # b = P'*x
    _writeback(b, out)
    return out


def _gram(a: Sprs, device) -> Sprs:
    """The Gram matrix CSNE factors: A'A when m >= n, AA' when m < n."""
    at = ops.transpose(a, device=device)
    return (ops.multiply(at, a, device=device) if a.m >= a.n
            else ops.multiply(a, at, device=device))


def _csne(a: Sprs, g: Sprs, s: Symb, B64: torch.Tensor, refine: int,
          device) -> torch.Tensor:
    """Corrected seminormal equations on `device` for B64 [m, nrhs] (a
    tensor there): the f64 Cholesky of the Gram matrix g (analysis s),
    its solves (the multifrontal tree, or the two sweeps of L on the level
    or host routes), X = G⁻¹A'B (X = A'G⁻¹B for m < n), then `refine`
    steps X += G⁻¹A'(B - AX) (X += A'G⁻¹(B - AX)). Returns X [n, nrhs]."""
    from .factor import chol
    from .factor.frontal import _solve_mf_dev

    m, n = a.m, a.n
    nm = chol(g, s, device=device)
    dev = torch.device(device)
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    if s._chol_route == "device_mf":
        mfp = s._mf_plan
        tree = mfp.__dict__["_cache_tree"]
        solve = lambda z: _solve_mf_dev(mfp, z, tree)
    else:
        lx = device_values(nm, "l", dev)
        tp0, tp2 = _chol_tri_plans(s, nm)
        solve = lambda z: sptrsv_multi(lx, sptrsv_multi(lx, z, tp0, 0), tp2, 2)
    spd_solve = _permuted(solve, ix(s.pinv) if s.pinv is not None else None)
    nz = a.nnz()
    rows, cols = ix(a.i[:nz]), ix(col_ids(a.p, n))
    ax = torch.as_tensor(np.asarray(a.x[:nz], np.float64), device=dev)
    amul = _coo_amul(rows, cols, ax, m)  # A
    atmul = _coo_amul(cols, rows, ax, n)  # A'
    if m >= n:
        correct = lambda r: spd_solve(atmul(r))
    else:  # minimum norm: X = A'(AA')⁻¹ B
        correct = lambda r: atmul(spd_solve(r))
    X = correct(B64)
    for _ in range(max(0, refine)):
        X = X + correct(B64 - amul(X))
    return X


def qrsol_ls(a: Sprs, b, order: int = 2, refine: int = 2, *,
             sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Least-squares / minimum-norm solve by corrected seminormal equations
    (CSNE, Björck): R from the Cholesky factorization of A'A (R'R = A'A),
    x = R⁻¹R⁻ᵀA'b, then `refine` f64 refinement steps
    x += (A'A)⁻¹A'(b - Ax). m < n solves the minimum-norm problem through
    AA'. The same solutions as `qrsol` for all but severely ill-conditioned
    systems (CSNE squares the condition number). `sym` reuses the A'A (or
    AA') analysis. The factorization, its solves and the refinement run on
    `device`; b is not overwritten. No reference counterpart.
    """
    from .symbolic import schol

    g = _gram(a, device)
    s = sym if sym is not None else schol(g, order)
    b64 = torch.as_tensor(np.asarray(b, np.float64), device=device)[:, None]
    return _csne(a, g, s, b64, refine, device)[:, 0].cpu().numpy()


# ---------------------------------------------------------------------------
# Batched and serving drivers: many right-hand sides on one factorization
# ---------------------------------------------------------------------------


def qrsol_serve(a: Sprs, order: int = 2, *, sym: Optional[Symb] = None,
                refine: int = 8, device="cuda"):
    """Device-resident batched least-squares / minimum-norm solve handle:
    `h(B[m, nrhs]) -> X[n, nrhs]` with `qrsol_ls` (CSNE) semantics — min
    ||AX - B|| for m >= n, the minimum-norm solution for m < n.

    One f64 Cholesky of the Gram matrix (A'A, or AA' when m < n) on
    `device`, then every `h(B)` call runs the Gram solve as two float32
    SpTRSV sweeps (L then L') and up to `refine` early-exit steps of
    corrected-seminormal-equation refinement (r = B - AX on the f64 A,
    correction G⁻¹A'r; A'G⁻¹r for m < n), on `device`. B may be a numpy
    array or a tensor; X is an f64 tensor on `device`. `sym`: a previous
    `schol` of that Gram matrix (ValueError when it analyses a system of
    another dimension). `h.last_residual` holds the final max of the
    least-squares gradient |A'(B - AX)| (of |B - AX| for m < n),
    `h.factor_route` the Gram factor's route, and `h.available` whether
    the sweep kernel takes the Gram factor's plans on `device` for any
    number of RHS columns (True off a card); when it is False, h(B) may
    raise ValueError. No reference
    counterpart (the reference's qrsol is single-RHS, src/lib.rs:927-956).
    """
    from .factor import chol
    from .symbolic import schol

    dev = torch.device(device)
    m, n = a.m, a.n
    g = _gram(a, dev)
    k = g.n
    s = sym if sym is not None else schol(g, order)
    if sym is not None and s.parent is not None and len(s.parent) != k:
        raise ValueError(
            f"sym analyzes a {len(s.parent)}-dim system but the Gram "
            f"matrix here is {k}x{k} (A'A for m>=n, AA' for m<n) — pass "
            "schol of the matching Gram")
    nm = chol(g, s, device=dev)
    lx = device_values(nm, "l", dev)
    p0, p2 = _chol_tri_plans(s, nm)
    pinv = np.asarray(s.pinv, np.int64) if s.pinv is not None else None
    nz = a.nnz()
    h = _make_serve_handle(n, [(p0, lx, 0), (p2, lx, 2)], pinv, pinv,
                           a.i[:nz], col_ids(a.p, n), a.x[:nz], refine, dev,
                           m=m)
    # without a fit the first sweep raises ValueError (launch_config)
    h.available = _sweeps_fit(((p0, 0), (p2, 2)), dev)
    h.sym = s
    h.factor_route = s._chol_route
    return h


def _serve_sweeps_mixed(a: Sprs, s: Symb, nm: Nmrc, Bm: np.ndarray, device):
    """cholsol_multi's serving branch: the SPD serve handle (float32 sweeps
    + f64 refinement on `device` against the SYMMETRIZED matrix chol
    factored), cached on s and rebuilt when A's values or the device
    change, with numpy in and out. Returns the solved [n, B] in original
    row order, or None when the path does not apply (fewer than 8 RHS,
    `config.serve_mixed`, a factor the kernel does not take) or when the
    host f64 oracle misses 1e-9·max(1, max|B|) (the caller takes the exact
    f64 sweeps)."""
    nrhs = Bm.shape[1] if Bm.ndim == 2 else 0
    if not _serve_enabled(device) or nrhs < 8:
        return None
    dev = _card(device)
    if not _sweeps_fit(zip(_chol_tri_plans(s, nm), (0, 2)), dev):
        return None
    key = (_values_fp(a), str(dev))
    handles = s.__dict__.setdefault("_serve_handles", {})
    h = handles.get("chol")
    if h is None or h._values_fp != key:
        h = _chol_serve_handle(a, s, nm, 8, dev)
        h._values_fp = key
        handles["chol"] = h
    X = h(Bm).cpu().numpy()
    # the oracle: the residual against triu(PAP') mirrored, on the host
    Mi, Mj, Mx = _sym_coo(a, s.pinv)
    R = Bm.copy()
    np.add.at(R, Mi, -Mx[:, None] * X[Mj])
    if float(np.abs(R).max()) < 1e-9 * max(1.0, float(np.abs(Bm).max())):
        return X
    return None  # conditioning beyond f32 refinement: exact path instead


def cholsol_multi(a: Sprs, B, order: int = 0, *, sym: Optional[Symb] = None,
                  device="cuda") -> np.ndarray:
    """Batched SPD solve: B is [n, nrhs]; returns X [n, nrhs] (numpy) with
    A X = B (chol semantics: the symmetrized triu(PAP')).

    `chol` on `device`, then the multifrontal tree solve when chol took
    the multifrontal route; else the serving branch (`_serve_sweeps_mixed`,
    with `config.serve_mixed`); else two f64 sweeps of L over all columns
    on `device`, their plans cached on the analysis. `s._multi_route`
    reads "device_mf", "serve", "device_level" or "host". Pass `sym` to
    reuse the analysis and plans across calls with one pattern. No
    reference counterpart (the reference is single-RHS)."""
    from .factor import chol
    from .factor.frontal import _solve_mf_dev
    from .symbolic import schol

    s = sym if sym is not None else schol(a, order)
    nm = chol(a, s, device=device)
    Bm = np.asarray(B, dtype=np.float64)
    if s._chol_route == "device_mf":
        mfp = s._mf_plan
        tree = mfp.__dict__["_cache_tree"]
        dev = tree[1].device
        solve = lambda Z: _solve_mf_dev(mfp, Z, tree)
        s._multi_route = "device_mf"
    else:
        out = _serve_sweeps_mixed(a, s, nm, Bm, device)
        if out is not None:
            s._multi_route = "serve"
            return out
        dev = torch.device(device)
        lx = device_values(nm, "l", dev)
        p0, p2 = _chol_tri_plans(s, nm)
        solve = lambda Z: sptrsv_multi(lx, sptrsv_multi(lx, Z, p0, 0), p2, 2)
        s._multi_route = s._chol_route
    p = (torch.as_tensor(np.asarray(s.pinv, np.int64), device=dev)
         if s.pinv is not None else None)
    X = _permuted(solve, p)(torch.as_tensor(Bm, device=dev))
    return X.cpu().numpy()


def _lu_sweeps(nm: Nmrc, s: Symb, Bm: np.ndarray, device) -> np.ndarray:
    """X = Q U⁻¹ L⁻¹ P B for B [n, nrhs] on nm's factors: two f64 sweeps
    over all columns on `device`. Returns numpy."""
    dev = torch.device(device)
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    B = torch.as_tensor(Bm, device=dev)
    Z = (B if nm.pinv is None
         else torch.zeros_like(B).index_copy_(0, ix(nm.pinv), B))
    Z = sptrsv_multi(device_values(nm, "l", dev), Z, tri_plan(nm.l, 0), 0)
    Z = sptrsv_multi(device_values(nm, "u", dev), Z, tri_plan(nm.u, 1), 1)
    if s.q is not None:
        Z = torch.zeros_like(Z).index_copy_(0, ix(s.q), Z)
    return Z.cpu().numpy()


def _lu_mf_refine(a: Sprs, s: Symb, tol: float, Bm: np.ndarray, shot,
                  device) -> np.ndarray:
    """lusol_multi's acceptance of the multifrontal one-shot: its X when
    the refined residual reached 1e-10·max(1, max|B|, max|X|), else the
    host engine's exact partial pivoting with the caller's tol and its f64
    sweeps on `device` (s._lu_route and s._multi_route read
    "host_exact"). The JAX package's host refinement steps are the last 6
    of the one-shot's 10 device steps (`_lu_one_shot`)."""
    X, rmax, xmax = shot
    if _refined(rmax, Bm, xmax):
        return _writable(X)
    s._lu_route = s._multi_route = "host_exact"
    return _lu_sweeps(_host_lu(a, s, tol), s, Bm, device)


def lusol_multi(a: Sprs, B, order: int = 1, tol: float = 1e-6, *,
                sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Batched LU solve: B is [n, nrhs]; returns X [n, nrhs] (numpy) with
    A X = B (lusol semantics).

    At or above `config.mf_min_n` the multifrontal one-shot on `device`
    (`_lu_one_shot`: the factorization, the tree solves of every column and
    f64 refinement), held to its residual with the host engine's exact
    factors as the escape (`_lu_mf_refine`). The JAX package's second
    branch, `lu` followed by the fused tree solve, is this one-shot in the
    port: `lu` takes the multifrontal route exactly when the one-shot
    does. Otherwise `lu` on `device` (the level LU, or the host engine
    when its static pivots are rejected) and two f64 sweeps over all
    columns. `s._multi_route` reads "device_mf", "host_exact",
    "device_level" or "host". A non-square A raises ValueError. No
    reference counterpart."""
    from .factor import lu
    from .symbolic import sqr

    require_square(a, "lusol_multi")
    s = sym if sym is not None else sqr(a, order, False)
    Bm = np.asarray(B, dtype=np.float64)
    if config.backend != "host":
        shot = _lu_one_shot(a, s, Bm, tol, device=device)
        if shot is not None:
            s._multi_route = "device_mf"
            return _lu_mf_refine(a, s, tol, Bm, shot, device)
    nm = lu(a, s, tol, device=device)
    s._multi_route = s._lu_route
    return _lu_sweeps(nm, s, Bm, device)


def qrsol_multi(a: Sprs, B, order: int = 2, refine: int = 2, *,
                sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Batched least-squares / minimum-norm solve: B is [m, nrhs]; returns
    X [n, nrhs] (numpy) minimizing ||AX - B|| columnwise (minimum norm
    when m < n), by CSNE on one Cholesky of the Gram matrix.

    With at least 8 RHS and the serving path enabled
    (`config.serve_mixed`), the batch runs through a `qrsol_serve` handle
    cached on the analysis (per `refine`, rebuilt when A's values or the
    device change) when the kernel takes its plans, and its answer is held
    to the least-squares optimality oracle max|A'(B - AX)| <
    1e-8·max(1, max|B|) on the host. Otherwise, or when the oracle fails,
    the exact branch (`_csne`): the f64 Gram solves and `refine` f64 CSNE
    steps on `device`. `s._multi_route` reads "serve", or the Gram
    factor's route. `sym` reuses the A'A (or AA') analysis. No reference
    counterpart (the reference's qrsol is single-RHS)."""
    from .symbolic import schol

    Bm = np.asarray(B, dtype=np.float64)
    s, g = sym, None
    if s is None:
        g = _gram(a, device)
        s = schol(g, order)
    if Bm.ndim == 2 and Bm.shape[1] >= 8 and _serve_enabled(device):
        dev = _card(device)
        key = (_values_fp(a), str(dev))
        handles = s.__dict__.setdefault("_serve_handles", {})
        h = handles.get(("qr", refine))
        if h is None or h._values_fp != key:
            h = qrsol_serve(a, sym=s, refine=refine, device=dev)
            h._values_fp = key
            handles[("qr", refine)] = h
        if h.available:
            X = h(Bm).cpu().numpy()
            opt = _host_spmm_t(a, Bm - _host_spmm(a, X))
            if float(np.abs(opt).max()) < 1e-8 * max(1.0, float(np.abs(Bm).max())):
                s._multi_route = "serve"
                return X
            # conditioning beyond f32 refinement: the exact branch
    if g is None:
        g = _gram(a, device)
    X = _csne(a, g, s, torch.as_tensor(Bm, device=device), refine, device)
    s._multi_route = s._chol_route
    return X.cpu().numpy()


def cholsol_ir(a: Sprs, b, order: int = 0, factor_dtype: str = "float32",
               refine: int = 2, *, device="cuda"):
    """Mixed-precision SPD solve: factor A with its values rounded to
    `factor_dtype`, then recover f64 accuracy with `refine` f64
    iterative-refinement steps against A; b overwritten with x.

    The port factors in float64 on every route, so `factor_dtype` sets
    what is rounded: A's values are rounded to it (torch's rounding) before
    `schol`/`chol`, and the two sweeps of every solve (L then L', one RHS)
    run in float32 on the f64 factor rounded to float32, for "float32"
    and for "bfloat16" alike (the sweep kernel has float32 and float64
    builds only), and in float64 for "float64". Each refinement step takes
    the f64 residual b - Ax against A's full stored values on `device`.
    The JAX package factors the rounded values too (its factor is f64 on
    the CPU) and rounds each sweep's right-hand side to `factor_dtype`.
    No reference counterpart."""
    from .factor import chol
    from .symbolic import schol

    dev = torch.device(device)
    n = a.n
    rd = getattr(torch, factor_dtype)
    sd = torch.float64 if rd == torch.float64 else torch.float32
    nz = a.nnz()
    ax = torch.as_tensor(np.asarray(a.x[:nz], np.float64))
    a_lo = a.copy()
    a_lo.x = ax.to(rd).to(torch.float64).numpy()
    s = schol(a_lo, order)
    nm = chol(a_lo, s, device=dev)
    lx = device_values(nm, "l", dev).to(sd)
    p0, p2 = tri_plan(nm.l, 0), tri_plan(nm.l, 2)
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    precond = _permuted(lambda z: sptrsv_multi(lx, sptrsv_multi(
        lx, z.to(sd), p0, 0), p2, 2).to(torch.float64),
        ix(s.pinv) if s.pinv is not None else None)
    amul = _coo_amul(ix(a.i[:nz]), ix(col_ids(a.p, n)), ax.to(dev))
    b64 = torch.as_tensor(np.asarray(b, np.float64), device=dev)[:, None]
    x = precond(b64)
    for _ in range(max(0, refine)):
        x = x + precond(b64 - amul(x))  # f64 residual
    out = x[:, 0].cpu().numpy()
    _writeback(b, out)
    return out


# ---------------------------------------------------------------------------
# Batched-values drivers: K systems of one sparsity pattern
# ---------------------------------------------------------------------------


def _vals_batch(a: Sprs, Ax, B, rows: int, what: str):
    """The validated float64 (AxK [K, nnz(a)], Bm [K, rows]) of a
    batched-values call; a B of [rows] values broadcasts to all K."""
    nz = a.nnz()
    AxK = np.asarray(Ax, dtype=np.float64)
    if AxK.ndim != 2 or AxK.shape[1] != nz:
        raise ValueError(f"Ax must be [K, nnz(a)] = [K, {nz}], got "
                         f"{AxK.shape}")
    K = AxK.shape[0]
    Bm = np.asarray(B, dtype=np.float64)
    if Bm.ndim == 1 and Bm.shape[0] == rows:
        Bm = np.tile(Bm, (K, 1))
    if Bm.shape != (K, rows):
        raise ValueError(f"B must be [K, {what}] = [{K}, {rows}] or [{what}], "
                         f"got {Bm.shape}")
    return AxK, Bm


def _instance(a: Sprs, AxK: np.ndarray, k: int) -> Sprs:
    """a's pattern with instance k's values."""
    nz = a.nnz()
    return Sprs(nz, a.m, a.n, a.p, a.i[:nz], AxK[k])


def _vals_redo(solve, a: Sprs, AxK, Bm, idx, out: np.ndarray,
               s: Symb, route: str) -> np.ndarray:
    """The per-instance tier: out[k] = solve(instance k, b_k) for k in idx
    (the port's single-system driver), the rest of out kept;
    `s._vals_route` = (route, the count re-solved). A
    NotPositiveDefiniteError names every instance that raised it (listed
    in its `instances`)."""
    from .errors import NotPositiveDefiniteError

    s._vals_route = (route, len(idx))
    bad = []
    for k in idx:
        try:
            out[k] = solve(_instance(a, AxK, k), Bm[k].copy())
        except NotPositiveDefiniteError:
            bad.append(int(k))
    if bad:
        err = NotPositiveDefiniteError(
            f"instances {bad} are not positive definite")
        err.instances = bad
        raise err
    return out


def _vals_mf(min_n: int) -> bool:
    """Whether a batched-values call may take the device multifrontal
    route (else every instance runs the single-system driver)."""
    return min_n >= config.mf_min_n and config.backend != "host"


def cholsol_vals(a: Sprs, Ax, B, order: int = 0, *,
                 sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Batched-values SPD solve: K systems A_k x_k = b_k that share `a`'s
    sparsity pattern and differ in values (chol semantics: the symmetrized
    triu(P A_k P'), reference src/lib.rs:377-389).

    Ax: [K, nnz(a)] value rows (a.x is ignored); B: [K, n], or [n] for all
    K. Returns X [K, n] (float64 numpy). At or above `config.mf_min_n` one
    multifrontal factorization and solve of all K instances on `device`
    (a leading instance dimension through the fronts, the skeleton and
    every SpTRSV sweep), then up to 4 keep-best f64 refinement steps per
    instance; an instance whose smallest pivot is not positive or whose
    residual misses 1e-10·max(1, max|b_k|, max|x_k|) is solved again by
    `cholsol`. Below it, or with `config.backend == "host"`, every
    instance runs `cholsol`. Raises NotPositiveDefiniteError naming every
    instance that is not positive definite. `s._vals_route` reads
    ("device_mf", instances re-solved) or ("per_instance", K). No
    reference counterpart (the JAX package vmaps the same program)."""
    from .factor.frontal import _chol_mf_values, _solve_mf_dev
    from .symbolic import schol

    require_square(a, "cholsol_vals")
    n = a.n
    AxK, Bm = _vals_batch(a, Ax, B, n, "n")
    K = AxK.shape[0]
    a0 = _instance(a, AxK, 0)
    s = sym if sym is not None else schol(a0, order)
    solve = lambda ak, b: cholsol(ak, b, order, sym=s, device=device)
    mfp = _chol_mf_plan(a0, s) if _vals_mf(n) else None
    if mfp is None:
        return _vals_redo(solve, a, AxK, Bm, range(K), np.empty((K, n)), s,
                          "per_instance")
    dev = _card(device)
    perm, mxmap, Mi, Mj, p = _chol_oneshot_maps(a0, s, dev)
    Cx = torch.as_tensor(AxK[:, perm], device=dev)
    _, dmins, tree = _chol_mf_values(Cx, mfp)
    B64 = torch.as_tensor(Bm[..., None], device=dev)
    amul = _coo_amul(Mi, Mj, torch.as_tensor(AxK[:, mxmap], device=dev))
    X, rmax = _refine(_permuted(lambda Z: _solve_mf_dev(mfp, Z, tree), p),
                      lambda X: B64 - amul(X), B64, 4)
    dmin = (torch.stack(dmins).amin(0) if dmins
            else Cx.new_ones(K)).cpu().numpy()
    out = _writable(X[..., 0].cpu().numpy())
    scale = np.maximum(np.abs(Bm).max(axis=1),
                       np.maximum(np.abs(out).max(axis=1), 1.0))
    redo = np.nonzero(~(dmin > 0.0) | ~(rmax <= 1e-10 * scale))[0]
    return _vals_redo(solve, a, AxK, Bm, redo, out, s, "device_mf")


def _lu_vals_compose(plan, margins, bads, perms, tol: float):
    """The host pass after a batched LU factorization (one readback of the
    accept stats, one of the pivot perms): per instance its accept flag
    (`lu_mf`'s rule: no zero pivot, margin + tol >= 1e-10), its composed
    row permutation pin [K, n] and its inner eliminations, stacked [K, ns]
    per nesting level in `_attach_inners` order. The integer compose runs
    instance by instance, as in the JAX package."""
    from .factor.frontal_lu import _compose_elim

    mg = torch.stack(margins).amin(0)
    bad = torch.stack(bads).any(0)
    stats = torch.stack([mg, bad.to(mg.dtype)], -1).cpu().numpy()  # [K, 2]
    perm_h = torch.cat(perms, -1).cpu().numpy()  # [K, total]
    n = plan.n
    ok = (stats[:, 1] == 0) & (stats[:, 0] + tol >= 1e-10)
    pinK = np.empty((len(stats), n), dtype=np.int64)
    inners = []
    for k in range(len(stats)):
        inners.append([])
        elim, _ = _compose_elim(plan, perm_h[k], 0, inners[-1])
        einv = np.empty(n, dtype=np.int64)
        einv[elim] = np.arange(n)
        pinK[k] = einv[plan.row_pinv] if plan.row_pinv is not None else einv
    return ok, pinK, [np.stack(v) for v in zip(*inners)]


def lusol_vals(a: Sprs, Ax, B, order: int = 1, tol: float = 1e-6, *,
               sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Batched-values LU solve: K square systems that share `a`'s sparsity
    pattern (lusol semantics, reference src/lib.rs:672-683).

    Ax: [K, nnz(a)] value rows (a.x is ignored); B: [K, n], or [n] for all
    K. Returns X [K, n] (float64 numpy). At or above `config.mf_min_n` the
    pivoting multifrontal LU of all K instances on `device` (one plan,
    built from instance 0's values; each instance pivots inside its own
    fronts and dense skeleton), the host compose of each instance's pivot
    perms, then the tree solves and up to 10 early-exit keep-best f64
    refinement steps per instance (`_lu_refine_body`, as `lusol`'s
    one-shot); an instance with a zero pivot, a pivot margin below the
    accept rule or a residual over 1e-10·max(1, max|b_k|, max|x_k|) is
    solved again by `lusol` with the caller's tol. Below it, or with
    `config.backend == "host"`, every instance runs `lusol`.
    `s._vals_route` reads ("device_mf", instances re-solved) or
    ("per_instance", K). No reference counterpart."""
    from .factor.frontal_lu import _attach_inners, _lu_mf_values
    from .symbolic import sqr

    require_square(a, "lusol_vals")
    n, nz = a.n, a.nnz()
    AxK, Bm = _vals_batch(a, Ax, B, n, "n")
    K = AxK.shape[0]
    a0 = _instance(a, AxK, 0)
    s = sym if sym is not None else sqr(a0, order, False)
    solve = lambda ak, b: lusol(ak, b, order, tol, sym=s, device=device)
    plan = _lu_mf_plan(a0, s) if _vals_mf(n) else None
    if plan is None:
        return _vals_redo(solve, a, AxK, Bm, range(K), np.empty((K, n)), s,
                          "per_instance")
    dev = _card(device)
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    Ax_d = torch.as_tensor(AxK[:, plan.vperm] if plan.vperm is not None
                           else AxK, device=dev)
    _, _, margins, bads, cache, perms = _lu_mf_values(Ax_d, plan, float(tol))
    ok, pinK, inners = _lu_vals_compose(plan, margins, bads, perms, tol)
    cache, _ = _attach_inners(plan, cache, [ix(v) for v in inners])
    Mi, Mj = device_cache(plan, "_fused_solve_pattern", dev, lambda: (
        ix(a.i[:nz]), ix(col_ids(a.p, n))))
    B64 = torch.as_tensor(Bm[..., None], device=dev)
    X, rmax, xmax = _lu_refine_body(
        plan, n, B64, cache, Mi, Mj, torch.as_tensor(AxK, device=dev),
        ix(pinK), ix(s.q) if s.q is not None else None, 10)
    out = _writable(X[..., 0].cpu().numpy())
    scale = np.maximum(np.abs(Bm).max(axis=1), np.maximum(xmax, 1.0))
    redo = np.nonzero(~(ok & (rmax <= 1e-10 * scale)))[0]
    return _vals_redo(solve, a, AxK, Bm, redo, out, s, "device_mf")


def qrsol_vals(a: Sprs, Ax, B, order: int = 2, *,
               sym: Optional[Symb] = None, device="cuda") -> np.ndarray:
    """Batched-values QR solve: K systems that share `a`'s sparsity
    pattern, least squares for m >= n and minimum norm (the QR of A_k')
    for m < n (qrsol semantics, reference src/lib.rs:927-956).

    Ax: [K, nnz(a)] value rows (a.x is ignored); B: [K, m], or [m] for all
    K. Returns X [K, n] (float64 numpy). `sym`: a `sqr(a, order, True)`
    analysis when m >= n, `sqr(transpose(a), order, True)` when m < n. At
    or above `config.mf_min_n` (A's n for least squares, its m for minimum
    norm) the multifrontal QR of all K instances on `device` (f64 fronts
    [K, F, rp, cp], one R sweep for all K), each instance held to
    `qrsol`'s gate on its f64 result (max|A_k'(b_k - A_k x_k)| <= 1e-8
    max(1, max|A_k'b_k|), or max|b_k - A_k x_k| <= 1e-8 max(1, max|b_k|);
    NaN fails), an instance that misses it solved again by `qrsol`. Below
    it, or with `config.backend == "host"`, every instance runs `qrsol`.
    `s._vals_route` reads ("device_mf", instances re-solved) or
    ("per_instance", K). No reference counterpart."""
    from .factor.frontal_qr import _qr_mf_values, qrsol_mf_ls, qrsol_mf_mn
    from .ops.plan import transpose_plan
    from .symbolic import sqr

    m, n = a.m, a.n
    AxK, Bm = _vals_batch(a, Ax, B, m, "m")
    K = AxK.shape[0]
    ls = m >= n
    a0 = _instance(a, AxK, 0)
    fa = a0 if ls else ops.transpose(a0, device="cpu")  # the factored matrix
    s = sym if sym is not None else sqr(fa, order, True)
    solve = lambda ak, b: qrsol(ak, b, order, sym=s, device=device)
    plan = _qr_mf_plan(fa, s)
    if plan is None:
        return _vals_redo(solve, a, AxK, Bm, range(K), np.empty((K, n)), s,
                          "per_instance")
    dev = _card(device)
    Fx = torch.as_tensor(AxK if ls else AxK[:, transpose_plan(a0).perm],
                         device=dev)
    qs, Rx = _qr_mf_values(Fx, plan)
    if ls:
        xp, gmax, gscale = qrsol_mf_ls(fa, s, plan, Bm, (qs, Fx, Rx))
        out = np.empty((K, n))
        out[:, plan.q if plan.q is not None else np.arange(n)] = xp
        good = gmax <= 1e-8 * gscale
    else:
        out, rmax = qrsol_mf_mn(fa, s, plan, Bm, (qs, Fx, Rx))
        out = _writable(out)
        good = rmax <= 1e-8 * np.maximum(1.0, np.abs(Bm).max(axis=1))
    return _vals_redo(solve, a, AxK, Bm, np.nonzero(~good)[0], out, s,
                      "device_mf")
