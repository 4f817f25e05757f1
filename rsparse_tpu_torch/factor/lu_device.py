"""Device LU, level-scheduled tier (static pivot + margin).

The PRIMARY device LU is the pivoting multifrontal path in
factor/frontal_lu.py (row matching + in-front threshold pivoting + dense
pivoted skeleton); `lu_device` routes problems at or above
`config.mf_min_n` there. This module keeps two pieces:

1. `build_lu_plan`/`_lu_step` — the level-scheduled static-pivot kernel
   (GESP-style): with a fixed pivot order the L/U patterns are static
   (native rt_lu_pattern), and each elimination level factors as one
   batched dense triangular solve + matmul:
      For column k with static offdiag-U rows B_k and offdiag-L rows L_k:
          M z = a(B_k)          M = L(B_k,B_k) unit-lower
          u_kk = a(k) - L(k,B_k)·z
          l = (a(L_k) - L(L_k,B_k) @ z) / u_kk
   Used below the multifrontal threshold and as the innermost skeleton
   fallback when recursion bottoms out too large for the dense pivoted
   block.
2. The trailing-dense tail (`LUDenseTail`); its U block comes from one
   batched SpTRSV sweep (`ops.sptrsv_cuda`, the CUDA kernel on the card).

The reference's tol rule (diagonal preferred iff |x[col]| >= tol·max|x|,
src/lib.rs:587-589) is evaluated on device as a stability margin: if a
static pivot violates it, this tier falls back to the host engine's
reference-exact partial pivoting.

Value arrays carry one spare slot (`lnz + 1`, `unz + 1`): the padding of the
per-level scatter maps points there, inside the array, and the slot is cut
off at the end. Gathers read index -1 as an absent entry (value 0).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..data import Sprs, Symb
from ..errors import NoPivotError
from ..ops.plan import device_cache
from ..symbolic import native
from ..utils.profiling import device_barrier, phase_timer


def _lookup(keys_sorted: np.ndarray, order: np.ndarray, qkeys: np.ndarray) -> np.ndarray:
    """Positions of qkeys in a sorted key table; -1 where absent. Takes the
    LAST match on duplicate keys (the reference's last-wins assignment, as
    frontal_lu._lookup)."""
    if len(keys_sorted) == 0:
        return np.full(np.shape(qkeys), -1, dtype=np.int64)
    pos = np.clip(np.searchsorted(keys_sorted, qkeys, side="right") - 1,
                  0, len(keys_sorted) - 1)
    found = keys_sorted[pos] == qkeys
    return np.where(found, order[pos], -1).astype(np.int64)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[..., idx] (the last dimension: a leading one holds instances),
    with 0 where idx < 0 (absent entry)."""
    return torch.where(idx >= 0, src[..., idx.clamp(min=0)],
                       src.new_zeros(()))


def _index_tensors(arrays, size_checks, device) -> tuple:
    """int64 tensors on `device`; each (k, size) in `size_checks` asserts
    that scatter map k stays inside a value array of that size (torch
    scatters have no drop mode, so a stray index must fail here)."""
    for k, size in size_checks:
        a = arrays[k]
        if a.size and (a.min() < 0 or a.max() >= size):
            raise ValueError(f"scatter map {k} leaves its [0, {size}) target")
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device)
                 for a in arrays)


@dataclasses.dataclass
class LUDenseTail:
    """Trailing-dense block for static-pivot LU (columns [cut, n)).

    The left-looking level phase computes COLUMNS < cut in full (their tail
    rows L_TN included), so only U_NT = L_NN^{-1} A(N,T) needs a batched
    sweep; L_TN gathers densely from the already-computed Lx, then
    S = A(T,T) − L_TN U_NT factors with an unpivoted dense LU whose margins
    feed the same tol rule as the level kernels."""

    cut: int
    d: int
    tri: object  # solve.TriPlan of L_NN (kind 0), positions into the FULL Lx
    ant_pos: np.ndarray  # [cut, D] A positions of A(N, T)
    att_pos: np.ndarray  # [D, D] A positions of A(T, T)
    ltn_src: np.ndarray  # [nltn] positions in Lx of L(T, N) entries
    ltn_r: np.ndarray  # row (t - cut)
    ltn_c: np.ndarray  # col (j < cut)
    unt_pos: np.ndarray  # [nunt] scatter into Ux (U(N, T) entries)
    unt_r: np.ndarray  # row (< cut)
    unt_c: np.ndarray  # col (t - cut)
    ltt_pos: np.ndarray
    ltt_r: np.ndarray
    ltt_c: np.ndarray
    utt_pos: np.ndarray
    utt_r: np.ndarray
    utt_c: np.ndarray


@dataclasses.dataclass
class LUPlan:
    n: int
    lnz: int
    unz: int
    Lp: np.ndarray
    Li: np.ndarray
    Up: np.ndarray
    Ui: np.ndarray
    q: Optional[np.ndarray]
    levels: List[Tuple[np.ndarray, ...]]
    plan_entries: int  # total gather-tensor volume (cost guard)
    tail: Optional[LUDenseTail] = None


# Beyond this many gather-tensor entries the dense-block plan is bigger than
# the problem deserves; the host engine is faster there anyway.
PLAN_ENTRY_CAP = 300_000_000


def build_lu_plan(a: Sprs, s: Symb, level_batch: int = 2048) -> Optional[LUPlan]:
    """Static per-level gather/scatter tensors; None if the plan would blow
    past PLAN_ENTRY_CAP (caller falls back to host)."""
    from ..ops.plan import col_ids
    from .chol_device import _choose_cut

    n = a.n
    q = np.asarray(s.q, dtype=np.int64) if s.q is not None else None
    cap = 4 * a.nnz() + n
    Lp, Li, Up, Ui, level = native.lu_pattern(n, a.p, a.i[: a.nnz()], q, cap, cap)
    lnz, unz = int(Lp[n]), int(Up[n])

    # quick cost estimate: sum over columns of r^2 + lr*r
    rcnt = np.diff(Up) - 1  # offdiag U rows per column
    lcnt = np.diff(Lp) - 1  # offdiag L rows per column
    est_col = rcnt * rcnt + lcnt * rcnt

    # position lookup tables
    lcols = col_ids(Lp, n)
    lkeys = lcols * np.int64(n) + Li
    lorder = np.arange(lnz, dtype=np.int64)
    if lnz and not np.all(np.diff(lkeys) > 0):  # diag-first breaks ordering
        lorder = np.argsort(lkeys, kind="stable")
        lkeys = lkeys[lorder]

    anz = a.nnz()
    acols_logical = col_ids(a.p, n)  # columns of A
    # column k of the factorization reads A(:, q[k]); build keys in k-space
    if q is not None:
        qinv = np.empty(n, dtype=np.int64)
        qinv[q] = np.arange(n)
        k_of_entry = qinv[acols_logical]
    else:
        k_of_entry = acols_logical
    akeys = k_of_entry * np.int64(n) + a.i[:anz]
    aorder = np.argsort(akeys, kind="stable")
    akeys_s = akeys[aorder]

    cut = _choose_cut(level, n)
    # plan-size guard: dense-ish systems blow up the level gather tensors —
    # push the cut down so the dense trailing block absorbs the heavy part
    while cut > 8 and int(np.sum(est_col[:cut])) > PLAN_ENTRY_CAP:
        cut = max(8, min(cut - 512, int(cut * 3 // 4)))
    if int(np.sum(est_col[:cut])) > PLAN_ENTRY_CAP or n - cut > 4096:
        return None  # still too big (or a >4096 dense block): host engine wins
    lev_n = level[:cut]
    nlev = int(lev_n.max()) + 1 if cut else 0
    order_by_level = np.argsort(lev_n, kind="stable")  # indices < cut only
    lev_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(lev_n, minlength=nlev), out=lev_off[1:])

    levels = []
    total = 0
    for lev in range(nlev):
        ks_all = order_by_level[lev_off[lev] : lev_off[lev + 1]]
        if len(ks_all) == 0:
            continue
        rmax = max(int(rcnt[ks_all].max()), 1)
        lmax = max(int(lcnt[ks_all].max()), 1)
        for s0 in range(0, len(ks_all), level_batch):
            ks = ks_all[s0 : s0 + level_batch]
            K = len(ks)
            B = np.full((K, rmax), -1, dtype=np.int64)  # offdiag U rows
            Lr = np.full((K, lmax), -1, dtype=np.int64)  # offdiag L rows
            for t, k in enumerate(ks):
                B[t, : rcnt[k]] = Ui[Up[k] : Up[k + 1] - 1]
                Lr[t, : lcnt[k]] = Li[Lp[k] + 1 : Lp[k + 1]]
            bvalid = B >= 0
            lvalid = Lr >= 0
            Bc = np.where(bvalid, B, 0)
            Lc = np.where(lvalid, Lr, 0)
            kcol = np.asarray(ks, dtype=np.int64)

            # M(a,b) = L(B[a], B[b]) for b < a (unit diag added on device) —
            # lookups only on valid (unpadded) entries
            colb = np.broadcast_to(Bc[:, None, :], (K, rmax, rmax))
            rowa = np.broadcast_to(Bc[:, :, None], (K, rmax, rmax))
            tril = np.tril(np.ones((rmax, rmax), bool), -1)
            pv = bvalid[:, :, None] & bvalid[:, None, :] & tril
            Midx = np.full((K, rmax, rmax), -1, dtype=np.int64)
            if pv.any():
                Midx[pv] = _lookup(lkeys, lorder,
                                   colb[pv] * np.int64(n) + rowa[pv])
            # N(a,b) = L(Lr[a], B[b])
            colb2 = np.broadcast_to(Bc[:, None, :], (K, lmax, rmax))
            rowl = np.broadcast_to(Lc[:, :, None], (K, lmax, rmax))
            pv2 = lvalid[:, :, None] & bvalid[:, None, :]
            Nidx = np.full((K, lmax, rmax), -1, dtype=np.int64)
            if pv2.any():
                Nidx[pv2] = _lookup(lkeys, lorder,
                                    colb2[pv2] * np.int64(n) + rowl[pv2])
            # L(k, B[b]) row of the current pivot
            Kidx = np.where(bvalid, _lookup(lkeys, lorder, Bc * np.int64(n) + kcol[:, None]), -1)
            # A gathers (k-space keys)
            bidx_u = np.where(bvalid, _lookup(akeys_s, aorder, kcol[:, None] * np.int64(n) + Bc), -1)
            bidx_l = np.where(lvalid, _lookup(akeys_s, aorder, kcol[:, None] * np.int64(n) + Lc), -1)
            akk = _lookup(akeys_s, aorder, kcol * np.int64(n) + kcol)
            # scatter positions; padding points at the spare slot
            upos = np.full((K, rmax), unz, dtype=np.int64)
            lpos = np.full((K, lmax), lnz, dtype=np.int64)
            for t, k in enumerate(ks):
                upos[t, : rcnt[k]] = np.arange(Up[k], Up[k + 1] - 1)
                lpos[t, : lcnt[k]] = np.arange(Lp[k] + 1, Lp[k + 1])
            dpos = Up[ks + 1] - 1  # U diag is last entry per column
            ldiag = Lp[ks]
            levels.append((Midx, Nidx, Kidx, bidx_u, bidx_l, akk,
                           upos, dpos, lpos, ldiag))
            total += Midx.size + Nidx.size
    tail = None
    if cut < n:
        tail = _build_lu_tail(n, cut, Lp, Li, Up, Ui, akeys_s, aorder, lcols)
    return LUPlan(n=n, lnz=lnz, unz=unz, Lp=Lp, Li=Li, Up=Up, Ui=Ui, q=q,
                  levels=levels, plan_entries=total, tail=tail)


def _build_lu_tail(n, cut, Lp, Li, Up, Ui, akeys_s, aorder, lcols):
    from ..solve import tri_plan

    D = n - cut
    # L_NN schedule (cols < cut, rows < cut), positions into full Lx
    mask_nn = (lcols < cut) & (Li < cut)
    sub = np.nonzero(mask_nn)[0]
    nn_p = np.zeros(cut + 1, dtype=np.int64)
    np.cumsum(np.bincount(lcols[sub], minlength=cut), out=nn_p[1:])
    lnn = Sprs(len(sub), cut, cut, nn_p, Li[sub], np.zeros(len(sub)))
    tp = tri_plan(lnn, 0)
    tri = tp.remap_positions(sub)
    i_grid = np.arange(cut, dtype=np.int64)[:, None]
    t_grid = (cut + np.arange(D, dtype=np.int64))[None, :]
    ant_pos = _lookup(akeys_s, aorder, t_grid * np.int64(n) + i_grid)
    a_grid = (cut + np.arange(D, dtype=np.int64))[:, None]
    att_pos = _lookup(akeys_s, aorder, t_grid * np.int64(n) + a_grid)
    # L(T, N): entries of columns < cut with rows >= cut (already computed
    # by the level phase — gathered densely)
    p21 = np.nonzero((lcols < cut) & (Li >= cut))[0]
    # U(N, T): entries of columns >= cut with rows < cut (scatter targets)
    ucols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
    pnt = np.nonzero((ucols >= cut) & (Ui < cut))[0]
    # tail-internal entries
    ptt_l = np.nonzero(lcols >= cut)[0]
    ptt_u = np.nonzero((ucols >= cut) & (Ui >= cut))[0]
    return LUDenseTail(
        cut=cut, d=D, tri=tri, ant_pos=ant_pos, att_pos=att_pos,
        ltn_src=p21, ltn_r=Li[p21] - cut, ltn_c=lcols[p21],
        unt_pos=pnt, unt_r=Ui[pnt], unt_c=ucols[pnt] - cut,
        ltt_pos=ptt_l, ltt_r=Li[ptt_l] - cut, ltt_c=lcols[ptt_l] - cut,
        utt_pos=ptt_u, utt_r=Ui[ptt_u] - cut, utt_c=ucols[ptt_u] - cut,
    )


def _unpivoted_lu_blocked(M: torch.Tensor, panel: int = 64):
    """Unpivoted dense LU of a single [D, D] matrix (or of K at once,
    [K, D, D]), right-looking blocked (panel rank-1 updates + one matmul
    Schur update per panel). Returns (packed LU, worst |piv|/colmax ratio
    as a 0-dim tensor, [K] for K matrices)."""
    M = M.clone()
    D = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    worst = M.new_full(M.shape[:-2], float("inf"))
    for b0 in range(0, D, panel):
        pb = min(panel, D - b0)
        e = b0 + pb
        for c in range(b0, e):
            piv = M[..., c, c]
            below = M[..., c + 1:, c]
            colmax = torch.maximum(below.abs().amax(-1) if below.shape[-1]
                                   else torch.zeros_like(piv), piv.abs())
            worst = torch.minimum(worst, piv.abs() / colmax.clamp(min=tiny))
            safe = torch.where(piv == 0, torch.ones_like(piv), piv)
            l = below / safe[..., None]
            M[..., c + 1:, c + 1:e] -= l[..., :, None] * M[..., c, None, c + 1:e]
            M[..., c + 1:, c] = l
        if e < D:
            L11 = M[..., b0:e, b0:e].tril(-1) + torch.eye(pb, dtype=M.dtype,
                                                           device=M.device)
            U12 = torch.linalg.solve_triangular(L11, M[..., b0:e, e:],
                                                upper=False, unitriangular=True)
            M[..., b0:e, e:] = U12
            M[..., e:, e:] -= M[..., e:, b0:e] @ U12
    return M, worst


def _tail_dev(tail: LUDenseTail, lsize: int, usize: int, device) -> tuple:
    return device_cache(tail, "_torch_dev", device, lambda: _index_tensors(
        (tail.ant_pos, tail.att_pos, tail.ltn_src, tail.ltn_r, tail.ltn_c,
         tail.unt_pos, tail.unt_r, tail.unt_c,
         tail.ltt_pos, tail.ltt_r, tail.ltt_c,
         tail.utt_pos, tail.utt_r, tail.utt_c),
        ((5, usize), (8, lsize), (11, usize)), device))


def _lu_tail(Lx, Ux, Ax, tol: float, tail: LUDenseTail):
    """Dense trailing block (the JAX package's `_lu_tail_kernel`): fills
    Lx/Ux in place; returns (margin, bad), [K] each for K instances (Lx
    [K, lnz+1], the U_NT sweep one launch for all K)."""
    from ..ops.sptrsv_cuda import sptrsv_multi

    (ant_pos, att_pos, ltn_src, ltn_r, ltn_c, unt_pos, unt_r, unt_c,
     ltt_pos, ltt_r, ltt_c, utt_pos, utt_r, utt_c) = _tail_dev(
        tail, Lx.numel(), Ux.numel(), Ax.device)
    rhs = _gather(Ax, ant_pos)  # A(N, T) [cut, D]
    # U_NT = L_NN^{-1} A(N, T); L_NN is unit-lower with explicit unit diag
    Unt = sptrsv_multi(Lx, rhs, tail.tri, 0)
    D = tail.d
    Ltn = Lx.new_zeros(Lx.shape[:-1] + (D, tail.cut))
    Ltn[..., ltn_r, ltn_c] = Lx[..., ltn_src]
    S = _gather(Ax, att_pos) - Ltn @ Unt
    LUt, worst = _unpivoted_lu_blocked(S)
    Ltt = LUt.tril(-1) + torch.eye(D, dtype=LUt.dtype, device=LUt.device)
    Utt = LUt.triu()
    Ux[..., unt_pos] = Unt[..., unt_r, unt_c]
    Lx[..., ltt_pos] = Ltt[..., ltt_r, ltt_c]
    Ux[..., utt_pos] = Utt[..., utt_r, utt_c]
    return worst - tol, worst == 0.0


def _lu_step(Lx, Ux, tensors, Ax, tol: float):
    """One level: dense tri solve for U, rank update for L (Lx/Ux in place).
    Returns (margin, bad) as 0-dim tensors ([K] for K instances, Lx
    [K, lnz+1])."""
    (Midx, Nidx, Kidx, bidx_u, bidx_l, akk, upos, dpos, lpos, ldiag) = tensors
    M = _gather(Lx, Midx)
    r = M.shape[-1]
    M = M + torch.eye(r, dtype=M.dtype, device=M.device)  # unit diagonal
    b_u = _gather(Ax, bidx_u)
    z = torch.linalg.solve_triangular(M, b_u[..., None], upper=False)[..., 0]
    ukk = _gather(Ax, akk) - (_gather(Lx, Kidx) * z).sum(-1)
    xl = _gather(Ax, bidx_l) - torch.einsum("...klr,...kr->...kl",
                                            _gather(Lx, Nidx), z)
    safe_ukk = torch.where(ukk == 0, torch.ones_like(ukk), ukk)
    lcol = xl / safe_ukk[..., None]
    # stability margin: reference tol rule (src/lib.rs:587-589) — the static
    # (diagonal) pivot is the one the reference would keep iff
    # |ukk| >= tol * max(|ukk|, max|xl|); margin < 0 → host fallback.
    colmax = torch.maximum(ukk.abs(), xl.abs().amax(dim=-1))
    margin = ukk.abs() - tol * colmax
    Ux[..., upos.reshape(-1)] = z.flatten(-2)
    Ux[..., dpos] = ukk
    Lx[..., lpos.reshape(-1)] = lcol.flatten(-2)
    Lx[..., ldiag] = 1.0
    return margin.amin(-1), (ukk == 0).any(-1)


def _levels_dev(plan: LUPlan, device) -> list:
    checks = ((6, plan.unz + 1), (7, plan.unz + 1), (8, plan.lnz + 1),
              (9, plan.lnz + 1))
    return device_cache(plan, "_torch_levels", device, lambda: [
        _index_tensors(lev, checks, device) for lev in plan.levels])


def _run_levels(plan: LUPlan, Ax: torch.Tensor, tol: float):
    """Level phase + dense tail of a level plan on Ax's device. Returns
    (Lx[lnz+1], Ux[unz+1], margins, bads) with 0-dim tensor stats; for K
    instances (Ax [K, nnz]) the value arrays [K, ...] and stats [K]."""
    Lx = Ax.new_zeros(Ax.shape[:-1] + (plan.lnz + 1,))
    Ux = Ax.new_zeros(Ax.shape[:-1] + (plan.unz + 1,))
    margins, bads = [], []
    for tensors in _levels_dev(plan, Ax.device):
        mg, bd = _lu_step(Lx, Ux, tensors, Ax, tol)
        margins.append(mg)
        bads.append(bd)
    if plan.tail is not None:
        mg, bd = _lu_tail(Lx, Ux, Ax, tol, plan.tail)
        margins.append(mg)
        bads.append(bd)
    return Lx, Ux, margins, bads


def _host_lu(a: Sprs, s: Symb, tol: float):
    return native.lu_numeric(
        a.n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q, tol, s.lnz, s.unz)


def lu_device(a: Sprs, s: Symb, tol: float, device):
    """Device static-pivot LU with host partial-pivot fallback.

    Returns (Lp, Li, Lx, Up, Ui, Ux, pinv) like the host engine; Lx/Ux are
    tensors on `device` when a device route succeeded, numpy arrays from the
    host engine otherwise. pinv is identity when the static factorization
    is accepted. Large systems route through the multifrontal path
    (factor/frontal_lu) first. Records the route taken in `s._lu_route`
    ("device_mf", "device_level" or "host")."""
    if a.n >= config.mf_min_n and not getattr(s, "_static_rejected", False):
        from .frontal_lu import build_lu_mf_plan, lu_mf

        mfp = getattr(s, "_mf_lu_plan", "unset")
        if mfp == "unset":
            try:
                with phase_timer("factor.plan"):
                    mfp = build_lu_mf_plan(a, s)
            except (NoPivotError, ValueError):
                mfp = None
            s._mf_lu_plan = mfp
        if mfp is not None:
            with phase_timer("factor.numeric", barrier=device_barrier(device)):
                out = lu_mf(a, s, mfp, tol, device)
            if out is not None:
                s._lu_route = "device_mf"
                return out
            # stability margin rejected static pivoting: remember so sym-
            # reuse callers don't pay the device attempt every solve
            s._static_rejected = True
            s._lu_route = "host"
            return _host_lu(a, s, tol)

    plan = getattr(s, "plan", None)
    if not isinstance(plan, LUPlan):
        try:
            plan = build_lu_plan(a, s)
        except NoPivotError:
            plan = None  # structurally singular w/o pivoting: host handles
        if plan is not None:
            s.plan = plan
    s._lu_route = "host"
    if plan is None:
        return _host_lu(a, s, tol)
    Ax = torch.as_tensor(np.ascontiguousarray(a.x[: a.nnz()]), device=device)
    Lx, Ux, margins, bads = _run_levels(plan, Ax, float(tol))
    if margins:
        mg = float(torch.stack(margins).min())
        bad = bool(torch.stack(bads).any())
    else:
        mg, bad = 0.0, False
    if bad or not (mg >= 0.0):  # NaN-safe: NaN margin also falls back
        # the reference would have pivoted differently (or pivot hit zero):
        # reproduce its exact partial-pivoting semantics on the host engine
        return _host_lu(a, s, tol)
    s._lu_route = "device_level"
    pinv = np.arange(plan.n, dtype=np.int64)
    return (plan.Lp, plan.Li, Lx[: plan.lnz],
            plan.Up, plan.Ui, Ux[: plan.unz], pinv)
