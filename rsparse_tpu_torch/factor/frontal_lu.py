"""Multifrontal LU with device partial pivoting inside fronts.

Unsymmetric multifrontal LU for the device factorization (lu_device.py).
Structure theory (all in k-space after the symmetric GESP permutation): for
a postorder-contiguous subtree S = [aa, r] of the elimination tree of
pattern(A + Aᵀ):

  - an edge (i, j) of A+Aᵀ with j ∈ S, i ∉ S forces i to be an ancestor of
    j, hence i > r and i in the ancestor-closed skeleton. Therefore
        Br := rows of A(:, S) outside S    (⊆ skeleton, all > r)
        Bc := cols of A(S, :) outside S    (⊆ skeleton, all > r)
  - with row pivoting RESTRICTED to S, all front fill stays inside the
    dense S x S triangle, the Br x S block, and the S x Bc block, so the
    factor patterns are static even though the pivot order is data-driven:

        P_f A(S,S) = L_SS U_SS        threshold-pivoted dense LU (device)
        L_B  = A(Br, S) U_SS^{-1}     (dense triangular solve)
        U_B  = L_SS^{-1} P_f A(S,Bc)
        Schur= -L_B U_B               extend-added into the skeleton

The compacted skeleton recurses (its fronts pivot too); the innermost level
is a dense pivoted LU, or lu_device's level kernels + dense tail when it is
still too large. The reference's tol rule (src/lib.rs:587-589) is enforced
exactly *within the pivot pool*: the threshold pivot search reproduces
"prefer the diagonal iff |diag| >= tol*colmax"; a boundary (Br) row that the
reference would have pivoted to instead (max|L_B| > 1/tol) degrades to the
host engine's exact global partial pivoting — detected per column via the
same margin flag.

CSC output convention: row indices of L/U are ELIMINATION positions (the
reference also renumbers L rows to pinv at the end, src/lib.rs:614-617).
Front-triangle labels are static; boundary/skeleton labels are finalized by
a host pass that composes the per-front pivot permutations returned from
the device (`_finalize_cache`). The returned `pinv` maps original rows to
elimination positions.

The device half is plain torch, run eagerly on the values' device: the
batched front LU is a loop over pivot columns of batched tensor ops, the
blocks around it are batched triangular solves and matmuls, and the
extend-add is `index_add_`. torch scatters have no drop mode, so every
scatter map is range-checked when its device tensor is made.

Instances: `_lu_mf_values` and `_solve_lu_mf_dev` also take K value
arrays of one pattern at once (Ax [K, nnz], X [K, n, B]; the batched-values
solver `lusol_vals`): the fronts of all K instances go through one pivoted
LU ([K·F, Sp, Sp]), the dense skeleton's steps carry K matrices each, the
margins, bad flags and pivot perms are per instance, and the host compose
then gives each instance its own inner eliminations ([K, ns] leaves of the
cache tree), which the solve gathers through per instance.

Solves (`_solve_lu_mf_dev`, on the factors' device) walk the same tree
with the cached factors: batched triangular solves with each bucket's
Lss/Uss and matmuls with LB/UB, the inner skeleton by recursion, by two
dense triangular solves (dense skeleton), or by two SpTRSV sweeps
(`ops.sptrsv_cuda`, the CUDA kernel on the card) of a level-LU skeleton.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..data import Sprs, Symb
from ..errors import NoPivotError
from ..ops.plan import device_cache
from ..symbolic import native
from .lu_device import _gather, _index_tensors


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _lookup(keys_sorted, order, qkeys):
    if len(keys_sorted) == 0:
        return np.full(np.shape(qkeys), -1, dtype=np.int64)
    # LAST match on duplicate keys (reference last-wins assign semantics —
    # see frontal._lookup)
    pos = np.clip(np.searchsorted(keys_sorted, qkeys, side="right") - 1,
                  0, len(keys_sorted) - 1)
    found = keys_sorted[pos] == qkeys
    return np.where(found, order[pos], -1).astype(np.int64)


@dataclasses.dataclass
class LUFrontBucket:
    sp: int
    bpr: int  # padded row-boundary size
    bpc: int  # padded col-boundary size
    ass_pos: np.ndarray  # [F, Sp, Sp] A positions (k-space), -1 absent
    abr_pos: np.ndarray  # [F, Bpr, Sp] A(Br, S)
    abc_pos: np.ndarray  # [F, Sp, Bpc] A(S, Bc)
    # scatter maps (flat; all dense now — fronts fill their whole blocks)
    lss_pos: np.ndarray
    lss_f: np.ndarray
    lss_r: np.ndarray
    lss_c: np.ndarray
    uss_pos: np.ndarray
    uss_f: np.ndarray
    uss_r: np.ndarray
    uss_c: np.ndarray
    lb_pos: np.ndarray
    lb_f: np.ndarray
    lb_r: np.ndarray
    lb_c: np.ndarray
    ub_pos: np.ndarray
    ub_f: np.ndarray
    ub_r: np.ndarray
    ub_c: np.ndarray
    schur_src: np.ndarray  # flat into Schur [F, Bpr, Bpc]
    schur_dst: np.ndarray  # into skeleton values
    srow: np.ndarray  # [F, Sp] global k-rows of S slots (n = pad)
    br_skel: np.ndarray  # [F, Bpr] compact skeleton index of Br rows (ns = pad)
    bc_skel: np.ndarray  # [F, Bpc] compact skeleton index of Bc cols (ns = pad)


@dataclasses.dataclass
class LUMFPlan:
    n: int
    lnz: int
    unz: int
    Lp: np.ndarray
    Li: np.ndarray  # labels: elim positions (static) or pre-pivot skel rows
    Up: np.ndarray
    Ui: np.ndarray
    li_skel: np.ndarray  # bool [lnz]: Li entry is a pre-pivot label (remap)
    ui_skel: np.ndarray  # bool [unz]
    buckets: List[LUFrontBucket]
    skel: np.ndarray
    skel_plan: object  # LUMFPlan (recursion) or lu_device.LUPlan
    skel_cnnz: int
    skel_a_src: np.ndarray
    skel_a_dst: np.ndarray
    skel_l_src: np.ndarray
    skel_l_dst: np.ndarray
    skel_u_src: np.ndarray
    skel_u_dst: np.ndarray
    # symmetric-permutation mode (order >= 0): the factorization runs on
    # A2 = A(P, P) with s.q := P; vperm maps a.x -> A2.x
    row_pinv: Optional[np.ndarray] = None
    vperm: Optional[np.ndarray] = None


def _sym_pattern_etree(a: Sprs, q: Optional[np.ndarray]):
    """etree + postorder of triu(pattern(A(:,q) + A(:,q)')) in k-space."""
    from ..ops.plan import col_ids

    n = a.n
    nz = a.nnz()
    rows = a.i[:nz].astype(np.int64)
    cols = col_ids(a.p, n)
    if q is not None:
        qinv = np.empty(n, dtype=np.int64)
        qinv[np.asarray(q, dtype=np.int64)] = np.arange(n)
        cols = qinv[cols]
    r2 = np.minimum(rows, cols)
    c2 = np.maximum(rows, cols)
    keys = np.unique(np.concatenate(
        [c2 * np.int64(n) + r2,
         np.arange(n, dtype=np.int64) * (n + 1)]))  # ensure diagonal
    ti = keys % n
    tc = keys // n
    tp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(tc, minlength=n), out=tp[1:])
    parent = native.etree(n, n, tp, ti, False)
    post = native.post(n, parent)
    return parent, post


MAX_DEPTH = 4
# Skeletons up to this size factor DENSELY with full partial pivoting on
# device (the skeleton rows are exactly the not-yet-eliminated pool, so the
# pivot search there is unrestricted — reference-equivalent). Larger
# skeletons recurse into another front layer first.
DENSE_SKEL_MAX = 2048


@dataclasses.dataclass
class DenseSkelPlan:
    """Dense pivoted-LU plan for the compacted skeleton system."""

    ns: int
    srows: np.ndarray  # compact CSC -> dense scatter rows
    scols: np.ndarray
    lnz: int  # = ns*ns + 1 (flattened dense factor + constant-1 slot)
    unz: int


def build_lu_mf_plan(a: Sprs, s: Symb, smax: int = 64,
                     depth: int = 0) -> Optional["LUMFPlan"]:
    """Build the pivoting multifrontal LU plan. May COMPOSE s.q with the
    symmetrized etree postorder (admissible — lusol applies s.q consistently
    afterward; committed only on success). Large skeletons recurse into
    another front layer. Returns None when not applicable."""
    from ..ops.plan import col_ids
    from .lu_device import build_lu_plan, LUPlan

    n = a.n
    row_pinv = None
    vperm = None
    if s.q is not None:
        from ..ops.plan import permute_plan
        from ..symbolic import _permute_host

        # 1) Static-pivoting row matching (MC64-flavoured, SuperLU_DIST's
        #    GESP prep): put large entries on the diagonal so the in-front
        #    threshold pivoting + tol margin rarely needs the host engine.
        #    The reference pivots dynamically instead (src/lib.rs:565-589);
        #    the margin check keeps its tol semantics authoritative.
        pm = native.match(n, a.p, a.i[: a.nnz()], a.x[: a.nnz()])
        if pm is not None and np.array_equal(pm, np.arange(n)):
            pm = None  # identity matching: skip the extra permute
        if pm is not None:
            a_m = _permute_host(a, pm, None)
            vperm_m = permute_plan(a, pm, None).perm
        else:
            a_m = a
            vperm_m = None
        # 2) GESP symmetric permutation: P = postordered AMD(A + A')
        #    applied to BOTH rows and columns — preserves the (matched)
        #    diagonal and gives a bushy elimination tree for the fronts.
        #    Admissible because lusol's driver applies pinv (rows) and s.q
        #    (columns) consistently.
        P = native.amd(0, n, n, a_m.p, a_m.i[: a_m.nnz()])
        if P is None:
            P = np.arange(n, dtype=np.int64)
        for _ in range(3):
            pinvP = np.empty(n, dtype=np.int64)
            pinvP[P] = np.arange(n)
            a2 = _permute_host(a_m, pinvP, P)
            parent, post = _sym_pattern_etree(a2, None)
            if np.array_equal(post, np.arange(n)):
                break
            P = P[post]
        else:
            return None
        # committed to s.q only when plan construction succeeds
        new_q = P
        row_pinv = pinvP[pm] if pm is not None else pinvP
        vperm2 = permute_plan(a_m, pinvP, P).perm
        vperm = vperm_m[vperm2] if vperm_m is not None else vperm2
        a_work = a2
    else:
        parent, post = _sym_pattern_etree(a, None)
        if not np.array_equal(post, np.arange(n)):
            return None  # natural order must stay untouched (parity)
        new_q = None
        a_work = a
    a = a_work

    # ---- subtree fronts over the symmetrized etree -----------------------
    sz = np.ones(n, dtype=np.int64)
    for k in range(n):
        p_ = parent[k]
        if p_ >= 0:
            sz[p_] += sz[k]
    is_root = (sz <= smax) & ((parent < 0) | (sz[np.clip(parent, 0, n - 1)] > smax))
    roots = np.nonzero(is_root)[0]
    in_front = np.zeros(n, dtype=bool)
    for r in roots:
        in_front[r - sz[r] + 1 : r + 1] = True
    skel = np.nonzero(~in_front)[0]
    ns = len(skel)
    if len(roots) == 0 or ns in (0, n):
        return None
    g = np.full(n, -1, dtype=np.int64)
    g[skel] = np.arange(ns)
    fr_of = np.full(n, -1, dtype=np.int64)
    for fi, r in enumerate(roots):
        fr_of[int(r - sz[r] + 1) : int(r) + 1] = fi

    # ---- structural boundaries (see module docstring for the theory) -----
    anz = a.nnz()
    arows = a.i[:anz].astype(np.int64)
    acols = col_ids(a.p, n)
    sk_mask = ~in_front
    # Br: rows outside S of columns in S; Bc: cols outside S of rows in S
    m_br = (fr_of[acols] >= 0) & sk_mask[arows]
    m_bc = (fr_of[arows] >= 0) & sk_mask[acols]
    fronts = []
    for fi, r in enumerate(roots):
        aa = int(r - sz[r] + 1)
        S = np.arange(aa, int(r) + 1)
        Br = np.unique(arows[m_br & (fr_of[acols] == fi)])
        Bc = np.unique(acols[m_bc & (fr_of[arows] == fi)])
        if (len(Br) and Br.min() <= r) or (len(Bc) and Bc.min() <= r):
            return None  # subtree theory violated (shouldn't happen)
        fronts.append((S, Br, Bc))

    # A keys in k-space (a is already permuted; columns are k columns)
    akeys = acols * np.int64(n) + arows
    aorder = np.argsort(akeys, kind="stable")
    akeys_s = akeys[aorder]

    # ---- skeleton pattern: A(skel, skel) + diag + Br x Bc cliques --------
    keep = sk_mask[arows] & sk_mask[acols]
    pairs = set(zip(g[arows[keep]].tolist(), g[acols[keep]].tolist()))
    for d in range(ns):
        pairs.add((d, d))
    for S, Br, Bc in fronts:
        gr = g[Br]
        gc = g[Bc]
        for x_ in gr:
            for y_ in gc:
                pairs.add((int(x_), int(y_)))
    pr = np.array(sorted(pairs, key=lambda t: (t[1], t[0])), dtype=np.int64) \
        if pairs else np.zeros((0, 2), dtype=np.int64)
    srows = pr[:, 0] if len(pr) else np.zeros(0, np.int64)
    scols = pr[:, 1] if len(pr) else np.zeros(0, np.int64)
    sCp = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(np.bincount(scols, minlength=ns), out=sCp[1:])
    s_cnnz = len(srows)
    skeys = scols * np.int64(ns) + srows
    sk_order = np.arange(s_cnnz, dtype=np.int64)

    ka = np.nonzero(keep)[0]
    skel_a_src = ka.astype(np.int64)
    skel_a_dst = _lookup(skeys, sk_order,
                         g[acols[keep]] * np.int64(ns) + g[arows[keep]])

    # ---- skeleton plan ---------------------------------------------------
    # Preference order: recurse (fronts pivot) while the skeleton is large;
    # then factor the compact remainder DENSELY with full partial pivoting
    # (skeleton rows = the whole remaining pool, so the pivot search there
    # is unrestricted); only fall back to the static-pivot level machinery
    # when the skeleton is still too big after MAX_DEPTH recursions.
    c_skel = Sprs(s_cnnz, ns, ns, sCp, srows, np.zeros(s_cnnz))
    s_sub = Symb()
    s_sub.q = None
    skel_plan = None
    if ns > DENSE_SKEL_MAX and depth < MAX_DEPTH:
        try:
            skel_plan = build_lu_mf_plan(c_skel, s_sub, smax, depth + 1)
        except (NoPivotError, ValueError):
            skel_plan = None
    if skel_plan is None:
        if ns <= DENSE_SKEL_MAX:
            skel_plan = DenseSkelPlan(ns=ns, srows=srows.copy(),
                                      scols=scols.copy(),
                                      lnz=ns * ns + 1, unz=ns * ns + 1)
        else:
            skel_plan = build_lu_plan(c_skel, s_sub)
    if skel_plan is None or not isinstance(
            skel_plan, (LUPlan, LUMFPlan, DenseSkelPlan)):
        return None
    if isinstance(skel_plan, LUMFPlan):
        in_li_skel = skel_plan.li_skel
        in_ui_skel = skel_plan.ui_skel
    elif isinstance(skel_plan, LUPlan):
        in_li_skel = np.zeros(skel_plan.lnz, dtype=bool)
        in_ui_skel = np.zeros(skel_plan.unz, dtype=bool)

    # ---- synthesized global pattern (dense front blocks) -----------------
    # L col j=aa+c: elim triangle [j..r] then Br (pre-pivot labels).
    # U col j: elim rows [aa..j] (diag last).
    # Skel col skel[q]: U first gets the full S range of every front with
    # skel[q] in Bc (elim labels), then the inner pattern mapped via skel[].
    Lcols: List[np.ndarray] = [None] * n
    Lmask: List[np.ndarray] = [None] * n
    Ucols: List[np.ndarray] = [None] * n
    Umask: List[np.ndarray] = [None] * n
    for S, Br, Bc in fronts:
        aa, r = int(S[0]), int(S[-1])
        for c in range(len(S)):
            j = aa + c
            tri = np.arange(j, r + 1)
            Lcols[j] = np.concatenate([tri, Br])
            Lmask[j] = np.concatenate(
                [np.zeros(len(tri), bool), np.ones(len(Br), bool)])
            Ucols[j] = np.arange(aa, j + 1)
            Umask[j] = np.zeros(c + 1, bool)
    # fronts contributing S-rows to each skeleton column's U
    bc_contrib: List[List[np.ndarray]] = [[] for _ in range(ns)]
    for S, Br, Bc in fronts:
        rng = np.arange(int(S[0]), int(S[-1]) + 1)
        for cq in g[Bc]:
            bc_contrib[int(cq)].append(rng)
    # Skeleton columns carry the inner plan's pattern mapped through skel[].
    # Mask semantics: inner ELIM labels are already final (inner step e
    # happens at global position skel[e] — a static map), so they must NOT
    # be remapped by the composed einv pass; inner PRE-PIVOT labels must.
    # The inner masks are therefore inherited verbatim. For the dense
    # skeleton and the innermost LUPlan every label is an elim label.
    if isinstance(skel_plan, DenseSkelPlan):
        for q in range(ns):
            c = int(skel[q])
            Lcols[c] = skel[q:]
            Lmask[c] = np.zeros(ns - q, bool)
            pre = (np.concatenate(bc_contrib[q]) if bc_contrib[q]
                   else np.zeros(0, np.int64))
            Ucols[c] = np.concatenate([pre, skel[: q + 1]])
            Umask[c] = np.zeros(len(pre) + q + 1, bool)
    else:
        sLp, sLi = skel_plan.Lp, skel_plan.Li
        sUp, sUi = skel_plan.Up, skel_plan.Ui
        for q in range(ns):
            c = int(skel[q])
            Lcols[c] = skel[sLi[sLp[q] : sLp[q + 1]]]
            Lmask[c] = in_li_skel[sLp[q] : sLp[q + 1]].copy()
            uin = sUi[sUp[q] : sUp[q + 1]]
            pre = (np.concatenate(bc_contrib[q]) if bc_contrib[q]
                   else np.zeros(0, np.int64))
            Ucols[c] = np.concatenate([pre, skel[uin]])
            Umask[c] = np.concatenate(
                [np.zeros(len(pre), bool),
                 in_ui_skel[sUp[q] : sUp[q + 1]].copy()])

    Lp = np.zeros(n + 1, dtype=np.int64)
    Up = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        Lp[j + 1] = Lp[j] + len(Lcols[j])
        Up[j + 1] = Up[j] + len(Ucols[j])
    Li = np.concatenate(Lcols) if n else np.zeros(0, np.int64)
    Ui = np.concatenate(Ucols) if n else np.zeros(0, np.int64)
    li_skel = np.concatenate(Lmask) if n else np.zeros(0, bool)
    ui_skel = np.concatenate(Umask) if n else np.zeros(0, bool)
    lnz, unz = int(Lp[n]), int(Up[n])

    # position maps inner L/U -> global (for the value copy-back)
    sl_src_p, sl_dst_p, su_src_p, su_dst_p = [], [], [], []
    if isinstance(skel_plan, DenseSkelPlan):
        # inner values live in the flattened dense factor [ns*ns]; slot
        # ns*ns holds the constant 1.0 for L's unit diagonal
        for q in range(ns):
            c = int(skel[q])
            sl_src_p.append(np.concatenate(
                [[ns * ns], np.arange(q + 1, ns, dtype=np.int64) * ns + q]))
            sl_dst_p.append(np.arange(Lp[c], Lp[c + 1], dtype=np.int64))
            su_src_p.append(np.arange(0, q + 1, dtype=np.int64) * ns + q)
            su_dst_p.append(np.arange(Up[c + 1] - (q + 1), Up[c + 1],
                                      dtype=np.int64))
    else:
        for q in range(ns):
            c = int(skel[q])
            sl_src_p.append(np.arange(sLp[q], sLp[q + 1], dtype=np.int64))
            sl_dst_p.append(np.arange(Lp[c], Lp[c] + (sLp[q + 1] - sLp[q]),
                                      dtype=np.int64))
            nU = int(sUp[q + 1] - sUp[q])
            su_src_p.append(np.arange(sUp[q], sUp[q + 1], dtype=np.int64))
            su_dst_p.append(np.arange(Up[c + 1] - nU, Up[c + 1],
                                      dtype=np.int64))
    cat = lambda ps: (np.concatenate(ps) if ps else np.zeros(0, np.int64))
    sl_src = cat(sl_src_p)
    sl_dst = cat(sl_dst_p)
    su_src = cat(su_src_p)
    su_dst = cat(su_dst_p)

    # ---- buckets ---------------------------------------------------------
    bmap = {}
    for fi, (S, Br, Bc) in enumerate(fronts):
        key = (_next_pow2(max(len(S), 1)), _next_pow2(max(len(Br), 1)),
               _next_pow2(max(len(Bc), 1)))
        bmap.setdefault(key, []).append(fi)

    buckets = []
    for (sp, bpr, bpc), fis in sorted(bmap.items()):
        F = len(fis)
        ass_pos = np.full((F, sp, sp), -1, dtype=np.int64)
        abr_pos = np.full((F, bpr, sp), -1, dtype=np.int64)
        abc_pos = np.full((F, sp, bpc), -1, dtype=np.int64)
        lss = ([], [], [], [])
        uss = ([], [], [], [])
        lb = ([], [], [], [])
        ub = ([], [], [], [])
        s_src, s_dst = [], []
        srow = np.full((F, sp), n, dtype=np.int64)
        br_skel = np.full((F, bpr), ns, dtype=np.int64)
        bc_skel = np.full((F, bpc), ns, dtype=np.int64)
        for t, fi in enumerate(fis):
            S, Br, Bc = fronts[fi]
            aa, r = int(S[0]), int(S[-1])
            ls, lbr, lbc = len(S), len(Br), len(Bc)
            srow[t, :ls] = S
            br_skel[t, :lbr] = g[Br]
            bc_skel[t, :lbc] = g[Bc]
            ass_pos[t, :ls, :ls] = _lookup(
                akeys_s, aorder, S[None, :] * np.int64(n) + S[:, None])
            if lbr:
                abr_pos[t, :lbr, :ls] = _lookup(
                    akeys_s, aorder, S[None, :] * np.int64(n) + Br[:, None])
            if lbc:
                abc_pos[t, :ls, :lbc] = _lookup(
                    akeys_s, aorder, Bc[None, :] * np.int64(n) + S[:, None])
            for c in range(ls):
                j = aa + c
                # L triangle: rows j..r at positions Lp[j]..; dense
                cnt = r + 1 - j
                lss[0].extend(range(int(Lp[j]), int(Lp[j]) + cnt))
                lss[1].extend([t] * cnt)
                lss[2].extend(range(c, ls))
                lss[3].extend([c] * cnt)
                # L boundary rows
                lb[0].extend(range(int(Lp[j]) + cnt, int(Lp[j + 1])))
                lb[1].extend([t] * lbr)
                lb[2].extend(range(lbr))
                lb[3].extend([c] * lbr)
                # U triangle: rows aa..j
                uss[0].extend(range(int(Up[j]), int(Up[j + 1])))
                uss[1].extend([t] * (c + 1))
                uss[2].extend(range(c + 1))
                uss[3].extend([c] * (c + 1))
            # U_B: skeleton columns' S rows (front-sorted prefix of Ucols)
            for cloc, cglob in enumerate(Bc):
                base = int(Up[cglob])
                # find this front's range within the column's prefix
                off = 0
                for rng in bc_contrib[int(g[cglob])]:
                    if int(rng[0]) == aa:
                        break
                    off += len(rng)
                ub[0].extend(range(base + off, base + off + ls))
                ub[1].extend([t] * ls)
                ub[2].extend(range(ls))
                ub[3].extend([cloc] * ls)
            if lbr and lbc:
                gr = g[Br]
                gc = g[Bc]
                xs = np.repeat(np.arange(lbr), lbc)
                ys = np.tile(np.arange(lbc), lbr)
                dsts = _lookup(skeys, sk_order, gc[ys] * np.int64(ns) + gr[xs])
                ok = dsts >= 0
                s_src.extend(((t * bpr + xs[ok]) * bpc + ys[ok]).tolist())
                s_dst.extend(dsts[ok].tolist())
        arr = lambda v: np.asarray(v, np.int64)
        buckets.append(LUFrontBucket(
            sp=sp, bpr=bpr, bpc=bpc,
            ass_pos=ass_pos, abr_pos=abr_pos, abc_pos=abc_pos,
            lss_pos=arr(lss[0]), lss_f=arr(lss[1]), lss_r=arr(lss[2]), lss_c=arr(lss[3]),
            uss_pos=arr(uss[0]), uss_f=arr(uss[1]), uss_r=arr(uss[2]), uss_c=arr(uss[3]),
            lb_pos=arr(lb[0]), lb_f=arr(lb[1]), lb_r=arr(lb[2]), lb_c=arr(lb[3]),
            ub_pos=arr(ub[0]), ub_f=arr(ub[1]), ub_r=arr(ub[2]), ub_c=arr(ub[3]),
            schur_src=arr(s_src), schur_dst=arr(s_dst),
            srow=srow, br_skel=br_skel, bc_skel=bc_skel,
        ))

    if row_pinv is not None:
        s.q = new_q  # commit the composed ordering only on success
    return LUMFPlan(
        n=n, lnz=lnz, unz=unz, Lp=Lp, Li=Li, Up=Up, Ui=Ui,
        li_skel=li_skel, ui_skel=ui_skel, buckets=buckets,
        skel=skel, skel_plan=skel_plan, skel_cnnz=s_cnnz,
        skel_a_src=skel_a_src, skel_a_dst=skel_a_dst,
        skel_l_src=np.asarray(sl_src, np.int64),
        skel_l_dst=np.asarray(sl_dst, np.int64),
        skel_u_src=np.asarray(su_src, np.int64),
        skel_u_dst=np.asarray(su_dst, np.int64),
        row_pinv=row_pinv, vperm=vperm,
    )


def _pivoted_lu(M: torch.Tensor, valid: torch.Tensor, tol: float):
    """Batched dense LU with threshold partial pivoting restricted to the
    block rows. M: [F, Sp, Sp] (K instances' fronts as K·F); `valid` marks
    real pivot slots (padded
    slots get identity pivots and are never swapped).

    Pivot rule per column c (the reference's shape, src/lib.rs:565-589):
    colmax = max |M[r, c]| over r >= c; keep the diagonal iff
    |M[c,c]| >= tol*colmax, else swap in the argmax row. Callers pass the
    DEVICE threshold (>= the user tol — pivoting more eagerly than the
    reference is always admissible and strictly more stable; the user tol
    governs only the boundary-row fallback margin). Returns (packed LU in
    elimination row order, perm [F, Sp] with perm[c] = pre-pivot slot
    eliminated at step c, worst ratio |piv|/colmax over real columns)."""
    F, spn, _ = M.shape
    dev = M.device
    M = M + torch.diag_embed((~valid).to(M.dtype))
    rows = torch.arange(spn, device=dev)
    perm = rows.expand(F, spn).clone()
    worst = M.new_full((F,), float("inf"))
    tiny = torch.finfo(M.dtype).tiny
    base = rows.expand(F, spn)
    for c in range(spn):
        absb = M[:, c:, c].abs()
        colmax = absb.amax(dim=1)
        amax = torch.argmax(absb, dim=1) + c  # first maximal row
        use_diag = M[:, c, c].abs() >= tol * colmax
        pivrow = torch.where(use_diag, torch.full_like(amax, c), amax)[:, None]
        # swap rows c <-> pivrow (full working rows: L part + trailing)
        swapidx = torch.where(base == c, pivrow,
                              torch.where(base == pivrow, c, base))
        M = torch.gather(M, 1, swapidx[:, :, None].expand(F, spn, spn))
        perm = torch.gather(perm, 1, swapidx)
        piv = M[:, c, c]
        ratio = piv.abs() / colmax.clamp(min=tiny)
        worst = torch.minimum(worst, torch.where(valid[:, c], ratio, worst))
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        l = M[:, c + 1:, c] / safe[:, None]
        M[:, c + 1:, c + 1:] -= l[:, :, None] * M[:, c, None, c + 1:]
        M[:, c + 1:, c] = l
    return M, perm, worst


def _pivoted_lu_single_blocked(M: torch.Tensor, theta: float, panel: int = 64):
    """Right-looking blocked LU with threshold partial pivoting for ONE
    dense [ns, ns] matrix (the compacted skeleton), or for K of them
    [K, ns, ns] at once, each pivoting on its own: per pivot step only the
    [R, panel] panel is updated, and the trailing update is one matmul per
    panel. Returns (packed LU, perm, worst ratio), the last two [K, ns] and
    [K] for K matrices (a 0-dim tensor for one)."""
    one = M.dim() == 2
    M = M[None].clone() if one else M.clone()
    K, ns = M.shape[0], M.shape[-1]
    dev = M.device
    ar = torch.arange(ns, device=dev)
    kk = torch.arange(K, device=dev)[:, None]
    perm = ar.repeat(K, 1)
    worst = M.new_full((K,), float("inf"))
    tiny = torch.finfo(M.dtype).tiny
    for b0 in range(0, ns, panel):
        e = min(b0 + panel, ns)
        for gc in range(b0, e):
            absb = M[:, gc:, gc].abs()
            colmax = absb.amax(-1)
            pivrow = torch.where(absb[:, 0] >= theta * colmax, ar[gc],
                                 torch.argmax(absb, -1) + gc)
            # swap rows gc <-> pivrow of each M (left L part, panel and
            # trailing columns) and of its perm
            idx = torch.stack([ar[gc].expand(K), pivrow], -1)  # [K, 2]
            M[kk, idx] = M[kk, idx.flip(-1)]
            perm[kk, idx] = perm[kk, idx.flip(-1)]
            piv = M[:, gc, gc]
            worst = torch.minimum(worst, piv.abs() / colmax.clamp(min=tiny))
            safe = torch.where(piv == 0, torch.ones_like(piv), piv)
            l = M[:, gc + 1:, gc] / safe[:, None]
            M[:, gc + 1:, gc + 1:e] -= l[:, :, None] * M[:, gc, None, gc + 1:e]
            M[:, gc + 1:, gc] = l
        if e < ns:
            L11 = M[:, b0:e, b0:e].tril(-1) + torch.eye(e - b0, dtype=M.dtype,
                                                         device=dev)
            U12 = torch.linalg.solve_triangular(L11, M[:, b0:e, e:],
                                                upper=False, unitriangular=True)
            M[:, b0:e, e:] = U12
            M[:, e:, e:] -= M[:, e:, b0:e] @ U12
    if one:
        return M[0], perm[0], worst[0]
    return M, perm, worst


def _dense_skel(Cs: torch.Tensor, sr: torch.Tensor, sc: torch.Tensor, ns: int):
    """Dense skeleton factorization (the JAX package's
    `_dense_skel_kernel`): scatter-assemble the compact values
    into [ns, ns] and run the blocked full-partial-pivoting LU. Threshold
    1.0 = plain partial pivoting (a dense block gains no sparsity from
    diagonal preference, so take the most stable pivot). Cs [K, cnnz]: K
    instances, each pivoting on its own."""
    Sd = Cs.new_zeros(Cs.shape[:-1] + (ns, ns))
    Sd[..., sr, sc] = Cs
    return _pivoted_lu_single_blocked(Sd, 1.0)


def _lu_front(Lx, Ux, Csx, Ax, tol: float, bdev):
    """One bucket of fronts (the JAX package's `_lu_front_kernel`):
    factor, scatter into Lx/Ux, extend-add the
    Schur complements into the skeleton values Csx (all in place). Returns
    (margin, bad, (Lss, Uss, LB, UB, perm)); for K instances (Ax [K, nnz])
    margin and bad are [K] and the blocks and perm [K, F, ...]."""
    (valid, ass_pos, abr_pos, abc_pos,
     lss_pos, lss_f, lss_r, lss_c, uss_pos, uss_f, uss_r, uss_c,
     lb_pos, lb_f, lb_r, lb_c, ub_pos, ub_f, ub_r, ub_c,
     schur_src, schur_dst) = bdev
    # device pivot threshold: at least 0.1 (standard sparse threshold
    # pivoting) — bounds in-front element growth regardless of the user tol
    Ass = _gather(Ax, ass_pos)  # [(K,) F, Sp, Sp]: one pivoted LU of K·F
    spn = Ass.shape[-1]
    K = Ass.numel() // (valid.numel() * spn)
    LUp, perm, worst = _pivoted_lu(Ass.reshape(-1, spn, spn),
                                   valid.repeat(K, 1), max(tol, 0.1))
    LUp, perm, worst = (LUp.reshape(Ass.shape), perm.reshape(Ass.shape[:-1]),
                        worst.reshape(Ass.shape[:-2]))
    Lss = LUp.tril(-1) + torch.eye(spn, dtype=LUp.dtype, device=LUp.device)
    Uss = LUp.triu()
    # L_B = A(Br,S) Uss^{-1}  -> solve X Uss = Abr (column ops: perm-free)
    LB = torch.linalg.solve_triangular(Uss, _gather(Ax, abr_pos), upper=True,
                                       left=False)
    # U_B = Lss^{-1} P_f A(S,Bc)
    Abc = _gather(Ax, abc_pos)
    Abc = torch.gather(Abc, -2, perm[..., None].expand_as(Abc))
    UB = torch.linalg.solve_triangular(Lss, Abc, upper=False,
                                       unitriangular=True)
    Schur = LB @ UB
    # boundary rows also compete for the pivot in the reference's rule:
    # |L_B| = |x_row| / |piv|, so the tol ratio there is 1 / max(1, |L_B|)
    lbmax = LB.abs().amax(dim=-2)  # [(K,) F, Sp]
    worst = torch.minimum(worst, (1.0 / lbmax.clamp(min=1.0)).amin(dim=-1))
    Lx[..., lss_pos] = Lss[..., lss_f, lss_r, lss_c]
    Ux[..., uss_pos] = Uss[..., uss_f, uss_r, uss_c]
    Lx[..., lb_pos] = LB[..., lb_f, lb_r, lb_c]
    Ux[..., ub_pos] = UB[..., ub_f, ub_r, ub_c]
    Csx.index_add_(-1, schur_dst, Schur.flatten(-3)[..., schur_src], alpha=-1)
    return (worst.amin(-1) - tol, (worst == 0.0).any(-1),
            (Lss, Uss, LB, UB, perm))


def _factor_dev(plan: LUMFPlan, device) -> dict:
    """Index tensors the factorization reads, made once per device."""

    def make():
        lsz, usz, csz = plan.lnz + 1, plan.unz + 1, plan.skel_cnnz + 1
        buckets = []
        for b in plan.buckets:
            idx = _index_tensors(
                (b.ass_pos, b.abr_pos, b.abc_pos,
                 b.lss_pos, b.lss_f, b.lss_r, b.lss_c,
                 b.uss_pos, b.uss_f, b.uss_r, b.uss_c,
                 b.lb_pos, b.lb_f, b.lb_r, b.lb_c,
                 b.ub_pos, b.ub_f, b.ub_r, b.ub_c,
                 b.schur_src, b.schur_dst),
                ((3, lsz), (7, usz), (11, lsz), (15, usz), (20, csz)), device)
            valid = torch.as_tensor(b.srow < plan.n, device=device)
            buckets.append((valid,) + idx)
        sp = plan.skel_plan
        # inner value arrays: the dense skeleton's flattened factor ends in
        # its constant-1 slot; the other inner plans carry a spare slot
        spare = 0 if isinstance(sp, DenseSkelPlan) else 1
        dev = {
            "buckets": buckets,
            "asm": _index_tensors((plan.skel_a_src, plan.skel_a_dst),
                                  ((1, csz),), device),
            "map": _index_tensors(
                (plan.skel_l_src, plan.skel_l_dst, plan.skel_u_src,
                 plan.skel_u_dst),
                ((0, sp.lnz + spare), (1, lsz), (2, sp.unz + spare),
                 (3, usz)), device),
        }
        if isinstance(sp, DenseSkelPlan):
            dev["skel"] = _index_tensors((sp.srows, sp.scols),
                                         ((0, sp.ns), (1, sp.ns)), device)
        return dev

    return device_cache(plan, "_torch_factor_dev", device, make)


def _lu_mf_values(Ax: torch.Tensor, plan: LUMFPlan, tol: float):
    """Recursive core: factor the values Ax of the plan's (permuted) system
    on Ax's device. Returns (Lx, Ux, margins, bads, cache tree, perm_parts)
    where perm_parts is the traversal-ordered list of flattened pivot perms
    — the caller concatenates them so the host finalize pass needs ONE
    readback. For K instances (Ax [K, nnz]) every value array and perm part
    gains the leading K and each margin and bad flag is [K]; the cache
    tree's inner-elimination leaves stay placeholders until
    `_attach_inners`. It writes nothing on the plan but device index
    tensors."""
    from .lu_device import LUPlan, _run_levels

    dev = _factor_dev(plan, Ax.device)
    lead = Ax.shape[:-1]
    Lx = Ax.new_zeros(lead + (plan.lnz + 1,))
    Ux = Ax.new_zeros(lead + (plan.unz + 1,))
    Csx = Ax.new_zeros(lead + (plan.skel_cnnz + 1,))
    a_src, a_dst = dev["asm"]
    Csx.index_add_(-1, a_dst, Ax[..., a_src])
    margins, bads = [], []
    front_vals = []
    perm_parts = []
    for bdev in dev["buckets"]:
        mg, bd, fv = _lu_front(Lx, Ux, Csx, Ax, tol, bdev)
        margins.append(mg)
        bads.append(bd)
        front_vals.append(fv)
        perm_parts.append(fv[-1].flatten(-2))

    sp = plan.skel_plan
    Cs = Csx[..., : plan.skel_cnnz]
    if isinstance(sp, LUMFPlan):  # recursive layer (skeleton is unpermuted)
        Lxs, Uxs, m2, b2, sub_cache, sub_perms = _lu_mf_values(Cs, sp, tol)
        margins += m2
        bads += b2
        perm_parts += sub_perms
    elif isinstance(sp, DenseSkelPlan):
        # dense skeleton: FULL partial pivoting — the pivot pool here is
        # every not-yet-eliminated row, so the search is unrestricted and
        # the tol rule is satisfiable by construction (bad only if the
        # whole remaining column is zero = numerically singular).
        LUd, permd, worst = _dense_skel(Cs, *dev["skel"], ns=sp.ns)
        bads.append(worst == 0.0)
        margins.append(Ax.new_zeros(lead))
        Lxs = torch.cat([LUd.flatten(-2), Ax.new_ones(lead + (1,))], dim=-1)
        Uxs = Lxs
        sub_cache = permd
        perm_parts.append(permd)
    else:
        assert isinstance(sp, LUPlan)
        sub_cache = None
        Lxs, Uxs, m2, b2 = _run_levels(sp, Cs, tol)
        margins += m2
        bads += b2
    l_src, l_dst, u_src, u_dst = dev["map"]
    Lx[..., l_dst] = Lxs[..., l_src]
    Ux[..., u_dst] = Uxs[..., u_src]
    # elim_inner placeholder (identity) — replaced by the host finalize pass
    cache = (tuple(front_vals), Lxs, Uxs, sub_cache,
             torch.arange(len(plan.skel), device=Ax.device))
    return Lx, Ux, margins, bads, cache, perm_parts


def _compose_elim(plan: LUMFPlan, permh: np.ndarray, ofs: int,
                  out_inners: list):
    """Pure host integer pass: compose the per-front device pivot perms
    with the recursive skeleton perm (consumed from the single `permh`
    readback in traversal order via `ofs`).

    Appends each nesting level's inner elimination map to `out_inners`
    in POST-ORDER (children before self — the order `_attach_inners`
    consumes). Returns (elim, ofs): elim[e] = pre-pivot k-row eliminated
    at step e in this plan's space."""
    n = plan.n
    elim = np.arange(n, dtype=np.int64)
    for b in plan.buckets:
        srow = b.srow
        F, spn = srow.shape
        permh_b = permh[ofs : ofs + F * spn].reshape(F, spn)
        ofs += F * spn
        for t in range(F):
            valid = srow[t] < n
            s = int(valid.sum())
            if s == 0:
                continue
            aa = int(srow[t, 0])
            elim[aa : aa + s] = aa + permh_b[t, :s]
    if isinstance(plan.skel_plan, LUMFPlan):
        inner, ofs = _compose_elim(plan.skel_plan, permh, ofs, out_inners)
    elif isinstance(plan.skel_plan, DenseSkelPlan):
        ns = plan.skel_plan.ns
        inner = permh[ofs : ofs + ns].astype(np.int64)  # dense pivot perm
        ofs += ns
    else:
        inner = np.arange(len(plan.skel), dtype=np.int64)
    elim[plan.skel] = plan.skel[inner]
    out_inners.append(inner)
    return elim, ofs


def _attach_inners(plan: LUMFPlan, cache, inners: list, idx: int = 0):
    """Rebuild the cache tree with the given inner-elimination leaves
    (post-order, matching `_compose_elim`). `inners` entries may carry a
    leading instance axis ([K, ns], a factorization of K instances) — the
    solve core gathers through them per instance either way."""
    fronts, Lxs, Uxs, sub_cache, _ = cache
    if isinstance(plan.skel_plan, LUMFPlan):
        sub_cache, idx = _attach_inners(plan.skel_plan, sub_cache, inners,
                                        idx)
    new_cache = (fronts, Lxs, Uxs, sub_cache, inners[idx])
    return new_cache, idx + 1


def _finalize_cache(plan: LUMFPlan, cache, permh: np.ndarray, device,
                    ofs: int = 0):
    """Host pass after a successful factorization: compose the per-front
    device pivot perms with the recursive skeleton perm.

    `permh` is the single host readback of the concatenated perm_parts from
    _lu_mf_values, consumed in the same traversal order via `ofs`.

    Returns (elim, new_cache, ofs): elim[e] = pre-pivot k-row eliminated at
    step e in this plan's space; new_cache carries the inner elimination map
    the solve path needs to convert the skeleton's pre-pivot rows to
    inner-elimination order."""
    inners: list = []
    elim, ofs = _compose_elim(plan, permh, ofs, inners)
    new_cache, _ = _attach_inners(
        plan, cache, [torch.as_tensor(v, device=device) for v in inners])
    return elim, new_cache, ofs


def lu_mf(a: Sprs, s: Symb, plan: LUMFPlan, tol: float, device):
    """Run the pivoting multifrontal LU on `device` (eagerly). Returns
    (Lp, Li, Lx, Up, Ui, Ux, pinv) with Lx/Ux tensors on `device`, or None
    when a pivot is zero or the boundary-row margin rejects the factors."""
    ax_host = a.x[: a.nnz()]
    if plan.vperm is not None:  # factorization runs on A(P, P)
        ax_host = ax_host[plan.vperm]
    Ax = torch.as_tensor(np.ascontiguousarray(ax_host, np.float64),
                         device=device)
    Lx, Ux, margins, bads, cache, perms = _lu_mf_values(Ax, plan, float(tol))
    mg = torch.stack(margins).min() if margins else Ax.new_zeros(())
    bad = (torch.stack(bads).any() if bads
           else Ax.new_zeros((), dtype=torch.bool))
    # one readback for both accept stats, one for the pivot perms
    stats = torch.stack([mg, bad.to(Ax.dtype)]).cpu().numpy()
    perm_h = (torch.cat(perms).cpu().numpy() if perms
              else np.zeros(0, np.int64))
    # Accept unless a pivot is exactly zero or the element growth implied by
    # a dominating boundary row (worst = 1/max|L_B|) is beyond what
    # iterative refinement can contract (growth*eps must be well below 1;
    # 1e10 leaves two orders of safety).
    worst_min = float(stats[0]) + float(tol)
    if bool(stats[1]) or not (worst_min >= 1e-10):
        plan.__dict__.pop("_cache_tree", None)
        return None
    # host finalize: compose pivot perms -> labels + pinv
    elim, cache, _ = _finalize_cache(plan, cache, perm_h, Ax.device)
    plan.__dict__["_cache_tree"] = cache
    einv = np.empty(plan.n, dtype=np.int64)
    einv[elim] = np.arange(plan.n)
    Li = plan.Li.copy()
    Li[plan.li_skel] = einv[Li[plan.li_skel]]
    Ui = plan.Ui.copy()
    Ui[plan.ui_skel] = einv[Ui[plan.ui_skel]]
    if plan.row_pinv is not None:
        pinv = einv[plan.row_pinv]
    else:
        pinv = einv.copy()
    return (plan.Lp, Li, Lx[: plan.lnz], plan.Up, Ui, Ux[: plan.unz], pinv)


# ---------------------------------------------------------------------------
# Multifrontal LU solves: dense front triangular solves + the innermost
# skeleton (dense LU, or SpTRSV sweeps of a level-LU skeleton)
# ---------------------------------------------------------------------------


def _lu_fwd_front(X, Ds, Lss, LB, srow, br_skel):
    """L forward, front phase (in place). X is in full elimination order,
    so the S window [aa..r] is already pivot-permuted: solve with Lss
    directly and accumulate LB y into the skeleton delta Ds (pre-pivot
    compact rows; garbage row ns). X, Ds: [(K,) rows, B]."""
    ys = torch.linalg.solve_triangular(Lss, X[..., srow, :], upper=False,
                                       unitriangular=True)
    X[..., srow, :] = ys  # padded slots write row n (garbage)
    Ds.index_add_(-2, br_skel.reshape(-1), (LB @ ys).flatten(-3, -2))


def _lu_bwd_front(X, Uss, UB, srow, bc_glob):
    """U backward, front phase (in place): x_S = Uss^{-1} (y_S - UB x_Bc)."""
    X[..., srow, :] = torch.linalg.solve_triangular(
        Uss, X[..., srow, :] - UB @ X[..., bc_glob, :], upper=True)


def _lu_skel_tri_plans(plan: LUMFPlan):
    """Sweep schedules for a level-LU skeleton's L (kind 0) and U (kind 1),
    cached on the plan."""
    from ..solve import tri_plan

    tp = plan.__dict__.get("_skel_tri")
    if tp is None:
        sp = plan.skel_plan
        ns = len(plan.skel)
        lsk = Sprs(sp.lnz, ns, ns, sp.Lp, sp.Li, np.zeros(sp.lnz))
        usk = Sprs(sp.unz, ns, ns, sp.Up, sp.Ui, np.zeros(sp.unz))
        tp = (tri_plan(lsk, 0), tri_plan(usk, 1))
        plan.__dict__["_skel_tri"] = tp
    return tp


def _solve_dev(plan: LUMFPlan, device) -> dict:
    """Index tensors the solve reads at this layer, made once per device
    (the JAX package's `_prep_lu_solve_indices` + `_collect_lu_sdev`)."""

    def make():
        ns, n = len(plan.skel), plan.n
        ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        return {
            "buckets": [(ix(b.srow), ix(b.br_skel), ix(np.where(
                b.bc_skel < ns, plan.skel[np.clip(b.bc_skel, 0, ns - 1)], n)))
                for b in plan.buckets],
            "skel_idx": ix(plan.skel),
        }

    return device_cache(plan, "_torch_solve_dev", device, make)


def _solve_lu_mf_dev(plan: LUMFPlan, X: torch.Tensor, cache) -> torch.Tensor:
    """Recursive device core: X [n, B] (elimination order) ->
    U^{-1} L^{-1} X; or X [K, n, B] with a cache tree of K instances (their
    inner eliminations [K, ns]), every sweep one launch for all K."""
    from ..ops.sptrsv_cuda import sptrsv_multi

    fronts, Lxs, Uxs, sub_cache, elim_inner = cache
    ns, n = len(plan.skel), plan.n
    sdev = _solve_dev(plan, X.device)
    lead, B = X.shape[:-2], X.shape[-1]
    Xd = torch.cat([X, X.new_zeros(lead + (1, B))], dim=-2)
    Ds = X.new_zeros(lead + (ns + 1, B))
    for (Lss, _, LB, _, _), (srow, br_skel, _) in zip(fronts, sdev["buckets"]):
        _lu_fwd_front(Xd, Ds, Lss, LB, srow, br_skel)
    skel_idx = sdev["skel_idx"]
    # Ds is accumulated at PRE-PIVOT compact rows; the inner solve consumes
    # inner-elimination order, so convert with the composed inner perm
    # (one per instance: [K, ns])
    Dp = Ds[..., :ns, :]
    Dp = (Dp[..., elim_inner, :] if elim_inner.dim() == 1 else torch.gather(
        Dp, -2, elim_inner[..., None].expand(Dp.shape)))
    bs = Xd[..., skel_idx, :] - Dp
    sp = plan.skel_plan
    if isinstance(sp, LUMFPlan):  # recursive layer
        ys = _solve_lu_mf_dev(sp, bs, sub_cache)
    elif isinstance(sp, DenseSkelPlan):
        LUd = Lxs[..., : ns * ns].unflatten(-1, (ns, ns))
        ys = torch.linalg.solve_triangular(LUd.tril(-1), bs, upper=False,
                                           unitriangular=True)
        ys = torch.linalg.solve_triangular(LUd.triu(), ys, upper=True)
    else:
        p0, p1 = _lu_skel_tri_plans(plan)
        ys = sptrsv_multi(Uxs, sptrsv_multi(Lxs, bs, p0, 0), p1, 1)
    Xd[..., skel_idx, :] = ys
    for (_, Uss, _, UB, _), (srow, _, bc_glob) in zip(
            reversed(fronts), reversed(sdev["buckets"])):
        _lu_bwd_front(Xd, Uss, UB, srow, bc_glob)
    return Xd[..., :n, :]
