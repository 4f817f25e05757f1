"""Device Cholesky, level-scheduled tier: batched dense triangular solves.

The reference's up-looking Cholesky (src/lib.rs:278-337) computes row k of L
by a sparse triangular solve against finished columns. For row k with the
(host-precomputed, static) row pattern R_k the recurrence is the dense
system

      L(R_k, R_k) · z = C(R_k, k),     L(k, R_k) = z',
      d = C(k,k) - z'z,                L(k,k) = sqrt(d),

and every j in R_k is a proper etree descendant of k, so all rows of one
etree level are independent: a level is one batched
`torch.linalg.solve_triangular` with static gather/scatter maps built once
per pattern. Deep, narrow level structures end in a trailing dense block
(`DenseTail`): one dense Cholesky instead of one step per level.

Instances: the device half also factors K value arrays of one pattern at
once (Cx [K, cnnz], the batched-values solvers): every gather and scatter
works on the last dimension, the dense solves and Cholesky factorizations
batch over the leading one, and each pivot minimum is taken per instance.

Failure semantics: each level and the tail report their smallest pivot
d (0 where `cholesky_ex` reports failure) as a device scalar ([K] for K
instances); the caller
reduces them and reads the minimum back once, at the end, and raises
NotPositiveDefiniteError when it is not positive (the reference errors at
the first such k; the observable — the exception — is the same). A failed
pivot's NaN propagates into later levels, and the NaN-safe test `not d > 0`
catches it.

The device half is plain torch on the values' device. torch scatters have
no drop mode: padded slots of a level's maps point at a spare slot at the
end of the value array (`lnz`), and every scatter map is range-checked when
its device tensor is made (`lu_device._index_tensors`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data import Sprs, Symb
from ..errors import NotPositiveDefiniteError
from ..ops.plan import col_ids, device_cache
from ..symbolic import native
from .lu_device import _gather, _index_tensors, _lookup


def _choose_cut(level: np.ndarray, n: int, target_levels: int = 48,
                dense_tail_max: int = 2048) -> int:
    """Largest cut with max(level[:cut]) < target_levels, tail capped.

    Columns past the cut factor as one dense trailing block: a deep level
    structure costs one dependent step per level, while a dense block of up
    to `dense_tail_max` columns is a handful of large dense operations."""
    nlev = int(level.max()) + 1 if n else 0
    if nlev <= 2 * target_levels:
        return n
    if n <= dense_tail_max:
        # deep level structure, small system: all-dense tail
        return 0
    pmax = np.maximum.accumulate(level)
    ok = np.nonzero(pmax < target_levels)[0]
    cut = int(ok[-1]) + 1 if len(ok) else 0
    cut = max(cut, n - dense_tail_max)
    return cut if n - cut >= 32 else n  # tiny tails aren't worth a launch


# Largest leading block L_NN of a dense tail that is materialized densely
# (one triangular inverse, then matmuls) instead of swept level by level.
DENSE_NN_MAX = 2048


@dataclasses.dataclass
class DenseTail:
    """Trailing-dense supernode (columns [cut, n)).

    etree parents always exceed their children, so every contiguous index
    tail is ancestor-closed: columns >= cut have all their L rows >= cut,
    and columns < cut form a self-contained leading factor L_NN. The tail
    then computes as dense work:

        W  = L_NN^{-1} C(N, T)        (dense inverse, or one SpTRSV sweep)
        S  = sym(C(T, T)) - Wᵀ W      (matmul)
        L_TT = cholesky(S)
        L(T, N) = Wᵀ, scattered into the static sparse pattern.
    """

    cut: int
    d: int
    # L_NN sweep schedule (kind 0, positions into the FULL Lx); None when
    # L_NN is densified (cut <= DENSE_NN_MAX)
    tri: object
    # C(N, T) and triu C(T, T): the LAST entry of each (row, col) only
    # (the reference's last-wins assignment on duplicate entries)
    rhs_src: np.ndarray  # C value positions of C(N, T) entries
    rhs_r: np.ndarray  # row (< cut)
    rhs_c: np.ndarray  # col - cut
    att_src: np.ndarray  # C value positions of triu C(T, T)
    att_r: np.ndarray  # row - cut
    att_c: np.ndarray  # col - cut
    l21_pos: np.ndarray  # scatter into Lx
    l21_j: np.ndarray  # W row (column index j < cut)
    l21_t: np.ndarray  # W col (t - cut)
    ltt_pos: np.ndarray  # scatter into Lx
    ltt_r: np.ndarray
    ltt_c: np.ndarray
    # dense L_NN gather (cut <= DENSE_NN_MAX; empty otherwise)
    nn_pos: np.ndarray
    nn_r: np.ndarray
    nn_c: np.ndarray


@dataclasses.dataclass
class CholPlan:
    n: int
    lnz: int
    Lp: np.ndarray
    Li: np.ndarray
    # per level batch: (Midx, bidx, akk, zpos, dpos)
    levels: List[Tuple[np.ndarray, ...]]
    tail: Optional[DenseTail] = None


def _last_per_key(keys: np.ndarray) -> np.ndarray:
    """Indices of the last occurrence of each distinct key, in key order."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    return order[np.r_[ks[1:] != ks[:-1], True]] if len(ks) else order


def _ragged(ptr: np.ndarray, idx: np.ndarray, ks: np.ndarray, width: int):
    """[len(ks), width] table of the segments idx[ptr[k]:ptr[k+1]], padded
    with -1."""
    cnt = ptr[ks + 1] - ptr[ks]
    out = np.full((len(ks), width), -1, dtype=np.int64)
    t = np.repeat(np.arange(len(ks)), cnt)
    j = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out[t, j] = idx[np.repeat(ptr[ks], cnt) + j]
    return out


def build_chol_plan(c: Sprs, s: Symb, level_batch: int = 4096) -> CholPlan:
    """Static per-level gather/scatter maps (host, once per pattern). Each
    batch is one level's rows (up to `level_batch`), its row patterns
    padded to the level's longest."""
    n = c.n
    Lp, Li, Rp, Rj, level = native.chol_pattern(n, c.p, c.i[: c.nnz()],
                                                 s.parent, s.cp)
    lnz = int(Lp[n])
    cut = _choose_cut(level, n)

    lcols = col_ids(Lp, n)
    lkeys = lcols * np.int64(n) + Li  # L columns have ascending rows
    lorder = np.arange(lnz, dtype=np.int64)
    if lnz and not np.all(np.diff(lkeys) > 0):
        lorder = np.argsort(lkeys, kind="stable")
        lkeys = lkeys[lorder]
    cnz = c.nnz()
    ckeys = col_ids(c.p, n) * np.int64(n) + c.i[:cnz]
    corder = np.argsort(ckeys, kind="stable")
    ckeys_s = ckeys[corder]

    rcnt = np.diff(Rp)
    lev_n = level[:cut]
    nlev = int(lev_n.max()) + 1 if cut else 0
    by_level = np.argsort(lev_n, kind="stable")
    lev_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(lev_n, minlength=nlev), out=lev_off[1:])
    levels = []
    for lev in range(nlev):
        ks_all = by_level[lev_off[lev]: lev_off[lev + 1]]
        if len(ks_all) == 0:
            continue
        r = max(int(rcnt[ks_all].max()), 1)
        for s0 in range(0, len(ks_all), level_batch):
            ks = ks_all[s0: s0 + level_batch]
            K = len(ks)
            R = _ragged(Rp, Rj, ks, r)
            valid = R >= 0
            Rc = np.where(valid, R, 0)
            # M(a, b) = L(R[a], R[b]) for b <= a: column R[b], row R[a]
            pv = valid[:, :, None] & valid[:, None, :] & np.tril(
                np.ones((r, r), bool))
            Midx = np.full((K, r, r), -1, dtype=np.int64)
            if pv.any():
                colb = np.broadcast_to(Rc[:, None, :], (K, r, r))
                rowa = np.broadcast_to(Rc[:, :, None], (K, r, r))
                Midx[pv] = _lookup(lkeys, lorder,
                                   colb[pv] * np.int64(n) + rowa[pv])
            kk = np.broadcast_to(ks[:, None], (K, r))
            # rhs C(R[a], k): column k, row R[a]
            bidx = np.full((K, r), -1, dtype=np.int64)
            bidx[valid] = _lookup(ckeys_s, corder,
                                  kk[valid] * np.int64(n) + Rc[valid])
            akk = _lookup(ckeys_s, corder, ks * np.int64(n) + ks)
            # L(k, R[a]) sits in column R[a] at row k; padding -> spare slot
            zpos = np.full((K, r), lnz, dtype=np.int64)
            zpos[valid] = _lookup(lkeys, lorder,
                                  Rc[valid] * np.int64(n) + kk[valid])
            dpos = Lp[ks].astype(np.int64)  # diagonal first per column
            levels.append((Midx, bidx, akk, zpos, dpos))
    tail = None
    if cut < n:
        tail = _build_tail(c, Lp, Li, lcols, n, cut)
    return CholPlan(n=n, lnz=lnz, Lp=Lp, Li=Li, levels=levels, tail=tail)


def _build_tail(c: Sprs, Lp, Li, lcols, n, cut) -> DenseTail:
    from ..solve import tri_plan

    D = n - cut
    sub = np.nonzero((lcols < cut) & (Li < cut))[0]  # L_NN, into full Lx
    dense_nn = cut <= DENSE_NN_MAX
    z = np.zeros(0, np.int64)
    tri = None
    if not dense_nn:
        nn_p = np.zeros(cut + 1, dtype=np.int64)
        np.cumsum(np.bincount(lcols[sub], minlength=cut), out=nn_p[1:])
        lnn = Sprs(len(sub), cut, cut, nn_p, Li[sub], np.zeros(len(sub)))
        tri = tri_plan(lnn, 0).remap_positions(sub)
    # C feeds: only UPPER entries (row <= col) participate — with a natural
    # ordering c is A as stored and may carry strictly-lower entries, which
    # chol ignores (reference semantics, src/lib.rs:278-337)
    cnz = c.nnz()
    crows = c.i[:cnz].astype(np.int64)
    ccols = col_ids(c.p, n)
    upper = crows <= ccols
    m_nt = np.nonzero(upper & (ccols >= cut) & (crows < cut))[0]
    rhs_src = m_nt[_last_per_key(ccols[m_nt] * np.int64(n) + crows[m_nt])]
    m_tt = np.nonzero(upper & (crows >= cut))[0]
    att_src = m_tt[_last_per_key(ccols[m_tt] * np.int64(n) + crows[m_tt])]
    p21 = np.nonzero((lcols < cut) & (Li >= cut))[0]
    pTT = np.nonzero(lcols >= cut)[0]
    return DenseTail(
        cut=cut, d=D, tri=tri,
        rhs_src=rhs_src, rhs_r=crows[rhs_src], rhs_c=ccols[rhs_src] - cut,
        att_src=att_src, att_r=crows[att_src] - cut,
        att_c=ccols[att_src] - cut,
        l21_pos=p21, l21_j=lcols[p21], l21_t=Li[p21] - cut,
        ltt_pos=pTT, ltt_r=Li[pTT] - cut, ltt_c=lcols[pTT] - cut,
        nn_pos=sub if dense_nn else z, nn_r=Li[sub] if dense_nn else z,
        nn_c=lcols[sub] if dense_nn else z,
    )


def _tail_dev(tail: DenseTail, lsize: int, device) -> tuple:
    return device_cache(tail, "_torch_dev", device, lambda: _index_tensors(
        (tail.rhs_src, tail.rhs_r, tail.rhs_c, tail.att_src, tail.att_r,
         tail.att_c, tail.l21_pos, tail.l21_j, tail.l21_t, tail.ltt_pos,
         tail.ltt_r, tail.ltt_c, tail.nn_pos, tail.nn_r, tail.nn_c),
        ((6, lsize), (9, lsize), (12, lsize)), device))


def _pivot_min(info: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """The smallest of the pivots `diag` [..., p], 0 when `cholesky_ex`
    reported a failed factorization; one value per leading index (an
    instance), info's dimensions past them reduced too."""
    failed = (info > 0).reshape(diag.shape[:-1] + (-1,)).any(-1)
    return torch.where(failed, diag.new_zeros(()), diag.amin(-1))


def _chol_tail(Lx: torch.Tensor, Cx: torch.Tensor, tail: DenseTail):
    """The dense trailing block (the JAX package's `_chol_tail_kernel`):
    fills Lx in place. Returns (smallest pivot, (W, Ls_inv, Lnn_inv)); with
    K instances (Lx [K, lnz+1]) each of them [K, ...], W = L_NN^-1 C(N, T)
    one sweep for all K.

    Solves against the tail use the precomputed triangular inverses (the
    whole application is a few matmuls); Lnn_inv is None when L_NN is too
    large to densify, and its solves then run SpTRSV sweeps."""
    from ..ops.sptrsv_cuda import sptrsv_multi

    (rhs_src, rhs_r, rhs_c, att_src, att_r, att_c, l21_pos, l21_j, l21_t,
     ltt_pos, ltt_r, ltt_c, nn_pos, nn_r, nn_c) = _tail_dev(
        tail, Lx.numel(), Lx.device)
    cut, d = tail.cut, tail.d
    lead = Lx.shape[:-1]  # () or (K,)
    rhs = Lx.new_zeros(lead + (cut, d))
    rhs[..., rhs_r, rhs_c] = Cx[..., rhs_src]
    Lnn_inv = None
    if tail.tri is None:
        Lnn = Lx.new_zeros(lead + (cut, cut))
        Lnn[..., nn_r, nn_c] = Lx[..., nn_pos]
        eye = torch.eye(cut, dtype=Lx.dtype, device=Lx.device)
        Lnn_inv = torch.linalg.solve_triangular(Lnn, eye, upper=False)
        W = Lnn_inv @ rhs
    else:
        W = sptrsv_multi(Lx, rhs, tail.tri, 0)
    Att = Lx.new_zeros(lead + (d, d))
    Att[..., att_r, att_c] = Cx[..., att_src]
    S = (Att + Att.mT - torch.diag_embed(torch.diagonal(Att, dim1=-2, dim2=-1))
         - W.mT @ W)
    Ls, info = torch.linalg.cholesky_ex(S)
    dmin = _pivot_min(info, torch.diagonal(Ls, dim1=-2, dim2=-1))
    Ls_inv = torch.linalg.solve_triangular(
        Ls, torch.eye(d, dtype=Lx.dtype, device=Lx.device), upper=False)
    Lx[..., l21_pos] = W[..., l21_j, l21_t]
    Lx[..., ltt_pos] = Ls[..., ltt_r, ltt_c]
    return dmin, (W, Ls_inv, Lnn_inv)


def _chol_step(Lx: torch.Tensor, Cx: torch.Tensor, tensors) -> torch.Tensor:
    """One level batch: batched dense triangular solve + scatter (Lx in
    place). Returns its smallest d as a 0-dim tensor ([K] for K instances,
    Lx [K, lnz+1])."""
    Midx, bidx, akk, zpos, dpos = tensors
    M = _gather(Lx, Midx)
    # unit diagonal where the pattern has no entry (padding rows)
    M = M + torch.diag_embed((torch.diagonal(Midx, dim1=1, dim2=2) < 0)
                             .to(M.dtype))
    z = torch.linalg.solve_triangular(M, _gather(Cx, bidx)[..., None],
                                      upper=False)[..., 0]
    d = _gather(Cx, akk) - (z * z).sum(-1)
    Lx[..., zpos.reshape(-1)] = z.flatten(-2)
    Lx[..., dpos] = torch.sqrt(d)
    return d.amin(-1)


def _levels_dev(plan: CholPlan, device) -> list:
    checks = ((3, plan.lnz + 1), (4, plan.lnz + 1))
    return device_cache(plan, "_torch_levels", device, lambda: [
        _index_tensors(lev, checks, device) for lev in plan.levels])


def _run_chol(plan: CholPlan, Cx: torch.Tensor):
    """Level phase + dense tail of a level plan on Cx's device. Returns
    (Lx[lnz+1], per-step smallest pivots, tail values or None); for K
    instances (Cx [K, cnnz]) Lx [K, lnz+1] and pivots [K] each."""
    Lx = Cx.new_zeros(Cx.shape[:-1] + (plan.lnz + 1,))
    dmins = [_chol_step(Lx, Cx, t) for t in _levels_dev(plan, Cx.device)]
    tail_vals = None
    if plan.tail is not None:
        dt, tail_vals = _chol_tail(Lx, Cx, plan.tail)
        dmins.append(dt)
    return Lx, dmins, tail_vals


def chol_device(c: Sprs, s: Symb, device):
    """Numeric Cholesky on `device`; c = triu(A(P,P)) with values. Returns
    (Lp, Li, Lx) with Lx a tensor on `device`; raises
    NotPositiveDefiniteError after one readback of the smallest pivot."""
    if not isinstance(s.plan, CholPlan):
        s.plan = build_chol_plan(c, s)
    plan: CholPlan = s.plan
    Cx = torch.as_tensor(np.ascontiguousarray(c.x[: c.nnz()], np.float64),
                         device=device)
    Lx, dmins, _ = _run_chol(plan, Cx)
    if dmins and not float(torch.stack(dmins).min()) > 0.0:
        raise NotPositiveDefiniteError()
    return plan.Lp, plan.Li, Lx[: plan.lnz]
