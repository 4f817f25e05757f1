"""Multifrontal Cholesky: batched dense leaf fronts + reduced skeleton.

Eliminate whole small *subtrees* of the elimination tree as dense frontal
matrices (assembly touches each entry of C once; all elimination work is
batched dense math), then factor the remaining ancestor-closed *skeleton*
— another multifrontal layer while it is large, else the level/tail
machinery of `chol_device` — on a much smaller system.

Phase structure (postordered permutation required — `symbolic.schol`
provides it for order >= 0):

  1. Subtree selection: maximal subtrees with size <= Smax. Postorder makes
     each subtree a contiguous column range [a, r]; the complement (the
     skeleton) is ancestor-closed.
  2. Batched fronts (one set of batched ops per power-of-two shape bucket):
        Ass  = sym(C(S, S)) scattered          [F, Sp, Sp]
        Lss  = cholesky(Ass)                   (dense, padded slots = I)
        Lbs  = C(B, S) · Lss^{-T}              (dense triangular solve)
        Schur= Lbs Lbsᵀ                        [F, Bp, Bp]
     L(S,S) and L(B,S) scatter once into the static sparse pattern.
  3. Skeleton assembly: C_skel = triu C(skel, skel) − Σ extend-add(Schur),
     one `index_add_` with static positions.
  4. Skeleton factorization: the compacted system's L values scatter back
     into the global pattern (skeleton columns' L rows are all skeleton).

Instances: the factorization and the solves also run K value arrays of
one pattern at once (Cx [K, cnnz], X [K, n, B]; the batched-values
solvers): gathers and scatters on the last dimension (rows: the one
before B), the dense fronts [K, F, sp, sp] in the same batched calls, one
smallest pivot per instance.

Solves (`_solve_mf_dev`, on the factors' device) use precomputed front
inverses Lss^{-1} (one batched matmul per bucket and direction instead of
a triangular substitution) and the skeleton's dense-tail inverses; only an
L_NN too large to densify, or a skeleton without a tail, runs SpTRSV
sweeps (`ops.sptrsv_cuda`: the CUDA kernel on the card).

Reference behaviour reproduced: chol (src/lib.rs:278-337) up to the
admissible symmetric permutation; NotPositiveDefinite surfaces from any
phase through one minimum-pivot readback at the end (src/lib.rs:325-328).
The host planner is vectorized numpy; its plan fields equal the JAX
package's `build_mf_plan` entry for entry (C's raw entries feeding the
skeleton are taken last-wins per (row, col), as the reference assigns).
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
from .chol_device import CholPlan, _last_per_key, _pivot_min, _run_chol
from .lu_device import _index_tensors, _lookup


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass
class FrontBucket:
    """Batched fronts sharing one padded shape (Sp, Bp). Front matrices are
    made by scattering the actual C entries into zeros."""

    sp: int
    bp: int
    ass_src: np.ndarray  # [nass] C value positions of triu front entries
    ass_f: np.ndarray  # [nass] front index
    ass_r: np.ndarray  # [nass] row within S-block
    ass_c: np.ndarray  # [nass] col within S-block
    pad_f: np.ndarray  # unit-pivot slots (missing diag or padding)
    pad_r: np.ndarray
    dg_f: np.ndarray  # real diagonal slots (dmin reduction)
    dg_r: np.ndarray
    abs_src: np.ndarray  # [nabs] C value positions of C(S, B) entries
    abs_f: np.ndarray
    abs_r: np.ndarray  # row within B-block
    abs_c: np.ndarray  # col within S-block
    lss_pos: np.ndarray  # [nssz] scatter into Lx
    lss_r: np.ndarray  # [nssz] row within front S-block
    lss_c: np.ndarray  # [nssz] col within front S-block
    lss_f: np.ndarray  # [nssz] front index
    lbs_pos: np.ndarray  # [nbsz] scatter into Lx
    lbs_r: np.ndarray
    lbs_c: np.ndarray
    lbs_f: np.ndarray
    schur_src: np.ndarray  # [nupd] flat index into Schur [F, Bp, Bp]
    schur_dst: np.ndarray  # [nupd] position in skeleton value array
    srow: np.ndarray  # [F, Sp] global row of each S slot (n = pad)
    brow: np.ndarray  # [F, Bp] compact skeleton row of each B slot (ns = pad)


@dataclasses.dataclass
class MFPlan:
    n: int
    lnz: int
    Lp: np.ndarray
    Li: np.ndarray
    buckets: List[FrontBucket]
    # skeleton
    skel: np.ndarray  # global indices of skeleton columns (sorted)
    skel_plan: object  # MFPlan (recursion) or chol_device.CholPlan
    skel_c_pattern: Tuple[np.ndarray, np.ndarray]  # (Cp, Ci) of C_skel
    skel_a_src: np.ndarray  # positions in global Cx feeding C_skel
    skel_a_dst: np.ndarray  # positions in C_skel values
    skel_l_src: np.ndarray  # positions in skeleton Lx
    skel_l_dst: np.ndarray  # positions in global Lx
    skel_cnnz: int


SMAX_DEFAULT = 64
# Skeletons larger than this recurse into another multifrontal layer. The
# JAX package tunes it per backend (3000 off the TPU, where the dense tail
# is cheap and extra layers cost compile time; 1200 on it). The port keeps
# 3000 on the CPU and on the card alike: the card's value has not been
# re-measured.
RECURSE_MIN = 3000
MAX_DEPTH = 4


def _subtree_sizes(parent: np.ndarray, n: int) -> np.ndarray:
    sz = np.ones(n, dtype=np.int64)
    for k in range(n):  # children precede parents in a postordered etree
        p = parent[k]
        if p >= 0:
            sz[p] += sz[k]
    return sz


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of arange(s, s + l) for each (s, l)."""
    tot = int(lens.sum())
    return (np.repeat(starts, lens) + np.arange(tot)
            - np.repeat(np.cumsum(lens) - lens, lens))


def build_mf_plan(c: Sprs, s: Symb, smax: int = SMAX_DEFAULT,
                  depth: int = 0) -> Optional[MFPlan]:
    """Build the multifrontal plan; None when not applicable (needs a
    postordered etree, i.e. postorder(parent) == identity — symbolic.schol
    guarantees this for order >= 0). Large skeletons recurse into another
    multifrontal layer (the Schur-completed skeleton is itself an SPD
    system on an ancestor-closed, still-postordered subset)."""
    from .chol_device import build_chol_plan

    n = c.n
    parent = np.asarray(s.parent, dtype=np.int64)
    if not np.array_equal(native.post(n, parent), np.arange(n)):
        return None
    Lp, Li, _, _, _ = native.chol_pattern(n, c.p, c.i[: c.nnz()],
                                          s.parent, s.cp)
    lnz = int(Lp[n])
    sz = _subtree_sizes(parent, n)
    # maximal small subtrees: root r with sz[r] <= smax and parent big/none
    is_root = (sz <= smax) & ((parent < 0)
                              | (sz[np.clip(parent, 0, n - 1)] > smax))
    roots = np.nonzero(is_root)[0]
    starts = roots - sz[roots] + 1
    front_of = np.full(n, -1, dtype=np.int64)
    front_of[_ranges(starts, sz[roots])] = np.repeat(np.arange(len(roots)),
                                                     sz[roots])
    skel = np.nonzero(front_of < 0)[0]
    ns = len(skel)
    if len(roots) == 0 or ns == n or ns == 0:
        return None

    lcols = col_ids(Lp, n)
    cnz = c.nnz()
    crows = c.i[:cnz].astype(np.int64)
    ccols = col_ids(c.p, n)
    ckeys = ccols * np.int64(n) + crows
    corder = np.argsort(ckeys, kind="stable")
    ckeys_s = ckeys[corder]
    g = np.full(n, -1, dtype=np.int64)  # global -> compact skeleton index
    g[skel] = np.arange(ns)

    # B of each front: the rows of L(:, S) past its root (all skeleton)
    fl = front_of[lcols]
    inb = (fl >= 0) & (Li > roots[np.clip(fl, 0, None)])
    bk = np.unique(fl[inb] * np.int64(n) + Li[inb])
    b_front, b_row = bk // n, bk % n
    b_len = np.bincount(b_front, minlength=len(roots))
    b_off = np.zeros(len(roots) + 1, dtype=np.int64)
    np.cumsum(b_len, out=b_off[1:])

    # ---- skeleton C pattern: C(skel, skel) + the B cliques (upper) ------
    keep = np.nonzero((front_of[crows] < 0) & (front_of[ccols] < 0))[0]
    keep = np.sort(keep[_last_per_key(ckeys[keep])])  # last-wins duplicates
    a_keys = g[ccols[keep]] * np.int64(ns) + g[crows[keep]]
    clique = []
    for lb in np.unique(b_len[b_len > 0]):
        fis = np.nonzero(b_len == lb)[0]
        gb = g[b_row[b_off[fis][:, None] + np.arange(lb)]]  # [F, lb] sorted
        xs, ys = np.triu_indices(lb)
        clique.append((gb[:, ys] * np.int64(ns) + gb[:, xs]).ravel())
    skeys = np.unique(np.concatenate([a_keys] + clique))
    srows, scols = skeys % ns, skeys // ns
    sCp = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(np.bincount(scols, minlength=ns), out=sCp[1:])
    s_cnnz = len(skeys)
    sk_order = np.arange(s_cnnz, dtype=np.int64)
    skel_a_dst = _lookup(skeys, sk_order, a_keys)

    # ---- shape buckets ---------------------------------------------------
    keys = [(_next_pow2(max(int(sz[r]), 1)), _next_pow2(max(int(lb), 1)))
            for r, lb in zip(roots, b_len)]
    buckets_map = {}
    for fi, key in enumerate(keys):
        buckets_map.setdefault(key, []).append(fi)
    buckets = []
    for (sp, bp), fis in sorted(buckets_map.items()):
        buckets.append(_bucket(
            np.asarray(fis, np.int64), sp, bp, n, ns, g, starts, sz[roots],
            bk, b_off, b_len, front_of, Lp, Li, lcols, ckeys_s, corder,
            skeys, sk_order))

    # ---- skeleton symbolic + plan ---------------------------------------
    sparent = np.where(parent[skel] >= 0,
                       g[np.clip(parent[skel], 0, n - 1)], -1)
    scp = np.zeros(ns + 1, dtype=np.int64)
    scp[1:] = np.cumsum(np.diff(Lp)[skel])
    c_skel = Sprs(s_cnnz, ns, ns, sCp, srows, np.zeros(s_cnnz))
    s_sub = Symb(parent=sparent, cp=scp)
    skel_plan = None
    if ns > RECURSE_MIN and depth < MAX_DEPTH:
        skel_plan = build_mf_plan(c_skel, s_sub, smax, depth + 1)
    if skel_plan is None:
        skel_plan = build_chol_plan(c_skel, s_sub)
    # map skeleton L positions -> global L positions (both diag-first asc)
    lens = np.diff(Lp)[skel]
    assert np.array_equal(np.diff(skel_plan.Lp), lens)
    return MFPlan(
        n=n, lnz=lnz, Lp=Lp, Li=Li, buckets=buckets,
        skel=skel, skel_plan=skel_plan, skel_c_pattern=(sCp, srows),
        skel_a_src=keep, skel_a_dst=skel_a_dst,
        skel_l_src=np.arange(int(skel_plan.Lp[ns]), dtype=np.int64),
        skel_l_dst=_ranges(Lp[skel], lens), skel_cnnz=s_cnnz,
    )


def _bucket(fis, sp, bp, n, ns, g, starts, lens, bk, b_off, b_len,
            front_of, Lp, Li, lcols, ckeys_s, corder, skeys,
            sk_order) -> FrontBucket:
    """One shape bucket's maps, for the fronts `fis` (ascending). `bk`
    holds front * n + row for every B row, sorted (front-major)."""
    F = len(fis)
    a0, ls, lb = starts[fis], lens[fis], b_len[fis]
    sl = np.arange(sp)
    svalid = sl[None, :] < ls[:, None]  # [F, sp]
    S = a0[:, None] + sl[None, :]
    srow = np.where(svalid, S, n)
    bl = np.arange(bp)
    bvalid = bl[None, :] < lb[:, None]  # [F, bp]
    b_row = np.r_[bk % n, -1]  # -1: padding
    B = b_row[np.where(bvalid, b_off[fis][:, None] + bl, len(bk))]
    brow = np.where(bvalid, g[np.clip(B, 0, None)], ns)
    # Ass: triu C(S, S) — C entry at (row S[x], col S[y]) for x <= y
    pv = svalid[:, :, None] & svalid[:, None, :] & (sl[:, None] <= sl[None, :])
    found = np.full((F, sp, sp), -1, dtype=np.int64)
    found[pv] = _lookup(ckeys_s, corder, np.broadcast_to(
        S[:, None, :] * np.int64(n) + S[:, :, None], (F, sp, sp))[pv])
    ass_f, ass_r, ass_c = np.nonzero(found >= 0)
    dpresent = np.diagonal(found, axis1=1, axis2=2) >= 0
    dg_f, dg_r = np.nonzero(dpresent)
    pad_f, pad_r = np.nonzero(~dpresent)  # missing diagonals and padding
    # Abs: A(B, S) stored in triu at (row S[s], col B[b])
    pb = bvalid[:, :, None] & svalid[:, None, :]
    fb = np.full((F, bp, sp), -1, dtype=np.int64)
    fb[pb] = _lookup(ckeys_s, corder, np.broadcast_to(
        np.clip(B, 0, None)[:, :, None] * np.int64(n) + S[:, None, :],
        (F, bp, sp))[pb])
    abs_f, abs_r, abs_c = np.nonzero(fb >= 0)
    # L(S,S) and L(B,S): the pattern entries of the fronts' columns, in
    # position order (front-major: the fronts' column ranges ascend)
    tmap = np.full(len(starts), -1, dtype=np.int64)
    tmap[fis] = np.arange(F)
    fo = front_of[lcols]
    pos = np.nonzero((fo >= 0) & (tmap[np.clip(fo, 0, None)] >= 0))[0]
    t = tmap[fo[pos]]
    fi = fis[t]
    col = lcols[pos] - a0[t]
    row = Li[pos]
    ins = row <= a0[t] + ls[t] - 1
    bloc = np.searchsorted(bk, fi * np.int64(n) + row) - b_off[fi]
    # Schur extend-add into C_skel (upper part x <= y of each B clique)
    pu = (bvalid[:, :, None] & bvalid[:, None, :]
          & (bl[:, None] <= bl[None, :]))
    st, xs, ys = np.nonzero(pu)
    gb = np.clip(brow, 0, ns - 1)
    s_dst = _lookup(skeys, sk_order, gb[st, ys] * np.int64(ns) + gb[st, xs])
    return FrontBucket(
        sp=sp, bp=bp,
        ass_src=found[ass_f, ass_r, ass_c], ass_f=ass_f, ass_r=ass_r,
        ass_c=ass_c, pad_f=pad_f, pad_r=pad_r, dg_f=dg_f, dg_r=dg_r,
        abs_src=fb[abs_f, abs_r, abs_c], abs_f=abs_f, abs_r=abs_r,
        abs_c=abs_c,
        lss_pos=pos[ins], lss_r=(row - a0[t])[ins], lss_c=col[ins],
        lss_f=t[ins],
        lbs_pos=pos[~ins], lbs_r=bloc[~ins], lbs_c=col[~ins], lbs_f=t[~ins],
        schur_src=(st * bp + xs) * bp + ys, schur_dst=s_dst,
        srow=srow, brow=brow,
    )


# ---------------------------------------------------------------------------
# Factorization (torch, eager, on the values' device)
# ---------------------------------------------------------------------------


def _factor_dev(plan: MFPlan, device) -> dict:
    """Index tensors the factorization reads, made once per device."""

    def make():
        lsz, csz = plan.lnz + 1, plan.skel_cnnz + 1
        return {
            "buckets": [_index_tensors(
                (b.ass_src, b.ass_f, b.ass_r, b.ass_c, b.pad_f, b.pad_r,
                 b.dg_f, b.dg_r, b.abs_src, b.abs_f, b.abs_r, b.abs_c,
                 b.lss_pos, b.lss_r, b.lss_c, b.lss_f,
                 b.lbs_pos, b.lbs_r, b.lbs_c, b.lbs_f,
                 b.schur_src, b.schur_dst),
                ((12, lsz), (16, lsz), (21, csz)), device)
                for b in plan.buckets],
            "asm": _index_tensors((plan.skel_a_src, plan.skel_a_dst),
                                  ((1, csz),), device),
            "map": _index_tensors(
                (plan.skel_l_src, plan.skel_l_dst),
                ((0, plan.skel_plan.lnz + 1), (1, lsz)), device),
        }

    return device_cache(plan, "_torch_factor_dev", device, make)


def _front(Lx, Csx, Cx, b: FrontBucket, bdev):
    """One bucket of fronts (the JAX package's `_front_kernel`): factor,
    scatter into Lx, extend-add the Schur complements into the skeleton
    values Csx (all in place). Returns (smallest pivot, (Lss_inv, Lbs))."""
    (ass_src, ass_f, ass_r, ass_c, pad_f, pad_r, dg_f, dg_r,
     abs_src, abs_f, abs_r, abs_c, lss_pos, lss_r, lss_c, lss_f,
     lbs_pos, lbs_r, lbs_c, lbs_f, schur_src, schur_dst) = bdev
    F, sp, bp = b.srow.shape[0], b.sp, b.bp
    lead = Cx.shape[:-1]  # () or (K,)
    Ass = Cx.new_zeros(lead + (F, sp, sp))
    Ass[..., ass_f, ass_r, ass_c] = Cx[..., ass_src]
    Ass = Ass + Ass.mT - torch.diag_embed(torch.diagonal(Ass, dim1=-2,
                                                         dim2=-1))
    # padded / missing-diagonal S slots (each once, zero so far): identity
    # pivots
    Ass[..., pad_f, pad_r, pad_r] = 1.0
    Lss, info = torch.linalg.cholesky_ex(Ass)
    dmin = (_pivot_min(info, Lss[..., dg_f, dg_r, dg_r]) if len(dg_f)
            else Cx.new_ones(lead))
    Abs = Cx.new_zeros(lead + (F, bp, sp))
    Abs[..., abs_f, abs_r, abs_c] = Cx[..., abs_src]
    # L_BS = A_BS Lss^{-T}: solve X Lss^T = A_BS
    Lbs = torch.linalg.solve_triangular(Lss.mT, Abs, upper=True, left=False)
    Schur = Lbs @ Lbs.mT
    Lx[..., lss_pos] = Lss[..., lss_f, lss_r, lss_c]
    Lx[..., lbs_pos] = Lbs[..., lbs_f, lbs_r, lbs_c]
    Csx.index_add_(-1, schur_dst, Schur.flatten(-3)[..., schur_src], alpha=-1)
    # Lss^{-1}: every solve application becomes one batched matmul
    eye = torch.eye(sp, dtype=Cx.dtype, device=Cx.device).expand(Lss.shape)
    Lss_inv = torch.linalg.solve_triangular(Lss, eye, upper=False)
    return dmin, (Lss_inv, Lbs)


def _chol_mf_values(Cx: torch.Tensor, plan: MFPlan):
    """Recursive core: factor the values Cx of the plan's system on Cx's
    device. Returns (Lx[lnz+1], smallest pivots, cache tree); the cache
    tree (fronts' (Lss_inv, Lbs), skeleton Lxs, tail values, sub-tree)
    carries the dense factors the solves use. For K instances (Cx
    [K, cnnz]) every array gains the leading K and each pivot is [K]. It
    writes nothing on the plan but device index tensors."""
    dev = _factor_dev(plan, Cx.device)
    lead = Cx.shape[:-1]
    Lx = Cx.new_zeros(lead + (plan.lnz + 1,))
    Csx = Cx.new_zeros(lead + (plan.skel_cnnz + 1,))
    a_src, a_dst = dev["asm"]
    Csx.index_add_(-1, a_dst, Cx[..., a_src])
    dmins, front_vals = [], []
    for b, bdev in zip(plan.buckets, dev["buckets"]):
        dmin, fv = _front(Lx, Csx, Cx, b, bdev)
        dmins.append(dmin)
        front_vals.append(fv)
    sp = plan.skel_plan
    Cs = Csx[..., : plan.skel_cnnz]
    tail_vals = sub_cache = None
    if isinstance(sp, MFPlan):  # recursive multifrontal layer
        Lxs, dsub, sub_cache = _chol_mf_values(Cs, sp)
    else:
        assert isinstance(sp, CholPlan)
        Lxs, dsub, tail_vals = _run_chol(sp, Cs)
    dmins += dsub
    l_src, l_dst = dev["map"]
    Lx[..., l_dst] = Lxs[..., l_src]
    return Lx, dmins, (tuple(front_vals), Lxs, tail_vals, sub_cache)


def _chol_mf_factor(Cx: torch.Tensor, plan: MFPlan) -> torch.Tensor:
    """Factor, read the smallest pivot back once, raise
    NotPositiveDefiniteError when it is not positive; on success cache the
    solve tree on the plan. Returns Lx[lnz+1] on Cx's device."""
    Lx, dmins, cache = _chol_mf_values(Cx, plan)
    if dmins and not float(torch.stack(dmins).min()) > 0.0:
        # a future sym-reuse solve must not dispatch on a stale tree
        plan.__dict__.pop("_cache_tree", None)
        raise NotPositiveDefiniteError()
    plan.__dict__["_cache_tree"] = cache
    return Lx


def chol_mf(c: Sprs, s: Symb, plan: MFPlan, device):
    """Run the multifrontal factorization on `device`. Returns (Lp, Li, Lx)
    with Lx a tensor on `device`, and caches the solve tree on the plan."""
    Cx = torch.as_tensor(np.ascontiguousarray(c.x[: c.nnz()], np.float64),
                         device=device)
    Lx = _chol_mf_factor(Cx, plan)
    return plan.Lp, plan.Li, Lx[: plan.lnz]


# ---------------------------------------------------------------------------
# Multifrontal solves: dense front ops + the innermost skeleton
# ---------------------------------------------------------------------------


def _fwd_front(X, Ds, Lss_inv, Lbs, srow, brow):
    """Forward front phase (in place): z_S = Lss^{-1} b_S; accumulate
    Lbs z into the skeleton delta Ds. X: [(K,) n+1, B] (garbage row n); Ds:
    [(K,) ns+1, B] (garbage row ns)."""
    zs = Lss_inv @ X[..., srow, :]  # [(K,) F, Sp, B]
    X[..., srow, :] = zs  # padded slots write row n
    Ds.index_add_(-2, brow.reshape(-1), (Lbs @ zs).flatten(-3, -2))


def _bwd_front(X, Lss_inv, Lbs, srow, browg):
    """Backward front phase (in place): x_S = Lss^{-T} (b_S - Lbsᵀ x_B).
    `browg` holds global row indices of B slots (n = pad)."""
    X[..., srow, :] = Lss_inv.mT @ (X[..., srow, :] - Lbs.mT @ X[..., browg, :])


def _skel_tri_plans(plan: MFPlan):
    """Pattern-only sweep schedules (kinds 0 and 2) for the compacted
    skeleton L, cached on the plan. With a dense tail they cover only its
    leading block L_NN (columns < cut), positions remapped into the full
    skeleton Lxs. Returns (p0, p2, cut); cut == ns when there is no tail."""
    from ..solve import tri_plan

    tp = plan.__dict__.get("_skel_tri")
    if tp is None:
        sp = plan.skel_plan
        ns = len(plan.skel)
        cut = sp.tail.cut if sp.tail is not None else ns
        lcols = col_ids(sp.Lp, ns)
        sub = np.nonzero((lcols < cut) & (sp.Li < cut))[0]
        nn_p = np.zeros(cut + 1, dtype=np.int64)
        np.cumsum(np.bincount(lcols[sub], minlength=cut), out=nn_p[1:])
        lnn = Sprs(len(sub), cut, cut, nn_p, sp.Li[sub], np.zeros(len(sub)))
        tp = (tri_plan(lnn, 0).remap_positions(sub),
              tri_plan(lnn, 2).remap_positions(sub), cut)
        plan.__dict__["_skel_tri"] = tp
    return tp


def _solve_dev(plan: MFPlan, device) -> dict:
    """Index tensors the solve reads at this layer, made once per device."""

    def make():
        ns, n = len(plan.skel), plan.n
        ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        return {
            "buckets": [(ix(b.srow), ix(b.brow), ix(np.where(
                b.brow < ns, plan.skel[np.clip(b.brow, 0, ns - 1)], n)))
                for b in plan.buckets],
            "skel_idx": ix(plan.skel),
        }

    return device_cache(plan, "_torch_solve_dev", device, make)


def _solve_mf_dev(plan: MFPlan, X: torch.Tensor, cache) -> torch.Tensor:
    """Recursive device core: X [n, B] -> L'^{-1} L^{-1} X; or X [K, n, B]
    with a cache tree of K instances (`_chol_mf_values` of Cx [K, cnnz]),
    every sweep one launch for all K."""
    from ..ops.sptrsv_cuda import sptrsv_multi

    fronts, Lxs, tail_vals, sub_cache = cache
    ns, n = len(plan.skel), plan.n
    sdev = _solve_dev(plan, X.device)
    lead, B = X.shape[:-2], X.shape[-1]
    Xd = torch.cat([X, X.new_zeros(lead + (1, B))], dim=-2)
    Ds = X.new_zeros(lead + (ns + 1, B))
    for (Lss_inv, Lbs), (srow, brow, _) in zip(fronts, sdev["buckets"]):
        _fwd_front(Xd, Ds, Lss_inv, Lbs, srow, brow)
    skel_idx = sdev["skel_idx"]
    bs = Xd[..., skel_idx, :] - Ds[..., :ns, :]
    if isinstance(plan.skel_plan, MFPlan):  # recursive layer
        ys = _solve_mf_dev(plan.skel_plan, bs, sub_cache)
    elif tail_vals is not None:
        # the dense trailing block (and, when densified, the leading block)
        # with precomputed inverses; sweeps only for a large L_NN
        W, Ls_inv, Lnn_inv = tail_vals
        cut = plan.skel_plan.tail.cut
        if Lnn_inv is None:
            p0, p2, _ = _skel_tri_plans(plan)
            nn_fwd = lambda v: sptrsv_multi(Lxs, v, p0, 0)
            nn_bwd = lambda v: sptrsv_multi(Lxs, v, p2, 2)
        else:
            nn_fwd = lambda v: Lnn_inv @ v
            nn_bwd = lambda v: Lnn_inv.mT @ v
        y_n = nn_fwd(bs[..., :cut, :])
        z_t = Ls_inv.mT @ (Ls_inv @ (bs[..., cut:, :] - W.mT @ y_n))
        ys = torch.cat([nn_bwd(y_n - W @ z_t), z_t], dim=-2)
    else:
        p0, p2, _ = _skel_tri_plans(plan)
        ys = sptrsv_multi(Lxs, sptrsv_multi(Lxs, bs, p0, 0), p2, 2)
    Xd[..., skel_idx, :] = ys
    for (Lss_inv, Lbs), (srow, _, browg) in zip(reversed(fronts),
                                                reversed(sdev["buckets"])):
        _bwd_front(Xd, Lss_inv, Lbs, srow, browg)
    return Xd[..., :n, :]
