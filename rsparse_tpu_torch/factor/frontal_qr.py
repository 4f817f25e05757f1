"""Multifrontal Householder QR: batched dense fronts over the column etree.

The reference's QR (src/lib.rs:788-877) applies reflectors column by
column; at scale its level schedule is too deep and too fine to batch
(`qr_device.PLAN_ENTRY_CAP`). The multifrontal structure is: partition the
column etree of AᵀA into connected chunks (pruned subtrees, a greedy
postorder merge up to `smax` columns), assign each row to the front of its
leftmost column, and per front factor the dense matrix

    F_f = [ A(O_f, S_f ∪ E_f) ; child contribution blocks ]

with one batched `torch.linalg.qr` per bucket of fronts (a library
factorization of dense fronts, Householder semantics). The first |S_f| rows
of the triangular factor are final rows of R; the next cb_f = min(rows -
|S_f|, |E_f|) rows form the contribution block passed to the parent front.
Row i's columns all descend from leftmost(i) in the etree, so a completed
child subtree never needs a row assigned to an ancestor chunk.

Fronts at the same tree depth with the same padded shape batch into one
bucket; each bucket's reduced Q [F, rp, kq] (kq = min(rp, cp)) is kept
with R, so a solve is one gather, one batched matmul and one scatter per
bucket — Qᵀb (least squares) forward, or Q·x (minimum norm, the tree built
on Aᵀ) backward — plus one sweep of the static R pattern through the SpTRSV
kernel (`ops.sptrsv_cuda`: the CUDA kernel on a card, its plain version on
the CPU): usolve (kind 1) or utsolve (kind 3).

Buckets hold compact descriptors (a few integers per (front, child) pair
and the irregular R and CB position maps); the front assembly, R and CB
index streams expand on the device with `torch.searchsorted` and integer
arithmetic at factor time.

The factorization and the solves also take K value arrays of one pattern
at once (Ax [K, nnz], the batched-values solver `qrsol_vals`): the fronts
[K, F, rp, cp] go into the same batched `torch.linalg.qr`, gathers and
scatters work on the last dimension (rows: the one before the columns of
B), and the R sweep is one launch for all K. That form (`_qr_mf_values`)
writes nothing on the plan but device index tensors; only `_qr_mf_factor`
caches one instance's factors there.

The port factors in float64 on every route, so the JAX package's float32
machinery stays behind: the dense R⁻¹ cache (`_maybe_dense_rinv`), the
compile-size chunking (`_qr_chunks`), the Pallas sweep switch
(`_use_pallas_sweeps`) and the padded residual gathers (`_resid_padded`, a
TPU gather workaround; the residuals here are `index_add_`s). With f64
fronts the JAX package runs the same algorithm with no refinement step,
and so does the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..data import Sprs, Symb
from ..ops.plan import col_ids, device_cache
from ..symbolic import native
from .chol_device import _last_per_key
from .lu_device import _index_tensors


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass
class QRFrontBucket:
    """One (level, padded-shape) batch of fronts, as compact descriptors
    that `_qr_front` expands on the device."""

    F: int  # fronts in the bucket
    rp: int  # padded rows
    cp: int  # padded cols
    kq: int  # min(rp, cp)
    # A assembly: COO (front, row, col) <- Ax[pos], valid entries only
    a_f: np.ndarray
    a_r: np.ndarray
    a_c: np.ndarray
    a_pos: np.ndarray
    # child-CB stacking: one descriptor per (front, child) pair; entry k of
    # pair p maps cbx[offv[p]+k] -> Fm[t[p], roff[p]+k//L[p],
    # cpos[cpos_off[p] + k%L[p]]]
    cb_t: np.ndarray
    cb_offv: np.ndarray
    cb_roff: np.ndarray
    cb_L: np.ndarray
    cb_cpos_off: np.ndarray
    cpos: np.ndarray  # concatenated child-column -> front-column maps
    cb_cum: np.ndarray  # [P+1] cumulative nb*L
    # R scatter: per-front rect ns x nc; r_dst holds the Rx position (the
    # spare slot rnz where masked: below the diagonal or absent)
    r_t: np.ndarray
    r_nc: np.ndarray
    r_cum: np.ndarray  # [Pf+1] cumulative ns*nc
    r_dst: np.ndarray
    # CB output: per-front rect nb x L over ext columns; entry k of front
    # descriptor p maps Rt[t, ns+k//L, ns+k%L] -> cbx[offv[p]+k] (the spare
    # slot below the trapezoid)
    o_t: np.ndarray
    o_L: np.ndarray
    o_ns: np.ndarray
    o_offv: np.ndarray
    o_cum: np.ndarray  # [Pf+1] cumulative nb*L
    # solve-side maps
    row_src: np.ndarray  # [F, rp] rows of concat([z(m), cbz]) (-1 pad)
    c_dst: np.ndarray  # [F, kq] Qᵀz rows -> global member col (-1 none)
    cbz_dst: np.ndarray  # [F, kq] Qᵀz rows -> cbz slots (-1 none)

    @property
    def dims(self):
        """Expansion sizes: (F, rp, cp, Tcb, Tr, Tout)."""
        return (self.F, self.rp, self.cp, int(self.cb_cum[-1]),
                int(self.r_cum[-1]), int(self.o_cum[-1]))


@dataclasses.dataclass
class QRMFPlan:
    m: int
    n: int
    rnz: int
    Rp: np.ndarray
    Ri: np.ndarray
    levels: List[List[QRFrontBucket]]  # buckets grouped by front-tree depth
    cb_total: int  # flat CB value-buffer length
    cbz_total: int  # flat CB rhs-buffer length
    q: Optional[np.ndarray]  # composed column order (committed to s.q)
    # the ordering before the commit, the one s.parent/pinv/cp/m2/lnz/unz
    # describe: the host-exact escapes factor with it
    q_host: Optional[np.ndarray] = None


def _chunks(n: int, parent2: np.ndarray, smax: int):
    """Greedy etree chunking into pruned subtrees (postordered etree):
    returns (chunk_of [n], chunk sizes, each chunk's child chunks)."""
    chunk_of = np.full(n, -1, dtype=np.int64)
    chunk_sz: List[int] = []
    chunk_children: List[List[int]] = []
    children_nodes: List[List[int]] = [[] for _ in range(n)]
    for k in range(n):
        p_ = parent2[k]
        if p_ >= 0:
            children_nodes[p_].append(k)
    for k in range(n):
        kids = children_nodes[k]
        best, bsz = -1, 0
        for c in kids:
            cid = int(chunk_of[c])
            if chunk_sz[cid] < smax and chunk_sz[cid] > bsz:
                best, bsz = cid, chunk_sz[cid]
        if best >= 0:
            chunk_of[k] = best
            chunk_sz[best] += 1
            for c in kids:
                if chunk_of[c] != best:
                    chunk_children[best].append(int(chunk_of[c]))
        else:
            chunk_of[k] = len(chunk_sz)
            chunk_sz.append(1)
            chunk_children.append([int(chunk_of[c]) for c in kids])
    return chunk_of, chunk_sz, chunk_children


def _groups(keys: np.ndarray, nk: int):
    """(order, offsets): the indices with key g are order[off[g]:off[g+1]],
    ascending; keys < 0 are left out."""
    ok = np.nonzero(keys >= 0)[0]
    order = ok[np.argsort(keys[ok], kind="stable")]
    off = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys[ok], minlength=nk), out=off[1:])
    return order, off


def build_qr_mf_plan(a: Sprs, s: Symb, smax: int = 256) -> Optional[QRMFPlan]:
    """Build the multifrontal QR plan; composes s.q with the etree postorder
    (committed only on success). None when not applicable (m < n, or a
    natural order whose etree is not postordered).

    smax, the chunk-merge bound, trades front count against R fill; 256 is
    the JAX package's choice (fewer, larger batched factorizations at +19%
    R entries against 64), kept here."""
    m, n = a.m, a.n
    if n == 0 or m < n:
        return None
    parent = np.asarray(s.parent, dtype=np.int64)
    post = native.post(n, parent)
    q0 = np.asarray(s.q, dtype=np.int64) if s.q is not None else None
    if np.array_equal(post, np.arange(n)):
        qt = q0
        parent2 = parent
    else:
        if q0 is None:
            return None  # natural order stays untouched (parity)
        qt = q0[post]
        pinv_post = np.empty(n, dtype=np.int64)
        pinv_post[post] = np.arange(n)
        parent2 = np.where(parent[post] >= 0,
                           pinv_post[np.clip(parent[post], 0, n - 1)], -1)
        # the relabeled postordered etree must itself be postordered
        if not np.array_equal(native.post(n, parent2), np.arange(n)):
            return None

    nz = a.nnz()
    arows = a.i[:nz].astype(np.int64)
    acols = col_ids(a.p, n)
    if qt is not None:
        qinv = np.empty(n, dtype=np.int64)
        qinv[qt] = np.arange(n)
        kcols = qinv[acols]
    else:
        kcols = acols
    leftmost = np.full(m, n, dtype=np.int64)
    np.minimum.at(leftmost, arows, kcols)

    chunk_of, chunk_sz, chunk_children = _chunks(n, parent2, smax)
    nf = len(chunk_sz)
    mord, moff = _groups(chunk_of, nf)
    members = [mord[moff[f]: moff[f + 1]] for f in range(nf)]

    # ---- per-front structure (bottom-up in root order) -------------------
    lm_chunk = np.where(leftmost < n, chunk_of[np.clip(leftmost, 0, n - 1)], -1)
    rord, roff = _groups(lm_chunk, nf)  # each front's original rows O_f
    eord, eoff = _groups(lm_chunk[arows], nf)  # the entries of those rows
    froot = np.array([mb[-1] for mb in members])
    E: List[np.ndarray] = [None] * nf
    Of = [rord[roff[f]: roff[f + 1]] for f in range(nf)]
    nrows = np.zeros(nf, dtype=np.int64)
    cb = np.zeros(nf, dtype=np.int64)
    flev = np.zeros(nf, dtype=np.int64)
    for fi in np.argsort(froot).tolist():
        kc = kcols[eord[eoff[fi]: eoff[fi + 1]]]
        parts = [kc[chunk_of[kc] != fi]]
        kids = chunk_children[fi]
        for c in kids:
            parts.append(E[c][chunk_of[E[c]] != fi])
        ext = np.unique(np.concatenate(parts))
        E[fi] = ext
        ns = len(members[fi])
        nrows[fi] = max(len(Of[fi]) + int(sum(cb[c] for c in kids)), ns)
        cb[fi] = min(max(nrows[fi] - ns, 0), len(ext))
        flev[fi] = max((int(flev[c]) for c in kids), default=-1) + 1

    # ---- R pattern (static CSC, diag LAST per column: usolve convention) --
    r_rows_parts: List[np.ndarray] = []
    r_cols_parts: List[np.ndarray] = []
    for fi in range(nf):
        mb = members[fi]
        ns_ = len(mb)
        cols_all = np.concatenate([mb, E[fi]])
        nc_ = len(cols_all)
        I = np.repeat(np.arange(ns_), nc_)
        J = np.tile(np.arange(nc_), ns_)
        keep = J >= I
        r_rows_parts.append(mb[I[keep]])
        r_cols_parts.append(cols_all[J[keep]])
    r_rows = np.concatenate(r_rows_parts)
    r_cols = np.concatenate(r_cols_parts)
    Ri = r_rows[np.lexsort((r_rows, r_cols))]
    Rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r_cols, minlength=n), out=Rp[1:])
    rnz = int(Rp[n])
    rkeys_s = np.repeat(np.arange(n, dtype=np.int64), np.diff(Rp)) * n + Ri

    def rlookup(col, row):  # R has one entry per (row, col), keys sorted
        kq = np.asarray(col) * np.int64(n) + np.asarray(row)
        pos = np.clip(np.searchsorted(rkeys_s, kq), 0, max(rnz - 1, 0))
        return np.where(rkeys_s[pos] == kq, pos, -1)

    # ---- CB slot layout ---------------------------------------------------
    cb_off = np.zeros(nf + 1, dtype=np.int64)  # value entries: cb * |E|
    cbz_off = np.zeros(nf + 1, dtype=np.int64)  # rhs entries: cb
    np.cumsum(cb * np.array([len(e) for e in E], dtype=np.int64),
              out=cb_off[1:])
    np.cumsum(cb, out=cbz_off[1:])

    # ---- buckets by (level, padded shape) --------------------------------
    nlev = int(flev.max()) + 1
    level_buckets: List[List[QRFrontBucket]] = []
    for lev in range(nlev):
        bmap = {}
        for fi in np.nonzero(flev == lev)[0].tolist():
            key = (_next_pow2(max(int(nrows[fi]), 1)),
                   _next_pow2(max(len(members[fi]) + len(E[fi]), 1)))
            bmap.setdefault(key, []).append(fi)
        level_buckets.append([
            _bucket(bf, rp, cp, m, rnz, members, E, Of, cb, cb_off, cbz_off,
                    chunk_children, arows, kcols, eord, eoff, rlookup)
            for (rp, cp), bf in sorted(bmap.items())])
    plan = QRMFPlan(m=m, n=n, rnz=rnz, Rp=Rp, Ri=Ri, levels=level_buckets,
                    cb_total=int(cb_off[nf]), cbz_total=int(cbz_off[nf]),
                    q=qt, q_host=q0)
    if qt is not None:
        s.q = qt  # commit the composed ordering; q_host keeps the old one
    return plan


def _bucket(bf, rp, cp, m, rnz, members, E, Of, cb, cb_off, cbz_off,
            chunk_children, arows, kcols, eord, eoff, rlookup) -> QRFrontBucket:
    """One bucket's descriptors and solve maps, for the fronts `bf`."""
    F = len(bf)
    kq = min(rp, cp)
    a4 = ([], [], [], [])  # COO: f, r, c, pos (valid only)
    cbd = ([], [], [], [], [])  # t, offv, roff, L, cpos_off
    cpos_parts: List[np.ndarray] = []
    cb_lens: List[int] = []
    cpos_total = 0
    rd = ([], [])  # t, nc
    r_lens: List[int] = []
    r_dst_parts: List[np.ndarray] = []
    od = ([], [], [], [])  # t, L, ns, offv
    o_lens: List[int] = []
    row_src = np.full((F, rp), -1, dtype=np.int64)
    c_dst = np.full((F, kq), -1, dtype=np.int64)
    cbz_dst = np.full((F, kq), -1, dtype=np.int64)
    for t, fi in enumerate(bf):
        mb = members[fi]
        ns = len(mb)
        ext = E[fi]
        cols_all = np.concatenate([mb, ext])
        nc = len(cols_all)
        of = Of[fi]
        no = len(of)
        ca_order = np.argsort(cols_all, kind="stable")
        ca_sorted = cols_all[ca_order]
        if no:
            # A(O_f, cols): each (row, col) from its last stored entry (the
            # reference's last-wins assignment), row-major
            ents = eord[eoff[fi]: eoff[fi + 1]]
            r = np.searchsorted(of, arows[ents])
            c = ca_order[np.searchsorted(ca_sorted, kcols[ents])]
            key = r * np.int64(nc) + c
            last = _last_per_key(key)
            a4[0].append(np.full(len(last), t, dtype=np.int64))
            a4[1].append(r[last])
            a4[2].append(c[last])
            a4[3].append(ents[last])
        # child CBs stacked below the original rows: one compact descriptor
        # per (front, child) pair
        roff = no
        for ci in chunk_children[fi]:
            ec = E[ci]
            nb = int(cb[ci])
            L = len(ec)
            if nb and L:
                # every child-CB column is a column of this front
                cbd[0].append(t)
                cbd[1].append(int(cb_off[ci]))
                cbd[2].append(roff)
                cbd[3].append(L)
                cbd[4].append(cpos_total)
                cpos_parts.append(ca_order[np.searchsorted(ca_sorted, ec)])
                cpos_total += L
                cb_lens.append(nb * L)
            roff += nb
        # R scatter: the ns x nc rect, spare slot rnz below the trapezoid
        I = np.repeat(np.arange(ns), nc)
        J = np.tile(np.arange(nc), ns)
        d = rlookup(cols_all[J], mb[I])
        rd[0].append(t)
        rd[1].append(nc)
        r_lens.append(ns * nc)
        r_dst_parts.append(np.where((J >= I) & (d >= 0), d, rnz))
        # CB output: nb x L rect over the ext columns
        nb = int(cb[fi])
        L = len(ext)
        if nb and L:
            od[0].append(t)
            od[1].append(L)
            od[2].append(ns)
            od[3].append(int(cb_off[fi]))
            o_lens.append(nb * L)
        # solve maps
        row_src[t, :no] = of
        roff = no
        for ci in chunk_children[fi]:
            nbc = int(cb[ci])
            row_src[t, roff: roff + nbc] = m + cbz_off[ci] + np.arange(nbc)
            roff += nbc
        c_dst[t, :ns] = mb
        cbz_dst[t, ns: ns + nb] = cbz_off[fi] + np.arange(nb)

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def i64(v):
        return np.asarray(v, dtype=np.int64)

    def cum(lens):
        c_ = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(i64(lens), out=c_[1:])
        return c_

    return QRFrontBucket(
        F=F, rp=rp, cp=cp, kq=kq,
        a_f=cat(a4[0]), a_r=cat(a4[1]), a_c=cat(a4[2]), a_pos=cat(a4[3]),
        cb_t=i64(cbd[0]), cb_offv=i64(cbd[1]), cb_roff=i64(cbd[2]),
        cb_L=i64(cbd[3]), cb_cpos_off=i64(cbd[4]),
        cpos=cat(cpos_parts), cb_cum=cum(cb_lens),
        r_t=i64(rd[0]), r_nc=i64(rd[1]), r_cum=cum(r_lens),
        r_dst=cat(r_dst_parts),
        o_t=i64(od[0]), o_L=i64(od[1]), o_ns=i64(od[2]),
        o_offv=i64(od[3]), o_cum=cum(o_lens),
        row_src=row_src, c_dst=c_dst, cbz_dst=cbz_dst)


# ---------------------------------------------------------------------------
# Factorization (torch, eager, on the values' device)
# ---------------------------------------------------------------------------


def _factor_dev(plan: QRMFPlan, device) -> list:
    """Each bucket's descriptor tensors on `device`, made once per device;
    the R map is range-checked against Rx (rnz + 1 slots)."""

    def make():
        return [_index_tensors(
            (b.a_f, b.a_r, b.a_c, b.a_pos,
             b.cb_t, b.cb_offv, b.cb_roff, b.cb_L, b.cb_cpos_off, b.cpos,
             b.cb_cum, b.r_t, b.r_nc, b.r_cum, b.r_dst,
             b.o_t, b.o_L, b.o_ns, b.o_offv, b.o_cum),
            ((14, plan.rnz + 1),), device)
            for lev in plan.levels for b in lev]

    return device_cache(plan, "_torch_factor_dev", device, make)


def _expand(cum: torch.Tensor, T: int):
    """Flat entry k -> (descriptor p, offset within p) for T entries: the
    device-side inverse of the planner's concatenation."""
    k = torch.arange(T, device=cum.device)
    p = torch.searchsorted(cum, k, right=True) - 1
    return p, k - cum[p]


def _qr_front(Rx, cbx, Ax, dev, dims):
    """One bucket: assemble the fronts, factor them (reduced QR), scatter R
    rows into Rx and the contribution blocks into cbx (in place). Returns
    the bucket's Q [F, rp, kq] ([K, F, rp, kq] for K instances)."""
    F, rp, cp, Tcb, Tr, Tout = dims
    (af, ar, ac, apos, cb_t, cb_offv, cb_roff, cb_L, cb_cpos_off, cposv,
     cb_cum, r_t, r_nc, r_cum, r_dst, o_t, o_L, o_ns, o_offv, o_cum) = dev
    Fm = Ax.new_zeros(Ax.shape[:-1] + (F, rp, cp))
    Fm[..., af, ar, ac] = Ax[..., apos]
    if Tcb:  # child CBs: rows below the original rows, one slot each
        p, off = _expand(cb_cum, Tcb)
        L = cb_L[p]
        bi = off // L
        Fm[..., cb_t[p], cb_roff[p] + bi,
           cposv[cb_cpos_off[p] + off - bi * L]] = cbx[..., cb_offv[p] + off]
    # reduced QR: Q [F, rp, kq] (every column a solve touches) and the upper
    # trapezoid Rt [F, kq, cp] holding the R rows and the CB block
    Q, Rt = torch.linalg.qr(Fm, mode="reduced")
    if Tr:
        p, off = _expand(r_cum, Tr)
        i = off // r_nc[p]
        Rx.index_copy_(-1, r_dst, Rt[..., r_t[p], i, off - i * r_nc[p]])
    if Tout:
        p, off = _expand(o_cum, Tout)
        L = o_L[p]
        bi = off // L
        j = off - bi * L
        keep = j >= bi  # the upper trapezoid; the rest goes to the spare slot
        dst = torch.where(keep, o_offv[p] + off, cbx.shape[-1] - 1)
        cbx.index_copy_(-1, dst, Rt[..., o_t[p], o_ns[p] + bi, o_ns[p] + j])
    return Q


def _qr_mf_values(Ax: torch.Tensor, plan: QRMFPlan):
    """Factor the values Ax [nnz] (or K instances' [K, nnz]) of the plan's
    matrix on Ax's device. Returns (the buckets' Q blocks, Rx with its
    spare slot); caches nothing on the plan."""
    lead = Ax.shape[:-1]
    Rx = Ax.new_zeros(lead + (plan.rnz + 1,))
    cbx = Ax.new_zeros(lead + (plan.cb_total + 1,))
    flat = [b for lev in plan.levels for b in lev]
    qs = [_qr_front(Rx, cbx, Ax, dev, b.dims)
          for b, dev in zip(flat, _factor_dev(plan, Ax.device))]
    return qs, Rx


def _qr_mf_factor(Ax: torch.Tensor, plan: QRMFPlan) -> None:
    """Factor the values Ax of the plan's matrix on Ax's device; caches the
    buckets' Q blocks, Ax, and R (Rx with its spare slot, and the [rnz] view
    the sweeps read) on the plan."""
    qs, Rx = _qr_mf_values(Ax, plan)
    plan.__dict__["_cache_q"] = qs
    plan.__dict__["_cache_ax"] = Ax  # the residuals' values
    plan.__dict__["_cache_rx"] = Rx
    plan.__dict__["_cache_rv"] = Rx[: plan.rnz]


def qr_mf(a: Sprs, s: Symb, plan: QRMFPlan, device="cuda"):
    """Factor A on `device`; caches the Q blocks and R on the plan. Returns
    (Rp, Ri, Rx) — R in static CSC, diagonal last per column, Rx a float64
    host array."""
    nz = a.nnz()
    _qr_mf_factor(torch.as_tensor(np.asarray(a.x[:nz], np.float64),
                                  device=torch.device(device)), plan)
    Rx = plan.__dict__["_cache_rv"]
    return plan.Rp, plan.Ri, Rx.cpu().numpy().copy()


# ---------------------------------------------------------------------------
# Solves: Qᵀ / Q through the bucket tree, R sweeps, f64 residuals
# ---------------------------------------------------------------------------


def _solve_dev(plan: QRMFPlan, device) -> list:
    """Per bucket, the solve's index tensors on `device`: the rows gathered
    into the fronts (padding -> a zero row at m + cbz_total), and the flat
    (front, row) slots that scatter into member columns, CB rhs slots and,
    for Q·x, original rows and CB rhs slots (each destination once)."""

    def make():
        m, n, cbt = plan.m, plan.n, plan.cbz_total
        ix = lambda a_: torch.as_tensor(np.asarray(a_, np.int64), device=device)
        out = []
        for lev in plan.levels:
            for b in lev:
                c = b.c_dst.reshape(-1)
                z = b.cbz_dst.reshape(-1)
                r = b.row_src.reshape(-1)
                fc, fz = np.nonzero(c >= 0)[0], np.nonzero(z >= 0)[0]
                fr = np.nonzero((r >= 0) & (r < m))[0]
                fb = np.nonzero(r >= m)[0]
                out.append(dict(
                    src=ix(np.where(b.row_src >= 0, b.row_src, m + cbt)),
                    fc=ix(fc), c=ix(c[fc]), fz=ix(fz), z=ix(z[fz]),
                    fr=ix(fr), r=ix(r[fr]), fb=ix(fb), b=ix(r[fb] - m),
                    u1=ix(np.where(b.c_dst >= 0, b.c_dst, n)),
                    u2=ix(np.where(b.cbz_dst >= 0, b.cbz_dst, cbt))))
        return out

    return device_cache(plan, "_torch_solve_dev", device, make)


def _qt_apply(plan: QRMFPlan, z: torch.Tensor, qs, sdevs) -> torch.Tensor:
    """c = (Qᵀ z) restricted to R's rows (n of them); z is [m, B], or
    [K, m, B] with K instances' Q blocks."""
    lead, B = z.shape[:-2], z.shape[-1]
    c = z.new_zeros(lead + (plan.n, B))
    cbz = z.new_zeros(lead + (plan.cbz_total + 1, B))  # last row: zero pad
    for Q, sd in zip(qs, sdevs):
        zf = torch.cat([z, cbz], dim=-2)[..., sd["src"], :]  # [(K,) F, rp, B]
        y = (Q.mT @ zf).flatten(-3, -2)  # [(K,) F * kq, B]
        c[..., sd["c"], :] = y[..., sd["fc"], :]
        cbz[..., sd["z"], :] = y[..., sd["fz"], :]
    return c


def _q_apply(plan: QRMFPlan, w: torch.Tensor, qs, sdevs) -> torch.Tensor:
    """z = Q [w; 0], the buckets in reverse (minimum-norm branch); w is
    [(K,) n, B], z is [(K,) m, B]."""
    lead, B = w.shape[:-2], w.shape[-1]
    z = w.new_zeros(lead + (plan.m, B))
    cbz = w.new_zeros(lead + (plan.cbz_total + 1, B))  # last row stays zero
    wz = torch.cat([w, w.new_zeros(lead + (1, B))], dim=-2)
    for Q, sd in zip(reversed(qs), reversed(sdevs)):
        zf = (Q @ (wz[..., sd["u1"], :] + cbz[..., sd["u2"], :])
              ).flatten(-3, -2)  # [(K,) F * rp, B]
        z[..., sd["r"], :] = zf[..., sd["fr"], :]
        cbz[..., sd["b"], :] = zf[..., sd["fb"], :]
    return z


def _r_plans(plan: QRMFPlan, kind: int):
    """The sweep schedule of R for usolve (kind 1) or utsolve (kind 3),
    from the pattern alone, cached on the plan."""
    from ..solve import tri_plan

    key = f"_rtri_{kind}"
    tp = plan.__dict__.get(key)
    if tp is None:
        rmat = Sprs(plan.rnz, plan.n, plan.n, plan.Rp, plan.Ri,
                    np.zeros(plan.rnz))
        tp = plan.__dict__[key] = tri_plan(rmat, kind)
    return tp


def _r_sweep(plan: QRMFPlan, X: torch.Tensor, kind: int,
             rv: torch.Tensor) -> torch.Tensor:
    """R⁻¹ X (kind 1) or R⁻ᵀ X (kind 3) for X [n, B] and R's values rv
    [rnz] (X [K, n, B] with rv [K, rnz]) on their device: one SpTRSV sweep
    (the CUDA kernel on a card)."""
    from ..ops.sptrsv_cuda import sptrsv_multi

    return sptrsv_multi(rv, X, _r_plans(plan, kind), kind)


def _factors(plan: QRMFPlan, factors, what: str):
    """(Q blocks, the factored values, R's values): `factors` when given
    (`_qr_mf_values` of K instances), else the last `qr_mf`'s, cached on
    the plan."""
    if factors is not None:
        qs, ax, rx = factors
        return qs, ax, rx[..., : plan.rnz]
    qs = plan.__dict__.get("_cache_q")
    if qs is None:
        raise RuntimeError(f"{what} requires a preceding qr_mf")
    return qs, plan.__dict__["_cache_ax"], plan.__dict__["_cache_rv"]


def _resid_pattern(plan: QRMFPlan, A: Sprs, device, cols=None):
    """(rows, colind, sel) of the factored matrix A on `device`: its entries
    with one per (row, col), the last stored (the values the fronts
    assembled), the column ids mapped through `cols` when given; cached."""

    def make():
        nz = A.nnz()
        rows = np.asarray(A.i[:nz], np.int64)
        ci = col_ids(A.p, A.n)
        sel = np.sort(_last_per_key(ci * np.int64(A.m) + rows))
        c = ci[sel] if cols is None else cols[ci[sel]]
        ix = lambda a_: torch.as_tensor(a_, device=device)
        return ix(rows[sel]), ix(c), ix(sel)

    return device_cache(plan, "_torch_resid_pattern", device, make)


def qrsol_mf_ls(a: Sprs, s: Symb, plan: QRMFPlan, b: np.ndarray,
                factors=None):
    """Least-squares solve (m >= n) on the tree of the last `qr_mf`:
    x = R⁻¹ (Qᵀ b)[:n], in the PERMUTED column order (the caller applies
    s.q). Returns (x, max|A'(b - Ax)|, max(1, max|A'b|)): the f64
    least-squares gradient and its scale, for the caller's gate. With
    `factors` (`_qr_mf_values` of K instances' values, and those values)
    b is [K, m] and each of the three is per instance ([K, n], [K], [K])."""
    from ..solve import _amax, _coo_amul

    qs, axf, rv = _factors(plan, factors, "qrsol_mf_ls")
    dev = rv.device
    # x lives in the permuted order: slot c holds original column q[c]
    q = (np.asarray(s.q, np.int64) if s.q is not None
         else np.arange(a.n, dtype=np.int64))
    jq = np.empty(a.n, np.int64)
    jq[q] = np.arange(a.n)
    ai, acol, sel = _resid_pattern(plan, a, dev, jq)
    ax = axf[..., sel]
    b64 = torch.as_tensor(np.asarray(b, np.float64), device=dev)[..., None]
    xp = _r_sweep(plan, _qt_apply(plan, b64, qs, _solve_dev(plan, dev)), 1,
                  rv)
    grad = _coo_amul(acol, ai, ax, a.n)  # A' r, in the permuted order
    r = b64 - _coo_amul(ai, acol, ax, a.m)(xp)
    g = _amax(torch.stack([grad(r), grad(b64)], dim=-3))  # [(K,) 2]
    gmax, gs = (g[0], g[1]) if np.ndim(g) == 1 else (g[:, 0], g[:, 1])
    return xp[..., 0].cpu().numpy(), gmax, np.maximum(1.0, gs)


def qrsol_mf_mn(at: Sprs, s: Symb, plan: QRMFPlan, b: np.ndarray,
                factors=None):
    """Minimum-norm solve through the tree of the last `qr_mf` of Aᵀ
    (reference underdetermined branch, src/lib.rs:943-955):
    x = Q [R⁻ᵀ b_q ; 0]. `plan` is the plan of Aᵀ (plan.m = A's n); b has
    plan.n values. Returns (x [plan.m] in original order, max|b - Ax|).
    With `factors` (as for `qrsol_mf_ls`) b is [K, plan.n], and both are
    per instance."""
    from ..solve import _amax, _coo_amul

    qs, axf, rv = _factors(plan, factors, "qrsol_mf_mn")
    dev = rv.device

    ati, acol, sel = _resid_pattern(plan, at, dev)
    ax = axf[..., sel]
    b64 = torch.as_tensor(np.asarray(b, np.float64), device=dev)[..., None]
    bq = (b64 if plan.q is None
          else b64[..., torch.as_tensor(plan.q, device=dev), :])
    x = _q_apply(plan, _r_sweep(plan, bq, 3, rv), qs, _solve_dev(plan, dev))
    # A = atᵀ: (A x)[c] = Σ over at's column c of at.x[k] x[at.i[k]]
    r = b64 - _coo_amul(acol, ati, ax, plan.n)(x)
    return x[..., 0].cpu().numpy(), _amax(r)
