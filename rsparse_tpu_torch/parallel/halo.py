"""Halo-exchange distributed kernels: sharded x over a 1-D row partition.

The port of `rsparse_tpu.parallel.halo` to `torch.distributed`. The
replicated layer (`parallel/__init__.py`) keeps x whole on every rank and
all-reduces full vectors; here x, b and r are SHARDED over the mesh axis
(nb = ceil(n/d) entries per rank), matrix entries are partitioned by row
block, and each SpMV/SpTRSV exchanges only whole boundary shards of x with
the ranks up to `hops` away on the ring (point-to-point sends).

  x_ext = [left halo | own shard | right halo]     (ring exchange)
  r_own = index_add(vals * x_ext[cols_local], rows_local)   (no reduction)

The ring is cyclic, as the JAX package's: rank 0's left halo is rank
d - 1's shard, and the extended coordinates are relative to (rank - hops)
* nb either way.

For triangular solves the level schedule is fused into blocks of at most
`kfuse` levels: one halo exchange serves the whole block, and a block ends
where a level reads across shards a value that an earlier level of the
same block wrote. With prefetch the next block's full exchange is posted
(asynchronous point-to-point) before the block's levels and waited for at
the next block's head, where an F-wide exchange of the segments the block
wrote brings it up to date.

`dist_lusol`, `dist_qrsol` (and `parallel.dist_cholsol`) factor on every
rank's device with the port's `lu`/`chol` and run both sweeps here on the
factor's device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data import Sprs
from ..ops.plan import col_ids, device_cache
from . import (_all_gather, _device, _host, _index, _on,
               _ring_finish, _ring_start, _size)

__all__ = [
    "RowPartition", "partition_rows", "make_gaxpy_halo", "dist_gaxpy_halo",
    "HaloTriPlan", "halo_tri_plan", "dist_tri_solve_halo", "dist_lusol",
    "dist_qrsol",
]


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Row-block partition of a CSC matrix with halo-remapped columns.

    Entries are grouped by owner (row // nb); within each rank the column
    indices are remapped into the extended-vector coordinate system
    [left halo (hops*nb) | own shard (nb) | right halo (hops*nb)].
    """

    m: int
    n: int
    d: int  # ranks
    nb: int  # shard length (rows/x entries per rank)
    hops: int  # halo width in shards on each side
    chunk: int  # entries per rank (padded)
    vals: np.ndarray  # [d*chunk]
    rows: np.ndarray  # [d*chunk] row - own_base (local row)
    cols: np.ndarray  # [d*chunk] extended-coordinate column
    perm: np.ndarray  # original entry -> padded position (value refresh)


def partition_rows(a: Sprs, n_shards: int,
                   hops: Optional[int] = None) -> Optional[RowPartition]:
    """Build the sharded partition; None if the pattern needs halos wider
    than (d-1) shards (caller should use the replication layer instead)."""
    if a.m != a.n:
        return None
    n = a.n
    d = n_shards
    nb = -(-n // d)
    nz = a.nnz()
    rows = a.i[:nz].astype(np.int64)
    cols = col_ids(a.p, n)
    owner = rows // nb
    need = int(np.abs(cols // nb - owner).max()) if nz else 0
    h = need if hops is None else max(hops, need)
    h = min(h, d - 1)
    if need > h:
        return None
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=d)
    chunk = max(1, int(counts.max()))
    off = np.zeros(d + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    own = owner[order]
    dst = own * chunk + np.arange(nz) - off[own]  # padded slot of each entry
    v = np.zeros(d * chunk, a.x.dtype)
    rl = np.full(d * chunk, nb, np.int32)  # pad rows scatter to slot nb
    cl = np.zeros(d * chunk, np.int32)
    v[dst] = a.x[:nz][order]
    rl[dst] = rows[order] - own * nb
    cl[dst] = cols[order] - (own - h) * nb
    perm = np.zeros(nz, np.int64)
    perm[order] = dst
    return RowPartition(m=a.m, n=n, d=d, nb=nb, hops=h, chunk=chunk,
                        vals=v, rows=rl, cols=cl, perm=perm)


def _halo_exchange(x_own: torch.Tensor, hops: int, mesh, axis: str):
    """[left halos | own | right halos], [(2*hops+1)*nb], by one ring
    exchange of whole shards."""
    left, right = _ring_finish(_ring_start(x_own, hops, mesh, axis))
    return torch.cat(left + [x_own] + right)


def _check_d(d: int, mesh, axis: str) -> None:
    if d != _size(mesh, axis):
        raise ValueError(f"the partition has {d} shards, the mesh axis "
                         f"{axis!r} has {_size(mesh, axis)} ranks")


def make_gaxpy_halo(rp: RowPartition, mesh, axis: str = "model"):
    """The sharded r = A@x + y of a partition on `mesh`.

    Returns `f(vals, rows, cols, x_own, y_own) -> r_own`: vals/rows/cols
    the partition's [d*chunk] arrays (each rank takes its block), x_own
    and y_own this rank's [nb] shards; r_own [nb] on the rank's device.
    Per-rank memory is nb (plus the halo window); the only communication
    is one ring exchange of `hops` shards each way."""
    _check_d(rp.d, mesh, axis)
    dev = _device(mesh)
    nb, hops = rp.nb, rp.hops
    k = _index(mesh, axis)
    sl = slice(k * rp.chunk, (k + 1) * rp.chunk)

    def f(vals, rows, cols, x_own, y_own):
        xe = _halo_exchange(_on(x_own, dev), hops, mesh, axis)
        g = xe[_on(cols[sl], dev, torch.int64)]
        r = g.new_zeros(nb + 1).index_add_(
            0, _on(rows[sl], dev, torch.int64), _on(vals[sl], dev) * g)
        return r[:nb] + _on(y_own, dev, g.dtype)

    return f


def _shard_vec(v: np.ndarray, rp, mesh, axis: str) -> torch.Tensor:
    """This rank's [nb] shard of a host vector (zero-padded to d*nb) on
    the rank's device."""
    k = _index(mesh, axis)
    out = np.zeros(rp.nb, v.dtype)
    own = v[k * rp.nb: (k + 1) * rp.nb]
    out[: len(own)] = own
    return _on(out, _device(mesh))


def _fetch(r_own: torch.Tensor, n: int, mesh, axis: str) -> np.ndarray:
    """The ranks' shards assembled into the host vector [n] (every rank)."""
    return _all_gather(r_own, mesh, axis).cpu().numpy()[:n]


def dist_gaxpy_halo(rp: RowPartition, x, y, mesh,
                    axis: str = "model") -> np.ndarray:
    """One-shot sharded r = A@x + y: x, y logical [n] host vectors; returns
    the assembled [n] result as a host array (on every rank)."""
    fn = make_gaxpy_halo(rp, mesh, axis)
    xs = _shard_vec(np.asarray(x, rp.vals.dtype), rp, mesh, axis)
    ys = _shard_vec(np.asarray(y, rp.vals.dtype), rp, mesh, axis)
    return _fetch(fn(rp.vals, rp.rows, rp.cols, xs, ys), rp.m, mesh, axis)


# ---------------------------------------------------------------------------
# Halo-sharded level-scheduled SpTRSV
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloTriPlan:
    """Level schedule with entries row-sharded and levels fused into blocks
    of at most `kfuse` levels per halo exchange.

    Each rank's columns and entries are kept flat, grouped by (rank,
    level) with offsets into them (`c_off`, `e_off` [d*nlev + 1], window
    rank*nlev + level): the sweep reads its windows through them, where
    the JAX package pads each window to `wmax` / `emax` (`col_loc`,
    `col_diag`, `ent_pos`, `ent_row`, `ent_col`, `ent_div` [d, nlev, w])
    for XLA's static shapes."""

    n: int
    d: int
    nb: int
    hops: int
    nlev: int
    kfuse: int
    nblocks: int
    wmax: int  # max columns (per rank) per level
    emax: int  # max off-diag entries (per rank) per level
    scatter_form: bool
    blocks: np.ndarray  # [nlev] block of each level (nondecreasing)
    c_off: np.ndarray  # [d*nlev + 1]
    c_loc: np.ndarray  # each window's columns, ascending (local index)
    c_diag: np.ndarray  # their diagonal positions in T.x
    e_off: np.ndarray  # [d*nlev + 1]
    # off-diagonal entries whose ROW (scatter form) or COLUMN (gather
    # form) the rank owns, in T.x order per window:
    e_pos: np.ndarray  # positions in T.x
    e_row: np.ndarray  # local row (scatter) / local column (gather)
    e_col: np.ndarray  # extended coordinate of the value read
    # scatter form only: diag position of the entry's column when the read
    # crosses shards (-1 local). Remote halo values are pre-division
    # snapshots; dividing locally by the REPLICATED factor diagonal
    # reproduces the owner's same-level division ("diag trick").
    e_div: np.ndarray


def _fuse(src_lev_max: np.ndarray, kfuse: int) -> np.ndarray:
    """Block of each level: a level starts a new block after kfuse levels,
    or when one of its cross-shard reads was last written inside the
    current block."""
    blocks = np.zeros(len(src_lev_max), dtype=np.int64)
    bstart = bid = 0
    for L, s in enumerate(src_lev_max.tolist()):
        if L > bstart and (L - bstart >= kfuse or s >= bstart):
            bid += 1
            bstart = L
        blocks[L] = bid
    return blocks


def _grouped(key: np.ndarray, nwin: int):
    """(stable order by key, offsets [nwin + 1], largest window >= 1)."""
    order = np.argsort(key, kind="stable")
    cnt = np.bincount(key, minlength=nwin)
    off = np.zeros(nwin + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    return order, off, max(1, int(cnt.max()) if len(cnt) else 1)


def halo_tri_plan(t: Sprs, kind: int, n_shards: int,
                  kfuse: int = 8) -> Optional[HaloTriPlan]:
    """kind: 0=lsolve, 1=usolve (scatter), 2=ltsolve, 3=utsolve (gather).

    Returns None when the pattern's halo exceeds the ring (use the
    replication layer). Fusion correctness: a cross-shard read at level L
    comes from the halo snapshot taken at its block's head, so every level
    that last WROTE that value must precede the block. The gather form
    (kinds 2/3) reads x[row], final at lev[row]; the scatter form (kinds
    0/1) reads x[col] at L = lev[col] after all UPDATES to it, which land
    at the levels of the entries in row col (their maximum gates the
    block), while the same-level division is reproduced locally from the
    replicated factor diagonal (the "diag trick"). Vectorised over the
    entries (the JAX package walks them in Python); the fields equal its
    plan's."""
    from ..symbolic import native

    n = t.n
    d = n_shards
    nb = -(-n // d)
    nz = t.nnz()
    rows = t.i[:nz].astype(np.int64)
    cols = col_ids(t.p, n)
    hops = int(np.abs(cols // nb - rows // nb).max()) if nz else 0
    if hops > d - 1:
        return None
    lev = native.tri_levels(n, t.p, t.i[:nz], kind)
    nlev = int(lev.max()) + 1 if n else 1
    lower_diag = kind in (0, 2)
    diag_pos = np.asarray(t.p[:-1] if lower_diag else t.p[1:] - 1, np.int64)
    scatter = kind in (0, 1)

    offd = np.ones(nz, dtype=bool)
    offd[diag_pos] = False
    pos = np.nonzero(offd)[0]
    ecols, erows = cols[offd], rows[offd]
    elev = lev[ecols]
    cross = (ecols // nb) != (erows // nb)
    if scatter:
        upd_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(upd_max, erows, elev)
        e_src = upd_max[ecols]
    else:
        e_src = lev[erows]
    src_lev_max = np.full(nlev, -1, dtype=np.int64)
    np.maximum.at(src_lev_max, elev[cross], e_src[cross])
    blocks = _fuse(src_lev_max, kfuse)

    j = np.arange(n, dtype=np.int64)
    corder, c_off, wmax = _grouped((j // nb) * nlev + lev, d * nlev)
    cj = j[corder]
    own = (erows if scatter else ecols) // nb
    eorder, e_off, emax = _grouped(own * nlev + elev, d * nlev)
    own, pos, er, ec = own[eorder], pos[eorder], erows[eorder], ecols[eorder]
    if scatter:
        e_row, e_col = er - own * nb, ec - (own - hops) * nb
        e_div = np.where(ec // nb != own, diag_pos[ec], -1)
    else:
        e_row, e_col = ec - own * nb, er - (own - hops) * nb
        e_div = np.full(len(pos), -1, dtype=np.int64)
    return HaloTriPlan(
        n=n, d=d, nb=nb, hops=hops, nlev=nlev, kfuse=kfuse,
        nblocks=int(blocks[-1]) + 1 if nlev else 1, wmax=wmax, emax=emax,
        scatter_form=scatter, blocks=blocks,
        c_off=c_off, c_loc=cj - (cj // nb) * nb, c_diag=diag_pos[cj],
        e_off=e_off, e_pos=pos, e_row=e_row, e_col=e_col, e_div=e_div)


def _block_tables(p: HaloTriPlan):
    """The prefetch path's fresh-patch bounds: per (rank, block) the range
    of OWN positions the block writes (its levels' columns; plus the rows
    its entries update in scatter form), F the widest of them (at least
    1) and flo [d, nblocks] each range's start, moved left so that
    flo + F <= nb. The JAX package's rule, quirks included (a block that
    writes no column starts its range at 0). Returns (flo, F), cached."""
    bt = p.__dict__.get("_blocked")
    if bt is not None:
        return bt
    d, NB, nlev, nb = p.d, p.nblocks, p.nlev, p.nb
    win = lambda off: np.repeat(np.arange(d * nlev), np.diff(off))
    wc = win(p.c_off)
    kb_c = (wc // nlev) * NB + p.blocks[wc % nlev]  # (rank, block) per column
    lo = np.full(d * NB, nb, dtype=np.int64)
    hi = np.full(d * NB, -1, dtype=np.int64)
    np.minimum.at(lo, kb_c, p.c_loc)
    np.maximum.at(hi, kb_c, p.c_loc)
    m_any = np.bincount(kb_c, minlength=d * NB) > 0
    lo = np.where(m_any, lo, 0)
    hi = np.where(m_any, hi + 1, 0)
    if p.scatter_form:
        we = win(p.e_off)
        kb_e = (we // nlev) * NB + p.blocks[we % nlev]
        lo_e = np.full(d * NB, nb, dtype=np.int64)
        hi_e = np.full(d * NB, -1, dtype=np.int64)
        np.minimum.at(lo_e, kb_e, p.e_row)
        np.maximum.at(hi_e, kb_e, p.e_row)
        e_any = np.bincount(kb_e, minlength=d * NB) > 0
        lo = np.where(e_any, np.minimum(lo, lo_e), lo)
        hi = np.where(e_any, np.maximum(hi, hi_e + 1), hi)
    F = max(1, int((hi - lo).max()))
    flo = np.minimum(lo, nb - F).clip(min=0).astype(np.int32).reshape(d, NB)
    bt = p.__dict__["_blocked"] = (flo, F)
    return bt


def _rank_tables(p: HaloTriPlan, k: int, dev: torch.device):
    """Rank k's sweep tables on dev (cached on the plan), int64 tensors:
    its columns (local index, diagonal position) and its entries (position,
    extended column, diag position) with each level's entries grouped by
    their target (the local row in scatter form, the local column in
    gather form), stably; each target's run length and the target itself;
    and the host offsets of each level's columns, entries and runs. A level
    sums each target's terms with one `segment_reduce` in a fixed order
    and adds the sum once, so a sweep gives the same x from run to run (a
    float `index_add_` of repeated targets on a card does not), and the
    prefetch and blocking sweeps stay bit-equal."""
    def build():
        nl = p.nlev
        c0, c1 = int(p.c_off[k * nl]), int(p.c_off[(k + 1) * nl])
        e0, e1 = int(p.e_off[k * nl]), int(p.e_off[(k + 1) * nl])
        ix = lambda v: _on(np.asarray(v, np.int64), dev)
        coff = p.c_off[k * nl: (k + 1) * nl + 1] - c0
        eoff = p.e_off[k * nl: (k + 1) * nl + 1] - e0
        lvl = np.repeat(np.arange(nl), np.diff(eoff))
        tgt = p.e_row[e0:e1]
        order = np.lexsort((tgt, lvl)) + e0
        key = lvl * (p.nb + 1) + tgt[order - e0]
        first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(
            key) else np.zeros(0, np.int64)
        runs = np.diff(np.r_[first, len(key)])
        soff = np.searchsorted(lvl[first], np.arange(nl + 1))
        return (ix(p.c_loc[c0:c1]), ix(p.c_diag[c0:c1]), ix(p.e_pos[order]),
                ix(p.e_col[order]), ix(np.maximum(p.e_div[order], 0)),
                _on(p.e_div[order] >= 0, dev), ix(p.e_row[order][first]),
                ix(runs), coff, eoff, soff)
    return device_cache(p, f"_rank{k}", dev, build)


def make_tri_solve_halo(p: HaloTriPlan, mesh, axis: str = "model",
                        prefetch: bool = True):
    """The sharded triangular solve of a plan on `mesh`: `f(tx, x_own) ->
    x_own` solves this rank's [nb] shard (tx the factor's values on the
    rank's device). One halo exchange per fused level block; each rank's
    own segment of the extended vector is its shard itself, so a level
    always reads its own latest values.

    prefetch=True (comm/compute overlap): the FULL halo exchange for block
    b+1 is posted at the START of block b, before its levels (it sends a
    snapshot of the shard, so nothing the levels write races it), and
    waited for at block b+1's head, where only an F-wide "fresh" segment
    (the static range each rank wrote in block b, `_block_tables`) is
    exchanged on the critical path: snapshot(start of b) + writes during b
    == snapshot(start of b+1), exactly what prefetch=False exchanges at
    every block head, so both give bit-equal x."""
    _check_d(p.d, mesh, axis)
    nb, hops, d = p.nb, p.hops, p.d
    k = _index(mesh, axis)
    flo, F = _block_tables(p)
    bstart = np.searchsorted(p.blocks, np.arange(p.nblocks + 1))

    def put(xe, left, right, starts_l=None, starts_r=None):
        """Write halo segments into xe: left[i] holds the rank hops - i
        to the left, right[i] the rank i + 1 to the right; a segment lands
        at its shard's start, or at starts_*[i] within it."""
        for i, seg in enumerate(left):
            s = i * nb + (0 if starts_l is None else starts_l[i])
            xe[s: s + len(seg)] = seg
        for i, seg in enumerate(right):
            s = (hops + 1 + i) * nb + (0 if starts_r is None else starts_r[i])
            xe[s: s + len(seg)] = seg

    def f(tx, x_own):
        dev = x_own.device
        (cl, cd, epos, ecol, ediv, ecross, tgt, runs, coff, eoff,
         soff) = _rank_tables(p, k, dev)
        tx = _on(tx, dev)
        xe = x_own.new_zeros((2 * hops + 1) * nb)
        xp = xe[hops * nb: (hops + 1) * nb]
        xp.copy_(x_own)
        dv = tx[cd].to(xe.dtype)
        ev = tx[epos].to(xe.dtype)
        if p.scatter_form:
            dvd = torch.where(ecross, tx[ediv].to(xe.dtype),
                              torch.ones((), dtype=xe.dtype, device=dev))
        if prefetch:
            pend = _ring_start(xp.clone(), hops, mesh, axis)
            fseg, flo_prev = xp[:F].clone(), np.zeros(d, dtype=np.int64)
        for b in range(p.nblocks):
            if prefetch:
                put(xe, *_ring_finish(pend))
                left, right = _ring_finish(_ring_start(fseg, hops, mesh, axis))
                put(xe, left, right,
                    [flo_prev[(k - hops + i) % d] for i in range(hops)],
                    [flo_prev[(k + 1 + i) % d] for i in range(hops)])
                pend = _ring_start(xp.clone(), hops, mesh, axis)
            else:
                put(xe, *_ring_finish(_ring_start(xp, hops, mesh, axis)))
            for L in range(int(bstart[b]), int(bstart[b + 1])):
                c0, c1 = int(coff[L]), int(coff[L + 1])
                e0, e1 = int(eoff[L]), int(eoff[L + 1])
                s0, s1 = int(soff[L]), int(soff[L + 1])
                c = cl[c0:c1]
                if p.scatter_form:
                    xp[c] = xp[c] / dv[c0:c1]
                if e1 > e0:
                    terms = ev[e0:e1] * xe[ecol[e0:e1]]
                    if p.scatter_form:
                        terms = terms / dvd[e0:e1]
                    sums = torch.segment_reduce(
                        terms[:, None], "sum", lengths=runs[s0:s1],
                        unsafe=True)[:, 0]
                if p.scatter_form:
                    if e1 > e0:
                        xp.index_add_(0, tgt[s0:s1], -sums)
                else:
                    acc = xp.new_zeros(nb)
                    if e1 > e0:
                        acc[tgt[s0:s1]] = sums
                    xp[c] = (xp[c] - acc[c]) / dv[c0:c1]
            if prefetch:
                fl = int(flo[k, b])
                fseg, flo_prev = xp[fl: fl + F].clone(), flo[:, b]
        if prefetch:
            _ring_finish(pend)
        return xp.clone()

    return f


def dist_tri_solve_halo(t: Sprs, x, kind: int, mesh, axis: str = "model",
                        plan: Optional[HaloTriPlan] = None,
                        prefetch: bool = True, *,
                        tx: Optional[torch.Tensor] = None):
    """Sharded-x level-scheduled triangular solve (halo design). Returns x
    as a host array [n] (every rank). When the pattern's halo exceeds the
    ring (`halo_tri_plan` returns None) it runs the replicated
    `dist_tri_solve` and returns its tensor, as the JAX package does;
    `dist_tri_solve_halo.routes` counts the calls per route ("halo",
    "replicated"). `tx`: t's values on the rank's device (a
    factorization's `device_values`), else t.x is uploaded."""
    D = _size(mesh, axis)
    p = plan or halo_tri_plan(t, kind, D)
    if p is None:
        from . import dist_tri_solve

        dist_tri_solve_halo.routes["replicated"] += 1
        return dist_tri_solve(t, x, kind, mesh, axis, tx=tx)
    dist_tri_solve_halo.routes["halo"] += 1
    fn = make_tri_solve_halo(p, mesh, axis, prefetch=prefetch)
    xs = _shard_vec(np.asarray(x, np.float64), p, mesh, axis)
    out = fn(t.x[: t.nnz()] if tx is None else tx, xs)
    return _fetch(out, t.n, mesh, axis)


dist_tri_solve_halo.routes = {"halo": 0, "replicated": 0}


def dist_qrsol(a: Sprs, b, mesh, order: int = 2, axis: str = "model",
               refine: int = 2) -> np.ndarray:
    """Distributed least-squares / minimum-norm solve via corrected
    seminormal equations: R from the Cholesky of AᵀA (or AAᵀ) on every
    rank's device, both triangular sweeps as halo-sharded SPMD solves,
    `refine` f64 refinement steps on the residuals (`gaxpy` on the
    rank's device). The single-process `qrsol` keeps exact Householder
    semantics; this is the multi-rank serving path (the same solutions
    for the well-conditioned systems CSNE with refinement covers)."""
    from .. import ops
    from ..factor import chol, device_values
    from ..symbolic import schol

    dev = _device(mesh)
    m, n = a.m, a.n
    bb = np.asarray(b, dtype=np.float64)
    at = ops.transpose(a, device=dev)
    g = ops.multiply(at, a, device=dev) if m >= n else ops.multiply(
        a, at, device=dev)
    s = schol(g, order)
    nm = chol(g, s, device=dev)
    lmat = nm.l
    lx = device_values(nm, "l", dev)
    pinv = np.asarray(s.pinv, dtype=np.int64) if s.pinv is not None else None
    k = g.n
    D = _size(mesh, axis)
    p0 = halo_tri_plan(lmat, 0, D)
    p2 = halo_tri_plan(lmat, 2, D)
    gx = lambda mat, v, rows: np.asarray(ops.gaxpy(mat, list(v), [0.0] * rows,
                                                   device=dev))

    def spd_solve(r):
        z = np.zeros(k)
        if pinv is not None:
            z[pinv] = r
        else:
            z[:] = r
        z = _host(dist_tri_solve_halo(lmat, z, 0, mesh, axis, plan=p0, tx=lx))
        z = _host(dist_tri_solve_halo(lmat, z, 2, mesh, axis, plan=p2, tx=lx))
        return z[pinv] if pinv is not None else z

    if m >= n:
        x = spd_solve(gx(at, bb, n))
        for _ in range(max(0, refine)):
            r = bb - gx(a, x, m)
            x = x + spd_solve(gx(at, r, n))
        return x
    y = spd_solve(bb)
    x = gx(at, y, n)
    for _ in range(max(0, refine)):
        r = bb - gx(a, x, m)
        x = x + gx(at, spd_solve(r), n)
    return x


def dist_lusol(a: Sprs, b, mesh, order: int = 1, tol: float = 1e-6,
               axis: str = "model") -> np.ndarray:
    """Distributed A\\b via LU: `sqr` and the port's `lu` (multifrontal
    with threshold pivoting at or above `config.mf_min_n`) on every rank's
    device, then both triangular sweeps as halo-sharded SPMD solves on the
    factors' device copies. Semantics match single-process `lusol`
    (reference src/lib.rs:672-683). Returns x as a host array; a
    non-square A raises ValueError before the mesh is read."""
    from .. import ops
    from ..factor import device_values, lu, require_square
    from ..symbolic import sqr

    require_square(a, "dist_lusol")
    dev = _device(mesh)
    n = a.n
    s = sqr(a, order, False)
    nm = lu(a, s, tol, device=dev)
    bb = np.asarray(b, dtype=np.float64)
    x = np.zeros(n)
    ops.ipvec(n, nm.pinv, bb, x)
    x = _host(dist_tri_solve_halo(nm.l, x, 0, mesh, axis,
                                  tx=device_values(nm, "l", dev)))
    x = _host(dist_tri_solve_halo(nm.u, x, 1, mesh, axis,
                                  tx=device_values(nm, "u", dev)))
    out = np.zeros(n)
    ops.ipvec(n, s.q, x, out)
    return out
