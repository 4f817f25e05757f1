"""Wide fronts: a multifrontal skeleton factored as a tree of supernodes.

The subtree fronts of `frontal` take maximal subtrees of at most Smax
columns. Where the skeleton left over holds a supernode wider than that
(the dense separators at the top of a 3D elimination tree, hundreds of
columns each), peeling it a leaf layer at a time does not shrink it, and
the column machinery of `chol_device` meets it column by column. This
module plans such a skeleton as what it is: one dense front per supernode,
of the supernode's own width.

A supernode is a run of consecutive columns j..t with nested patterns
(parent[j] = j + 1 and count[j + 1] = count[j] - 1, from the analysis's
column counts): column j's rows are j..t and then B, the rows of column t
below its diagonal. Its front has m = w + |B| rows, S = j..t then B:

    F    = assembled entries + the children's updates     [m, m], lower
    Lss  = cholesky(F(S, S))
    Lbs  = F(B, S) Lss^{-T}
    U    = F(B, B) - Lbs Lbsᵀ, extend-added into the parent's front

Every front's F is a dense (m + 1) x (m + 1) block of one flat buffer; the
last row and column take nothing real, so a padded slot of a child's B
lands there. The caller assembles into the same buffer: the skeleton's
entries of C and the subtree fronts' Schur updates go straight to their
front's block (the `position` map of `build_front_tree`). Fronts are
factored a level (height in the tree) at a time, those of one level and
one padded shape (widths and row counts to the next power of two, padded
to the group's largest) in one set of batched dense operations: no loop
over columns or fronts on the host. The extend-add's destinations come from each B row's local row
in the parent's front (|B| integers a front), the rest from arithmetic on
the device.

Each group's L columns, [Lss; Lbs] with the padded slots, are written into
one dense store, and L's values in the skeleton's CSC order are one gather
from it. Solves run the fronts with the precomputed inverses Lss^{-1}, a
level at a time, forward then backward. Instances (values [K, size]) add a
leading dimension everywhere, as in `frontal`.

The dense arithmetic of a batch of fronts (`factor_fronts`) and its solve
phases (`fwd_front`, `bwd_front`) are the ones `frontal`'s subtree fronts
run too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops.plan import device_cache
from .chol_device import _pivot_min


def _pow2(x: np.ndarray) -> np.ndarray:
    """The next power of two of each x >= 1; 0 for 0."""
    x = np.asarray(x, np.int64)
    return np.where(x > 0, 1 << np.ceil(np.log2(np.maximum(x, 1))).astype(
        np.int64), 0)


def supernodes(parent: np.ndarray, count: np.ndarray) -> np.ndarray:
    """First column of each supernode (runs of columns with nested
    patterns), ascending; `count` holds L's column counts, diagonal
    included."""
    n = len(parent)
    j = np.arange(1, n)
    nested = (parent[j - 1] == j) & (count[j] == count[j - 1] - 1)
    return np.r_[0, j[~nested]] if n else np.zeros(0, np.int64)


def has_wide(parent: np.ndarray, count: np.ndarray, smax: int) -> bool:
    """Whether the tree has a supernode wider than smax columns (the
    subtree fronts' limit: no subtree front can hold it)."""
    first = supernodes(parent, count)
    widths = np.diff(np.r_[first, len(parent)])
    return bool(len(widths)) and int(widths.max()) > smax


@dataclasses.dataclass
class FrontGroup:
    """The fronts of one level with one padded shape: wp columns, bp rows
    below them. Each front's padded slots (m: its block's spare row) are
    the S slots past its width and the B slots past its row count."""

    wp: int
    bp: int
    off: np.ndarray  # [F] first entry of each front's block
    m: np.ndarray  # [F] rows of each front
    rows: np.ndarray  # [F, wp + bp] the front row of each slot (m: padded)
    poff: np.ndarray  # [F] the parent's block (0 for a root)
    pm: np.ndarray  # [F] the parent's rows
    rel: np.ndarray  # [F, bp] B slots' rows in the parent's front (pm: pad)
    srow: np.ndarray  # [F, wp] skeleton row of each S slot (n: padded)
    brow: np.ndarray  # [F, bp] skeleton row of each B slot (n: padded)
    base: int  # where the group's [F, wp + bp, wp] block starts in the store


@dataclasses.dataclass
class FrontTree:
    n: int
    lnz: int
    Lp: np.ndarray  # the skeleton L's column pointers
    size: int  # entries of the front buffer (every front's block)
    groups: List[FrontGroup]  # level by level, leaves first
    store: int  # entries of the dense store of L's columns
    lsrc: np.ndarray  # [lnz] each L entry's place in the store
    wide_cols: int  # columns in fronts wider than the subtree fronts' smax


Rows = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


def build_front_tree(parent: np.ndarray, Lp: np.ndarray, below: Rows,
                     smax: int
                     ) -> Tuple[FrontTree, Callable[[np.ndarray], np.ndarray]]:
    """The plan of a postordered system of n = len(parent) columns with L's
    column pointers Lp; `below(t)` gives the rows below the diagonal of
    the columns t, ascending per column (concatenated, and their counts);
    fronts wider than smax count as wide. Returns (plan, position):
    position(keys) maps C entries keyed col * n + row (row <= col, i.e.
    L(col, row)) to the front buffer."""
    n = len(parent)
    count = np.diff(Lp)
    first = supernodes(parent, count)
    S = len(first)
    w = np.diff(np.r_[first, n])
    top = first + w - 1
    brows, nb = below(top)
    assert np.array_equal(nb, count[top] - 1)
    m = w + nb
    sn_of = np.repeat(np.arange(S), w)
    boff = np.zeros(S + 1, np.int64)
    np.cumsum(nb, out=boff[1:])
    bkeys = np.repeat(np.arange(S), nb) * np.int64(n) + brows
    off = np.zeros(S + 1, np.int64)
    np.cumsum((m + 1) ** 2, out=off[1:])
    size = int(off[-1])

    def local(f, r):
        """The row of each r in front f's rows (S, then B)."""
        in_s = r <= top[f]
        k = np.searchsorted(bkeys, f * np.int64(n) + r) - boff[f]
        return np.where(in_s, r - first[f], w[f] + k)

    def position(keys):
        c, r = keys % n, keys // n  # L(r, c), r >= c
        f = sn_of[c]
        return off[f] + local(f, r) * (m[f] + 1) + (c - first[f])

    # each front's parent: the front of the first row below it
    par = np.full(S, -1, np.int64)
    has_b = nb > 0
    par[has_b] = sn_of[brows[boff[:-1][has_b]]]
    rel = local(np.repeat(par, nb), brows)  # B rows in the parent's front
    height = np.zeros(S, np.int64)
    for f in range(S):  # children come first in postorder
        if par[f] >= 0:
            height[par[f]] = max(height[par[f]], height[f] + 1)

    key = np.stack([height, _pow2(w), _pow2(nb)], 1)
    order = np.lexsort(key.T[::-1])
    cuts = np.r_[0, np.nonzero(np.any(np.diff(key[order], axis=0), 1))[0] + 1,
                 S]
    groups, base = [], 0
    grp_of = np.zeros(S, np.int64)
    slot_of = np.zeros(S, np.int64)
    for gi, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        fs = order[a:b]
        F, wp, bp = len(fs), int(w[fs].max()), int(nb[fs].max())
        grp_of[fs], slot_of[fs] = gi, np.arange(F)
        ks, js = np.arange(wp), np.arange(bp)
        sval = ks[None, :] < w[fs, None]
        bval = js[None, :] < nb[fs, None]
        bidx = np.where(bval, boff[fs, None] + js[None, :], 0)
        pf = np.maximum(par[fs], 0)
        groups.append(FrontGroup(
            wp=wp, bp=bp, off=off[fs], m=m[fs],
            rows=np.concatenate([np.where(sval, ks[None, :], m[fs, None]),
                                 np.where(bval, w[fs, None] + js[None, :],
                                          m[fs, None])], 1),
            poff=np.where(par[fs] >= 0, off[pf], 0),
            pm=np.where(par[fs] >= 0, m[pf], 0),
            rel=np.where(bval, rel[bidx] if len(rel) else 0, m[pf][:, None]),
            srow=np.where(sval, first[fs, None] + ks[None, :], n),
            brow=np.where(bval, brows[bidx] if len(brows) else 0, n),
            base=base))
        base += F * (wp + bp) * wp

    # L's entries in CSC order: column j = first[f] + k holds the front
    # rows k..m-1 of column k of its front's block
    lnz = int(Lp[n])
    f = sn_of
    k = np.arange(n) - first[f]
    g = grp_of[f]
    wp = np.array([gr.wp for gr in groups], np.int64)[g]
    mp = wp + np.array([gr.bp for gr in groups], np.int64)[g]
    gbase = np.array([gr.base for gr in groups], np.int64)[g]
    cnt = m[f] - k
    e = np.arange(lnz) - np.repeat(Lp[:-1], cnt)
    R = np.repeat(k, cnt) + e  # the front row
    wj = np.repeat(w[f], cnt)
    slot = np.where(R < wj, R, np.repeat(wp, cnt) + R - wj)
    lsrc = (np.repeat(gbase, cnt) + (np.repeat(slot_of[f] * mp, cnt) + slot)
            * np.repeat(wp, cnt) + np.repeat(k, cnt))
    plan = FrontTree(n=n, lnz=lnz, Lp=Lp, size=size, groups=groups,
                     store=base, lsrc=lsrc,
                     wide_cols=int(w[w > smax].sum()))
    return plan, position


def _groups_dev(plan: FrontTree, device) -> list:
    """Each group's index tensors on `device`, made once."""
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return device_cache(plan, "_torch_groups", device, lambda: [
        tuple(ix(getattr(gr, f)) for f in (
            "off", "m", "rows", "poff", "pm", "rel", "srow", "brow"))
        for gr in plan.groups])


def _lsrc_dev(plan: FrontTree, device) -> torch.Tensor:
    return device_cache(plan, "_torch_lsrc", device, lambda: torch.as_tensor(
        plan.lsrc, device=device))


def factor_fronts(Ass: torch.Tensor, Abs: torch.Tensor):
    """The dense arithmetic of a batch of fronts, Ass [(K,) F, s, s] (its
    padded slots identity pivots) and Abs [(K,) F, b, s]: Lss =
    cholesky(Ass), Lbs = Abs Lss^{-T}, the Schur product Lbs Lbsᵀ and
    Lss^{-1} (every solve application becomes one batched matmul).
    Returns (Lss, info, Lbs, Schur, Lss_inv)."""
    Lss, info = torch.linalg.cholesky_ex(Ass)
    # L_BS = A_BS Lss^{-T}: solve X Lss^T = A_BS
    Lbs = torch.linalg.solve_triangular(Lss.mT, Abs, upper=True, left=False)
    eye = torch.eye(Lss.shape[-1], dtype=Ass.dtype,
                    device=Ass.device).expand(Lss.shape)
    return (Lss, info, Lbs, Lbs @ Lbs.mT,
            torch.linalg.solve_triangular(Lss, eye, upper=False))


def fwd_front(X, Ds, Lss_inv, Lbs, srow, brow, alpha=1):
    """Forward front phase (in place): z_S = Lss^{-1} b_S into X's rows
    srow; alpha Lbs z added into Ds's rows brow. X: [(K,) n+1, B] (garbage
    row n); Ds: [(K,) m+1, B] (garbage row m; X itself for alpha = -1)."""
    zs = Lss_inv @ X[..., srow, :]  # [(K,) F, Sp, B]
    X[..., srow, :] = zs  # padded slots write row n
    Ds.index_add_(-2, brow.reshape(-1), (Lbs @ zs).flatten(-3, -2),
                  alpha=alpha)


def bwd_front(X, Lss_inv, Lbs, srow, brow):
    """Backward front phase (in place): x_S = Lss^{-T} (b_S - Lbsᵀ x_B).
    `brow` holds X's rows of the B slots (n = pad)."""
    X[..., srow, :] = Lss_inv.mT @ (X[..., srow, :] - Lbs.mT @ X[..., brow, :])


def tree_values(Fb: torch.Tensor, plan: FrontTree):
    """Factor the assembled front buffer Fb [(K,) size] (updated in place).
    Returns (Lx [(K,) lnz] in the skeleton's CSC order, smallest pivots,
    the solve's (Lss^{-1}, Lbs) of each group)."""
    lead = Fb.shape[:-1]
    store = Fb.new_zeros(lead + (plan.store,))
    dmins, vals = [], []
    for gr, (off, m, rows, poff, pm, rel, _, _) in zip(
            plan.groups, _groups_dev(plan, Fb.device)):
        F, wp, bp = len(gr.off), gr.wp, gr.bp
        mp = wp + bp
        idx = (off[:, None, None] + rows[:, :, None] * (m[:, None, None] + 1)
               + rows[:, None, :])
        real = rows < m[:, None]
        Fd = torch.where(real[:, :, None] & real[:, None, :], Fb[..., idx],
                         Fb.new_zeros(()))
        Fd = Fd.tril() + Fd.tril(-1).mT
        pad = torch.diag_embed((~real[:, :wp]).to(Fb.dtype))
        Lss, info, Lbs, schur, Lss_inv = factor_fronts(
            Fd[..., :wp, :wp] + pad, Fd[..., wp:, :wp])
        diag = torch.diagonal(Lss, dim1=-2, dim2=-1)
        dmins.append(_pivot_min(info, torch.where(
            real[:, :wp], diag, torch.inf).flatten(-2)))
        blk = store[..., gr.base: gr.base + F * mp * wp].unflatten(
            -1, (F, mp, wp))
        blk[..., :wp, :] = Lss
        blk[..., wp:, :] = Lbs
        if bp:
            dst = (poff[:, None, None]
                   + rel[:, :, None] * (pm[:, None, None] + 1)
                   + rel[:, None, :])
            Fb.index_add_(-1, dst.flatten(),
                          (Fd[..., wp:, wp:] - schur).flatten(-3))
        vals.append((Lss_inv, Lbs))
    return store[..., _lsrc_dev(plan, Fb.device)], dmins, vals


def tree_solve(plan: FrontTree, X: torch.Tensor, vals) -> torch.Tensor:
    """L'^{-1} L^{-1} X for X [(K,) n, B], with `tree_values`' vals."""
    groups = _groups_dev(plan, X.device)
    lead, B = X.shape[:-2], X.shape[-1]
    Xd = torch.cat([X, X.new_zeros(lead + (1, B))], dim=-2)  # row n: padding
    for (Lss_inv, Lbs), (*_, srow, brow) in zip(vals, groups):
        fwd_front(Xd, Xd, Lss_inv, Lbs, srow, brow, alpha=-1)
    for (Lss_inv, Lbs), (*_, srow, brow) in zip(reversed(vals),
                                                reversed(groups)):
        bwd_front(Xd, Lss_inv, Lbs, srow, brow)
    return Xd[..., : plan.n, :]
