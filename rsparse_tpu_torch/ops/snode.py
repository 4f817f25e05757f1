"""The supernodal schedule of a lower triangular factor, for the sweep
kernel's "supernodal" variant (`ops.sptrsv_cuda`, `csrc/sptrsv.cu`).

`snode_panels(n, p, i)` reads the pattern of L (CSC, the diagonal the
first entry of each column) and returns its `Panels`, or None when the
pattern lacks what the schedule relies on; `snode_schedule(panels, kind)`
orders them for one sweep kind. Both are vectorized numpy over columns,
entries, panels or tree levels; nothing loops over panels in Python.

  - Panels: runs of consecutive columns with nested patterns (column j's
    rows below itself are j+1 and then exactly column j+1's rows), at most
    PANEL columns each: the fundamental supernodes, cut into panels. A
    panel is a dense block: its triangle over its own columns, then the
    rows below it, the same rows for each of its columns.
  - The panel tree: a panel's parent is the panel holding the first row
    below it. The pattern must be closed along it (the rows below a
    column's parent lie in the parent's column, as in a Cholesky factor),
    so every row a panel touches belongs to an ancestor: in the forward
    solve (kind 0, L x = b) a panel needs only its children finished, in
    the transposed one (kind 2, L' x = b) only its parent.
  - Tasks: each bottom subtree of at most TASK_ENTRIES entries is one task,
    its panels in levels by depth (the deepest first for kind 0, the top
    first for kind 2); every panel above those subtrees is a task of its
    own. Tasks come in ticket order, a topological one (kind 0: the
    subtrees, which wait on nothing, then the deepest task first; kind 2:
    the shallowest first), so that a task only ever waits on tasks handed
    out before it.
  - Parts: a panel above the subtrees is a group of tasks, each taking at
    most PART_ROWS of its rows below, so that more CTAs share the long
    chain of panels near the root. In kind 0 each part solves the triangle
    and applies it to its rows, and the last part to arrive stores it; in
    kind 2 each part adds its rows' partial sums to the group's
    accumulator, and the last to arrive solves the triangle and stores.
  - Dependencies: in kind 0 a group's tasks wait on its counter until each
    task of each child group has added one, then add one to the parent
    group's; in kind 2 a task waits until its parent group's counter has
    risen by one, and a group with children adds one to its own when done.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

PANEL = 32  # most columns in a panel (csrc/sptrsv.cu kSnWidth)
TASK_ENTRIES = 8192  # most factor entries in a bottom-subtree task
PART_ROWS = 64  # most rows below a panel one task applies (forward sweep)
VEC = 4  # a block row's stride is a multiple of VEC values (vector loads)


@dataclasses.dataclass(frozen=True)
class Panels:
    """The panels of one lower triangle and its bottom-subtree tasks, for
    either sweep kind.

    Panel s: columns pf[s] .. pf[s]+pw[s]-1; the pm[s] rows below them are
    prow[prow_off[s]:prow_off[s]+pm[s]] (ascending). Its block of values
    sits at pval_off[s] in the packed values, row-major, pw + pm rows of
    pw rounded up to VEC values: first the triangle (row i holds
    L[pf+i, pf .. pf+i], the diagonal last, zeros after it), then one row
    for each row below. `vslot`/`vpos`: every entry's slot in the packed
    values and its position in T.x."""

    n: int
    pf: np.ndarray  # int32 [npanel]
    pw: np.ndarray  # int32 [npanel]
    pm: np.ndarray  # int32 [npanel]
    prow_off: np.ndarray  # int32 [npanel]
    prow: np.ndarray  # int32 [sum pm]
    pval_off: np.ndarray  # int32 [npanel]
    val_total: int
    vslot: np.ndarray  # int32 [nnz(L)]
    vpos: np.ndarray  # int32 [nnz(L)]
    pparent: np.ndarray  # int64 [npanel], -1 at a root
    depth: np.ndarray  # int64 [npanel]: ancestors in the panel tree
    height: int  # panels on the tree's longest path: the sweep's chain
    root: np.ndarray  # int64 [npanel]: the top panel of its task
    subtree: np.ndarray  # bool [npanel]: in a bottom-subtree task

    @property
    def npanel(self) -> int:
        return len(self.pf)


@dataclasses.dataclass(frozen=True)
class SnodePlan:
    """`Panels` in one sweep kind's ticket order. Group g = 0..ngroup-1 (a
    bottom subtree, or a panel above them) runs the levels task_lvl[g] ..
    task_lvl[g+1]-1, level l the panels pan[lvl_pan[l]:lvl_pan[l+1]]. Task
    t = 0..ntask-1 is part part[t] of nparts[t] of group grp[t]: a panel
    above the subtrees shares its rows below among parts of at most
    PART_ROWS rows, each a task; a bottom subtree is one task. Before task
    t starts, counter wait[t] (a group, -1: none) must have risen by
    need[t] in the launch; when it ends it adds one to counter signal[t]
    (a group, -1: none): in kind 2, only the group's last part to end."""

    kind: int
    panels: Panels
    task_lvl: np.ndarray  # int32 [ngroup + 1]
    lvl_pan: np.ndarray  # int32 [nlevel + 1]
    pan: np.ndarray  # int32 [npanel]: panels in group and level order
    grp: np.ndarray  # int32 [ntask]
    part: np.ndarray  # int32 [ntask]
    nparts: np.ndarray  # int32 [ntask]
    wait: np.ndarray  # int32 [ntask]
    need: np.ndarray  # int32 [ntask]
    signal: np.ndarray  # int32 [ntask]

    @property
    def ngroup(self) -> int:
        return len(self.task_lvl) - 1

    @property
    def ntask(self) -> int:
        return len(self.grp)


def _seg_arange(lens: np.ndarray) -> np.ndarray:
    """0..len-1 for each length, concatenated."""
    starts = np.cumsum(lens) - lens
    return np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)


def _depth(par: np.ndarray) -> np.ndarray:
    """Each node's number of ancestors (par: -1 at a root), by pointer
    jumping: log2(height) vector passes."""
    dist = (par >= 0).astype(np.int64)
    nxt = par.astype(np.int64)
    while True:
        live = np.flatnonzero(nxt >= 0)
        if not len(live):
            return dist
        up = nxt[live]
        dist[live] += dist[up]
        nxt[live] = nxt[up]


def _root_of(par: np.ndarray, stop: np.ndarray) -> np.ndarray:
    """Each node's nearest ancestor-or-self with `stop` set (pointer
    jumping; every root of the tree must have it set)."""
    tgt = np.where(stop, np.arange(len(par)), par).astype(np.int64)
    while True:
        nxt = tgt[tgt]
        if np.array_equal(nxt, tgt):
            return tgt
        tgt = nxt


def snode_panels(n: int, p: np.ndarray, i: np.ndarray,
                 task_entries: Optional[int] = None) -> Optional[Panels]:
    """The panels and bottom-subtree tasks (of at most `task_entries`
    entries, TASK_ENTRIES when None) of the lower triangle (n, p, i); None
    for a pattern whose diagonal is not the first entry of every column,
    with duplicate or upper entries, not closed along its panel tree, or
    too large for 32-bit offsets."""
    if n < 1:
        return None
    task_entries = TASK_ENTRIES if task_entries is None else task_entries
    p = np.asarray(p[: n + 1], np.int64)
    nz = int(p[n])
    i = np.asarray(i[:nz], np.int64)
    cols = np.arange(n, dtype=np.int64)
    cnt = np.diff(p) - 1  # entries below the diagonal, per column
    if nz >= 2**31 or np.any(cnt < 0) or np.any(i[p[:-1]] != cols):
        return None
    c = np.repeat(cols, cnt)
    pos = np.arange(len(c), dtype=np.int64) + c + 1  # past each diagonal
    r = i[pos]
    offp = p - np.arange(n + 1)  # column pointers into r
    if np.any(r <= c):
        return None
    step = np.diff(r) <= 0
    cut = offp[1:n]
    step[cut[(cut > 0) & (cut < len(r))] - 1] = False  # a column boundary
    if np.any(step):  # unsorted rows: sort them, refuse duplicates
        order = np.lexsort((r, c))
        r, pos = r[order], pos[order]
        if np.any((np.diff(r) == 0) & (c[1:] == c[:-1])):
            return None
    rr = np.r_[r, -1]  # a column's first row below, or -1 past the end
    parent = np.where(cnt > 0, rr[offp[:-1]], -1)

    # nested patterns: j joins j-1 when rows(j-1) = {j} + rows(j)
    cand = np.flatnonzero((parent[:-1] == cols[1:])
                          & (cnt[:-1] == cnt[1:] + 1)) + 1
    merge = np.zeros(n, dtype=bool)
    merge[cand] = True
    e = np.flatnonzero(merge[c])  # their entries: compare with column j-1's
    merge[c[e[r[e - cnt[c[e]]] != r[e]]]] = False
    start = ~merge
    run_first = np.flatnonzero(start)
    start |= (cols - run_first[np.cumsum(start) - 1]) % PANEL == 0
    pid = np.cumsum(start) - 1
    pf = np.flatnonzero(start)
    npanel = len(pf)
    pw = np.diff(np.r_[pf, n])
    pl = pf + pw - 1
    below = offp[pf] + pw - 1  # the first row below the panel, in r
    pm = cnt[pf] - (pw - 1)
    pparent = np.where(pm > 0, pid[rr[below]], -1)
    prow_off = np.zeros(npanel + 1, dtype=np.int64)
    np.cumsum(pm, out=prow_off[1:])
    k = _seg_arange(pm)
    pseg = np.repeat(np.arange(npanel), pm)
    prow = r[below[pseg] + k]

    # closed along the tree: the rows below a panel's parent column that
    # lie beyond the parent panel are rows below the parent panel
    t = pparent[pseg]
    q = (k > 0) & (t >= 0)
    q[q] = prow[q] > pl[t[q]]
    keys = pseg * n + prow  # ascending: panels in order, rows ascending
    qk = t[q] * n + prow[q]
    at = np.minimum(np.searchsorted(keys, qk), max(len(keys) - 1, 0))
    if len(qk) and not np.array_equal(keys[at], qk):
        return None

    # the packed blocks and every entry's slot in them
    wq = -(-pw // VEC) * VEC
    pval_off = np.zeros(npanel + 1, dtype=np.int64)
    np.cumsum((pw + pm) * wq, out=pval_off[1:])
    if pval_off[-1] >= 2**31:
        return None
    ps = pid[c]
    j = c - pf[ps]
    kk = np.arange(len(r), dtype=np.int64) - offp[c]
    rem = pl[ps] - c
    row = np.where(kk < rem, j + 1 + kk, pw[ps] + kk - rem)
    vslot = np.r_[pval_off[pid] + (cols - pf[pid]) * (wq[pid] + 1),
                  pval_off[ps] + row * wq[ps] + j]

    # bottom subtrees of at most task_entries entries are tasks
    depth = _depth(pparent)
    sub = pw * (pw + 1) // 2 + pw * pm
    by_depth = np.argsort(-depth, kind="stable")
    for grp in np.split(by_depth, np.flatnonzero(np.diff(depth[by_depth])) + 1):
        up = pparent[grp]
        np.add.at(sub, up[up >= 0], sub[grp[up >= 0]])
    small = sub <= task_entries
    has = pparent >= 0
    psmall = has & small[np.where(has, pparent, 0)]
    top = ~small | ~psmall  # a panel above the subtrees, or a subtree's root
    i32 = lambda v: np.ascontiguousarray(v, dtype=np.int32)
    return Panels(
        n=n, pf=i32(pf), pw=i32(pw), pm=i32(pm), prow_off=i32(prow_off[:-1]),
        prow=i32(prow), pval_off=i32(pval_off[:-1]),
        val_total=int(pval_off[-1]), vslot=i32(vslot),
        vpos=i32(np.r_[p[:-1], pos]), pparent=pparent, depth=depth,
        height=int(depth.max()) + 1, root=_root_of(pparent, top),
        subtree=small)


def snode_schedule(pn: Panels, kind: int) -> SnodePlan:
    """`pn`'s tasks, levels and dependencies in ticket order for a sweep of
    kind 0 (L x = b: leaves first) or 2 (L' x = b: the root first)."""
    if kind not in (0, 2):
        raise ValueError(f"the supernodal schedule is for kinds 0 and 2, "
                         f"got {kind}")
    npanel = pn.npanel
    roots = np.flatnonzero(pn.root == np.arange(npanel))
    rdepth = pn.depth[roots]
    if kind == 0:  # the subtrees wait on nothing: all of them first
        top = roots[np.lexsort((-rdepth, ~pn.subtree[roots]))]
    else:
        top = roots[np.argsort(rdepth, kind="stable")]
    ntask = len(top)
    task_of = np.empty(npanel, dtype=np.int64)
    task_of[top] = np.arange(ntask)
    task = task_of[pn.root]
    rel = pn.depth - pn.depth[pn.root]
    lev = -rel if kind == 0 else rel
    pan = np.lexsort((lev, task))
    tl = np.stack([task[pan], lev[pan]])
    lstart = np.r_[True, np.any(tl[:, 1:] != tl[:, :-1], axis=0)]
    lvl_pan = np.r_[np.flatnonzero(lstart), npanel]
    task_lvl = np.searchsorted(tl[0][lstart], np.arange(ntask + 1))
    up = pn.pparent[top]
    gparent = np.where(up >= 0, task[np.maximum(up, 0)], -1)
    kids = gparent >= 0
    nchild = np.bincount(gparent[kids], minlength=ntask)
    # a panel above the subtrees: parts of its rows below
    parts = np.where(pn.subtree[top], 1,
                     np.maximum(-(-pn.pm[top] // PART_ROWS), 1))
    if kind == 0:  # every part signals its parent
        need = np.bincount(gparent[kids], weights=parts[kids],
                           minlength=ntask).astype(np.int64)
        wait = np.where(need > 0, np.arange(ntask), -1)
        signal = gparent
    else:  # the group's last part signals, once
        need = kids.astype(np.int64)
        wait = gparent
        signal = np.where(nchild > 0, np.arange(ntask), -1)
    grp = np.repeat(np.arange(ntask), parts)
    i32 = lambda v: np.ascontiguousarray(v, dtype=np.int32)
    return SnodePlan(kind=kind, panels=pn, task_lvl=i32(task_lvl),
                     lvl_pan=i32(lvl_pan), pan=i32(pan), grp=i32(grp),
                     part=i32(_seg_arange(parts)), nparts=i32(parts[grp]),
                     wait=i32(wait[grp]), need=i32(need[grp]),
                     signal=i32(signal[grp]))
