"""Batched SpTRSV over the RHS columns of X: the CUDA kernel and its plain
torch versions.

`sptrsv_multi(tx, X, plan, kind)` solves T X = B (or T' X = B) for X[n, B]
with the schedule of `solve.tri_plan`, in float32 or float64. It replaces
the TPU kernel `rsparse_tpu/ops/sptrsv_pallas.py::_sweep_call` (f32 only
there) and, in float64, its XLA twin `solve._tri_sweep_multi` (which the
JAX package's batched-values solvers vmap). With tx [K, L] and X [K, n, B]
it solves K factors of one pattern (K instances' values), in one launch.

  - On a CUDA tensor it launches the hand-written kernel in
    `csrc/sptrsv.cu`, one launch per sweep: the plan's dense block (if any)
    as one super-level solved in panels, and the other columns' levels;
    X's column in shared memory when it fits (`launch_config`), in device
    memory otherwise. An L sweep (kinds 0 and 2) of one instance over
    B >= SNODE_MIN_B columns whose plan has `snode`, and whose level
    schedule is several times as long as its panel tree is high
    (SNODE_LEVELS), takes the "supernodal" variant instead, whether or not
    X's column fits: `plan.snode`'s tasks
    (`ops.snode`: panels of consecutive columns with nested patterns;
    bottom subtrees as tasks, the panels above them in parts of their rows
    below) in one persistent launch, X row-major in device memory, tiles of
    32 RHS columns; the rule adapts to the kind, the instances, the width,
    the dtype and the pattern alone.
    It counts on `sptrsv_multi.supernodal` as well as `launches`. The
    source's header says what bounds each variant and how. A build or
    launch failure, or a plan the kernel does not take, raises: there is
    no fallback.
  - On a CPU tensor it runs `sptrsv_plain_multi`, the plain torch version
    over the whole level schedule (a Python loop over levels with
    `index_add_`), which the CPU tests use and which the chip check
    compares the kernel with.
  - `sptrsv_plain_split_multi` is a second plain version that follows the
    kernel's schedule (a dense triangular solve for the block, then the
    re-levelled columns); `sptrsv_plain_snode_multi` follows the
    supernodal variant's tasks and packed blocks. Only the tests call
    them.

The kernel is compiled with nvcc from the one source at first use
(`cuda_build`), into the package's gitignored build directory, under a name
keyed on the source's hash. Nothing is built at import time.

The supernodal variant's streams (`_snode_streams`) are the plan's task,
level and panel tables and the dependency counters of each launch shape,
which are never reset: each launch passes the number of launches made on
them before (its epoch). So launches on one plan's counters must run one
after another: `_in_order` makes a launch from another stream than the
last one's wait for it (an event recorded after each launch), and a lock
keeps threads from interleaving. Its value prepass (`_snode_values`)
packs the factor's values into the panels' dense blocks with 1 / L[j, j]
on the diagonal, kept while the values tensor is unchanged; `prepare`
makes the schedule, its streams and the prepass ahead of the first sweep
(the serve handles' build calls it).

Streams derived from the plan (`_streams`): per level offsets eoff/coff,
entry rows erow and columns ecol (slots eslot for the plain gather form),
sorted columns cid, the positions epos/cdiag of the entry and diagonal
values in the factor's value array; for a dense block its columns, its
triangle's slots in the packed panels, and its outside entries. The value
prepass (`tx[epos]`, `tx[cdiag]`, the packed panels) is a torch gather
outside the kernel, as it was on the TPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
import torch

from . import cuda_build, snode
from .plan import device_cache

__all__ = ["sptrsv_multi", "sptrsv_plain_multi", "sptrsv_plain_split_multi",
           "sptrsv_plain_snode_multi", "launch_config", "prepare", "build"]

SOURCE = cuda_build.source("sptrsv")
PANEL = 32  # dense panel width (csrc/sptrsv.cu kPanel)
THREADS = 1024  # threads per CTA (csrc/sptrsv.cu kThreads)
BATCH = 4  # entries per lane loaded together (csrc/sptrsv.cu kBatch)
SNODE_MIN_B = 32  # fewest RHS columns for the supernodal variant
# The supernodal variant takes a sweep whose level schedule has at least
# SNODE_LEVELS[dtype] levels per panel on the panel tree's longest path. On
# an H100 (B = 128) a panel step of its chain took ~3.4 us, a level of the
# shared variant ~0.9 us in float32 and ~3.2 us in float64 (1,444 levels,
# 1,407 panels high: 4.77 ms against 1.30, and 4.85 against 4.55). The L
# and L' sweeps of a factor broke even at 5.1 levels a panel in float32
# (1.3-1.5x slower at 2.1-2.6, 0.53-0.81x at 5.4), and in float64 between
# 1.2 (1.3x slower) and 2.1 (0.47-0.82x) (PERF.md).
SNODE_LEVELS = {torch.float32: 5.0, torch.float64: 1.5}
SN_WARPS = 8  # warps per supernodal CTA (csrc/sptrsv.cu kSnWarps)
PANEL_SN = snode.PANEL  # panel width (csrc/sptrsv.cu kSnWidth)


class _Args(ctypes.Structure):
    """The kernel's `SweepArgs` (csrc/sptrsv.cu): pointers, then ints."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "lvl", "cid", "dv", "esrc", "edst", "epk", "ev", "dcol", "ddiag",
        "dpan", "x")]
        + [(f, ctypes.c_int) for f in (
            "nlev", "ncols", "nents", "k", "kpad", "dense_first", "n", "B",
            "pan_total", "K")])


class _SnArgs(ctypes.Structure):
    """The supernodal kernel's `SnodeArgs` (csrc/sptrsv.cu)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "task_lvl", "lvl_pan", "pan", "grp", "part", "pinfo", "pval", "prow",
        "wait", "need", "signal", "val", "x", "ctr", "acc")]
        + [(f, ctypes.c_int) for f in ("ntask", "ngroup", "n", "B", "ntile")]
        + [("epoch", ctypes.c_uint)])


def _declare(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    for fn in (lib.sptrsv_sweep_f32, lib.sptrsv_sweep_f64):
        fn.argtypes = [i, i, i, ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = i
    for fn in (lib.sptrsv_snode_f32, lib.sptrsv_snode_f64):
        fn.argtypes = [i, i, ctypes.POINTER(_SnArgs), ctypes.c_void_p]
        fn.restype = i
    lib.sptrsv_smem_optin.argtypes = [i]
    lib.sptrsv_smem_optin.restype = i


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return cuda_build.load("sptrsv", _declare)


def _level_streams(plan, device: torch.device) -> dict:
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return dict(
        eoff=t(plan.ent_off), coff=t(plan.col_off),
        eoff_h=[int(v) for v in plan.ent_off],
        coff_h=[int(v) for v in plan.col_off],
        epos=t(plan.ent_pos), erow=t(plan.ent_row), ecol=t(plan.ent_col),
        eslot=t(plan.ent_slot), cid=t(plan.col_id), cdiag=t(plan.col_diag),
    )


def _panels(k: int):
    """(kpad, per-panel row counts R_p, per-panel offsets, total) of the
    packed dense block: k padded to panels of PANEL columns; panel p holds
    the rows p*PANEL..kpad-1, column-major, PANEL * R_p values."""
    kpad = -(-k // PANEL) * PANEL
    rows = kpad - PANEL * np.arange(kpad // PANEL, dtype=np.int64)
    off = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(PANEL * rows, out=off[1:])
    return kpad, rows, off[:-1], int(off[-1])


def _streams(plan, device: torch.device) -> dict:
    """The whole level schedule's streams for the plain version, as int32
    tensors on `device` (cached)."""
    return device_cache(plan, "_sptrsv_streams", device,
                        lambda: _level_streams(plan, device))


def _split_streams(d, device: torch.device) -> dict:
    """A dense split's streams for `sptrsv_plain_split_multi` (cached): the
    block, its outside entries and the other columns' levels (`sched`)."""

    def make():
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        return dict(
            sched=_level_streams(d.rest, device), tri_pos=i32(d.tri_pos),
            tri_dst=i32(d.tri_dst), tri_src=i32(d.tri_src),
            dcol=i32(d.cols), ddiag=i32(d.diag), opos=i32(d.out_pos),
            orow=i32(d.out_row), oidx=i32(d.out_idx))

    return device_cache(d, "_sptrsv_split_streams", device, make)


def _kernel_streams(plan, kind: int, device: torch.device) -> dict:
    """The kernel's streams (cached): the sparse levels (the dense split's
    other columns, or the whole schedule) as level offsets, columns, and
    entries (x index read, x index updated, value position and the position
    of the diagonal it is divided by); a dense block's entries into outside
    rows as one more level next to the block, with no columns and values
    not divided (`raw`: their range); in the gather form each level's
    entries are interleaved across columns (k-th entry of every column,
    then the (k+1)-th), so a warp's atomics meet on few columns. For a
    dense block also its packed panels' slots and its diagonal."""

    def make():
        i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                        device=device)
        d = plan.dense
        sp = plan if d is None else d.rest
        nlev, col_off, ent_off = sp.nlev, sp.col_off, sp.ent_off
        lev = np.repeat(np.arange(nlev), np.diff(ent_off))
        diag_of = np.zeros(plan.n, dtype=np.int64)
        diag_of[sp.col_id] = sp.col_diag
        row, col, pos = sp.ent_row, sp.ent_col, sp.ent_pos
        ediag = diag_of[col]
        raw = (0, 0)
        no = 0 if d is None else len(d.out_pos)
        if no:  # first in scatter form, last in gather form (DenseSplit)
            ocol = d.cols[d.out_idx]
            if d.first:
                lev = np.r_[np.zeros(no, np.int64), lev + 1]
                row, col = np.r_[d.out_row, row], np.r_[ocol, col]
                pos, ediag = np.r_[d.out_pos, pos], np.r_[np.zeros(no), ediag]
                col_off = np.r_[0, col_off]
                ent_off = np.r_[0, ent_off + no]
                raw = (0, no)
            else:
                lev = np.r_[lev, np.full(no, nlev)]
                row, col = np.r_[row, d.out_row], np.r_[col, ocol]
                pos, ediag = np.r_[pos, d.out_pos], np.r_[ediag, np.zeros(no)]
                col_off = np.r_[col_off, col_off[-1]]
                ent_off = np.r_[ent_off, ent_off[-1] + no]
                raw = (len(lev) - no, len(lev))
            nlev += 1
        order = np.arange(len(col))
        if kind in (2, 3) and len(col):
            start = np.r_[True, (col[1:] != col[:-1]) | (lev[1:] != lev[:-1])]
            run = np.cumsum(start) - 1
            rank = order - np.flatnonzero(start)[run]
            order = np.lexsort((col, rank, lev))
        row, col = row[order], col[order]
        src, dst = (col, row) if kind in (0, 1) else (row, col)
        ks = dict(lvl=i32(np.stack([col_off, ent_off], 1)), cid=i32(sp.col_id),
                  cdiag=i32(sp.col_diag), esrc=i32(src), edst=i32(dst),
                  epos=i32(pos[order]),
                  epk=i32((dst.astype(np.int64) << 16 | src)
                          .astype(np.uint32).view(np.int32))
                  if plan.n <= 1 << 16 else None,
                  ediag=i32(ediag[order]), raw=raw, nlev=nlev,
                  ncols=len(sp.col_id), nents=len(order), k=0, kpad=0,
                  pan_total=0)
        if d is not None:
            kpad, rows, off, total = _panels(d.k)
            a = d.tri_src.astype(np.int64)
            b = d.tri_dst.astype(np.int64)
            p = a // PANEL
            pan = off[p] + (a % PANEL) * rows[p] + (b - PANEL * p)
            ks.update(k=d.k, kpad=kpad, pan_total=total, first=d.first,
                      pan_slot=torch.as_tensor(pan, device=device),
                      tri_pos=i32(d.tri_pos), dcol=i32(d.cols),
                      ddiag=i32(d.diag))
        return ks

    return device_cache(plan, f"_sptrsv_kernel_streams_{kind}", device, make)


def _check(tx: torch.Tensor, X: torch.Tensor, plan, kind: int) -> None:
    if kind not in (0, 1, 2, 3):
        raise ValueError(f"kind must be 0..3, got {kind}")
    if tx.dim() == 2:  # K instances
        if X.dim() != 3 or X.shape[:2] != (tx.shape[0], plan.n):
            raise ValueError(f"X must be [{tx.shape[0]}, {plan.n}, B] for "
                             f"values [K, L], got {tuple(X.shape)}")
    elif tx.dim() != 1 or X.dim() != 2 or X.shape[0] != plan.n:
        raise ValueError(f"X must be [{plan.n}, B], got {tuple(X.shape)}")
    if tx.dtype != X.dtype or tx.device != X.device:
        raise ValueError("factor values and X must share dtype and device")


def _prepass(tx: torch.Tensor, X: torch.Tensor, plan, kind: int):
    _check(tx, X, plan, kind)
    st = _streams(plan, X.device)
    ev = tx[..., st["epos"]]
    dv = tx[..., st["cdiag"]]
    eb = st["ecol"] if kind in (0, 1) else st["eslot"]
    return st, ev, dv, eb


def sptrsv_plain_multi(tx: torch.Tensor, X: torch.Tensor, plan,
                       kind: int) -> torch.Tensor:
    """Plain torch sweep over the whole level schedule (any device): the
    kernel's reference version. Takes the kernel's shapes: tx [L] with
    X [n, B], or tx [K, L] with X [K, n, B]."""
    return _sweep_plain(*_prepass(tx, X, plan, kind), X, plan, kind)


def _sweep_plain(st, ev, dv, eb, X: torch.Tensor, plan, kind: int):
    # rows are the next-to-last dimension (a leading one holds instances)
    x = X.clone()
    cid, erow = st["cid"], st["erow"]
    eo, co = st["eoff_h"], st["coff_h"]
    for lev in range(plan.nlev):
        c0, c1, e0, e1 = co[lev], co[lev + 1], eo[lev], eo[lev + 1]
        j = cid[c0:c1]
        d = dv[..., c0:c1, None]
        if kind in (0, 1):
            x[..., j, :] = x[..., j, :] / d
            x.index_add_(-2, erow[e0:e1],
                         ev[..., e0:e1, None] * x[..., eb[e0:e1], :], alpha=-1)
        else:
            contrib = x.new_zeros(x.shape[:-2] + (c1 - c0, x.shape[-1]))
            contrib.index_add_(-2, eb[e0:e1],
                               ev[..., e0:e1, None] * x[..., erow[e0:e1], :])
            x[..., j, :] = (x[..., j, :] - contrib) / d
    return x


def sptrsv_plain_split_multi(tx: torch.Tensor, X: torch.Tensor, plan,
                             kind: int) -> torch.Tensor:
    """Plain torch version of the kernel's schedule (any device): the dense
    block as one dense triangular solve, its outside entries in one pass,
    and the other columns' levels. The whole level loop when the plan has
    no dense block. No main path calls it; the tests hold it against
    `sptrsv_plain_multi` and the JAX package. One instance only (tx [L])."""
    d = plan.dense
    if d is None:
        return sptrsv_plain_multi(tx, X, plan, kind)
    _check(tx, X, plan, kind)
    st = _split_streams(d, X.device)
    scatter = kind in (0, 1)

    def dense(x):
        M = torch.diag(tx[st["ddiag"]])
        M[st["tri_dst"].long(), st["tri_src"].long()] = tx[st["tri_pos"]]
        cols, ov = st["dcol"].long(), tx[st["opos"]][:, None]
        orow, oidx = st["orow"].long(), st["oidx"].long()
        xd = x[cols]
        if not scatter:  # outside rows gathered into D first
            xd.index_add_(0, oidx, ov * x[orow], alpha=-1)
        xd = torch.linalg.solve_triangular(M, xd, upper=False)
        x[cols] = xd
        if scatter:  # D's entries into outside rows
            x.index_add_(0, orow, ov * xd[oidx], alpha=-1)
        return x

    rs = st["sched"]
    rest = lambda x: _sweep_plain(
        rs, tx[rs["epos"]], tx[rs["cdiag"]],
        rs["ecol"] if scatter else rs["eslot"], x, d.rest, kind)
    if d.first:
        return rest(dense(X.clone()))
    return dense(rest(X))


def _snode_streams(plan, kind: int, device: torch.device) -> dict:
    """The supernodal variant's streams (cached): `plan.snode`'s groups,
    levels and panels ((first column, width, rows below, first row in prow)
    and each block's offset in the packed values), its tasks' groups and
    parts, the rows below the panels, the dependencies, and each entry's
    slot and position for the value prepass; `counters` keeps, for each
    tile count, the counters (`ctr`: one int32 per group and tile, the
    ticket, one arrival count per group and tile), the launches made on
    them (`epoch`), for kind 2 each dtype's accumulator of the parts'
    partial sums (`acc`: [group][tile][32][32], zero between launches),
    and the last launch's stream and the event recorded after it."""

    def make():
        sp = plan.snode
        pn = sp.panels
        i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                        device=device)
        return dict(
            task_lvl=i32(sp.task_lvl), lvl_pan=i32(sp.lvl_pan), pan=i32(sp.pan),
            grp=i32(sp.grp), part=i32(np.stack([sp.part, sp.nparts], 1)),
            pinfo=i32(np.stack([pn.pf, pn.pw, pn.pm, pn.prow_off], 1)),
            pval=i32(pn.pval_off), prow=i32(pn.prow), wait=i32(sp.wait),
            need=i32(sp.need), signal=i32(sp.signal), vslot=i32(pn.vslot),
            vpos=i32(pn.vpos), val_total=pn.val_total, n=pn.n, ntask=sp.ntask,
            ngroup=sp.ngroup, parted=bool((sp.nparts > 1).any()),
            npanel=pn.npanel, counters={})

    return device_cache(plan, f"_sptrsv_snode_streams_{kind}", device, make)


def _snode_values(tx: torch.Tensor, ks: dict) -> torch.Tensor:
    """The supernodal value prepass: the factor's values packed into the
    panels' dense blocks (zeros elsewhere), kept as `_values` keeps its
    streams, while `tx` is unchanged."""
    hit = ks.get("values")
    if hit is not None and hit[0] is tx and hit[1] == tx._version:
        return hit[2]
    val = tx.new_zeros(ks["val_total"])
    val[ks["vslot"]] = tx[ks["vpos"]]
    dslot = ks["vslot"][:ks["n"]]  # the diagonals come first
    val[dslot] = 1 / val[dslot]
    ks["values"] = (tx, tx._version, val)
    return val


def sptrsv_plain_snode_multi(tx: torch.Tensor, X: torch.Tensor, plan,
                             kind: int) -> torch.Tensor:
    """Plain torch version of the supernodal variant (any device), on its
    streams and packed values: the tasks in ticket order, each level's
    panels in turn as dense blocks. Kind 0 solves a panel's triangle over
    its rows of X, subtracts the block below times them from the task's
    part of the rows below, and the group's last part stores them; kind 2
    sums the transposed block below times the task's part of the rows
    below, and the group's last part subtracts the sum from the panel's
    rows and solves the transposed triangle. One
    instance (tx [L], X [n, B]), kinds 0 and 2 of a plan with `snode`. No
    main path calls it; the tests hold it against `sptrsv_plain_multi` and
    the JAX package, and the kernel against it."""
    _check(tx, X, plan, kind)
    if kind not in (0, 2) or tx.dim() != 1 or plan.snode is None:
        raise ValueError("the supernodal schedule takes kinds 0 and 2 of "
                         "one instance, on a plan that has it")
    ks = _snode_streams(plan, kind, X.device)
    val = _snode_values(tx, ks)
    x = X.clone()
    prow = ks["prow"].long()
    info, pval = ks["pinfo"].tolist(), ks["pval"].tolist()
    tl, lp = ks["task_lvl"].tolist(), ks["lvl_pan"].tolist()
    pan, grp = ks["pan"].tolist(), ks["grp"].tolist()
    for g, (p, k) in zip(grp, ks["part"].tolist()):
        for lev in range(tl[g], tl[g + 1]):
            for s in pan[lp[lev]:lp[lev + 1]]:
                f, w, m, ro = info[s]
                wq = -(-w // snode.VEC) * snode.VEC
                blk = val[pval[s]:pval[s] + (w + m) * wq].view(w + m, wq)
                tri = blk[:w, :w].clone()
                tri.diagonal().reciprocal_()  # the blocks hold 1 / L[j, j]
                b0, b1 = m * p // k, m * (p + 1) // k  # this part's rows
                low, rows = blk[w + b0:w + b1, :w], prow[ro + b0:ro + b1]
                if kind == 0:  # each part solves; the last one stores
                    xp = torch.linalg.solve_triangular(tri, x[f:f + w],
                                                       upper=False)
                    x.index_add_(0, rows, low @ xp, alpha=-1)
                    if p == k - 1:
                        x[f:f + w] = xp
                else:  # each part sums; the last one solves
                    acc = low.T @ x[rows] + (acc if p else 0)
                    if p == k - 1:
                        x[f:f + w] = torch.linalg.solve_triangular(
                            tri.T, x[f:f + w] - acc, upper=True)
    return x


_OPTIN: dict = {}
_ITEM = {torch.float32: 4, torch.float64: 8}


def _smem_optin(device: torch.device) -> int:
    """The card's opt-in dynamic shared memory per CTA, in bytes."""
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    v = _OPTIN.get(idx)
    if v is None:
        v = _OPTIN[idx] = int(build().sptrsv_smem_optin(idx))
        if v <= 0:
            raise RuntimeError("cannot read the card's shared-memory limit")
    return v


# One RHS column per CTA (B CTAs, each on its own SM, each bound by its own
# chain of phases). Two columns per CTA measured slower at n = 16,384,
# B = 128, f32 on an H100 (PERF.md, PR 3): L 0.549-0.556 ms per sweep
# against 0.735-0.754 (shared-memory variant), 1.67 against 1.94-1.97
# (global-memory variant); L' 0.704-0.717 against 1.29-1.30.


def launch_config(plan, dtype, device, kind: int, B: int, *, K: int = 1,
                  smem_optin=None) -> dict:
    """The launch shape of a sweep of `kind` over X[(K,) plan.n, B]: the
    variant and its dynamic shared memory per CTA. "supernodal" for a sweep
    of kind 0 or 2 over B >= SNODE_MIN_B columns of one instance (K = 1)
    whose plan has `snode` with at least SNODE_LEVELS[dtype] levels per
    panel of its panel tree's height, whether or not X's column fits in
    shared memory; else "shared" (one CTA per RHS column, X's column in
    shared memory beside the dense block's x_D) when n <= 2^16 and that
    fits the card's per-CTA limit (`smem_optin`, read from the card when
    None), else "global" (one CTA per RHS column, X in device memory).
    Raises when the kernel does not take the plan."""
    device = torch.device(device)
    item = _ITEM[dtype]
    optin = _smem_optin(device) if smem_optin is None else int(smem_optin)
    # Also where X's column fits in shared memory: on an H100 (B = 128,
    # f32) a 24^3 27-point factor's L and L' sweeps took 1.39 / 2.01 ms
    # against 3.64 / 45.6 ms on the shared variant (PERF.md). Chosen before
    # the dense block, which a supernodal sweep never reads and which is
    # found at its first read.
    if (kind in (0, 2) and K == 1 and B >= SNODE_MIN_B
            and plan.snode is not None
            and plan.nlev >= SNODE_LEVELS[dtype] * plan.snode.panels.height):
        rows = 16 if item == 4 else 8  # csrc/sptrsv.cu Sn<T>::kRows
        smem = SN_WARPS * (PANEL_SN * 32 + 32 * 36 + 2 * rows * 32) * item
        return {"shared": False, "variant": "supernodal", "smem": smem}
    kpad = _panels(plan.dense.k)[0] if plan.dense is not None else 0
    dbuf = 2 * PANEL * PANEL if kpad else 0  # the staged diagonal blocks
    shared = (plan.n <= 1 << 16 and plan.n * item <= optin
              and (dbuf + kpad + plan.n) * item <= optin)
    smem = (dbuf + kpad + (plan.n if shared else 0)) * item
    if smem > optin:
        raise ValueError(
            f"SpTRSV kernel needs {smem} B of shared memory per CTA (a dense "
            f"block of {kpad} rows), the card allows {optin}")
    return {"shared": shared, "variant": "shared" if shared else "global",
            "smem": smem}


def _values(tx: torch.Tensor, ks: dict) -> list:
    """The value prepass: [entry values over their column's diagonal (the
    block's outside entries undivided), diagonal values] of the sparse
    levels, then [packed panels, block diagonal] with a dense block. Kept
    in the kernel streams, with a reference to `tx` itself, while `tx` is
    unchanged (the same tensor at the same version counter), so repeated
    sweeps with one factor (the serve handle's) gather once. A change made to tx's memory
    behind torch's back (not through a torch op) is not seen. For tx [K, L]
    (K instances) each stream is [K, ...], contiguous: the kernel reads
    instance k's at k times the stream's length."""
    hit = ks.get("values")
    if hit is not None and hit[0] is tx and hit[1] == tx._version:
        return hit[2]
    ev = tx[..., ks["epos"]] / tx[..., ks["ediag"]]
    r0, r1 = ks["raw"]
    ev[..., r0:r1] = tx[..., ks["epos"][r0:r1]]
    vals = [ev, tx[..., ks["cdiag"]]]
    if ks["k"]:
        dpan = tx.new_zeros(tx.shape[:-1] + (ks["pan_total"],))
        dpan[..., ks["pan_slot"]] = tx[..., ks["tri_pos"]]
        vals += [dpan, tx[..., ks["ddiag"]]]
    ks["values"] = (tx, tx._version, vals)
    return vals


def _sanitize_streams(ks: dict, n: int, L: int) -> None:
    """`cuda_build.sanitize`'s checks of the kernel streams, on the host:
    level pointers, columns and rows < n, value positions < L."""
    name = "SpTRSV"
    lvl = ks["lvl"].cpu()
    cuda_build.check_pointers(name, "column offsets", lvl[:, 0], ks["ncols"])
    cuda_build.check_pointers(name, "entry offsets", lvl[:, 1], ks["nents"])
    for key in ("cid", "esrc", "edst") + (("dcol",) if ks["k"] else ()):
        cuda_build.check_index(name, key, ks[key], n)
    for key in ("epos", "ediag", "cdiag") + (
            ("tri_pos", "ddiag") if ks["k"] else ()):
        cuda_build.check_index(name, key, ks[key], L)
    if ks["k"]:
        cuda_build.check_index(name, "pan_slot", ks["pan_slot"],
                               ks["pan_total"])


def _sweep_cuda(tx: torch.Tensor, X: torch.Tensor, plan, kind: int):
    """One kernel launch, grid (B, K). Returns X solved: in the shared
    variant as the transposed view of a [(K,) B, n] buffer."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"SpTRSV kernel takes float32/float64, got {X.dtype}")
    B = X.shape[-1]
    K = X.shape[0] if X.dim() == 3 else 1
    if K > 65535:
        raise ValueError(f"SpTRSV kernel takes at most 65,535 instances, "
                         f"got {K}")
    cfg = launch_config(plan, X.dtype, X.device, kind, B, K=K)
    if cfg["variant"] == "supernodal":
        if X.dim() == 3:
            return _sweep_snode(tx[0], X[0], plan, kind)[None]
        return _sweep_snode(tx, X, plan, kind)
    ks = _kernel_streams(plan, kind, X.device)
    for what, count in (("entry", ks["nents"] + BATCH * THREADS),
                        ("dense block", ks["pan_total"]),
                        ("dense block", ks["kpad"] ** 2)):
        if count >= 2**31:
            raise ValueError(f"{what} too large for the kernel's 32-bit index")
    lib = build()
    sanitize = cuda_build.sanitizing()
    if sanitize:
        _sanitize_streams(ks, plan.n, tx.shape[-1])
    keep = _values(tx, ks)
    args = _Args(lvl=ks["lvl"].data_ptr(), cid=ks["cid"].data_ptr(),
                 dv=keep[1].data_ptr(), esrc=ks["esrc"].data_ptr(),
                 edst=ks["edst"].data_ptr(), ev=keep[0].data_ptr(),
                 epk=ks["epk"].data_ptr() if cfg["shared"] else None,
                 nlev=ks["nlev"], ncols=ks["ncols"], nents=ks["nents"],
                 n=plan.n, B=B, pan_total=ks["pan_total"], K=K)
    if ks["k"]:
        args.dcol, args.ddiag, args.dpan = (
            ks["dcol"].data_ptr(), keep[3].data_ptr(), keep[2].data_ptr())
        args.k, args.kpad = ks["k"], ks["kpad"]
        args.dense_first = int(ks["first"])
    if cfg["shared"]:  # X^T [B, n]: each CTA's RHS column contiguous
        xt = X.transpose(-1, -2)
        x = xt.clone() if xt.is_contiguous() else xt.contiguous()
    else:
        x = X.contiguous().clone()
    args.x = x.data_ptr()
    fn = (lib.sptrsv_sweep_f32 if X.dtype == torch.float32
          else lib.sptrsv_sweep_f64)
    dev = X.device
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            int(kind in (0, 1)), int(cfg["shared"]), ctypes.byref(args),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SpTRSV kernel launch failed (cudaError {rc})")
    sptrsv_multi.launches += 1
    if sanitize:
        cuda_build.synchronize("SpTRSV", dev)
    return x.transpose(-1, -2) if cfg["shared"] else x


def _sanitize_snode(ks: dict, n: int, L: int) -> None:
    """`cuda_build.sanitize`'s checks of the supernodal streams."""
    name = "SpTRSV"
    cuda_build.check_pointers(name, "task levels", ks["task_lvl"],
                              len(ks["lvl_pan"]) - 1)
    cuda_build.check_pointers(name, "level panels", ks["lvl_pan"],
                              ks["npanel"])
    cuda_build.check_index(name, "pan", ks["pan"], ks["npanel"])
    cuda_build.check_index(name, "grp", ks["grp"], ks["ngroup"])
    pk = ks["part"].cpu().long()
    cuda_build.check_index(name, "part", pk[:, 0], 2**16)
    cuda_build.check_index(name, "parts", pk[:, 1] - pk[:, 0], 2**16, 1)
    info = ks["pinfo"].cpu().long()
    f, w, m, ro = info.unbind(1)
    cuda_build.check_index(name, "panel columns", f + w, n + 1, 1)
    cuda_build.check_index(name, "panel widths", w, PANEL_SN + 1, 1)
    cuda_build.check_index(name, "panel rows", ro + m, len(ks["prow"]) + 1)
    wq = (w + snode.VEC - 1) // snode.VEC * snode.VEC
    cuda_build.check_index(name, "panel blocks",
                           ks["pval"].cpu().long() + (w + m) * wq,
                           ks["val_total"] + 1)
    cuda_build.check_index(name, "prow", ks["prow"], n)
    for key in ("wait", "signal"):
        cuda_build.check_index(name, key, ks[key], ks["ngroup"], -1)
    cuda_build.check_index(name, "vslot", ks["vslot"], ks["val_total"])
    cuda_build.check_index(name, "vpos", ks["vpos"], L)


_SNODE_LOCK = threading.Lock()  # one supernodal launch's host side at a time


@contextlib.contextmanager
def _in_order(c: dict, stream):
    """Run a launch on the counters `c` after the last one: from another
    stream than the last launch's, `stream` first waits for the event
    recorded after that launch (its counters and accumulator are only
    right for launches that follow one another). Yields the launch's
    epoch; once the launch is made, the epoch counts it and the event is
    recorded on `stream`. Hold `_SNODE_LOCK` around it."""
    if c["done"] is not None and c["stream"] != stream.cuda_stream:
        stream.wait_event(c["done"])
    yield c["epoch"]
    c["epoch"] += 1
    c["done"] = stream.record_event(c["done"])
    c["stream"] = stream.cuda_stream


def _sweep_snode(tx: torch.Tensor, X: torch.Tensor, plan, kind: int):
    """One launch of the supernodal variant over X [n, B] (tx [L]): a
    persistent grid whose CTAs take (task, tile of 32 RHS columns) tickets
    in order. Returns X solved, a new contiguous [n, B]. Launches on one
    plan's counters run one after another, on any streams (`_in_order`)."""
    ks = _snode_streams(plan, kind, X.device)
    B = X.shape[-1]
    ntile = -(-B // 32)
    if (ks["ntask"] + 2 * ks["ngroup"]) * ntile + 1 >= 2**31:
        raise ValueError("too many supernodal tasks for 32-bit tickets")
    lib = build()
    sanitize = cuda_build.sanitizing()
    if sanitize:
        _sanitize_snode(ks, plan.n, tx.shape[-1])
    dev = X.device
    stream = torch.cuda.current_stream(dev)
    with _SNODE_LOCK:
        val = _snode_values(tx, ks)
        c = ks["counters"].get(ntile)
        if c is None:
            c = ks["counters"][ntile] = dict(
                ctr=torch.zeros(2 * ks["ngroup"] * ntile + 1,
                                dtype=torch.int32, device=dev),
                epoch=0, acc={}, stream=None, done=None)
        acc = None
        if kind == 2 and ks["parted"]:  # the parts' partial sums, kept zero
            acc = c["acc"].get(X.dtype)
            if acc is None:
                acc = c["acc"][X.dtype] = X.new_zeros(
                    ks["ngroup"] * ntile * 32 * 32)
        x = X.contiguous().clone()
        p = lambda key: ks[key].data_ptr()
        args = _SnArgs(task_lvl=p("task_lvl"), lvl_pan=p("lvl_pan"),
                       pan=p("pan"), grp=p("grp"), part=p("part"),
                       pinfo=p("pinfo"), pval=p("pval"), prow=p("prow"),
                       wait=p("wait"), need=p("need"), signal=p("signal"),
                       val=val.data_ptr(), x=x.data_ptr(),
                       ctr=c["ctr"].data_ptr(),
                       acc=acc.data_ptr() if acc is not None else None,
                       ntask=ks["ntask"], ngroup=ks["ngroup"], n=plan.n, B=B,
                       ntile=ntile)
        fn = (lib.sptrsv_snode_f32 if X.dtype == torch.float32
              else lib.sptrsv_snode_f64)
        with _in_order(c, stream) as epoch:
            args.epoch = epoch & 0xFFFFFFFF
            rc = fn(dev.index if dev.index is not None
                    else torch.cuda.current_device(), int(kind == 0),
                    ctypes.byref(args), stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    f"SpTRSV kernel launch failed (cudaError {rc})")
    sptrsv_multi.launches += 1
    sptrsv_multi.supernodal += 1
    if sanitize:
        cuda_build.synchronize("SpTRSV", dev)
    return x


def prepare(tx: torch.Tensor, plan, kind: int) -> None:
    """Make ahead of the first sweep what a supernodal sweep of `kind` over
    the values `tx` would make then: the plan's schedule (`plan.snode`),
    its streams on tx's card and the value prepass. Nothing where the
    variant would not run at B = SNODE_MIN_B (off a card, K instances,
    kinds 1 and 3, a pattern without `snode` or with too few levels for
    its panel tree's height) or the kernel does not take the plan (the
    sweep raises)."""
    if tx.device.type != "cuda" or tx.dim() != 1:
        return
    try:
        cfg = launch_config(plan, tx.dtype, tx.device, kind, SNODE_MIN_B)
    except ValueError:
        return
    if cfg["variant"] == "supernodal":
        _snode_values(tx, _snode_streams(plan, kind, tx.device))


def sptrsv_multi(tx: torch.Tensor, X: torch.Tensor, plan, kind: int, *,
                 contiguous: bool = True) -> torch.Tensor:
    """Batched triangular solve of X[n, B]; returns a new [n, B] tensor.

    tx: the factor's value array (1-D tensor; the plan's positions index
    it), on X's device and in X's dtype; or K instances' value arrays
    [K, L] of factors with one pattern, with X [K, n, B] (one launch, the
    result [K, n, B]). plan: `solve.tri_plan(t, kind)`.
    kind: 0 lsolve / 1 usolve (scatter form), 2 ltsolve / 3 utsolve (gather
    form). A CUDA tensor goes through the kernel; a CPU tensor through the
    plain version. `contiguous=False` lets the kernel's shared-memory
    variant return the transposed view of its [B, n] buffer, which the next
    sweep of a chain takes as X^T without a copy.
    """
    _check(tx, X, plan, kind)
    if X.numel() == 0:
        return X.clone()
    if X.device.type == "cuda":
        x = _sweep_cuda(tx, X, plan, kind)
        return x.contiguous() if contiguous else x
    if X.device.type == "cpu":
        return _sweep_plain(*_prepass(tx, X, plan, kind), X, plan, kind)
    raise ValueError(f"no SpTRSV path for device {X.device}")


sptrsv_multi.launches = 0  # kernel launches (the CPU path does not count)
sptrsv_multi.supernodal = 0  # of them, launches of the supernodal variant
