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
    memory otherwise. The source's header says what bounds it and how. A
    build or launch failure, or a plan the kernel does not take, raises:
    there is no fallback.
  - On a CPU tensor it runs `sptrsv_plain_multi`, the plain torch version
    over the whole level schedule (a Python loop over levels with
    `index_add_`), which the CPU tests use and which the chip check
    compares the kernel with.
  - `sptrsv_plain_split_multi` is a second plain version that follows the
    kernel's schedule (a dense triangular solve for the block, then the
    re-levelled columns); only the tests call it.

The kernel is compiled with nvcc from the one source at first use
(`cuda_build`), into the package's gitignored build directory, under a name
keyed on the source's hash. Nothing is built at import time.

Streams derived from the plan (`_streams`): per level offsets eoff/coff,
entry rows erow and columns ecol (slots eslot for the plain gather form),
sorted columns cid, the positions epos/cdiag of the entry and diagonal
values in the factor's value array; for a dense block its columns, its
triangle's slots in the packed panels, and its outside entries. The value
prepass (`tx[epos]`, `tx[cdiag]`, the packed panels) is a torch gather
outside the kernel, as it was on the TPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .plan import device_cache

__all__ = ["sptrsv_multi", "sptrsv_plain_multi", "sptrsv_plain_split_multi",
           "launch_config", "build"]

SOURCE = cuda_build.source("sptrsv")
PANEL = 32  # dense panel width (csrc/sptrsv.cu kPanel)
THREADS = 1024  # threads per CTA (csrc/sptrsv.cu kThreads)
BATCH = 4  # entries per lane loaded together (csrc/sptrsv.cu kBatch)


class _Args(ctypes.Structure):
    """The kernel's `SweepArgs` (csrc/sptrsv.cu): pointers, then ints."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "lvl", "cid", "dv", "esrc", "edst", "epk", "ev", "dcol", "ddiag",
        "dpan", "x")]
        + [(f, ctypes.c_int) for f in (
            "nlev", "ncols", "nents", "k", "kpad", "dense_first", "n", "B",
            "pan_total", "K")])


def _declare(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    for fn in (lib.sptrsv_sweep_f32, lib.sptrsv_sweep_f64):
        fn.argtypes = [i, i, i, ctypes.POINTER(_Args), ctypes.c_void_p]
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


def launch_config(plan, dtype, device) -> dict:
    """The kernel's launch shape for X[plan.n, B] (one CTA per RHS column):
    the variant, "shared" (X's column in shared memory beside the dense
    block's x_D) when n <= 2^16 and it fits the card's per-CTA limit, else
    "global"; and its dynamic shared memory. Raises when the kernel does
    not take the plan."""
    device = torch.device(device)
    item = _ITEM[dtype]
    kpad = _panels(plan.dense.k)[0] if plan.dense is not None else 0
    dbuf = 2 * PANEL * PANEL if kpad else 0  # staged diagonal blocks
    optin = _smem_optin(device)
    shared = plan.n <= 1 << 16 and (dbuf + kpad + plan.n) * item <= optin
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


def _sweep_cuda(tx: torch.Tensor, X: torch.Tensor, plan, kind: int):
    """One kernel launch, grid (B, K). Returns X solved: in the shared
    variant as the transposed view of a [(K,) B, n] buffer."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"SpTRSV kernel takes float32/float64, got {X.dtype}")
    ks = _kernel_streams(plan, kind, X.device)
    B = X.shape[-1]
    K = X.shape[0] if X.dim() == 3 else 1
    if K > 65535:
        raise ValueError(f"SpTRSV kernel takes at most 65,535 instances, "
                         f"got {K}")
    cfg = launch_config(plan, X.dtype, X.device)
    for what, count in (("entry", ks["nents"] + BATCH * THREADS),
                        ("dense block", ks["pan_total"]),
                        ("dense block", ks["kpad"] ** 2)):
        if count >= 2**31:
            raise ValueError(f"{what} too large for the kernel's 32-bit index")
    lib = build()
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
    return x.transpose(-1, -2) if cfg["shared"] else x


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
