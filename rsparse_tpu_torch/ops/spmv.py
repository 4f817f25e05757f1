"""SpMV in DIA (diagonal) format, and SpGEMM as a convolution of diagonals.

For banded and structured patterns the product is, per kept diagonal
offset o_k,

    r[i] = sum_k  dia_k[i] * x[i - o_k]

i.e. K elementwise multiply-adds against shifted views of x. `dia_plan`
extracts the diagonals on the host (numpy; entries on rare diagonals
beyond `max_diags` go to a COO remainder). `spmv_fn(plan)` returns
`f(dia, x)`: the diagonal part is `dia_spmv`, which on a CUDA tensor
launches the hand-written kernel of `csrc/spmv_dia.cu` (it replaces the
TPU kernel `rsparse_tpu/ops/spmv.py::_dia_kernel_tpu`; the source's
header says what bounds it and how) and on a CPU tensor runs
`dia_spmv_plain`, the plain torch version (static slices of a padded x, the
JAX package's `_dia_kernel_xla`). The remainder is a torch `index_add_`.

The plan keeps the JAX package's layout (dia [K, rr, 128], rr * 128 >=
max(m, n)) so its fields compare with the JAX plan's one to one.

`spgemm_dia` multiplies two banded matrices diagonal by diagonal, in plain
torch on `device`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..data import Sprs
from . import cuda_build
from .plan import col_ids, device_cache

__all__ = ["DiaPlan", "dia_plan", "dia_plan_cached", "refresh_dia_values",
           "spmv", "spmv_fn", "dia_spmv", "dia_spmv_plain", "spgemm_dia",
           "interior_rows", "streams_dia", "build"]

SOURCE = cuda_build.source("spmv_dia")
_LANE = 128


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Host-built diagonal-format plan for one sparsity pattern."""

    n: int  # logical vector length
    m: int
    rr: int  # padded row tiles: rr * 128 >= max(m, n)
    offsets: tuple  # python ints, ascending
    dia: np.ndarray  # [K, rr, 128] float — diagonal d stored at row index i
    pad_rows: int  # halo rows on each side of x (multiple of 8)
    tile_rows: int  # the TPU kernel's grid tile height (divides rr)
    # COO remainder for entries off the selected diagonals (None if empty)
    rem_vals: Optional[np.ndarray]
    rem_rows: Optional[np.ndarray]
    rem_cols: Optional[np.ndarray]
    # value-refresh maps (flat positions into dia / remainder per A entry)
    val_kk: Optional[np.ndarray] = None  # diag index per kept entry
    val_rows: Optional[np.ndarray] = None  # row per kept entry
    val_keep: Optional[np.ndarray] = None  # kept-entry mask over a.x[:nnz]


def refresh_dia_values(plan: DiaPlan, x: np.ndarray) -> DiaPlan:
    """Rebuild the plan's value arrays from new entry values `x` (same
    sparsity pattern) without re-deriving the diagonal structure."""
    K = len(plan.offsets)
    dia = np.zeros((K, plan.rr * _LANE), plan.dia.dtype)
    keep = plan.val_keep
    dia[plan.val_kk, plan.val_rows] = x[keep].astype(plan.dia.dtype)
    rem = None if plan.rem_vals is None else x[~keep].astype(plan.dia.dtype)
    return dataclasses.replace(
        plan, dia=dia.reshape(K, plan.rr, _LANE), rem_vals=rem)


def dia_plan(a: Sprs, max_diags: int = 48, dtype=np.float32) -> DiaPlan:
    """Extract diagonal structure; entries on rare diagonals (beyond the
    `max_diags` most populated) go to a COO remainder.

    Vectorized: the kept-entry mask is `np.isin` and each entry's diagonal
    index a `np.searchsorted` on the sorted kept offsets (the JAX package
    runs a Python generator per entry for both, seconds of host time at
    n = 2^20); the fields are the same.
    """
    nz = a.nnz()
    rows = a.i[:nz].astype(np.int64)
    cols = col_ids(a.p, a.n)
    vals = a.x[:nz]
    offs = rows - cols
    uoff, counts = np.unique(offs, return_counts=True)
    if len(uoff) > max_diags:
        keep = np.isin(offs, uoff[np.argsort(-counts)[:max_diags]])
    else:
        keep = np.ones(nz, bool)
    sel_off = np.unique(offs[keep])
    K = len(sel_off)
    dim = max(a.m, a.n)
    rr = -(-dim // _LANE)
    tile_rows = 64
    while rr % tile_rows:
        tile_rows //= 2
    maxoff = int(np.abs(sel_off).max()) if K else 0
    pad_rows = max(8, (-(-(maxoff) // _LANE) + 7) // 8 * 8)
    dia = np.zeros((K, rr * _LANE), dtype)
    kk = np.searchsorted(sel_off, offs[keep]).astype(np.int64)
    dia[kk, rows[keep]] = vals[keep]
    rem = ~keep
    return DiaPlan(
        n=a.n,
        m=a.m,
        rr=rr,
        offsets=tuple(int(o) for o in sel_off),
        dia=dia.reshape(K, rr, _LANE),
        pad_rows=pad_rows,
        tile_rows=tile_rows,
        rem_vals=vals[rem].astype(dtype) if rem.any() else None,
        rem_rows=rows[rem].astype(np.int32) if rem.any() else None,
        rem_cols=cols[rem].astype(np.int32) if rem.any() else None,
        val_kk=kk,
        val_rows=rows[keep],
        val_keep=keep,
    )


_DIA_PLAN_CACHE: dict = {}


def dia_plan_cached(a: Sprs, max_diags: int = 10**9,
                    dtype=np.float64) -> DiaPlan:
    """Pattern-keyed DIA plan cache with value refresh (repeated SpGEMM /
    SpMV on one pattern skips the O(nnz) unique/offset derivation)."""
    from .plan import pattern_key

    key = (pattern_key(a), int(max_diags), np.dtype(dtype).name)
    nzv = a.x[: a.nnz()]
    vfp = hash(np.ascontiguousarray(nzv).tobytes())
    plan = _DIA_PLAN_CACHE.get(key)
    if plan is None:
        if len(_DIA_PLAN_CACHE) > 64:
            _DIA_PLAN_CACHE.clear()
        plan = dia_plan(a, max_diags=max_diags, dtype=dtype)
        plan.__dict__["_vfp"] = vfp
        _DIA_PLAN_CACHE[key] = plan
        return plan
    if plan.__dict__.get("_vfp") == vfp:
        # unchanged values: reuse the cached plan verbatim, keeping its
        # device-upload cache warm
        return plan
    plan = refresh_dia_values(plan, nzv)
    plan.__dict__["_vfp"] = vfp
    _DIA_PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# The DIA SpMV: kernel wrapper and plain version
# ---------------------------------------------------------------------------


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmv_dia_f32, lib.spmv_dia_f64):
        fn.argtypes = [i, p, p, p, p, p, i, ctypes.c_int64, i, i, i, i, i, p]
        fn.restype = i


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return cuda_build.load("spmv_dia", _declare)


def _check(dia: torch.Tensor, x: torch.Tensor, plan: DiaPlan) -> None:
    K = len(plan.offsets)
    if tuple(dia.shape) != (K, plan.rr, _LANE):
        raise ValueError(f"dia must be [{K}, {plan.rr}, {_LANE}], "
                         f"got {tuple(dia.shape)}")
    if tuple(x.shape) != (plan.n,):
        raise ValueError(f"x must be [{plan.n}], got {tuple(x.shape)}")
    if dia.dtype != x.dtype or dia.device != x.device:
        raise ValueError("dia and x must share dtype and device")


def dia_spmv_plain(dia: torch.Tensor, x: torch.Tensor,
                   plan: DiaPlan) -> torch.Tensor:
    """Plain torch diagonal product (any device): K static slices of a
    zero-padded x. The kernel's reference version."""
    _check(dia, x, plan)
    n_el = plan.rr * _LANE
    pad = plan.pad_rows * _LANE
    xp = x.new_zeros(n_el + 2 * pad)
    xp[pad: pad + plan.n] = x
    flat = dia.reshape(len(plan.offsets), n_el)
    acc = x.new_zeros(n_el)
    for k, o in enumerate(plan.offsets):
        acc = acc + flat[k] * xp[pad - o: pad - o + n_el]
    return acc[: plan.m]


def interior_rows(offsets, m: int, n: int) -> tuple:
    """[lo, hi): the rows i < m at which every i - offsets[k] lies in
    [0, n), so that the kernel's tiles inside it skip the bounds checks
    (lo = hi when there is none; every row when there is no offset)."""
    if not len(offsets):
        return 0, m
    lo = min(max(0, max(offsets)), m)
    hi = max(min(m, n + min(offsets)), lo)
    return lo, hi


def streams_dia(plan: DiaPlan, itemsize: int, l2_bytes: int) -> bool:
    """Whether the kernel loads dia with the evict-first hint: when the
    product's bytes (dia, x, r) exceed the L2 cache, so that x and r keep
    their lines; below it, dia stays in L2 for the next product on the same
    plan (an iterative solver's chain)."""
    n_el = plan.rr * _LANE
    return (len(plan.offsets) * n_el + plan.n + plan.m) * itemsize > l2_bytes


def dia_spmv(dia: torch.Tensor, x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """r[i] = sum_k dia[k, i] * x[i - offsets[k]] for i < m (the diagonal
    part of A @ x). A CUDA tensor goes through the kernel, a CPU tensor
    through the plain version. Returns a new [m] tensor."""
    _check(dia, x, plan)
    if x.device.type == "cpu":
        return dia_spmv_plain(dia, x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"no DIA SpMV path for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"DIA SpMV kernel takes float32/float64, got {x.dtype}")
    if max(plan.m, plan.n) >= 2**31:
        raise ValueError("vector too long for the kernel's int32 sizes")
    r = x.new_empty(plan.m)
    if plan.m == 0:
        return r
    off, host_off, (lo, hi) = device_cache(plan, "_dia_offsets", x.device, lambda: (
        torch.as_tensor(plan.offsets, dtype=torch.int32, device=x.device),
        (ctypes.c_int * max(1, len(plan.offsets)))(*plan.offsets),
        interior_rows(plan.offsets, plan.m, plan.n)))
    stream = streams_dia(plan, x.element_size(),
                         cuda_build.l2_bytes(str(x.device)))
    lib = build()
    fn = lib.spmv_dia_f32 if x.dtype == torch.float32 else lib.spmv_dia_f64
    dev = x.device
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            dia.contiguous().data_ptr(), off.data_ptr(),
            ctypes.addressof(host_off),
            x.contiguous().data_ptr(), r.data_ptr(), len(plan.offsets),
            plan.rr * _LANE, plan.m, plan.n, lo, hi, int(stream),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"DIA SpMV kernel launch failed (cudaError {rc})")
    dia_spmv.launches += 1
    return r


dia_spmv.launches = 0  # kernel launches (the CPU path does not count)


def spmv_fn(plan: DiaPlan):
    """Return `f(dia, x) -> r` for the plan: dia is the plan's [K, rr, 128]
    values as a tensor, x the logical [n] vector in dia's dtype, on dia's
    device; r is the logical [m] product A @ x there."""
    has_rem = plan.rem_vals is not None

    def rem_streams(d: torch.device):
        return device_cache(plan, "_dia_rem", d, lambda: (
            torch.as_tensor(plan.rem_vals, device=d),
            torch.as_tensor(plan.rem_rows, dtype=torch.int64, device=d),
            torch.as_tensor(plan.rem_cols, dtype=torch.int64, device=d)))

    def f(dia: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = dia_spmv(dia, x, plan)
        if has_rem:
            rv, rrw, rcl = rem_streams(x.device)
            r = r + r.new_zeros(plan.m).index_add_(0, rrw, rv * x[rcl])
        return r

    return f


def spmv(a: Sprs, x, plan: Optional[DiaPlan] = None, *,
         device="cuda") -> torch.Tensor:
    """r = A @ x through the DIA path on `device` (plan built on the fly if
    absent), in the plan's dtype."""
    p = plan or dia_plan(a)
    dia = torch.as_tensor(p.dia, device=device)
    return spmv_fn(p)(dia, torch.as_tensor(np.asarray(x), dtype=dia.dtype,
                                           device=device))


# ---------------------------------------------------------------------------
# SpGEMM of banded matrices as a convolution of diagonals (plain torch)
# ---------------------------------------------------------------------------


def spgemm_dia_fn(pa: DiaPlan, pb: DiaPlan, bn: int):
    """The SpGEMM-as-diagonal-convolution for a (pattern(A), pattern(B))
    pair. Returns (c_offsets, compute) where
    compute(da [KA, n_el_c], db [KB, n_el_b]) -> c [Kc, n_el_c]."""
    return _spgemm_dia_compute(pa.offsets, pb.offsets, pa.m,
                               pb.rr * _LANE, bn)


@functools.lru_cache(maxsize=64)
def _spgemm_dia_compute(a_offsets: tuple, b_offsets: tuple, am: int,
                        n_el_b: int, bn: int):
    KB = len(b_offsets)
    c_offsets = sorted({o1 + o2 for o1 in a_offsets for o2 in b_offsets})
    c_idx = {o: i for i, o in enumerate(c_offsets)}
    rr_c = -(-max(am, bn) // _LANE)
    n_el_c = rr_c * _LANE
    # pad B rows so b[i - o1] stays in range for all o1. The slice window is
    # [pad - o1, pad - o1 + n_el_c); with o1 ∈ [-pad, pad] its end can reach
    # 2*pad + n_el_c, and the buffer must also hold db itself (pad + n_el_b)
    # — tall-rectangular A makes n_el_c exceed n_el_b, so size for both.
    pad = max((abs(o) for o in a_offsets), default=0) + _LANE
    wb = pad + max(n_el_b, pad + n_el_c)
    # target diagonals per o1: all KB at once (distinct for one o1)
    rows_per_o1 = np.asarray(
        [[c_idx[o1 + o2] for o2 in b_offsets] for o1 in a_offsets],
        dtype=np.int64,
    ).reshape(len(a_offsets), KB)

    def compute(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
        dbp = db.new_zeros((KB, wb))
        dbp[:, pad: pad + db.shape[1]] = db
        c = da.new_zeros((len(c_offsets), n_el_c))
        targets = torch.as_tensor(rows_per_o1, device=da.device)
        for i1, o1 in enumerate(a_offsets):
            shifted = dbp[:, pad - o1: pad - o1 + n_el_c]
            c.index_add_(0, targets[i1], da[i1, :n_el_c][None, :] * shifted)
        return c

    return c_offsets, compute


def _dia_dev(plan: DiaPlan, n_el_c: int, device: torch.device) -> torch.Tensor:
    """Fingerprint-cached device copy of a plan's diagonal values (padded
    to n_el_c): repeated products on unchanged values skip the upload."""
    K = len(plan.offsets)
    flat = plan.dia.reshape(K, -1)
    fp = (flat.shape, n_el_c, str(device),
          hash(np.ascontiguousarray(flat).tobytes()))
    cached = plan.__dict__.get("_dev_vals")
    if cached is not None and cached[0] == fp:
        return cached[1]
    d = torch.as_tensor(flat, device=device)
    if flat.shape[1] < n_el_c:
        d = torch.nn.functional.pad(d, (0, n_el_c - flat.shape[1]))
    plan.__dict__["_dev_vals"] = (fp, d)
    return d


def _dia_csc_layout(c_offsets, m: int, nc: int):
    """Column pointers of a DIA product's full-diagonal CSC pattern, and per
    diagonal its column range (jlo, jhi) and the entries' output positions.
    Within a column, rows = j + o ascend with the diagonal offset, so each
    diagonal's slot is its rank among the diagonals valid at that column."""
    cnt = np.zeros(nc + 1, dtype=np.int64)
    ranges = []
    for o in c_offsets:
        jlo = max(0, -o)
        jhi = min(nc, m - o)
        ranges.append((jlo, jhi))
        if jlo < jhi:
            cnt[jlo] += 1
            cnt[jhi] -= 1
    cnt = np.cumsum(cnt[:-1])
    Cp = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(cnt, out=Cp[1:])
    rank = np.zeros(nc, dtype=np.int64)
    slots = []
    for jlo, jhi in ranges:
        if jlo >= jhi:
            slots.append(None)
            continue
        slots.append(Cp[jlo:jhi] + rank[jlo:jhi])
        rank[jlo:jhi] += 1
    return Cp, ranges, slots


_DIA_CSC_CACHE: dict = {}


def _dia_csc_pattern(c_offsets, m: int, nc: int, n_el_c: int):
    """Structural CSC pattern of a DIA product + flat gather indices into
    the [Kc, n_el_c] diagonal tensor (host, values-free, cached): entry
    (row=j+o, col=j) of diagonal o lives at flat index idx(o)*n_el_c+j+o."""
    key = (tuple(c_offsets), m, nc, n_el_c)
    hit = _DIA_CSC_CACHE.get(key)
    if hit is not None:
        return hit
    Cp, ranges, slots = _dia_csc_layout(c_offsets, m, nc)
    nnz = int(Cp[nc])
    rows = np.empty(nnz, dtype=np.int64)
    gidx = np.empty(nnz, dtype=np.int64)
    for idx, o in enumerate(c_offsets):
        if slots[idx] is None:
            continue
        js = np.arange(*ranges[idx])
        rows[slots[idx]] = js + o
        gidx[slots[idx]] = idx * n_el_c + js + o
    if len(_DIA_CSC_CACHE) > 64:
        _DIA_CSC_CACHE.clear()
    _DIA_CSC_CACHE[key] = (Cp, rows, gidx)
    return Cp, rows, gidx


def spgemm_dia(a: Sprs, b: Sprs, trim: bool = True,
               materialize: Optional[bool] = None, *, device="cuda") -> Sprs:
    """C = A @ B in diagonal form: a *convolution of diagonals*.

    With A[i,k] on diagonal o1 = i-k and B[k,j] on o2 = k-j, the product
    contributes C[i, j] on diagonal o1+o2 as

        c_{o1+o2}[i] += a_{o1}[i] * b_{o2}[i - o1]

    i.e. K_A x K_B shifted elementwise multiply-adds on `device` (the
    reference's Gustavson scatter is src/lib.rs:713-748). Patterns that are
    not banded enough go to `ops.multiply`.

    `materialize`: None keeps the values on `device` when it is a CUDA
    device (C.x is a tensor there, in the full structural diagonals, no
    value trim) and materializes on the CPU. True gives a host Sprs; then
    `trim=True` drops the explicit zeros, as `multiply`'s structure does.
    """
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: A is {a.m}x{a.n}, B is {b.m}x{b.n}")
    dev = torch.device(device)
    pa = dia_plan_cached(a)
    pb = dia_plan_cached(b)
    assert pa.rem_vals is None and pb.rem_vals is None
    KA, KB = len(pa.offsets), len(pb.offsets)
    if KA * KB > 65536 or KA > 1024:
        # not banded enough for the diagonal formulation — Gustavson path
        from . import multiply

        return multiply(a, b, device=device)
    c_offsets, compute = spgemm_dia_fn(pa, pb, b.n)
    m = a.m
    n_el_b = pb.rr * _LANE
    n_el_c = -(-max(m, b.n) // _LANE) * _LANE
    da = _dia_dev(pa, n_el_c, dev)
    db = _dia_dev(pb, n_el_b, dev)
    if materialize is None:
        materialize = dev.type != "cuda"
    if not materialize:
        Cp, rows, gidx = _dia_csc_pattern(c_offsets, m, b.n, n_el_c)
        vals = compute(da, db).reshape(-1)[torch.as_tensor(gidx, device=dev)]
        out = Sprs(len(rows), m, b.n, Cp.copy(), rows.copy(), None)
        out.x = vals  # a tensor on the device
        return out
    c = compute(da, db).cpu().numpy()
    nc = b.n
    Cp, ranges, slots = _dia_csc_layout(c_offsets, m, nc)
    rows = np.empty(int(Cp[nc]), dtype=np.int64)
    vals = np.empty(int(Cp[nc]), dtype=np.float64)
    for idx, o in enumerate(c_offsets):
        if slots[idx] is None:
            continue
        jlo, jhi = ranges[idx]
        rows[slots[idx]] = np.arange(jlo, jhi) + o
        vals[slots[idx]] = c[idx, jlo + o: jhi + o]
    if trim:
        keep = vals != 0.0
        kept_before = np.concatenate([[0], np.cumsum(keep)])
        Cp = kept_before[Cp]
        rows = rows[keep]
        vals = vals[keep]
    return Sprs(len(vals), m, nc, Cp, rows, vals)
