"""Streaming SpMM R[m, B] = A @ X[n, B] for any sparsity pattern: the CUDA
kernel and its plain torch version.

The counterpart of the JAX package's `rsparse_tpu/ops/spmm_pallas.py`,
whose Pallas kernel `_spmm_call` (f32 only, under a 9 MiB VMEM gate) is
replaced by the hand-written kernel in `csrc/spmm.cu` (float32 and
float64, no size gate; the source's header says what bounds it and how).

  - `spmm_plan(a)` / `spmm_plan_cached(a)`: the host plan (numpy): A's CSC
    entry rows and columns, and its CSR copy (row pointers, column ids and
    the CSR -> CSC entry permutation, a stable sort by row, as
    `ops.plan.transpose_plan`'s); `spmm_plan_coo(rows, cols, m, n)` the
    same for A given as COO entries in any order.
  - `launch_config(B, itemsize, x_ptr)`: the kernel's lanes per row, its
    tiles of RHS columns and its vector width.
  - `spmm_fn(plan)` returns `f(vals, X) -> R`, with vals the entry values
    in CSC order. On a CUDA tensor, f gathers them into CSR order
    (`vals[perm]`, a torch gather) and launches the kernel through
    `spmm_csr`; a build or launch failure raises, there is no fallback. On
    a CPU tensor, f runs `spmm_plain`, the plain torch version (one
    `index_add_` over the CSC entries), which the CPU tests use and the
    chip check compares the kernel with.
  - `spmm_csr(..., sub=S)` and `spmm_plain(..., sub=S)`: the residual
    form R = S - A @ X, in the kernel one launch (its store subtracts).
  - `spmm(a, X)`: R = A @ X in X's dtype (float32 or float64), plan cached
    per pattern; the counterpart of `spmm_pallas`.

The kernel is compiled with nvcc at its first launch (`cuda_build`).
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data import Sprs
from . import cuda_build
from .plan import _cached_plan, col_ids, device_cache

__all__ = ["SpmmPlan", "spmm_plan", "spmm_plan_coo", "spmm_plan_cached",
           "spmm_fn", "spmm", "spmm_csr", "spmm_plain", "launch_config",
           "build"]

SOURCE = cuda_build.source("spmm")
_LANE_BYTES = 32  # bytes of a tile row per lane (csrc/spmm.cu: K * V values)
_MAX_LANES = 32


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Host plan of R = A @ X for one sparsity pattern of A."""

    m: int
    n: int
    nnz: int
    rows: np.ndarray  # [nnz] row of each CSC (or COO) entry
    cols: np.ndarray  # [nnz] column of each CSC (or COO) entry
    row_ptr: np.ndarray  # [m + 1] CSR row pointers
    col_idx: np.ndarray  # [nnz] CSR column ids
    perm: np.ndarray  # [nnz] CSR entry -> CSC (or COO) entry position


def spmm_plan_coo(rows, cols, m: int, n: int) -> SpmmPlan:
    """Plan of R = A @ X for the m x n matrix A given as COO entries (rows,
    cols) in any order, duplicates summed; vals are given in that order.
    The CSR copy keeps the entries of a row in that order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    perm = np.argsort(rows, kind="stable")
    row_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    return SpmmPlan(m, n, len(rows), rows, cols, row_ptr, cols[perm], perm)


def spmm_plan(a: Sprs) -> SpmmPlan:
    nz = a.nnz()
    return spmm_plan_coo(a.i[:nz], col_ids(a.p, a.n), a.m, a.n)


def spmm_plan_cached(a: Sprs) -> SpmmPlan:
    """Pattern-keyed plan cache (shares `ops.plan`'s LRU)."""
    return _cached_plan("spmm", spmm_plan, a)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmm_csr_f32, lib.spmm_csr_f64):
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return cuda_build.load("spmm", _declare)


def _streams(plan: SpmmPlan, device: torch.device) -> dict:
    """The plan's index arrays as tensors on `device` (cached)."""

    def make():
        if plan.nnz >= 2**31 or plan.m >= 2**31:
            raise ValueError("pattern too large for the kernel's int32 indices")
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                        device=device)
        i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                        device=device)
        return dict(rows=i64(plan.rows), cols=i64(plan.cols),
                    row_ptr=i32(plan.row_ptr), col_idx=i32(plan.col_idx),
                    perm=i64(plan.perm))

    return device_cache(plan, "_spmm_streams", device, make)


def _check(vals: torch.Tensor, X: torch.Tensor, plan: SpmmPlan) -> None:
    if X.dim() != 2 or X.shape[0] != plan.n:
        raise ValueError(f"X must be [{plan.n}, B], got {tuple(X.shape)}")
    if vals.dim() != 1 or vals.shape[0] != plan.nnz:
        raise ValueError(f"vals must be [{plan.nnz}], got {tuple(vals.shape)}")
    if vals.dtype != X.dtype or vals.device != X.device:
        raise ValueError("vals and X must share dtype and device")


def _check_sub(sub: torch.Tensor, X: torch.Tensor, plan: SpmmPlan) -> None:
    """The residual form's S: R's shape [m, B], X's dtype and device,
    contiguous."""
    if tuple(sub.shape) != (plan.m, X.shape[1]):
        raise ValueError(f"sub must be [{plan.m}, {X.shape[1]}], got "
                         f"{tuple(sub.shape)}")
    if sub.dtype != X.dtype or sub.device != X.device:
        raise ValueError("sub and X must share dtype and device")
    if not sub.is_contiguous():
        raise ValueError("sub must be contiguous")


def spmm_plain(vals: torch.Tensor, X: torch.Tensor, plan: SpmmPlan,
               sub: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch R = A @ X (any device): R[rows] += vals * X[cols] over
    A's CSC entries; with `sub`, R = sub - A @ X. The kernel's reference
    version."""
    _check(vals, X, plan)
    if sub is not None:
        _check_sub(sub, X, plan)
    st = _streams(plan, X.device)
    R = X.new_zeros((plan.m, X.shape[1])).index_add_(
        0, st["rows"], vals[:, None] * X[st["cols"]])
    return R if sub is None else sub - R


def launch_config(B: int, itemsize: int, x_ptr: int) -> dict:
    """The kernel's lanes per row W (the least power of two, at most 32,
    for which W lanes of 32 bytes cover B columns), its tile of W * 32
    bytes of columns (one tile up to 128 float64 or 256 float32 columns,
    ragged tiles beyond), the number of tiles, and its vector width V:
    float4 gathers in float32 when B and X's base allow it, else scalars
    (always in float64: `csrc/spmm.cu` says why)."""
    per_lane = _LANE_BYTES // itemsize
    W = 1
    while W < _MAX_LANES and W * per_lane < B:
        W *= 2
    V = 4 if itemsize == 4 and B % 4 == 0 and x_ptr % 16 == 0 else 1
    tile = W * per_lane
    return {"V": V, "W": W, "tile": tile, "tiles": -(-B // tile)}


def spmm_csr(vals_csr: torch.Tensor, X: torch.Tensor, plan: SpmmPlan,
             sub: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on a CUDA device: R = A @ X with A's values already in CSR
    order (`vals[perm]`); with `sub` (R's shape, X's dtype and device,
    contiguous), the residual form R = sub - A @ X in the same launch.
    Returns a new [m, B] tensor."""
    if X.device.type != "cuda":
        raise ValueError(f"the SpMM kernel runs on a CUDA device, not {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"SpMM kernel takes float32/float64, got {X.dtype}")
    _check(vals_csr, X, plan)
    if sub is not None:
        _check_sub(sub, X, plan)
    m, B = plan.m, X.shape[1]
    R = X.new_empty((m, B))
    if m == 0 or B == 0:
        return R
    st = _streams(plan, X.device)
    X = X.contiguous()
    s_ptr = sub.data_ptr() if sub is not None else None
    # float4 gathers of X and of S need both 16-byte aligned
    cfg = launch_config(B, X.element_size(), X.data_ptr() | (s_ptr or 0))
    if cfg["tiles"] > 65535:
        raise ValueError(f"B = {B} is too wide for the kernel's grid")
    lib = build()
    sanitize = cuda_build.sanitizing()
    if sanitize:
        if st["row_ptr"].numel() != m + 1:
            raise IndexError(f"SpMM kernel: row_ptr must hold {m + 1} pointers")
        cuda_build.check_pointers("SpMM", "row_ptr", st["row_ptr"], plan.nnz)
        cuda_build.check_index("SpMM", "col_idx", st["col_idx"], plan.n)
    fn = lib.spmm_csr_f32 if X.dtype == torch.float32 else lib.spmm_csr_f64
    dev = X.device
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            st["row_ptr"].data_ptr(), st["col_idx"].data_ptr(),
            vals_csr.contiguous().data_ptr(), X.data_ptr(), s_ptr,
            R.data_ptr(), m, B, cfg["V"], cfg["W"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SpMM kernel launch failed (cudaError {rc})")
    spmm_csr.launches += 1
    if sanitize:
        cuda_build.synchronize("SpMM", dev)
    return R


spmm_csr.launches = 0  # kernel launches (the CPU path does not count)


def spmm_fn(plan: SpmmPlan):
    """Return `f(vals, X[n, B]) -> R[m, B]` for the pattern.

    vals: A's entry values in CSC order (`a.x[:nnz]` as a tensor), on X's
    device and in X's dtype, kept there across calls. A CUDA tensor goes
    through the kernel, a CPU tensor through the plain version.
    """

    def f(vals: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        _check(vals, X, plan)
        if X.device.type == "cuda":
            return spmm_csr(vals[_streams(plan, X.device)["perm"]], X, plan)
        if X.device.type == "cpu":
            return spmm_plain(vals, X, plan)
        raise ValueError(f"no SpMM path for device {X.device}")

    return f


def spmm(a: Sprs, X, *, device="cuda") -> torch.Tensor:
    """R = A @ X on `device`, in X's dtype (float32 or float64); the plan is
    cached per pattern. Use `spmm_plan`/`spmm_fn` directly to keep the
    values on the device across calls."""
    Xt = torch.as_tensor(X, device=device)
    if Xt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spmm takes a float32/float64 X, got {Xt.dtype}")
    vals = torch.as_tensor(a.x[: a.nnz()], device=device).to(Xt.dtype)
    return spmm_fn(spmm_plan_cached(a))(vals, Xt)
