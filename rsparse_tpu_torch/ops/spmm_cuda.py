"""Streaming SpMM R[m, B] = A @ X[n, B] for any sparsity pattern: the CUDA
kernel and its plain torch version.

The counterpart of the JAX package's `rsparse_tpu/ops/spmm_pallas.py`,
whose Pallas kernel `_spmm_call` (f32 only, under a 9 MiB VMEM gate) is
replaced by the hand-written kernel in `csrc/spmm.cu` (float32 and
float64, no size gate; the source's header says what bounds it and how).

  - `spmm_plan(a)` / `spmm_plan_cached(a)`: the host plan (numpy): A's CSC
    entry rows and columns, and its CSR copy (row pointers, column ids and
    the CSR -> CSC entry permutation, from `ops.plan.transpose_plan`).
  - `launch_config(B, itemsize, x_ptr)`: the kernel's lanes per row, its
    tiles of RHS columns and its vector width.
  - `spmm_fn(plan)` returns `f(vals, X) -> R`, with vals the entry values
    in CSC order. On a CUDA tensor, f gathers them into CSR order
    (`vals[perm]`, a torch gather) and launches the kernel through
    `spmm_csr`; a build or launch failure raises, there is no fallback. On
    a CPU tensor, f runs `spmm_plain`, the plain torch version (one
    `index_add_` over the CSC entries), which the CPU tests use and the
    chip check compares the kernel with.
  - `spmm(a, X)`: R = A @ X in X's dtype (float32 or float64), plan cached
    per pattern; the counterpart of `spmm_pallas`.

The kernel is compiled with nvcc at its first launch (`cuda_build`).
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..data import Sprs
from . import cuda_build
from .plan import _cached_plan, col_ids, device_cache, transpose_plan

__all__ = ["SpmmPlan", "spmm_plan", "spmm_plan_cached", "spmm_fn", "spmm",
           "spmm_csr", "spmm_plain", "launch_config", "build"]

SOURCE = cuda_build.source("spmm")
_LANE_BYTES = 32  # bytes of a tile row per lane (csrc/spmm.cu: K * V values)
_MAX_LANES = 32


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Host plan of R = A @ X for one sparsity pattern of A."""

    m: int
    n: int
    nnz: int
    rows: np.ndarray  # [nnz] row of each CSC entry
    cols: np.ndarray  # [nnz] column of each CSC entry
    row_ptr: np.ndarray  # [m + 1] CSR row pointers
    col_idx: np.ndarray  # [nnz] CSR column ids
    perm: np.ndarray  # [nnz] CSR entry -> CSC entry position


def spmm_plan(a: Sprs) -> SpmmPlan:
    nz = a.nnz()
    tp = transpose_plan(a)
    return SpmmPlan(a.m, a.n, nz, np.asarray(a.i[:nz], np.int64),
                    col_ids(a.p, a.n), tp.out_p, tp.out_i, tp.perm)


def spmm_plan_cached(a: Sprs) -> SpmmPlan:
    """Pattern-keyed plan cache (shares `ops.plan`'s LRU)."""
    return _cached_plan("spmm", spmm_plan, a)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmm_csr_f32, lib.spmm_csr_f64):
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
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


def spmm_plain(vals: torch.Tensor, X: torch.Tensor,
               plan: SpmmPlan) -> torch.Tensor:
    """Plain torch R = A @ X (any device): R[rows] += vals * X[cols] over
    A's CSC entries. The kernel's reference version."""
    _check(vals, X, plan)
    st = _streams(plan, X.device)
    return X.new_zeros((plan.m, X.shape[1])).index_add_(
        0, st["rows"], vals[:, None] * X[st["cols"]])


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


def spmm_csr(vals_csr: torch.Tensor, X: torch.Tensor,
             plan: SpmmPlan) -> torch.Tensor:
    """The kernel on a CUDA device: R = A @ X with A's values already in CSR
    order (`vals[perm]`). Returns a new [m, B] tensor."""
    if X.device.type != "cuda":
        raise ValueError(f"the SpMM kernel runs on a CUDA device, not {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"SpMM kernel takes float32/float64, got {X.dtype}")
    _check(vals_csr, X, plan)
    m, B = plan.m, X.shape[1]
    R = X.new_empty((m, B))
    if m == 0 or B == 0:
        return R
    st = _streams(plan, X.device)
    X = X.contiguous()
    cfg = launch_config(B, X.element_size(), X.data_ptr())
    if cfg["tiles"] > 65535:
        raise ValueError(f"B = {B} is too wide for the kernel's grid")
    lib = build()
    fn = lib.spmm_csr_f32 if X.dtype == torch.float32 else lib.spmm_csr_f64
    dev = X.device
    rc = fn(dev.index if dev.index is not None else torch.cuda.current_device(),
            st["row_ptr"].data_ptr(), st["col_idx"].data_ptr(),
            vals_csr.contiguous().data_ptr(), X.data_ptr(), R.data_ptr(),
            m, B, cfg["V"], cfg["W"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SpMM kernel launch failed (cudaError {rc})")
    spmm_csr.launches += 1
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
