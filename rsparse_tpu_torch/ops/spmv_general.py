"""General-sparsity SpMV r = A @ x on the streaming SpMM kernel at B = 1.

The JAX package's `rsparse_tpu/ops/spmv_general.py` routes gathers and
scatters through 128 x 128 one-hot matmuls, because XLA on a TPU pays about
10 ns per index. A GPU gathers by address, so the port keeps the module's
public functions and computes them with the hand-written SpMM kernel
(`csrc/spmm.cu`, `ops.spmm_cuda`) on one right-hand-side column: A's CSR
copy, one lane per output row.

  - `mxu_spmv_plan(a, dtype)`: the kernel's CSR plan of A, A's values in CSR
    order (`plan.vals`) and `plan.perm`, each CSC entry's slot in
    `plan.vals`, so that `vals[plan.perm] = a.x[:nnz]` refreshes the values
    without planning again.
  - `spmv_general_fn(plan)` returns `f(vals, x) -> r`: on a CUDA tensor the
    kernel (`spmm_csr`), on a CPU tensor its plain version (`spmm_plain`).
  - `spmv_general(a, x)`: r = A @ x on `device`, in the plan's dtype.

The names keep the JAX package's, MXU included, so that callers port
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data import Sprs
from .plan import device_cache
from .spmm_cuda import SpmmPlan, spmm_csr, spmm_plain, spmm_plan

__all__ = ["MxuSpmvPlan", "mxu_spmv_plan", "spmv_general", "spmv_general_fn"]


@dataclasses.dataclass(frozen=True)
class MxuSpmvPlan:
    """Static per-pattern plan of the general SpMV."""

    m: int
    n: int
    nnz: int
    spmm: SpmmPlan  # the kernel's CSR plan of A
    vals: np.ndarray  # [nnz] A's values in CSR order, in the plan's dtype
    perm: np.ndarray  # [nnz] CSC entry -> its slot in vals


def mxu_spmv_plan(a: Sprs, dtype=np.float32) -> MxuSpmvPlan:
    sp = spmm_plan(a)
    perm = np.empty(sp.nnz, np.int64)
    perm[sp.perm] = np.arange(sp.nnz, dtype=np.int64)
    vals = np.asarray(a.x[: sp.nnz]).astype(dtype)[sp.perm]
    return MxuSpmvPlan(a.m, a.n, sp.nnz, sp, vals, perm)


def spmv_general_fn(plan: MxuSpmvPlan, precision: str = "highest"):
    """Return `f(vals, x) -> r` for the plan.

    vals: a tensor of A's values in CSR order (`plan.vals`, or values
    refreshed through `plan.perm`), x [n] on its device, cast to its dtype.
    A CUDA tensor goes through the SpMM kernel, a CPU tensor through its
    plain version. `precision` keeps the JAX signature: "high" (a TPU matmul
    mode there) gives the same exact products as "highest" here.
    """
    if precision not in ("highest", "high"):
        raise ValueError(f"precision must be 'highest' or 'high', got {precision!r}")
    sp = plan.spmm

    def f(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        X = x.to(vals.dtype)[:, None]
        if X.device.type == "cuda":
            return spmm_csr(vals, X, sp)[:, 0]
        if X.device.type == "cpu":
            perm = device_cache(plan, "_perm", X.device,
                                lambda: torch.as_tensor(plan.perm, device=X.device))
            return spmm_plain(vals[perm], X, sp)[:, 0]
        raise ValueError(f"no SpMV path for device {X.device}")

    return f


def spmv_general(a: Sprs, x, plan: Optional[MxuSpmvPlan] = None, *,
                 device="cuda") -> torch.Tensor:
    """r = A @ x on `device` (plan built on the fly if absent), in the
    plan's dtype."""
    p = plan or mxu_spmv_plan(a)
    vals = torch.as_tensor(p.vals, device=device)
    return spmv_general_fn(p)(vals, torch.as_tensor(np.asarray(x), dtype=vals.dtype,
                                                    device=device))
