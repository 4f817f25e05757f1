"""rsparse_tpu_torch — the PyTorch/CUDA port of rsparse_tpu.

A second implementation of the sparse direct-solver framework, for one
NVIDIA H100 (sm_90a), checked against the JAX package it is ported from.
It imports torch and numpy, never jax or rsparse_tpu.

Ported so far (the `lusol_serve` slice, the L2 operator slice, the
direct solvers `lusol`/`cholsol`/`qrsol`, the batched and serving
drivers, the batched-values drivers, the general operators, `utils` and
the distributed layer):
  - L1' storage: `Sprs`, `Trpl`, `Symb`, `Nmrc`, `.sprs` IO (`data`), the
    device view `CSCDevice` (`Sprs.to_device`/`from_device`), and
    `convert` to build them from plain numpy fields.
  - L2' ops: `add`, `multiply`, `transpose`, `gaxpy`, `norm`, `scpmat`,
    `scxmat`, `permute`, `symperm`, `fkeep`, `sprs_print`, `ipvec`/`pvec`/
    `pinvert` and the `Sprs` operator overloads (host plans in `ops.plan`,
    torch value passes in `ops.device`); `gaxpy_multi` on the streaming
    SpMM (`ops.spmm_cuda`); the DIA SpMV and `spgemm_dia` (`ops.spmv`); the
    level-scheduled SpTRSV sweep (`ops.sptrsv_cuda`); `ops.device.spmv_csc`
    on a `CSCDevice` (autograd through it), the general SpMV on the SpMM
    kernel (`ops.spmv_general`), the deterministic ESC SpGEMM
    (`ops.spgemm_general`) and device-resident op pipelines (`ops.chain`).
    The three kernels are hand-written CUDA (`csrc/`), each with a plain
    torch version for the CPU.
  - L3' symbolic: `sqr`/`schol`/AMD/etree/postorder on the native C++
    engine, compiled at first use from the port's own copy of its source
    (`native/rsymbolic.cpp`).
  - L4' factorization: `lu` — multifrontal LU with threshold pivoting
    inside fronts, the level-scheduled LU below `config.mf_min_n`, and the
    host engine's exact partial pivoting as the fallback; `chol` —
    multifrontal Cholesky (recursive skeleton), the level-scheduled
    Cholesky with its dense tail below `config.mf_min_n`; `qr` — the
    level-scheduled blocked Householder QR with the reference's exact V, R
    and beta (the host engine above its plan cap), and the multifrontal QR
    (batched dense fronts) behind `qrsol`. Factors are float64, their
    values numpy arrays.
  - L5' solvers: the single-RHS triangular solves (`lsolve`, `ltsolve`,
    `usolve`, `utsolve`) and their batched forms (`*solve_multi`); the
    `lusol` and `cholsol` solvers (multifrontal one-shot with f64
    refinement on device, host-exact escape); `qrsol` (least squares and
    minimum norm on the multifrontal QR, with an acceptance gate and a
    host-exact escape) and `qrsol_ls` (CSNE on the Cholesky factorization
    of A'A); the `lusol_serve`, `cholsol_serve` and `qrsol_serve` handles
    (float32 sweeps + float64 refinement on device); the batched drivers
    `cholsol_multi`, `lusol_multi` and `qrsol_multi` (numpy [n, nrhs] out,
    the serving branch behind `config.serve_mixed`) and the
    mixed-precision `cholsol_ir`; the batched-values drivers
    `cholsol_vals`, `lusol_vals` and `qrsol_vals` (K systems of one
    pattern: a leading instance dimension through the multifrontal
    factorizations, their solves and the SpTRSV sweep).
  - Aux (`utils`): the phase-metrics registry that `lusol`/`cholsol` fill,
    `profile_trace`, the kernels' `sanitize` mode, and `.npz` checkpoints
    of analyses and factors, interchangeable with the JAX package's.
  - L6' distributed (`parallel`, `parallel.halo`,
    `ops.spgemm_general.spgemm_general_dist`): the JAX package's mesh
    layer on `torch.distributed`, one process per rank (NCCL on cards,
    gloo on the CPU); imported on its own, as in the JAX package.

The device-facing entry points take an explicit `device` argument, which
defaults to the card ("cuda").
"""

from .config import config
from .data import Sprs, Trpl, Symb, Nmrc, CSCDevice
from .errors import RsparseError, NotPositiveDefiniteError, NoPivotError
from .ops import (
    add,
    multiply,
    transpose,
    gaxpy,
    gaxpy_multi,
    norm,
    scpmat,
    scxmat,
    permute,
    symperm,
    ipvec,
    pvec,
    pinvert,
    fkeep,
    sprs_print,
)
from .solve import (
    TriPlan,
    tri_plan,
    lsolve,
    ltsolve,
    usolve,
    utsolve,
    lsolve_multi,
    ltsolve_multi,
    usolve_multi,
    utsolve_multi,
    lusol,
    cholsol,
    lusol_serve,
    cholsol_serve,
    qrsol,
    qrsol_ls,
    cholsol_multi,
    lusol_multi,
    qrsol_multi,
    qrsol_serve,
    cholsol_ir,
    cholsol_vals,
    lusol_vals,
    qrsol_vals,
)
from .symbolic import schol, sqr
from .factor import chol, lu, qr
from .convert import sprs_from_fields, symb_from_fields
from . import utils

__all__ = [
    "config",
    "Sprs", "Trpl", "Symb", "Nmrc", "CSCDevice",
    "RsparseError", "NotPositiveDefiniteError", "NoPivotError",
    "add", "multiply", "transpose", "gaxpy", "gaxpy_multi", "norm",
    "scpmat", "scxmat", "permute", "symperm", "ipvec", "pvec", "pinvert",
    "fkeep", "sprs_print",
    "TriPlan", "tri_plan",
    "lsolve", "ltsolve", "usolve", "utsolve",
    "lsolve_multi", "ltsolve_multi", "usolve_multi", "utsolve_multi",
    "lusol", "cholsol", "lusol_serve", "cholsol_serve", "qrsol", "qrsol_ls",
    "cholsol_multi", "lusol_multi", "qrsol_multi", "qrsol_serve", "cholsol_ir",
    "cholsol_vals", "lusol_vals", "qrsol_vals",
    "schol", "sqr", "chol", "lu", "qr",
    "sprs_from_fields", "symb_from_fields",
]
