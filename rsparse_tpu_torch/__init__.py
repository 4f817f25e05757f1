"""rsparse_tpu_torch — the PyTorch/CUDA port of rsparse_tpu.

A second implementation of the sparse direct-solver framework, for one
NVIDIA H100 (sm_90a), checked against the JAX package it is ported from.
It imports torch and numpy, never jax or rsparse_tpu.

Ported so far (the `lusol_serve` slice):
  - L1' storage: `Sprs`, `Trpl`, `Symb`, `Nmrc`, `.sprs` IO (`data`), and
    `convert` to build them from plain numpy fields.
  - L2' ops: `ipvec`/`pvec`/`pinvert`, the permutation planners
    (`ops.plan`), and the level-scheduled SpTRSV sweep (`ops.sptrsv_cuda`:
    a hand-written CUDA kernel, with a plain torch twin for the CPU).
  - L3' symbolic: `sqr`/`schol`/AMD/etree/postorder on the native C++
    engine, compiled from the JAX package's source at first use.
  - L4' factorization: `lu` — multifrontal LU with threshold pivoting
    inside fronts, the level-scheduled LU below `config.mf_min_n`, and the
    host engine's exact partial pivoting as the fallback.
  - L5' solvers: batched triangular solves (`*solve_multi`) and the
    `lusol_serve` handle (float32 sweeps + float64 refinement on device).

The device-facing entry points take an explicit `device` argument.
"""

from .config import config
from .data import Sprs, Trpl, Symb, Nmrc
from .errors import RsparseError, NotPositiveDefiniteError, NoPivotError
from .ops import ipvec, pvec, pinvert
from .solve import (
    TriPlan,
    tri_plan,
    lsolve_multi,
    ltsolve_multi,
    usolve_multi,
    utsolve_multi,
    lusol_serve,
)
from .symbolic import schol, sqr
from .factor import lu
from .convert import sprs_from_fields, symb_from_fields

__all__ = [
    "config",
    "Sprs", "Trpl", "Symb", "Nmrc",
    "RsparseError", "NotPositiveDefiniteError", "NoPivotError",
    "ipvec", "pvec", "pinvert",
    "TriPlan", "tri_plan",
    "lsolve_multi", "ltsolve_multi", "usolve_multi", "utsolve_multi",
    "lusol_serve",
    "schol", "sqr", "lu",
    "sprs_from_fields", "symb_from_fields",
]
