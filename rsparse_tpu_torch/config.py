"""Global configuration for rsparse_tpu_torch.

The reference library (rsparse) exposes exactly two behavioural knobs —
`order` and `tol` — as positional parameters; they stay on the public solver
APIs. This layer holds the few package-wide options: the value and index
dtypes, the numeric backend, the size at which `lu` switches to the
multifrontal path, and when the batched drivers take the serving path. The device is not a config option: the device-facing
entry points take it as an argument.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # Value dtype of host containers and of the factors. float64 matches the
    # reference's f64 tolerances.
    dtype: str = "float64"
    # Index dtype handed to device kernels. int32 suffices for n, nnz < 2**31.
    index_dtype: str = "int32"
    # Numeric backend: "device" runs the factorization and solves as torch
    # code and CUDA kernels on the caller's device; "host" runs the native
    # C++ engine (the reference-exact oracle).
    backend: str = os.environ.get("RSPARSE_TORCH_BACKEND", "device")
    # Minimum n for the multifrontal LU; below it the level-scheduled LU runs.
    mf_min_n: int = 1500
    # Serving path of the batched drivers (cholsol_multi's level route,
    # qrsol_multi): float32 sweeps plus float64 refinement through a cached
    # serve handle. "auto" takes it on a CUDA device, "force" on any device
    # (on the CPU through the plain sweep), "off" never.
    serve_mixed: str = "auto"


config = Config()
