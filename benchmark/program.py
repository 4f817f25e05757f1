"""The system under test, `rsparse_tpu_torch`, as the drivers call it.

The only file of the benchmark that imports the program. It hands the
program the generated CSC arrays wrapped in its `Sprs` and reads back the
answers, the routes taken, the handles' own build seconds and the kernels'
launch counters.
"""

import numpy as np


def _sprs(n, p, i, x):
    from rsparse_tpu_torch import Sprs

    return Sprs(len(x), n, n, p, i, np.array(x, np.float64))


def server(cfg: dict, arrays, device):
    """(h, info): the serve handle of the configuration's family on A,
    h(B[n, m] on the device) -> X on the device."""
    import rsparse_tpu_torch as rt

    a = _sprs(*arrays)
    if cfg["family"] == "cholesky":
        h = rt.cholsol_serve(a, cfg["order"], device=device)
    else:
        h = rt.lusol_serve(a, cfg["order"], cfg["tol"], device=device)
    info = {"route": h.factor_route,
            "build_seconds": dict(h.build_seconds),
            # the factor's CSC as the factorization returned it, per sweep
            "factor_nnz": [int(v.numel()) for _, v, _ in h.chain],
            "sweep_dtype": str(h.chain[0][1].dtype).replace("torch.", "")}
    if cfg["family"] == "cholesky":
        info["lnz"] = int(h.sym.lnz)
    return h, info


def refactor(cfg: dict, arrays, device):
    """(solve, info): one analysis of A's pattern, then solve(values, b)
    -> x (numpy) through the one-shot driver with the analysis reused;
    info["routes"] gathers the routes the calls took."""
    import rsparse_tpu_torch as rt

    n, p, i, x0 = arrays
    a0 = _sprs(n, p, i, x0)
    cholesky = cfg["family"] == "cholesky"
    s = rt.schol(a0, cfg["order"]) if cholesky else rt.sqr(a0, cfg["order"], False)
    info = {"routes": {}}

    def solve(values, b):
        a = _sprs(n, p, i, values)
        bb = np.array(b, np.float64)
        if cholesky:
            out = rt.cholsol(a, bb, cfg["order"], sym=s, device=device)
            route = getattr(s, "_chol_route", None)
        else:
            out = rt.lusol(a, bb, cfg["order"], cfg["tol"], sym=s, device=device)
            route = getattr(s, "_lu_route", None)
        info["routes"][route] = info["routes"].get(route, 0) + 1
        return out

    return solve, info


def read_counters() -> dict:
    """The three kernels' launch counters, by the counter's name."""
    from rsparse_tpu_torch.ops import spmv
    from rsparse_tpu_torch.ops.spmm_cuda import spmm_csr
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    return {"sptrsv_multi": sptrsv_multi.launches,
            "spmm_csr": spmm_csr.launches,
            "dia_spmv": spmv.dia_spmv.launches}
