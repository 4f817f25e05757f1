"""Port parity, SpTRSV sweep: the torch package's sweep against the JAX
package's Pallas kernel (float32, run through the Pallas interpreter on the
CPU, as tests/test_sptrsv_pallas.py runs it) and its f64 XLA level sweep,
for all four kinds, on the LU of a 12 x 12 5-point Laplacian.

On the CPU the port's wrapper runs its plain torch version; the CUDA kernel
itself is checked against that version in tests/test_torch_kernel.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu.ops.sptrsv_pallas import sptrsv_pallas_multi  # noqa: E402
from rsparse_tpu.solve import _tri_solve_multi as tri_solve_jax  # noqa: E402
from rsparse_tpu.solve import tri_plan as tri_plan_jax  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi  # noqa: E402


def _factors(g=12):
    """Host-engine LU of a 5-point Laplacian (well-conditioned, so f32
    reordering stays at rounding level)."""
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    a = rs.Sprs(len(x), n, n, p, i, x)
    s = rs.sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, _ = rs.symbolic.native.lu_numeric(
        n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q, 1e-6, s.lnz, s.unz)
    return n, (Lp, Li, Lx), (Up, Ui, Ux)


def _tri(kind):
    n, L, U = _factors()
    p, i, x = L if kind in (0, 2) else U
    return rs.Sprs(len(x), n, n, p, i, x), sprs_from_fields(n, n, p, i, x)


def _rel(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sweep_f32_matches_pallas(kind):
    tj, tt = _tri(kind)
    X = np.random.default_rng(kind).standard_normal((tj.n, 16))
    ref = np.asarray(sptrsv_pallas_multi(tj.x[: tj.nnz()], X, tri_plan_jax(tj, kind), kind),
                     np.float64)
    tx = torch.as_tensor(tt.x[: tt.nnz()], dtype=torch.float32)
    got = sptrsv_multi(tx, torch.as_tensor(X, dtype=torch.float32),
                       rt.tri_plan(tt, kind), kind)
    assert got.dtype == torch.float32
    # f32 with a different accumulation order (the TPU test's tolerance)
    assert _rel(got.double().numpy(), ref) < 5e-5


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sweep_f64_matches_xla(kind):
    tj, tt = _tri(kind)
    X = np.random.default_rng(10 + kind).standard_normal((tj.n, 7))
    ref = np.asarray(tri_solve_jax(tj, X, kind))
    got = rt.solve._tri_solve_multi(tt, X, kind, device="cpu")
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12


def test_multi_wrappers_and_dense_oracle():
    """lsolve/usolve/ltsolve/utsolve_multi solve the dense triangular
    systems (f64, reordered sums only)."""
    n, L, U = _factors(6)
    lt = sprs_from_fields(n, n, *L)
    ut = sprs_from_fields(n, n, *U)
    Ld, Ud = lt.to_dense_np(), ut.to_dense_np()
    B = np.random.default_rng(3).standard_normal((n, 4))
    for fn, mat, M in ((rt.lsolve_multi, lt, Ld), (rt.usolve_multi, ut, Ud),
                       (rt.ltsolve_multi, lt, Ld.T), (rt.utsolve_multi, ut, Ud.T)):
        X = fn(mat, B, device="cpu").numpy()
        assert np.abs(M @ X - B).max() < 1e-12


def test_wrapper_rejects_mismatch():
    _, tt = _tri(0)
    plan = rt.tri_plan(tt, 0)
    tx = torch.as_tensor(tt.x[: tt.nnz()])
    with pytest.raises(ValueError, match="dtype"):
        sptrsv_multi(tx, torch.zeros((tt.n, 2), dtype=torch.float32), plan, 0)
    with pytest.raises(ValueError, match="kind"):
        sptrsv_multi(tx, torch.zeros((tt.n, 2), dtype=torch.float64), plan, 4)


def test_cpu_path_counts_no_launch():
    _, tt = _tri(1)
    before = sptrsv_multi.launches
    rt.usolve_multi(tt, np.ones((tt.n, 3)), device="cpu")
    assert sptrsv_multi.launches == before
