"""The port's CUDA kernels against their plain torch versions: the SpTRSV
sweep (csrc/sptrsv.cu), the streaming SpMM (csrc/spmm.cu) and the DIA SpMV
(csrc/spmv_dia.cu).

This file imports neither jax nor the JAX package (only the numpy test
matrix of bench.py), so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

The `gpu` tests skip without a card. The CPU tests hold the plain versions
(the wrappers' path for CPU tensors) to dense numpy products and solves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench import laplacian_5pt, rand_csc  # noqa: E402  (numpy only)
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.ops import spmv as spmv_mod  # noqa: E402
from rsparse_tpu_torch.ops.spmm_cuda import (  # noqa: E402
    spmm_csr, spmm_fn, spmm_plain, spmm_plan)
from rsparse_tpu_torch.ops.sptrsv_cuda import (  # noqa: E402
    sptrsv_multi, sptrsv_plain_multi)
from rsparse_tpu_torch.symbolic import native  # noqa: E402


def _tri(kind, g=12):
    """L (kinds 0/2) or U (kinds 1/3) of the host engine's LU of a g x g
    5-point Laplacian."""
    n, p, i, x = laplacian_5pt(g)
    a = sprs_from_fields(n, n, p, i, x)
    s = rt.sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, _ = native.lu_numeric(
        n, a.p, a.i, a.x, s.q, 1e-6, s.lnz, s.unz)
    return sprs_from_fields(n, n, *((Lp, Li, Lx) if kind in (0, 2)
                                    else (Up, Ui, Ux)))


def _rel(got, ref):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_plain_sweep_vs_dense_solve(kind, dtype, tol):
    t = _tri(kind, g=6)
    D = t.to_dense_np()
    M = D if kind in (0, 1) else D.T
    B = np.random.default_rng(kind).standard_normal((t.n, 5))
    X = sptrsv_plain_multi(torch.as_tensor(t.x[: t.nnz()], dtype=dtype),
                           torch.as_tensor(B, dtype=dtype),
                           rt.tri_plan(t, kind), kind)
    want = torch.as_tensor(np.linalg.solve(M, B))
    assert _rel(X, want) < tol


_SWEEP_CASES: dict = {}


def _sweep_case(name, kind):
    """The triangle and its plan for kind: "dense", L or U of the port's
    multifrontal LU of chip_smoke.make_matrix(24) (a dense skeleton block of
    109 columns); "levels", the host engine's factor of `_tri` (no block);
    "large", chip_smoke.synthetic_triangle(70000, 96), whose n is too large
    for X's column in shared memory (the global-memory variant)."""
    key = (name, kind)
    if key not in _SWEEP_CASES:
        import chip_smoke

        if name == "dense":
            old, rt.config.mf_min_n = rt.config.mf_min_n, 100
            try:
                a = chip_smoke.make_matrix(24, 0)
                s = rt.sqr(a, 1, False)
                nm = rt.lu(a, s, 1e-6, device="cpu")
                assert s._lu_route == "device_mf"
            finally:
                rt.config.mf_min_n = old
            t = nm.l if kind in (0, 2) else nm.u
            t = sprs_from_fields(t.n, t.n, t.p, t.i, t.x.cpu().numpy())
        elif name == "levels":
            t = _tri(kind)
        else:
            L, U = chip_smoke.synthetic_triangle(70000, 96, 0)
            t = L if kind in (0, 2) else U
        _SWEEP_CASES[key] = (t, rt.tri_plan(t, kind))
    return _SWEEP_CASES[key]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 40, 128, 130])
@pytest.mark.parametrize("case", ["dense", "levels", "large"])
def test_kernel_matches_plain_on_card(case, kind, dtype, tol, B):
    """One launch per sweep, against the level loop. f32: atomics reorder
    the sums from run to run; f64: rounding level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    t, plan = _sweep_case(case, kind)
    assert (plan.dense is not None) == (case != "levels")
    cfg = launch_config(plan, dtype, "cuda")
    assert cfg["variant"] == ("global" if case == "large" else "shared")
    tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((t.n, B)),
                        dtype=dtype, device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
    assert got.shape == X.shape and got.is_contiguous()
    assert _rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol


@pytest.mark.gpu
def test_serve_handle_on_card():
    """lusol_serve on the card answers with the kernel in its sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, p, i, x = laplacian_5pt(20)
    a = sprs_from_fields(n, n, p, i, x)
    B = np.random.default_rng(1).standard_normal((n, 64))
    before = sptrsv_multi.launches
    h = rt.lusol_serve(a, 1, 1e-6, device="cuda")
    X = h(B)
    assert X.device.type == "cuda" and sptrsv_multi.launches >= before + 4
    want = rt.lusol_serve(a, 1, 1e-6, device="cpu")(B)
    assert _rel(X, want) < 1e-10


def _rand_sprs(m, n, nnz, seed):
    return sprs_from_fields(m, n, *rand_csc(m, n, nnz, seed))


def _banded(n, seed, far):
    """A 5-point Laplacian (g = n**0.5) with `far` stray entries added off
    its band, which a `max_diags=5` plan sends to the COO remainder."""
    g = int(round(n ** 0.5))
    n, p, i, x = laplacian_5pt(g)
    d = sprs_from_fields(n, n, p, i, x).to_dense_np()
    rng = np.random.default_rng(seed)
    for _ in range(far):
        d[rng.integers(n), rng.integers(n)] = rng.standard_normal()
    return rt.Sprs.new_from_vec(d)


@pytest.mark.parametrize("B", [1, 8, 40, 128])
def test_plain_spmm_vs_dense(B):
    a = _rand_sprs(70, 50, 300, B)
    plan = spmm_plan(a)
    X = np.random.default_rng(B).standard_normal((50, B))
    R = spmm_plain(torch.as_tensor(a.x[: a.nnz()]), torch.as_tensor(X), plan)
    assert _rel(R, torch.as_tensor(a.to_dense_np() @ X)) < 1e-13


@pytest.mark.parametrize("far", [0, 7])
def test_plain_dia_vs_dense(far):
    a = _banded(144, far, far)
    plan = spmv_mod.dia_plan(a, max_diags=5, dtype=np.float64)
    assert (plan.rem_vals is not None) == (far > 0)
    x = np.random.default_rng(far).standard_normal(a.n)
    r = spmv_mod.spmv_fn(plan)(torch.as_tensor(plan.dia), torch.as_tensor(x))
    assert _rel(r, torch.as_tensor(a.to_dense_np() @ x)) < 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [1, 8, 40, 128])
@pytest.mark.parametrize("shape", [(700, 500, 4000), (300, 900, 2500),
                                   (64, 64, 0)])
def test_spmm_kernel_matches_plain_on_card(shape, B, dtype, tol):
    """Rows in any order per row, no atomics: rounding-level differences
    from the plain version's CSC-order sums only. m != n, empty rows
    (the sparse shapes have many) and nnz = 0 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n, nnz = shape
    a = _rand_sprs(m, n, nnz, B) if nnz else rt.Sprs.zeros(m, n, 0)
    plan = spmm_plan(a)
    vals = torch.as_tensor(a.x[: a.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((n, B)),
                        dtype=dtype, device="cuda")
    before = spmm_csr.launches
    got = spmm_fn(plan)(vals, X)
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + 1
    assert tuple(got.shape) == (m, B) and got.dtype == dtype
    assert _rel(got, spmm_plain(vals, X, plan)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("far", [0, 9])
def test_dia_kernel_matches_plain_on_card(far, dtype, tol):
    """The diagonal kernel, with and without a COO remainder, and one plan
    with more than 256 diagonals (several chunks of staged offsets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    a = _banded(1024, far, far)
    cases = [spmv_mod.dia_plan(a, max_diags=5, dtype=np_dt)]
    wide = _rand_sprs(600, 600, 6000, far)
    cases.append(spmv_mod.dia_plan(wide, max_diags=10**9, dtype=np_dt))
    assert len(cases[1].offsets) > 256
    for mat, plan in ((a, cases[0]), (wide, cases[1])):
        dia = torch.as_tensor(plan.dia, device="cuda")
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(mat.n),
                            dtype=dtype, device="cuda")
        before = spmv_mod.dia_spmv.launches
        diag = spmv_mod.dia_spmv(dia, x, plan)
        full = spmv_mod.spmv_fn(plan)(dia, x)
        torch.cuda.synchronize()
        assert spmv_mod.dia_spmv.launches == before + 2
        assert _rel(diag, spmv_mod.dia_spmv_plain(dia, x, plan)) < tol
        # with the remainder: against the whole CPU path on the same inputs
        assert _rel(full, spmv_mod.spmv_fn(plan)(dia.cpu(), x.cpu())) < tol


@pytest.mark.gpu
def test_public_ops_launch_on_card():
    """gaxpy_multi and spmv on the card go through their kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _banded(400, 3, 3)
    X = np.random.default_rng(2).standard_normal((a.n, 16))
    before = spmm_csr.launches
    R = rt.gaxpy_multi(a, X, np.ones(a.m), device="cuda")
    assert spmm_csr.launches == before + 1 and R.device.type == "cuda"
    assert _rel(R, torch.as_tensor(a.to_dense_np() @ X + 1.0)) < 1e-12
    before = spmv_mod.dia_spmv.launches
    r = spmv_mod.spmv(a, X[:, 0], device="cuda")
    assert spmv_mod.dia_spmv.launches == before + 1
    assert _rel(r, torch.as_tensor(a.to_dense_np() @ X[:, 0])) < 1e-5
