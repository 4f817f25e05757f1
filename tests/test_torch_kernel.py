"""The SpTRSV sweep kernel (rsparse_tpu_torch/csrc/sptrsv.cu) against its
plain torch version.

This file imports neither jax nor the JAX package (only the numpy test
matrix of bench.py), so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

The `gpu` tests skip without a card. The CPU tests hold the plain version
(the wrapper's path for CPU tensors) to dense triangular solves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench import laplacian_5pt  # noqa: E402  (numpy only)
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [2, 40, 128])
def test_kernel_matches_plain_on_card(kind, dtype, tol, B):
    """f32: atomics reorder the sums from run to run; f64: rounding level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = _tri(kind)
    plan = rt.tri_plan(t, kind)
    tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((t.n, B)),
                        dtype=dtype, device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
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
