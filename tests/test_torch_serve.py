"""Port parity, the `lusol_serve` slice end to end: the torch package's
handle against the JAX package's on the same matrix (n = 400, with
`mf_min_n` patched down in both so the multifrontal LU runs), and both
against numpy's dense solve.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi  # noqa: E402


def _unsym(g, seed):
    """Nonsymmetric diagonally dominant matrix on the g x g 5-point pattern
    (the chip smoke's matrix at a test size)."""
    from bench import laplacian_5pt

    n, p, i, _ = laplacian_5pt(g)
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(n), np.diff(p))
    d = np.zeros((n, n))
    d[i, cols] = -(1.0 + 0.3 * rng.standard_normal(len(i)))
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, np.maximum(np.abs(d).sum(0), np.abs(d).sum(1)) + 1.0)
    return d


def test_lusol_serve_matches_jax_and_dense(monkeypatch):
    monkeypatch.setattr(rs.config, "mf_min_n", 300)
    monkeypatch.setattr(rt.config, "mf_min_n", 300)
    d = _unsym(20, 5)  # n = 400
    aj = rs.Sprs.new_from_vec(d)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    B = np.random.default_rng(6).standard_normal((aj.n, 8))
    Xj = np.asarray(rs.lusol_serve(aj, 1, 1e-6)(B), np.float64)
    h = rt.lusol_serve(at, 1, 1e-6, device="cpu")
    assert h.factor_route == "device_mf"
    assert not getattr(h.sym, "_static_rejected", False)
    Xt = h(B)
    assert Xt.dtype == torch.float64 and tuple(Xt.shape) == B.shape
    Xt = Xt.numpy()
    assert np.abs(Xt - Xj).max() / max(1.0, np.abs(Xj).max()) < 1e-10
    want = np.linalg.solve(d, B)
    for X in (Xt, Xj):
        assert np.abs(X - want).max() / max(1.0, np.abs(want).max()) < 1e-9
    assert h.last_residual <= 1e-10 * max(1.0, np.abs(B).max())
    # a second request reuses the handle's device state
    np.testing.assert_allclose(h(torch.as_tensor(B)).numpy(), Xt, rtol=0,
                               atol=1e-12 * np.abs(Xt).max())


def test_lusol_serve_level_path_and_natural_order():
    """Default mf_min_n at n = 144: the level LU (or its host fallback)
    feeds the same handle; natural order exercises the perm-free branch."""
    d = _unsym(12, 8)
    a = rt.Sprs.new_from_vec(d)
    B = np.random.default_rng(9).standard_normal((a.n, 3))
    want = np.linalg.solve(d, B)
    for order in (-1, 1):
        h = rt.lusol_serve(a, order, 1e-6, device="cpu")
        X = h(B).numpy()
        assert np.abs(X - want).max() / max(1.0, np.abs(want).max()) < 1e-10


def test_lusol_serve_cpu_runs_no_kernel():
    d = _unsym(6, 1)
    a = rt.Sprs.new_from_vec(d)
    before = sptrsv_multi.launches
    rt.lusol_serve(a, 1, 1e-6, device="cpu")(np.ones((a.n, 2)))
    assert sptrsv_multi.launches == before


def test_lusol_serve_singular_raises():
    """A structurally singular matrix: no pivot, in both packages."""
    d = np.eye(6) * 3.0
    d[:, 2] = 0.0
    d[2, 4] = 1.0
    aj = rs.Sprs.new_from_vec(d)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    with pytest.raises(rs.NoPivotError):
        rs.lusol_serve(aj, 1, 1e-6)
    with pytest.raises(rt.NoPivotError):
        rt.lusol_serve(at, 1, 1e-6, device="cpu")
