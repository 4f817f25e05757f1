"""Port parity, the `cholsol` solver and the `cholsol_serve` handle: the
torch package against the JAX package on the same seeded inputs, and both
against numpy's dense solve, at n <= 150 (`mf_min_n` patched down in both
packages to force the multifrontal one-shot), on `torch_cases`' inputs.
Device routes agree to 1e-10 relative, the host engine (`config.backend =
"host"`) to 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.solve as solve_torch  # noqa: E402
import torch_cases as C  # noqa: E402


@pytest.mark.parametrize("order,route", [(0, "device_mf"), (1, "device_mf"),
                                         (0, "device_level"),
                                         (-1, "device_level")])
def test_cholsol_matches_jax_and_dense(monkeypatch, order, route):
    C.mf(monkeypatch, 100 if route == "device_mf" else 10**9)
    at = C.port("lap12")
    b = np.random.default_rng(12 + order).standard_normal(at.n)
    want = np.linalg.solve(C.dense("lap12"), b)
    xj = C.jax_answer("cholsol", "lap12", list(b), order)
    bl = list(b)
    st = rt.schol(at, order)
    xt = rt.cholsol(at, bl, order, sym=st, device="cpu")
    assert st._chol_route == route
    assert np.array_equal(np.asarray(bl), xt)  # b overwritten
    assert C.rel(xt, xj) <= 1e-10
    assert C.rel(xt, want) <= 1e-10
    # sym reuse: the cached plan and values give the same answer
    np.testing.assert_allclose(
        rt.cholsol(at, b.copy(), order, sym=st, device="cpu"), xt, rtol=0,
        atol=1e-13 * np.abs(xt).max())


def _serve_answer(aj, order, B):
    return rs.cholsol_serve(aj, order)(B)


def test_cholsol_serve_matches_jax_and_dense(monkeypatch):
    C.mf(monkeypatch)
    at = C.port("lap12")  # n = 144
    B = np.random.default_rng(7).standard_normal((at.n, 6))
    Xj = C.jax_answer(_serve_answer, "lap12", 0, B)
    h = rt.cholsol_serve(at, 0, device="cpu")
    assert h.factor_route == "device_mf"
    Xt = h(B)
    assert Xt.dtype == torch.float64 and tuple(Xt.shape) == B.shape
    Xt = Xt.numpy()
    assert C.rel(Xt, Xj) <= 1e-10
    assert C.rel(Xt, np.linalg.solve(C.dense("lap12"), B)) <= 1e-10
    assert h.last_residual <= 1e-10 * max(1.0, np.abs(B).max())
    np.testing.assert_allclose(h(torch.as_tensor(B)).numpy(), Xt, rtol=0,
                               atol=1e-12 * np.abs(Xt).max())


def test_cholsol_serve_level_route_nonsymmetric_storage():
    """Below mf_min_n, natural order, and a stored matrix whose strictly
    lower triangle differs from the upper one: chol reads triu(A), so the
    handle's answers and residual target the symmetrized triu (the
    reference's cholsol semantics)."""
    d = C.dense("lap8")
    rng = np.random.default_rng(8)
    low = np.tril(d, -1) * (1.0 + 0.5 * rng.random(d.shape))
    a = C.port(np.triu(d) + low)
    dsym = np.triu(d) + np.triu(d, 1).T
    B = rng.standard_normal((a.n, 3))
    h = rt.cholsol_serve(a, -1, device="cpu")
    assert h.factor_route == "device_level"
    assert C.rel(h(B).numpy(), np.linalg.solve(dsym, B)) <= 1e-10
    x = rt.cholsol(a, B[:, 0].copy(), -1, device="cpu")
    assert C.rel(x, np.linalg.solve(dsym, B[:, 0])) <= 1e-10


def test_cholsol_duplicate_entries_mf(monkeypatch):
    C.mf(monkeypatch, 50)
    a = C.port("dup150")
    d = C.dense("dup150")
    b = np.random.default_rng(1).standard_normal(150)
    s = rt.schol(a, 0)
    x = rt.cholsol(a, list(b), 0, sym=s, device="cpu")
    assert s._chol_route == "device_mf"
    assert C.rel(x, np.linalg.solve(np.triu(d) + np.triu(d, 1).T, b)) <= 1e-10


@pytest.mark.parametrize("mf", [False, True])
def test_cholsol_not_positive_definite(monkeypatch, mf):
    if mf:
        C.mf(monkeypatch)
    d = C.dense("lap12")
    d[5, 5] = -4.0
    b = np.ones(d.shape[0])
    with pytest.raises(rs.NotPositiveDefiniteError):
        rs.cholsol(C.jax(d), list(b), 0)
    with pytest.raises(rt.NotPositiveDefiniteError):
        rt.cholsol(C.port(d), list(b), 0, device="cpu")


def test_cholsol_backend_host_matches(monkeypatch):
    C.host(monkeypatch)
    b = np.random.default_rng(2).standard_normal(64)
    xj = C.jax_answer("cholsol", "lap8", list(b), 0)
    xt = rt.cholsol(C.port("lap8"), list(b), 0, device="cpu")
    assert C.rel(xt, xj) <= 1e-12


@pytest.mark.parametrize("steps", [6, 0])
def test_chol_mf_refine_and_host_exact_escape(monkeypatch, steps):
    """A factor tree off by a relative 1e-6: the one-shot's refinement on
    the device recovers the answer within 6 steps (route device_mf); with
    no step, cholsol takes the host engine's exact factors (route
    host_exact)."""
    import functools

    import rsparse_tpu_torch.factor.frontal as frontal_torch

    C.mf(monkeypatch)
    real = frontal_torch._chol_mf_factor

    def off(Cx, plan):
        Lx = real(Cx, plan)
        C.scale_tree(plan.__dict__["_cache_tree"], 1.0 + 1e-6)
        return Lx

    monkeypatch.setattr(frontal_torch, "_chol_mf_factor", off)
    monkeypatch.setattr(solve_torch, "_chol_one_shot", functools.partial(
        solve_torch._chol_one_shot, steps=steps))
    at = C.port("lap12")
    b = np.random.default_rng(3).standard_normal(at.n)
    want = np.linalg.solve(C.dense("lap12"), b)
    s = rt.schol(at, 0)
    bl = list(b)
    x = rt.cholsol(at, bl, 0, sym=s, device="cpu")
    assert s._chol_route == ("device_mf" if steps else "host_exact")
    assert np.array_equal(np.asarray(bl), x)
    assert C.rel(x, want) <= 1e-10
