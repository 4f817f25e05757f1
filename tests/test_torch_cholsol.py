"""Port parity, the `cholsol` solver and the `cholsol_serve` handle: the
torch package against the JAX package on the same seeded inputs, and both
against numpy's dense solve, at n <= 400 (`mf_min_n` patched down in both
packages to force the multifrontal one-shot). Device routes agree to
1e-10 relative, the host engine (`config.backend = "host"`) to 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.solve as solve_torch  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402


def _laplacian(g):
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    return rs.Sprs(len(x), n, n, p, i, x)


def _port(aj):
    return sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)


def _rel(x, want):
    return np.abs(np.asarray(x) - want).max() / max(1.0, np.abs(want).max())


def _scale_tree(obj, f):
    """Multiply every floating tensor of a cached factor tree by f, in
    place (a factor off by a relative 1e-6)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            obj.mul_(f)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _scale_tree(o, f)


def _mf(monkeypatch, n=100):
    monkeypatch.setattr(rs.config, "mf_min_n", n)
    monkeypatch.setattr(rt.config, "mf_min_n", n)


@pytest.mark.parametrize("g,order,route", [(20, 0, "device_mf"),
                                           (20, 1, "device_mf"),
                                           (10, 0, "device_level"),
                                           (10, -1, "device_level")])
def test_cholsol_matches_jax_and_dense(monkeypatch, g, order, route):
    if route == "device_mf":
        _mf(monkeypatch)
    aj = _laplacian(g)
    at = _port(aj)
    b = np.random.default_rng(g + order).standard_normal(aj.n)
    want = np.linalg.solve(aj.to_dense_np(), b)
    xj = np.asarray(rs.cholsol(aj, list(b), order), np.float64)
    bl = list(b)
    st = rt.schol(at, order)
    xt = rt.cholsol(at, bl, order, sym=st, device="cpu")
    assert st._chol_route == route
    assert np.array_equal(np.asarray(bl), xt)  # b overwritten
    assert _rel(xt, xj) <= 1e-10
    assert _rel(xt, want) <= 1e-10
    # sym reuse: the cached plan and values give the same answer
    np.testing.assert_allclose(
        rt.cholsol(at, b.copy(), order, sym=st, device="cpu"), xt, rtol=0,
        atol=1e-13 * np.abs(xt).max())


def test_cholsol_serve_matches_jax_and_dense(monkeypatch):
    _mf(monkeypatch, 300)
    aj = _laplacian(20)  # n = 400
    at = _port(aj)
    B = np.random.default_rng(7).standard_normal((aj.n, 6))
    Xj = np.asarray(rs.cholsol_serve(aj, 0)(B), np.float64)
    h = rt.cholsol_serve(at, 0, device="cpu")
    assert h.factor_route == "device_mf"
    Xt = h(B)
    assert Xt.dtype == torch.float64 and tuple(Xt.shape) == B.shape
    Xt = Xt.numpy()
    assert _rel(Xt, Xj) <= 1e-10
    assert _rel(Xt, np.linalg.solve(aj.to_dense_np(), B)) <= 1e-10
    assert h.last_residual <= 1e-10 * max(1.0, np.abs(B).max())
    np.testing.assert_allclose(h(torch.as_tensor(B)).numpy(), Xt, rtol=0,
                               atol=1e-12 * np.abs(Xt).max())


def test_cholsol_serve_level_route_nonsymmetric_storage():
    """Below mf_min_n, natural order, and a stored matrix whose strictly
    lower triangle differs from the upper one: chol reads triu(A), so the
    handle's answers and residual target the symmetrized triu (the
    reference's cholsol semantics)."""
    aj = _laplacian(8)
    d = aj.to_dense_np()
    rng = np.random.default_rng(8)
    low = np.tril(d, -1) * (1.0 + 0.5 * rng.random(d.shape))
    a = rt.Sprs.new_from_vec(np.triu(d) + low)
    dsym = np.triu(d) + np.triu(d, 1).T
    B = rng.standard_normal((a.n, 3))
    h = rt.cholsol_serve(a, -1, device="cpu")
    assert h.factor_route == "device_level"
    assert _rel(h(B).numpy(), np.linalg.solve(dsym, B)) <= 1e-10
    x = rt.cholsol(a, B[:, 0].copy(), -1, device="cpu")
    assert _rel(x, np.linalg.solve(dsym, B[:, 0])) <= 1e-10


def _dup_spd(n, seed):
    """An SPD matrix with duplicate (i, j) entries after `sum_dupl` (the
    first slot an explicit zero, the last the sum)."""
    rng = np.random.default_rng(seed)
    t = rt.Trpl()
    for i in range(n):
        t.append(i, i, 10.0)
        t.append(i, i, 2.5)
    for _ in range(3 * n):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        v = 0.3 * rng.standard_normal()
        t.append(min(i, j), max(i, j), v)
        t.append(max(i, j), min(i, j), v)
    t.sum_dupl()
    return t.to_sprs()


def test_cholsol_duplicate_entries_mf(monkeypatch):
    _mf(monkeypatch, 50)
    a = _dup_spd(150, 0)
    d = a.to_dense_np()
    b = np.random.default_rng(1).standard_normal(150)
    s = rt.schol(a, 0)
    x = rt.cholsol(a, list(b), 0, sym=s, device="cpu")
    assert s._chol_route == "device_mf"
    assert _rel(x, np.linalg.solve(np.triu(d) + np.triu(d, 1).T, b)) <= 1e-10


@pytest.mark.parametrize("mf", [False, True])
def test_cholsol_not_positive_definite(monkeypatch, mf):
    if mf:
        _mf(monkeypatch)
    aj = _laplacian(12)
    col = 5
    pos = int(aj.p[col]) + int(np.nonzero(
        aj.i[aj.p[col]: aj.p[col + 1]] == col)[0][0])
    aj.x = aj.x.copy()
    aj.x[pos] = -4.0
    b = np.ones(aj.n)
    with pytest.raises(rs.NotPositiveDefiniteError):
        rs.cholsol(aj, list(b), 0)
    with pytest.raises(rt.NotPositiveDefiniteError):
        rt.cholsol(_port(aj), list(b), 0, device="cpu")


def test_cholsol_backend_host_matches(monkeypatch):
    monkeypatch.setattr(rs.config, "backend", "host")
    monkeypatch.setattr(rt.config, "backend", "host")
    aj = _laplacian(9)
    b = np.random.default_rng(2).standard_normal(aj.n)
    xj = np.asarray(rs.cholsol(aj, list(b), 0), np.float64)
    xt = rt.cholsol(_port(aj), list(b), 0, device="cpu")
    assert _rel(xt, xj) <= 1e-12


@pytest.mark.parametrize("steps", [6, 0])
def test_chol_mf_refine_and_host_exact_escape(monkeypatch, steps):
    """A factor tree off by a relative 1e-6: the one-shot's refinement on
    the device recovers the answer within 6 steps (route device_mf); with
    no step, cholsol takes the host engine's exact factors (route
    host_exact)."""
    import functools

    import rsparse_tpu_torch.factor.frontal as frontal_torch

    _mf(monkeypatch)
    real = frontal_torch._chol_mf_factor

    def off(Cx, plan):
        Lx = real(Cx, plan)
        _scale_tree(plan.__dict__["_cache_tree"], 1.0 + 1e-6)
        return Lx

    monkeypatch.setattr(frontal_torch, "_chol_mf_factor", off)
    monkeypatch.setattr(solve_torch, "_chol_one_shot", functools.partial(
        solve_torch._chol_one_shot, steps=steps))
    aj = _laplacian(14)
    at = _port(aj)
    b = np.random.default_rng(3).standard_normal(at.n)
    want = np.linalg.solve(aj.to_dense_np(), b)
    s = rt.schol(at, 0)
    bl = list(b)
    x = rt.cholsol(at, bl, 0, sym=s, device="cpu")
    assert s._chol_route == ("device_mf" if steps else "host_exact")
    assert np.array_equal(np.asarray(bl), x)
    assert _rel(x, want) <= 1e-10
