"""Port parity, the `qrsol` and `qrsol_ls` solvers: the torch package
against the JAX package on the same seeded inputs, and both against
numpy's least-squares / minimum-norm solution. Least squares (m >= n) and
minimum norm (m < n) on the multifrontal route (`mf_min_n` patched down in
both packages) and on the level route (`factor.qr` and the reference's
apply); device routes agree to 1e-10 relative, the host engines
(`config.backend = "host"`) to 1e-12.

Also: the README-style 3 x 2 call, `sym` reuse with refreshed values, b's
overwrite (a list grows to n values, a fixed ndarray is left as it is),
the acceptance gate's host-exact escape (reading the plan's `q_host`), a
structurally rank-deficient matrix, and `qrsol_ls`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.solve as solve_torch  # noqa: E402
import torch_cases as C  # noqa: E402

ROUTE_MIN = {"device_mf": 100, "device_level": 10**9}
CASE = {"ls": "ls", "mn": "ls_mn"}  # 150 x 100, or its 100 x 150 transpose


def _want(d, b):
    """numpy's least-squares solution, minimum norm when m < n."""
    return np.linalg.lstsq(d, b, rcond=None)[0]


def _case(branch):
    d = C.dense(CASE[branch])
    b = np.random.default_rng(1).standard_normal(d.shape[0])
    return d, C.port(CASE[branch]), b


@pytest.mark.parametrize("branch", ["ls", "mn"])
@pytest.mark.parametrize("route", ["device_mf", "device_level"])
def test_qrsol_matches_jax(monkeypatch, branch, route):
    C.mf(monkeypatch, ROUTE_MIN[route])
    d, at, b = _case(branch)
    s = rt.sqr(at if branch == "ls" else rt.transpose(at, device="cpu"), 2,
               True)
    x = rt.qrsol(at, list(b), 2, sym=s, device="cpu")
    assert s._qr_route == route
    n = d.shape[1]
    assert x.shape == (n,)
    assert C.rel(x, C.jax_answer("qrsol", CASE[branch], list(b), 2)[:n]) \
        <= 1e-10
    assert C.rel(x, _want(d, b)) <= 1e-10


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_host_engine_matches_jax(monkeypatch, branch):
    C.host(monkeypatch)
    d, at, b = _case(branch)
    s = rt.sqr(at if branch == "ls" else rt.transpose(at, device="cpu"), 2,
               True)
    x = rt.qrsol(at, list(b), 2, sym=s, device="cpu")
    assert s._qr_route == "host"
    want = C.jax_answer("qrsol", CASE[branch], list(b), 2)
    assert C.rel(x, want[: d.shape[1]]) <= 1e-12


def test_qrsol_readme_3x2():
    """The docstring's overdetermined 3 x 2 system, both packages."""
    xj = C.jax_answer("qrsol", "readme3x2", [1.0, 4.0, 3.0], 2)
    b = [1.0, 4.0, 3.0]
    x = rt.qrsol(C.port("readme3x2"), b, 2, device="cpu")
    np.testing.assert_allclose(x, [1.0, 2.0], atol=1e-12)
    np.testing.assert_allclose(x, np.asarray(xj)[:2], atol=1e-12)
    assert b[:2] == list(x) and len(b) == 3  # overwritten, not shrunk


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_sym_reuse_refreshed_values(monkeypatch, branch):
    """One analysis, two value sets: the plan is kept and refactored."""
    C.mf(monkeypatch, 100)
    d, at, b = _case(branch)
    s = rt.sqr(at if branch == "ls" else rt.transpose(at, device="cpu"), 2,
               True)
    x1 = rt.qrsol(at, b.copy(), 2, sym=s, device="cpu")
    plan = s._mf_qr_plan
    d2 = d * (1.0 + 0.5 * (np.arange(d.shape[1]) % 3 == 0))  # column scaling
    a2 = C.port(d2)
    np.testing.assert_array_equal(a2.p, at.p)
    x2 = rt.qrsol(a2, b.copy(), 2, sym=s, device="cpu")
    assert s._mf_qr_plan is plan and s._qr_route == "device_mf"
    assert C.rel(x1, _want(d, b)) <= 1e-10
    assert C.rel(x2, _want(d2, b)) <= 1e-10


@pytest.mark.parametrize("route", ["device_mf", "device_level"])
def test_qrsol_minimum_norm_overwrite(monkeypatch, route):
    """m < n: a list b grows to the n values of x; a fixed ndarray (m
    values) is left as it is and x comes back as the return value."""
    C.mf(monkeypatch, ROUTE_MIN[route])
    d, at, b = _case("mn")
    blist = list(b)
    x = rt.qrsol(at, blist, 2, device="cpu")
    assert len(blist) == d.shape[1] and blist == list(x)
    barr = b.copy()
    x2 = rt.qrsol(at, barr, 2, device="cpu")
    np.testing.assert_array_equal(barr, b)
    np.testing.assert_array_equal(x2, x)


def test_qrsol_least_squares_overwrite(monkeypatch):
    """m > n: the first n entries of an ndarray b take x."""
    C.mf(monkeypatch, 100)
    d, at, b = _case("ls")
    barr = b.copy()
    x = rt.qrsol(at, barr, 2, device="cpu")
    np.testing.assert_array_equal(barr[: d.shape[1]], x)
    np.testing.assert_array_equal(barr[d.shape[1]:], b[d.shape[1]:])


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_gate_escapes_to_host_exact(monkeypatch, branch):
    """A tree that misses the acceptance gate (its Q blocks off by 1e-6):
    the host engine answers, factoring with the plan's q_host, not the
    composed ordering in s.q."""
    C.mf(monkeypatch, 100)
    d, at, b = _case(branch)
    s = rt.sqr(at if branch == "ls" else rt.transpose(at, device="cpu"), 2,
               True)
    rt.qrsol(at, b.copy(), 2, sym=s, device="cpu")
    assert s._qr_route == "device_mf"
    plan = s._mf_qr_plan
    assert not np.array_equal(plan.q_host, s.q)
    C.scale_tree(plan.__dict__["_cache_q"], 1.0 + 1e-6)
    name = "_qr_ls_host_exact" if branch == "ls" else "_qr_mn_host_exact"
    real, seen = getattr(solve_torch, name), []

    def spy(a, s_, bb, q):
        seen.append(q)
        return real(a, s_, bb, q)

    monkeypatch.setattr(solve_torch, name, spy)
    x = rt.qrsol(at, b.copy(), 2, sym=s, device="cpu")
    assert s._qr_route == "host_exact"
    assert len(seen) == 1 and seen[0] is plan.q_host
    assert C.rel(x, _want(d, b)) <= 1e-10


def test_qrsol_rank_deficient_reaches_the_gate(monkeypatch):
    """Two columns that share their only row: R has a zero diagonal, the
    sweep's inf/NaN fails the gate (it does not raise), and the host
    engine's reference-exact answer is returned."""
    C.mf(monkeypatch, 10)
    a = C.port("deficient")
    s = rt.sqr(a, 2, True)
    assert s.m2 > a.m
    b = np.random.default_rng(0).standard_normal(30)
    x = rt.qrsol(a, b.copy(), 2, sym=s, device="cpu")
    assert s._qr_route == "host_exact"
    with monkeypatch.context() as mp:
        mp.setattr(rt.config, "backend", "host")
        xh = rt.qrsol(a, b.copy(), 2, device="cpu")
    np.testing.assert_allclose(x, xh, rtol=1e-12, atol=1e-12)  # NaNs equal


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_ls_matches_jax(monkeypatch, branch):
    C.mf(monkeypatch, 100)
    d, at, b = _case(branch)
    x = rt.qrsol_ls(at, b, 2, device="cpu")
    assert C.rel(x, C.jax_answer("qrsol_ls", CASE[branch], b, 2)) <= 1e-10
    assert C.rel(x, _want(d, b)) <= 1e-10


def test_qrsol_ls_level_route(monkeypatch):
    """Below mf_min_n the Gram factor is the level Cholesky's, its solves
    the SpTRSV sweeps."""
    C.mf(monkeypatch, 10**9)
    d, at, b = _case("ls")
    assert C.rel(rt.qrsol_ls(at, b, 2, device="cpu"), _want(d, b)) <= 1e-10
