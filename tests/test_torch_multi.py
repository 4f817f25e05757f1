"""Port parity, the batched and serving drivers: `cholsol_multi`,
`lusol_multi`, `qrsol_multi`, `qrsol_serve` and `cholsol_ir` of the torch
package against the JAX package's on the same seeded inputs, and against
numpy's dense solves, at n <= 200 (`mf_min_n` patched down in both packages
to force the multifrontal routes).

Tolerances: 1e-12 relative on the host engine's route
(`config.backend = "host"`), 1e-10 relative on the f64 device routes, 1e-8
relative on the float32-sweep routes after refinement (the serving branches
and `cholsol_ir`). On a host-exact escape x is compared, never pivots.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.solve as solve_torch  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch.factor import frontal_lu as flu_torch  # noqa: E402


def _serve(monkeypatch, mode="force"):
    monkeypatch.setattr(rt.config, "serve_mixed", mode)


# ---------------------------------------------------------------------------
# cholsol_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,case,order,tol", [
    ("device_mf", "lap12", 1, 1e-10), ("device_level", "lap8", 0, 1e-10),
    ("host", "lap8", 1, 1e-12)])
def test_cholsol_multi_matches_jax(monkeypatch, route, case, order, tol):
    if route == "device_mf":
        C.mf(monkeypatch)
    if route == "host":
        C.host(monkeypatch)
    at = C.port(case)
    B = np.random.default_rng(order + 3).standard_normal((at.n, 5))
    Xj = C.jax_answer("cholsol_multi", case, B, order)
    st = rt.schol(at, order)
    Xt = rt.cholsol_multi(at, B, order, sym=st, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == B.shape
    assert st._multi_route == route
    assert C.rel(Xt, Xj) <= tol
    assert C.rel(Xt, np.linalg.solve(C.dense(case), B)) <= 1e-10
    # sym reuse: the cached plans give the same answer
    np.testing.assert_allclose(rt.cholsol_multi(at, B, order, sym=st,
                                                device="cpu"), Xt, rtol=0,
                               atol=1e-13 * np.abs(Xt).max())


def test_cholsol_multi_serve_route(monkeypatch):
    """The forced serving branch (float32 plain sweeps + f64 refinement)
    reaches the JAX package's f64 answer; the handle is cached on the
    analysis and rebuilt when A's values change; fewer than 8 RHS or
    `serve_mixed = "off"` take the exact sweeps."""
    at = C.port("lap8")  # n = 64: below mf_min_n, the level route
    B = np.random.default_rng(3).standard_normal((at.n, 8))
    Xj = C.jax_answer("cholsol_multi", "lap8", B, 0)
    _serve(monkeypatch)
    s = rt.schol(at, 0)
    Xt = rt.cholsol_multi(at, B, 0, sym=s, device="cpu")
    assert s._multi_route == "serve"
    assert C.rel(Xt, Xj) <= 1e-8
    h = s._serve_handles["chol"]
    np.testing.assert_array_equal(
        rt.cholsol_multi(at, B, 0, sym=s, device="cpu"), Xt)
    assert s._serve_handles["chol"] is h
    a2 = at.copy()
    a2.x = 2.0 * a2.x
    X2 = rt.cholsol_multi(a2, B, 0, sym=s, device="cpu")
    assert s._serve_handles["chol"] is not h
    assert C.rel(2.0 * X2, Xj) <= 1e-8
    rt.cholsol_multi(at, B[:, :7], 0, sym=s, device="cpu")
    assert s._multi_route == "device_level"
    _serve(monkeypatch, "off")
    np.testing.assert_allclose(rt.cholsol_multi(at, B, 0, sym=s,
                                                device="cpu"), Xj,
                               rtol=0, atol=1e-10 * np.abs(Xj).max())
    assert s._multi_route == "device_level"


def test_cholsol_multi_serve_oracle_falls_back(monkeypatch):
    """When the serve handle's answer misses the host oracle, the exact
    f64 sweeps answer."""
    _serve(monkeypatch)
    at = C.port("lap8")
    B = np.random.default_rng(4).standard_normal((at.n, 8))
    real = solve_torch._chol_serve_handle

    def weak(*args):
        h = real(*args)
        return lambda B: 1.001 * h(B)

    monkeypatch.setattr(solve_torch, "_chol_serve_handle", weak)
    s = rt.schol(at, 0)
    X = rt.cholsol_multi(at, B, 0, sym=s, device="cpu")
    assert s._multi_route == "device_level"
    assert C.rel(X, np.linalg.solve(C.dense("lap8"), B)) <= 1e-10


# ---------------------------------------------------------------------------
# lusol_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,order,route,tol", [
    ("mf", 1, "device_mf", 1e-10), ("level", -1, "device_level", 1e-10),
    ("level_rejected", 1, "host", 1e-10),
    ("pivoting", 1, "device_mf", 1e-10), ("backend_host", 1, "host", 1e-12)])
def test_lusol_multi_matches_jax(monkeypatch, case, order, route, tol):
    if case in ("mf", "pivoting"):
        C.mf(monkeypatch)
    if case == "backend_host":
        C.host(monkeypatch)
    name = {"mf": "unsym12", "level": "rand50", "level_rejected": "unsym6",
            "backend_host": "unsym6", "pivoting": "pivot200"}[case]
    at = C.port(name)
    B = np.random.default_rng(5).standard_normal((at.n, 4))
    Xj = C.jax_answer("lusol_multi", name, B, order, 1e-6)
    st = rt.sqr(at, order, False)
    Xt = rt.lusol_multi(at, B, order, 1e-6, sym=st, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == B.shape
    assert st._multi_route == route
    assert C.rel(Xt, Xj) <= tol
    assert C.rel(Xt, np.linalg.solve(C.dense(name), B)) <= 1e-10
    np.testing.assert_allclose(rt.lusol_multi(at, B, order, 1e-6, sym=st,
                                              device="cpu"), Xt, rtol=0,
                               atol=1e-12 * np.abs(Xt).max())


def test_lusol_multi_host_exact_escape(monkeypatch):
    """A factor tree off by a relative 1e-6 and no refinement step: the
    one-shot misses 1e-10, and lusol_multi answers with the host engine's
    exact partial pivoting at the caller's tol (x compared, not pivots)."""
    C.mf(monkeypatch)
    real = flu_torch.lu_mf

    def off(a, s, mfp, *args):
        out = real(a, s, mfp, *args)
        C.scale_tree(mfp.__dict__["_cache_tree"], 1.0 + 1e-6)
        return out

    monkeypatch.setattr(flu_torch, "lu_mf", off)
    monkeypatch.setattr(solve_torch, "_lu_one_shot", functools.partial(
        solve_torch._lu_one_shot, steps=0))
    at = C.port("unsym12")
    B = np.random.default_rng(6).standard_normal((at.n, 3))
    s = rt.sqr(at, 1, False)
    X = rt.lusol_multi(at, B, 1, 1e-3, sym=s, device="cpu")
    assert s._multi_route == s._lu_route == "host_exact"
    Xj = C.jax_answer("lusol_multi", "unsym12", B, 1, 1e-3)
    assert C.rel(X, Xj) <= 1e-10
    assert C.rel(X, np.linalg.solve(C.dense("unsym12"), B)) <= 1e-12


# ---------------------------------------------------------------------------
# qrsol_multi and qrsol_serve
# ---------------------------------------------------------------------------


def _ls_want(a, B):
    """numpy's answer: least squares (m >= n) or minimum norm (m < n)."""
    return np.linalg.lstsq(C.dense(a), B, rcond=None)[0]


def _qr_pair(case, branch="ls"):
    """(JAX, port) Sprs of a grid_ls case, or of their transposes."""
    aj, at = C.pair(case)
    if branch == "mn":
        return rs.transpose(aj), rt.transpose(at, device="cpu")
    return aj, at


@pytest.mark.parametrize("branch", ["ls", "mn"])
@pytest.mark.parametrize("route", ["device_mf", "device_level", "serve"])
def test_qrsol_multi_matches_jax(monkeypatch, branch, route):
    if route == "device_mf":
        C.mf(monkeypatch, 50)
    if route == "serve":
        _serve(monkeypatch)
    case = "grid_ls10" if route == "device_mf" else "grid_ls6"
    aj, at = _qr_pair(case, branch)
    B = np.random.default_rng(7).standard_normal((aj.m, 8))
    Xj = C.jax_answer("qrsol_multi", case + ("t" if branch == "mn" else ""),
                      B, 2, refine=3)
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    Xt = rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == (aj.n, 8)
    assert s._multi_route == route
    tol = 1e-8 if route == "serve" else 1e-10
    assert C.rel(Xt, Xj) <= tol
    assert C.rel(Xt, _ls_want(aj, B)) <= tol
    # sym reuse: a second call (the cached handle on the serving route)
    Xt2 = rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert C.rel(Xt2, Xt) <= 1e-13


def test_qrsol_serve_handle_matches_jax(monkeypatch):
    """The qrsol_serve handle against the JAX package's (forced through its
    interpreter) on both branches: X, last_residual, available; sym of the
    wrong dimension raises ValueError."""
    monkeypatch.setattr(rs.config, "serve_mixed", "force")
    aj, at = _qr_pair("grid_ls6")
    rng = np.random.default_rng(8)
    for a_j, a_t in ((aj, at), (rs.transpose(aj), rt.transpose(at, device="cpu"))):
        B = rng.standard_normal((a_j.m, 8))
        hj = rs.qrsol_serve(a_j, 2)
        Xj = np.asarray(hj(B), np.float64)
        h = rt.qrsol_serve(a_t, 2, device="cpu")
        X = h(B)
        assert isinstance(X, torch.Tensor) and X.dtype == torch.float64
        assert tuple(X.shape) == (a_j.n, 8) and h.available
        assert C.rel(X.numpy(), Xj) <= 1e-8
        assert C.rel(X.numpy(), _ls_want(a_j, B)) <= 1e-8
        scale = max(1.0, np.abs(B).max())
        assert h.last_residual <= 1e-8 * scale
        assert float(hj.last_residual) <= 1e-8 * scale
        assert h.factor_route == "device_level"
    # A'A of the tall A is also the wide A'-problem's Gram: one analysis
    # serves both branches; an analysis of another dimension is refused
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    aw = rt.transpose(at, device="cpu")
    B = rng.standard_normal((aw.m, 8))
    X = rt.qrsol_serve(aw, 2, sym=s, device="cpu")(B).numpy()
    assert C.rel(X, _ls_want(rs.transpose(aj), B)) <= 1e-8
    aj5, at5 = _qr_pair("grid_ls5")
    wrong_t = rt.schol(solve_torch._gram(at5, "cpu"), 2)
    wrong_j = rs.schol(rs.multiply(rs.transpose(aj5), aj5), 2)
    with pytest.raises(ValueError):
        rt.qrsol_serve(at, 2, sym=wrong_t, device="cpu")
    with pytest.raises(ValueError):
        rs.qrsol_serve(aj, 2, sym=wrong_j)


def test_qrsol_multi_handle_rebuilt_on_new_values(monkeypatch):
    """qrsol_multi's cached handle (per refine) is reused while A's values
    are unchanged and rebuilt when they change under sym reuse."""
    _serve(monkeypatch)
    at = C.port("grid_ls6")
    B = np.random.default_rng(9).standard_normal((at.m, 8))
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    X = rt.qrsol_multi(at, B, 2, sym=s, device="cpu")
    h = s._serve_handles[("qr", 2)]
    rt.qrsol_multi(at, B, 2, sym=s, device="cpu")
    assert s._serve_handles[("qr", 2)] is h
    a2 = at.copy()
    a2.x = 2.0 * a2.x
    X2 = rt.qrsol_multi(a2, B, 2, sym=s, device="cpu")
    assert s._serve_handles[("qr", 2)] is not h
    assert s._multi_route == "serve"
    assert C.rel(2.0 * X2, X) <= 1e-8
    rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert set(s._serve_handles) == {("qr", 2), ("qr", 3)}


def test_serving_branches_yield_when_the_kernel_cannot_take_the_plans(
        monkeypatch):
    """When the sweep kernel cannot take the factor's plans (a dense block
    beyond its shared memory), qrsol_serve's handle reads unavailable and
    qrsol_multi and cholsol_multi take their exact f64 branches."""
    _serve(monkeypatch)
    monkeypatch.setattr(solve_torch, "_sweeps_fit", lambda plans, dev: False)
    aj, at = _qr_pair("grid_ls6")
    B = np.random.default_rng(12).standard_normal((aj.m, 8))
    assert not rt.qrsol_serve(at, 2, device="cpu").available
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    X = rt.qrsol_multi(at, B, 2, sym=s, device="cpu")
    assert s._multi_route == "device_level"
    assert C.rel(X, C.jax_answer("qrsol_multi", "grid_ls6", B, 2)) <= 1e-10
    lt = C.port("lap8")
    sl = rt.schol(lt, 0)
    Bl = B[: lt.n]
    X = rt.cholsol_multi(lt, Bl, 0, sym=sl, device="cpu")
    assert sl._multi_route == "device_level"
    assert C.rel(X, np.linalg.solve(C.dense("lap8"), Bl)) <= 1e-10


# ---------------------------------------------------------------------------
# cholsol_ir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor_dtype,refine", [("float32", 3),
                                                 ("bfloat16", 8)])
def test_cholsol_ir_matches_jax(monkeypatch, factor_dtype, refine):
    """cholsol_ir rounds A's values to factor_dtype, sweeps in float32 and
    refines in f64: its x reaches the JAX package's and the dense solve's,
    b overwritten; on the multifrontal route too."""
    rng = np.random.default_rng(10)
    A = C.dense("lap8")
    d = 1.0 + 0.1 * rng.random(A.shape[0])  # D A D: values not exact in f32
    A = d[:, None] * A * d[None, :]
    at = C.port(A)
    b = rng.standard_normal(at.n)
    want = np.linalg.solve(A, b)
    xj = C.jax_answer("cholsol_ir", A, list(b), 0, factor_dtype, refine)
    for mf in (False, True):
        if mf:
            C.mf(monkeypatch, 50)
        bl = list(b)
        x = rt.cholsol_ir(at, bl, 0, factor_dtype, refine, device="cpu")
        assert np.array_equal(np.asarray(bl), x)  # b overwritten
        assert C.rel(x, xj) <= 1e-8 and C.rel(x, want) <= 1e-8
    # one step from the rounded factor alone is only float32-accurate
    x0 = rt.cholsol_ir(at, b.copy(), 0, "float32", 0, device="cpu")
    assert C.rel(x0, want) > 1e-10
