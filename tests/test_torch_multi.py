"""Port parity, the batched and serving drivers: `cholsol_multi`,
`lusol_multi`, `qrsol_multi`, `qrsol_serve` and `cholsol_ir` of the torch
package against the JAX package's on the same seeded inputs, and against
numpy's dense solves, at n <= 400 (`mf_min_n` patched down in both packages
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
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.factor import frontal_lu as flu_torch  # noqa: E402


def _laplacian(g):
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    return rs.Sprs(len(x), n, n, p, i, x)


def _unsym(g, seed):
    """Nonsymmetric diagonally dominant matrix on the g x g 5-point pattern
    (the chip smoke's lusol matrix at a test size)."""
    from chip_smoke import make_matrix

    a = make_matrix(g, seed)
    return rs.Sprs(a.nnz(), a.m, a.n, a.p, a.i, a.x)


def _qr_pair(grid=6, seed=0):
    """A = [A5; 0.1 I] (the chip smoke's least-squares matrix at a test
    size) in both packages."""
    from chip_smoke import qr_matrix

    a = qr_matrix(seed, grid)
    return rs.Sprs(a.nnz(), a.m, a.n, a.p, a.i, a.x), a


def _port(aj):
    return sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)


def _dense(a):
    d = np.zeros((a.m, a.n))
    nz = a.nnz()
    np.add.at(d, (a.i[:nz], np.repeat(np.arange(a.n), np.diff(a.p))),
              a.x[:nz])
    return d


def _rel(x, want):
    x, want = np.asarray(x, np.float64), np.asarray(want, np.float64)
    return np.abs(x - want).max() / max(1.0, np.abs(want).max())


def _mf(monkeypatch, n=100):
    monkeypatch.setattr(rs.config, "mf_min_n", n)
    monkeypatch.setattr(rt.config, "mf_min_n", n)


def _host(monkeypatch):
    monkeypatch.setattr(rs.config, "backend", "host")
    monkeypatch.setattr(rt.config, "backend", "host")


def _serve(monkeypatch, mode="force"):
    monkeypatch.setattr(rt.config, "serve_mixed", mode)


# ---------------------------------------------------------------------------
# cholsol_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,g,order,tol", [
    ("device_mf", 14, 1, 1e-10), ("device_level", 10, 0, 1e-10),
    ("host", 10, 1, 1e-12)])
def test_cholsol_multi_matches_jax(monkeypatch, route, g, order, tol):
    if route == "device_mf":
        _mf(monkeypatch)
    if route == "host":
        _host(monkeypatch)
    aj = _laplacian(g)
    at = _port(aj)
    B = np.random.default_rng(g + order).standard_normal((aj.n, 5))
    Xj = np.asarray(rs.cholsol_multi(aj, B, order), np.float64)
    st = rt.schol(at, order)
    Xt = rt.cholsol_multi(at, B, order, sym=st, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == B.shape
    assert st._multi_route == route
    assert _rel(Xt, Xj) <= tol
    assert _rel(Xt, np.linalg.solve(_dense(aj), B)) <= 1e-10
    # sym reuse: the cached plans give the same answer
    np.testing.assert_allclose(rt.cholsol_multi(at, B, order, sym=st,
                                                device="cpu"), Xt, rtol=0,
                               atol=1e-13 * np.abs(Xt).max())


def test_cholsol_multi_serve_route(monkeypatch):
    """The forced serving branch (float32 plain sweeps + f64 refinement)
    reaches the JAX package's f64 answer; the handle is cached on the
    analysis and rebuilt when A's values change; fewer than 8 RHS or
    `serve_mixed = "off"` take the exact sweeps."""
    aj = _laplacian(10)  # n = 100: below mf_min_n, the level route
    at = _port(aj)
    B = np.random.default_rng(3).standard_normal((aj.n, 8))
    Xj = np.asarray(rs.cholsol_multi(aj, B, 0), np.float64)
    _serve(monkeypatch)
    s = rt.schol(at, 0)
    Xt = rt.cholsol_multi(at, B, 0, sym=s, device="cpu")
    assert s._multi_route == "serve"
    assert _rel(Xt, Xj) <= 1e-8
    h = s._serve_handles["chol"]
    np.testing.assert_array_equal(
        rt.cholsol_multi(at, B, 0, sym=s, device="cpu"), Xt)
    assert s._serve_handles["chol"] is h
    a2 = at.copy()
    a2.x = 2.0 * a2.x
    X2 = rt.cholsol_multi(a2, B, 0, sym=s, device="cpu")
    assert s._serve_handles["chol"] is not h
    assert _rel(2.0 * X2, Xj) <= 1e-8
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
    aj = _laplacian(8)
    at = _port(aj)
    B = np.random.default_rng(4).standard_normal((aj.n, 8))
    real = solve_torch._chol_serve_handle

    def weak(*args):
        h = real(*args)
        return lambda B: 1.001 * h(B)

    monkeypatch.setattr(solve_torch, "_chol_serve_handle", weak)
    s = rt.schol(at, 0)
    X = rt.cholsol_multi(at, B, 0, sym=s, device="cpu")
    assert s._multi_route == "device_level"
    assert _rel(X, np.linalg.solve(_dense(aj), B)) <= 1e-10


# ---------------------------------------------------------------------------
# lusol_multi
# ---------------------------------------------------------------------------


def _adversarial(n, extra, zeros, seed):
    """A matrix whose zero diagonal entries need row pivoting
    (tests/test_lu_pivot.py's `_adversarial` at a test size)."""
    rng = np.random.default_rng(seed)
    d = np.eye(n) * 10.0
    ii, jj = rng.integers(0, n, extra), rng.integers(0, n, extra)
    np.add.at(d, (ii, jj), rng.standard_normal(extra))
    for z in zeros:
        d[z, z] = 0.0
        d[(z + 1) % n, z] += 3.0
        d[z, (z + 2) % n] += 3.0
    return rs.Sprs.new_from_vec(d)


def _level_matrix(n=50, seed=0):
    """Random diagonally dominant, few levels in natural order: the level
    LU takes its static pivots (tests/test_torch_lu.py::test_level_path)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0)
    return rs.Sprs.new_from_vec(d)


@pytest.mark.parametrize("case,order,route,tol", [
    ("mf", 1, "device_mf", 1e-10), ("level", -1, "device_level", 1e-10),
    ("level_rejected", 1, "host", 1e-10),
    ("pivoting", 1, "device_mf", 1e-10), ("backend_host", 1, "host", 1e-12)])
def test_lusol_multi_matches_jax(monkeypatch, case, order, route, tol):
    if case in ("mf", "pivoting"):
        _mf(monkeypatch)
    if case == "backend_host":
        _host(monkeypatch)
    aj = {"mf": lambda: _unsym(16, 1), "level": _level_matrix,
          "level_rejected": lambda: _unsym(10, 2),
          "backend_host": lambda: _unsym(10, 3),
          "pivoting": lambda: _adversarial(200, 600, (17, 55, 130), 7)}[case]()
    at = _port(aj)
    B = np.random.default_rng(5).standard_normal((aj.n, 4))
    Xj = np.asarray(rs.lusol_multi(aj, B, order, 1e-6), np.float64)
    st = rt.sqr(at, order, False)
    Xt = rt.lusol_multi(at, B, order, 1e-6, sym=st, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == B.shape
    assert st._multi_route == route
    assert _rel(Xt, Xj) <= tol
    assert _rel(Xt, np.linalg.solve(_dense(aj), B)) <= 1e-10
    np.testing.assert_allclose(rt.lusol_multi(at, B, order, 1e-6, sym=st,
                                              device="cpu"), Xt, rtol=0,
                               atol=1e-12 * np.abs(Xt).max())


def test_lusol_multi_host_exact_escape(monkeypatch):
    """A factor tree off by a relative 1e-6 and no refinement step: the
    one-shot misses 1e-10, and lusol_multi answers with the host engine's
    exact partial pivoting at the caller's tol (x compared, not pivots)."""
    _mf(monkeypatch)
    real = flu_torch.lu_mf

    def scale(obj):
        if isinstance(obj, torch.Tensor) and obj.is_floating_point():
            obj.mul_(1.0 + 1e-6)
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                scale(o)

    def off(a, s, mfp, *args):
        out = real(a, s, mfp, *args)
        scale(mfp.__dict__["_cache_tree"])
        return out

    monkeypatch.setattr(flu_torch, "lu_mf", off)
    monkeypatch.setattr(solve_torch, "_lu_one_shot", functools.partial(
        solve_torch._lu_one_shot, steps=0))
    aj = _unsym(14, 6)
    at = _port(aj)
    B = np.random.default_rng(6).standard_normal((aj.n, 3))
    s = rt.sqr(at, 1, False)
    X = rt.lusol_multi(at, B, 1, 1e-3, sym=s, device="cpu")
    assert s._multi_route == s._lu_route == "host_exact"
    Xj = np.asarray(rs.lusol_multi(aj, B, 1, 1e-3), np.float64)
    assert _rel(X, Xj) <= 1e-10
    assert _rel(X, np.linalg.solve(_dense(aj), B)) <= 1e-12


# ---------------------------------------------------------------------------
# qrsol_multi and qrsol_serve
# ---------------------------------------------------------------------------


def _ls_want(aj, B):
    """numpy's answer: least squares (m >= n) or minimum norm (m < n)."""
    d = _dense(aj)
    return np.linalg.lstsq(d, B, rcond=None)[0]


@pytest.mark.parametrize("branch", ["ls", "mn"])
@pytest.mark.parametrize("route", ["device_mf", "device_level", "serve"])
def test_qrsol_multi_matches_jax(monkeypatch, branch, route):
    if route == "device_mf":
        _mf(monkeypatch, 50)
    if route == "serve":
        _serve(monkeypatch)
    aj, at = _qr_pair(grid=10 if route == "device_mf" else 6)
    if branch == "mn":
        aj, at = rs.transpose(aj), rt.transpose(at, device="cpu")
    B = np.random.default_rng(7).standard_normal((aj.m, 8))
    Xj = np.asarray(rs.qrsol_multi(aj, B, 2, refine=3), np.float64)
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    Xt = rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert isinstance(Xt, np.ndarray) and Xt.shape == (aj.n, 8)
    assert s._multi_route == route
    tol = 1e-8 if route == "serve" else 1e-10
    assert _rel(Xt, Xj) <= tol
    assert _rel(Xt, _ls_want(aj, B)) <= tol
    # sym reuse: a second call (the cached handle on the serving route)
    Xt2 = rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert _rel(Xt2, Xt) <= 1e-13


def test_qrsol_serve_handle_matches_jax(monkeypatch):
    """The qrsol_serve handle against the JAX package's (forced through its
    interpreter) on both branches: X, last_residual, available; sym of the
    wrong dimension raises ValueError."""
    monkeypatch.setattr(rs.config, "serve_mixed", "force")
    aj, at = _qr_pair()
    rng = np.random.default_rng(8)
    for a_j, a_t in ((aj, at), (rs.transpose(aj), rt.transpose(at, device="cpu"))):
        B = rng.standard_normal((a_j.m, 8))
        hj = rs.qrsol_serve(a_j, 2)
        Xj = np.asarray(hj(B), np.float64)
        h = rt.qrsol_serve(a_t, 2, device="cpu")
        X = h(B)
        assert isinstance(X, torch.Tensor) and X.dtype == torch.float64
        assert tuple(X.shape) == (a_j.n, 8) and h.available
        assert _rel(X.numpy(), Xj) <= 1e-8
        assert _rel(X.numpy(), _ls_want(a_j, B)) <= 1e-8
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
    assert _rel(X, _ls_want(rs.transpose(aj), B)) <= 1e-8
    aj5, at5 = _qr_pair(grid=5)
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
    _, at = _qr_pair()
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
    assert _rel(2.0 * X2, X) <= 1e-8
    rt.qrsol_multi(at, B, 2, refine=3, sym=s, device="cpu")
    assert set(s._serve_handles) == {("qr", 2), ("qr", 3)}


def test_serving_branches_yield_when_the_kernel_cannot_take_the_plans(
        monkeypatch):
    """When the sweep kernel cannot take the factor's plans (a dense block
    beyond its shared memory), qrsol_serve's handle reads unavailable and
    qrsol_multi and cholsol_multi take their exact f64 branches."""
    _serve(monkeypatch)
    monkeypatch.setattr(solve_torch, "_sweeps_fit", lambda plans, dev: False)
    aj, at = _qr_pair()
    B = np.random.default_rng(12).standard_normal((aj.m, 8))
    assert not rt.qrsol_serve(at, 2, device="cpu").available
    s = rt.schol(solve_torch._gram(at, "cpu"), 2)
    X = rt.qrsol_multi(at, B, 2, sym=s, device="cpu")
    assert s._multi_route == "device_level"
    assert _rel(X, np.asarray(rs.qrsol_multi(aj, B, 2), np.float64)) <= 1e-10
    lj = _laplacian(8)
    sl = rt.schol(_port(lj), 0)
    Bl = B[: lj.n]
    X = rt.cholsol_multi(_port(lj), Bl, 0, sym=sl, device="cpu")
    assert sl._multi_route == "device_level"
    assert _rel(X, np.linalg.solve(_dense(lj), Bl)) <= 1e-10


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
    aj = _laplacian(10)
    nz = aj.nnz()
    d = 1.0 + 0.1 * rng.random(aj.n)  # D A D: values not exact in f32
    aj = rs.Sprs(nz, aj.n, aj.n, aj.p, aj.i[:nz],
                 aj.x[:nz] * d[aj.i[:nz]] * d[np.repeat(np.arange(aj.n),
                                                       np.diff(aj.p))])
    at = _port(aj)
    b = rng.standard_normal(aj.n)
    want = np.linalg.solve(_dense(aj), b)
    xj = np.asarray(rs.cholsol_ir(aj, list(b), 0, factor_dtype, refine),
                    np.float64)
    for mf in (False, True):
        if mf:
            _mf(monkeypatch, 50)
        bl = list(b)
        x = rt.cholsol_ir(at, bl, 0, factor_dtype, refine, device="cpu")
        assert np.array_equal(np.asarray(bl), x)  # b overwritten
        assert _rel(x, xj) <= 1e-8 and _rel(x, want) <= 1e-8
    # one step from the rounded factor alone is only float32-accurate
    x0 = rt.cholsol_ir(at, b.copy(), 0, "float32", 0, device="cpu")
    assert _rel(x0, want) > 1e-10
