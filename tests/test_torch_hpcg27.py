"""HPCG's 27-point problem on the port's Cholesky (`benchmark/generators/
hpcg27.py`, HPCG 3.1's `GenerateProblem_ref.cpp`), and the wide-front route
of the multifrontal planner (`factor.front_tree`) that its dense 3D
separators take.

Covered: the generator against a dense construction of the stencil;
`cholsol_serve` against the plain `planes` reference with HPCG's values and
with seeded random SPD values on the same pattern; the wide-front route,
forced at a small size by planning with a small Smax (and `mf_min_n`
patched down), against the host engine's `native.chol_numeric` to 1e-12
and the JAX package's `chol` on the same analysis to 1e-10, with its
counters and its `factor.fronts` span; the route's one-shot, batched-RHS
and batched-values solves against a dense solve; NotPositiveDefinite
through it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch import utils  # noqa: E402
from rsparse_tpu_torch.errors import NotPositiveDefiniteError  # noqa: E402
from rsparse_tpu_torch.factor import front_tree, frontal  # noqa: E402
from rsparse_tpu_torch.symbolic import _symperm_host, native  # noqa: E402

import torch_cases as C  # noqa: E402
from benchmark.generators import hpcg27  # noqa: E402
from benchmark.reference import planes  # noqa: E402


def _fields(g, values="hpcg", seed=0):
    """(n, p, i, x) of `torch_cases.hpcg27`."""
    return C.hpcg27(g, values, seed)[1:]


def test_generator_is_hpcgs_stencil():
    g = 4
    n, p, i, x = hpcg27.make({"grid": g}, None)
    A = np.zeros((n, n))
    for iz in range(g):
        for iy in range(g):
            for ix in range(g):
                row = iz * g * g + iy * g + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            z, y, xx = iz + sz, iy + sy, ix + sx
                            if 0 <= z < g and 0 <= y < g and 0 <= xx < g:
                                col = z * g * g + y * g + xx
                                A[row, col] = 26.0 if col == row else -1.0
    np.testing.assert_array_equal(C.dense((n, n, p, i, x)), A)
    for j in range(n):  # rows ascending in each column
        assert np.all(np.diff(i[p[j]:p[j + 1]]) > 0)


@pytest.mark.parametrize("values", ["hpcg", "random"])
def test_cholsol_serve_matches_planes(values):
    g = 6
    n, p, i, x = _fields(g, values, seed=3)
    h = rt.cholsol_serve(rt.Sprs(len(x), n, n, p, i, x), 1, device="cpu")
    B = torch.as_tensor(np.random.default_rng(4).standard_normal((n, 8)))
    X = h(B)
    Xr = planes.build({"params": {"grid": g}}, n, p, i, x).solve(B)
    assert float((X - Xr).abs().max() / Xr.abs().max()) < 1e-12


SMAX = 8  # the subtree fronts' limit at a test size


def _wide_sym(monkeypatch, a):
    """a's analysis (AMD) with its multifrontal plan made at Smax = SMAX:
    at a test size its skeleton then holds supernodes wider than the
    subtree fronts, and takes the front tree."""
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    s = rt.schol(a, 1)
    s._mf_plan = frontal.build_mf_plan(_symperm_host(a, s.pinv), s, SMAX)
    return s


@pytest.mark.parametrize("values", ["hpcg", "random"])
def test_wide_front_route_matches_host_engine(monkeypatch, values):
    n, p, i, x = _fields(8, values, seed=5)
    a = rt.Sprs(len(x), n, n, p, i, x)
    s = _wide_sym(monkeypatch, a)
    cols0 = frontal._chol_mf_values.cols
    wide0 = frontal._chol_mf_values.wide_front_cols
    with utils.recording():
        nm = rt.chol(a, s, device="cpu")
    tree = s._mf_plan.skel_plan
    assert s._chol_route == "device_mf"
    assert isinstance(tree, front_tree.FrontTree)
    assert s._mf_plan.skel_c_pattern is None
    c = _symperm_host(a, s.pinv)
    _, _, Lx = native.chol_numeric(n, c.p, c.i[:c.nnz()], c.x[:c.nnz()],
                                   s.parent, s.cp)
    Lx = np.asarray(Lx)
    assert np.abs(nm.l.x[:len(Lx)] - Lx).max() <= 1e-12 * np.abs(Lx).max()
    # the counters: every column, and those of the fronts wider than SMAX
    assert frontal._chol_mf_values.cols - cols0 == n
    assert tree.wide_cols > 0
    assert frontal._chol_mf_values.wide_front_cols - wide0 == tree.wide_cols
    rec = utils.spans()
    fronts = [r for r in rec if r.name == "factor.fronts"]
    assert len(fronts) == 1 and rec[fronts[0].parent].name == "factor.numeric"


def test_wide_front_route_solves(monkeypatch):
    """One analysis, the route's plan reused by the one-shot, batched-RHS
    and batched-values (K = 2) solves."""
    n, p, i, x = _fields(7, "random", seed=6)
    a = rt.Sprs(len(x), n, n, p, i, x)
    A = C.dense((n, n, p, i, x))
    s = _wide_sym(monkeypatch, a)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    xs = rt.cholsol(a, b.copy(), 1, sym=s, device="cpu")
    assert isinstance(s._mf_plan.skel_plan, front_tree.FrontTree)
    assert np.abs(np.asarray(xs) - np.linalg.solve(A, b)).max() < 1e-10
    B = rng.standard_normal((n, 3))
    X = rt.cholsol_multi(a, B, 1, sym=s, device="cpu")
    assert np.abs(np.asarray(X) - np.linalg.solve(A, B)).max() < 1e-10
    # a second instance: the values doubled and the diagonal shifted
    Ax = np.stack([x, 2 * x + (np.repeat(np.arange(n), np.diff(p)) == i)])
    Bk = rng.standard_normal((2, n))
    Xk = rt.cholsol_vals(a, Ax, Bk, 1, sym=s, device="cpu")
    assert s._vals_route == ("device_mf", 0)
    for k in range(2):
        Ak = C.dense((n, n, p, i, Ax[k]))
        assert np.abs(Xk[k] - np.linalg.solve(Ak, Bk[k])).max() < 1e-10


def test_wide_front_route_not_positive_definite(monkeypatch):
    n, p, i, x = _fields(8)
    x = x.copy()
    s = _wide_sym(monkeypatch, rt.Sprs(len(x), n, n, p, i, x))
    # negate the diagonal of the column eliminated last (the tree's root)
    q = np.argsort(np.asarray(s.pinv))[n - 1]
    x[p[q] + int(np.nonzero(i[p[q]:p[q + 1]] == q)[0][0])] = -30.0
    a = rt.Sprs(len(x), n, n, p, i, x)
    with pytest.raises(NotPositiveDefiniteError):
        rt.chol(a, s, device="cpu")
    assert isinstance(s._mf_plan.skel_plan, front_tree.FrontTree)


def _jax_chol(aj):
    """The JAX package's analysis (AMD; its fields) and its chol."""
    import rsparse_tpu as rs

    sj = rs.schol(aj, 1)
    return C.symb_fields(sj), rs.chol(aj, sj)


def test_wide_front_route_matches_jax_package(monkeypatch):
    """L of the wide-front route at grid 6 against the JAX package's chol
    of the same matrix under the same analysis (passed across with
    `convert`), as `test_torch_chol.py` holds the other routes. Grid 6,
    not 8: the JAX package compiles its factorization for each matrix
    (about 6 s here, 17 s at grid 8)."""
    pytest.importorskip("rsparse_tpu")
    case = C.hpcg27(6, "random", seed=8)
    before, nj = C.jax_answer(_jax_chol, case)
    at, st = C.port(case), C.symb(before)
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    st._mf_plan = frontal.build_mf_plan(_symperm_host(at, st.pinv), st, SMAX)
    nt = rt.chol(at, st, device="cpu")
    assert isinstance(st._mf_plan.skel_plan, front_tree.FrontTree)
    nz = nj.l.nnz()
    assert nt.l.nnz() == nz
    np.testing.assert_array_equal(nj.l.p, nt.l.p)
    np.testing.assert_array_equal(nj.l.i[:nz], nt.l.i[:nz])
    xj = np.asarray(nj.l.x)[:nz]
    assert np.abs(xj - nt.l.x[:nz]).max() <= 1e-10 * max(1.0, np.abs(xj).max())
