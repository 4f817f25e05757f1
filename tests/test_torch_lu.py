"""Port parity, LU factorization: the torch package's `lu` against the JAX
package's on the same matrix under the same analysis (passed across with
`convert`). Patterns and pinv must be equal; values agree to 1e-12
relative (f64, reordered sums only).

Covered: the multifrontal path with a dense skeleton, the recursive
skeleton layer (`DENSE_SKEL_MAX` patched down in both packages), and the
level-scheduled path (`mf_min_n` patched up in both). All matrices are
duplicate-free.

Then the `lusol` solver against the JAX package's and numpy's dense solve:
the README 8x8 (x[0] = 0.2646806068156303, `examples/basic.py`), a
duplicate-entry matrix and a pivot-requiring random one on the
multifrontal one-shot (`mf_min_n` patched down), the rejected-static-pivot
escape, the host-driven refinement and its host-exact escape,
`NoPivotError`, and the host engine (`config.backend = "host"`, 1e-12).
Device routes agree to 1e-10 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu.factor.frontal_lu as flu_jax  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.factor.frontal_lu as flu_torch  # noqa: E402
import torch_cases as C  # noqa: E402


def _jax_lu(aj, order, tol):
    """The JAX package's analysis (its fields before the factorization, and
    itself after: the multifrontal planner rebinds q) and factors."""
    sj = rs.sqr(aj, order, False)
    before = C.symb_fields(sj)
    return before, sj, rs.lu(aj, sj, tol)


def _both_lu(case, order, tol=1e-6, extra=()):
    """Both packages' lu of a case (or a dense array) under the JAX
    package's analysis; `extra` names the module constants a test
    patched."""
    before, sj, nj = C.jax_answer(_jax_lu, case, order, tol, extra=extra)
    at = C.port(case)
    st = C.symb(before)
    nt = rt.lu(at, st, tol, device="cpu")
    return (sj, nj), (at, st, nt)


def _assert_same_factors(nj, nt):
    C.same_sprs(nt.l, nj.l)
    C.same_sprs(nt.u, nj.u)
    np.testing.assert_array_equal(nj.pinv, nt.pinv)


def test_mf_dense_skeleton(monkeypatch):
    C.mf(monkeypatch)
    (sj, nj), (at, st, nt) = _both_lu("unsym12", 1)
    assert isinstance(st._mf_lu_plan.skel_plan, flu_torch.DenseSkelPlan)
    assert st._lu_route == "device_mf" and not getattr(st, "_static_rejected", False)
    np.testing.assert_array_equal(sj.q, st.q)  # the MF planner's composed order
    _assert_same_factors(nj, nt)


@pytest.mark.parametrize("case,inner", [("unsym20", "DenseSkelPlan"),
                                        ("unsym24", "LUPlan")])
def test_mf_recursive_skeleton(monkeypatch, case, inner):
    """The skeleton recurses into a second front layer; its innermost
    skeleton factors densely (grid 20) or, still too large for the patched
    dense cap, on the level-scheduled LU (grid 24)."""
    C.mf(monkeypatch)
    for m in (flu_jax, flu_torch):
        monkeypatch.setattr(m, "DENSE_SKEL_MAX", 24)
    (sj, nj), (at, st, nt) = _both_lu(case, 1, extra=24)
    sub = st._mf_lu_plan.skel_plan
    assert isinstance(sub, flu_torch.LUMFPlan), "recursion must engage"
    assert type(sub.skel_plan).__name__ == inner
    assert st._lu_route == "device_mf"
    _assert_same_factors(nj, nt)


def test_level_path(monkeypatch):
    """Below mf_min_n: the level-scheduled static-pivot LU (natural order on
    a random diagonally dominant matrix, few enough levels that both
    packages take the level phase without a dense tail)."""
    C.mf(monkeypatch, 10**9)
    (sj, nj), (at, st, nt) = _both_lu("rand50", -1)
    assert st._lu_route == "device_level"
    assert st.plan.tail is None
    _assert_same_factors(nj, nt)


def test_level_path_dense_tail(monkeypatch):
    """A deep level structure on a small system factors entirely in the
    dense tail (cut = 0): L U must reproduce A exactly (port only — the
    JAX package's level sweep cannot take an empty L_NN schedule)."""
    monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    d = C.dense("unsym12")
    a = C.port("unsym12")
    s = rt.sqr(a, -1, False)
    nm = rt.lu(a, s, 1e-6, device="cpu")
    assert s._lu_route == "device_level" and s.plan.tail.cut == 0
    L = rt.Sprs(nm.l.nnz(), a.n, a.n, nm.l.p, nm.l.i, nm.l.x).to_dense_np()
    U = rt.Sprs(nm.u.nnz(), a.n, a.n, nm.u.p, nm.u.i, nm.u.x).to_dense_np()
    assert np.abs(L @ U - d).max() < 1e-12 * np.abs(d).max()


def test_host_fallback_on_pivoting_matrix():
    """A tiny diagonal rejects the static pivot: both packages fall back to
    the host engine's exact partial pivoting and agree."""
    d = np.array([[1e-14, 1.0, 0.0],
                  [1.0, 2.0, 1.0],
                  [0.0, 1.0, 3.0]])
    (sj, nj), (at, st, nt) = _both_lu(d, -1)
    assert st._lu_route == "host"
    assert not np.array_equal(nt.pinv, np.arange(3))
    _assert_same_factors(nj, nt)


def test_backend_host_matches(monkeypatch):
    monkeypatch.setattr(rt.config, "backend", "host")
    at = C.port("unsym6")
    nm = rt.lu(at, rt.sqr(at, 1, False), 1e-6, device="cpu")
    assert isinstance(nm.l.x, np.ndarray) and nm.l.x.dtype == np.float64


def test_pivoted_lu_single_blocked_vs_dense():
    """The dense skeleton LU (full partial pivoting, blocked) reproduces
    P M = L U across a panel boundary."""
    rng = np.random.default_rng(7)
    M = torch.as_tensor(rng.standard_normal((70, 70)))
    LU, perm, worst = flu_torch._pivoted_lu_single_blocked(M, 1.0, panel=32)
    L = LU.tril(-1) + torch.eye(70, dtype=LU.dtype)
    U = LU.triu()
    assert torch.allclose(L @ U, M[perm], atol=1e-12)
    assert float(worst) == 1.0  # theta = 1: every pivot is its column max


def test_level_path_duplicate_entries(monkeypatch):
    """Duplicate (i, j) entries after `sum_dupl`: the first slot holds an
    explicit zero and the last the sum. The level LU's lookups take the
    LAST slot (the reference's last-wins assignment), so L U reproduces the
    matrix as rendered densely (port only: the JAX package's level-path
    lookup takes the first slot)."""
    monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    rng = np.random.default_rng(4)
    n = 40
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0)
    t = rt.Trpl()
    r, c = np.nonzero(d)
    for i, j in zip(r, c):
        t.append(int(i), int(j), float(d[i, j]))
    for i, j in zip(r[::5], c[::5]):  # split every 5th entry in two
        t.append(int(i), int(j), 0.25)
        t.x[[k for k in range(len(t.x) - 1) if (t.i[k], t.p[k]) == (i, j)][0]] -= 0.25
    t.sum_dupl()
    a = t.to_sprs()
    assert a.nnz() > np.count_nonzero(d)  # duplicates are stored
    np.testing.assert_allclose(a.to_dense_np(), d, atol=1e-15)
    s = rt.sqr(a, -1, False)
    nm = rt.lu(a, s, 1e-6, device="cpu")
    assert s._lu_route == "device_level"
    L = rt.Sprs(nm.l.nnz(), n, n, nm.l.p, nm.l.i, nm.l.x).to_dense_np()
    U = rt.Sprs(nm.u.nnz(), n, n, nm.u.p, nm.u.i, nm.u.x).to_dense_np()
    assert np.abs(L @ U - d).max() < 1e-12 * np.abs(d).max()


# ---------------------------------------------------------------------------
# lusol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["device", "host"])
def test_lusol_readme_8x8(monkeypatch, backend):
    monkeypatch.setattr(rt.config, "backend", backend)
    b = list(C.README_B)
    x = rt.lusol(C.port("readme8"), b, 1, 1e-6, device="cpu")
    assert abs(x[0] - 0.2646806068156303) <= 1e-15
    assert b[0] == x[0]  # b overwritten
    xj = C.jax_answer("lusol", "readme8", list(C.README_B), 1, 1e-6)
    assert C.rel(x, xj) <= 1e-12


@pytest.mark.parametrize("make", ["duplicates", "pivoting"])
def test_lusol_mf_matches_jax_and_dense(monkeypatch, make):
    C.mf(monkeypatch, 50)
    case = "dup150" if make == "duplicates" else "pivot200"
    at = C.port(case)
    b = np.random.default_rng(4).standard_normal(at.n)
    want = np.linalg.solve(C.dense(case), b)
    xj = C.jax_answer("lusol", case, list(b), 1, 1e-6)
    st = rt.sqr(at, 1, False)
    bl = list(b)
    xt = rt.lusol(at, bl, 1, 1e-6, sym=st, device="cpu")
    assert st._lu_route == "device_mf"
    assert not getattr(st, "_static_rejected", False)
    assert np.array_equal(np.asarray(bl), xt)
    assert C.rel(xt, xj) <= 1e-10 and C.rel(xt, want) <= 1e-10


def test_lusol_static_rejected_escape(monkeypatch):
    """When the one-shot's accept rule rejects the static pivots, lusol
    marks the analysis and solves on the host engine's exact partial
    pivoting."""
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    monkeypatch.setattr(flu_torch, "lu_mf", lambda *a, **k: None)
    d = C.dense("unsym12")
    a = C.port("unsym12")
    b = np.random.default_rng(5).standard_normal(a.n)
    s = rt.sqr(a, 1, False)
    x = rt.lusol(a, b.copy(), 1, 1e-6, sym=s, device="cpu")
    assert s._static_rejected and s._lu_route == "host"
    assert C.rel(x, np.linalg.solve(d, b)) <= 1e-12


@pytest.mark.parametrize("steps", [6, 0])
def test_lu_mf_refine_and_host_exact_escape(monkeypatch, steps):
    """A factor tree off by a relative 1e-6: the one-shot's refinement on
    the device recovers the answer within 6 steps (route device_mf); with
    no step, lusol takes the host engine's exact partial pivoting (route
    host_exact)."""
    import functools

    import rsparse_tpu_torch.solve as solve_torch

    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    real = flu_torch.lu_mf

    def off(a, s, mfp, *args):
        out = real(a, s, mfp, *args)
        C.scale_tree(mfp.__dict__["_cache_tree"], 1.0 + 1e-6)
        return out

    monkeypatch.setattr(flu_torch, "lu_mf", off)
    monkeypatch.setattr(solve_torch, "_lu_one_shot", functools.partial(
        solve_torch._lu_one_shot, steps=steps))
    d = C.dense("unsym12")
    a = C.port("unsym12")
    b = np.random.default_rng(6).standard_normal(a.n)
    s = rt.sqr(a, 1, False)
    bl = list(b)
    x = rt.lusol(a, bl, 1, 1e-6, sym=s, device="cpu")
    assert s._lu_route == ("device_mf" if steps else "host_exact")
    assert not getattr(s, "_static_rejected", False)
    assert np.array_equal(np.asarray(bl), x)
    assert C.rel(x, np.linalg.solve(d, b)) <= 1e-10


def test_lusol_singular_raises():
    d = np.eye(6) * 3.0
    d[:, 2] = 0.0
    d[2, 4] = 1.0
    aj, at = C.pair(d)
    with pytest.raises(rs.NoPivotError):
        rs.lusol(aj, [1.0] * 6, 1, 1e-6)
    with pytest.raises(rt.NoPivotError):
        rt.lusol(at, [1.0] * 6, 1, 1e-6, device="cpu")


def test_lusol_backend_host_matches(monkeypatch):
    C.host(monkeypatch)
    at = C.port("unsym6")
    b = np.random.default_rng(8).standard_normal(at.n)
    xj = C.jax_answer("lusol", "unsym6", list(b), 1, 1e-6)
    assert C.rel(rt.lusol(at, list(b), 1, 1e-6, device="cpu"), xj) <= 1e-12
