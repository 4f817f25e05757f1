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
from rsparse_tpu_torch.convert import sprs_from_fields, symb_from_fields  # noqa: E402


def _scale_tree(obj, f):
    """Multiply every floating tensor of a cached factor tree by f, in
    place (a factor off by a relative 1e-6)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            obj.mul_(f)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _scale_tree(o, f)


def _unsym(g, seed):
    """Nonsymmetric diagonally dominant matrix on the g x g 5-point pattern:
    off-diagonals -(1 + 0.3 N(0,1)), diagonal 1 + max(row, col) abs-sum."""
    from bench import laplacian_5pt

    n, p, i, _ = laplacian_5pt(g)
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(n), np.diff(p))
    d = np.zeros((n, n))
    d[i, cols] = -(1.0 + 0.3 * rng.standard_normal(len(i)))
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, np.maximum(np.abs(d).sum(0), np.abs(d).sum(1)) + 1.0)
    return d


def _both_lu(d, order, tol=1e-6):
    aj = rs.Sprs.new_from_vec(d)
    sj = rs.sqr(aj, order, False)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    st = symb_from_fields(q=sj.q, lnz=sj.lnz, unz=sj.unz)
    nj = rs.lu(aj, sj, tol)
    nt = rt.lu(at, st, tol, device="cpu")
    return (aj, sj, nj), (at, st, nt)


def _assert_same_factors(nj, nt):
    for mj, mt in ((nj.l, nt.l), (nj.u, nt.u)):
        nz = mj.nnz()
        assert mt.nnz() == nz
        np.testing.assert_array_equal(mj.p, mt.p)
        np.testing.assert_array_equal(mj.i[:nz], mt.i[:nz])
        xj = np.asarray(mj.x)[:nz]
        xt = mt.x[:nz]
        assert np.abs(xj - xt).max() <= 1e-12 * max(1.0, np.abs(xj).max())
    np.testing.assert_array_equal(nj.pinv, nt.pinv)


def test_mf_dense_skeleton(monkeypatch):
    monkeypatch.setattr(rs.config, "mf_min_n", 100)
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    (aj, sj, nj), (at, st, nt) = _both_lu(_unsym(14, 1), 1)
    assert isinstance(st._mf_lu_plan.skel_plan, flu_torch.DenseSkelPlan)
    assert st._lu_route == "device_mf" and not getattr(st, "_static_rejected", False)
    np.testing.assert_array_equal(sj.q, st.q)  # the MF planner's composed order
    _assert_same_factors(nj, nt)


@pytest.mark.parametrize("g,inner", [(20, "DenseSkelPlan"), (24, "LUPlan")])
def test_mf_recursive_skeleton(monkeypatch, g, inner):
    """The skeleton recurses into a second front layer; its innermost
    skeleton factors densely (g=20) or, still too large for the patched
    dense cap, on the level-scheduled LU (g=24)."""
    for m, cfg in ((flu_jax, rs.config), (flu_torch, rt.config)):
        monkeypatch.setattr(m, "DENSE_SKEL_MAX", 24)
        monkeypatch.setattr(cfg, "mf_min_n", 100)
    (aj, sj, nj), (at, st, nt) = _both_lu(_unsym(g, 2), 1)
    sub = st._mf_lu_plan.skel_plan
    assert isinstance(sub, flu_torch.LUMFPlan), "recursion must engage"
    assert type(sub.skel_plan).__name__ == inner
    assert st._lu_route == "device_mf"
    _assert_same_factors(nj, nt)


def test_level_path(monkeypatch):
    """Below mf_min_n: the level-scheduled static-pivot LU (natural order on
    a random diagonally dominant matrix, few enough levels that both
    packages take the level phase without a dense tail)."""
    monkeypatch.setattr(rs.config, "mf_min_n", 10**9)
    monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    rng = np.random.default_rng(0)
    n = 50
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0)
    (aj, sj, nj), (at, st, nt) = _both_lu(d, -1)
    assert st._lu_route == "device_level"
    assert st.plan.tail is None
    _assert_same_factors(nj, nt)


def test_level_path_dense_tail(monkeypatch):
    """A deep level structure on a small system factors entirely in the
    dense tail (cut = 0): L U must reproduce A exactly (port only — the
    JAX package's level sweep cannot take an empty L_NN schedule)."""
    monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    d = _unsym(12, 3)
    a = rt.Sprs.new_from_vec(d)
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
    (aj, sj, nj), (at, st, nt) = _both_lu(d, -1)
    assert st._lu_route == "host"
    assert not np.array_equal(nt.pinv, np.arange(3))
    _assert_same_factors(nj, nt)


def test_backend_host_matches(monkeypatch):
    monkeypatch.setattr(rt.config, "backend", "host")
    d = _unsym(5, 4)
    at = rt.Sprs.new_from_vec(d)
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

README_A = [
    [8.2541e-01, 9.5622e-01, 4.6698e-01, 8.4410e-03, 6.3193e-01, 7.5741e-01, 5.3584e-01, 3.9448e-01],
    [7.4808e-01, 2.0403e-01, 9.4649e-01, 2.5086e-01, 2.6931e-01, 5.5866e-01, 3.1827e-01, 2.9819e-02],
    [6.3980e-01, 9.1615e-01, 8.5515e-01, 9.5323e-01, 7.8323e-01, 8.6003e-01, 7.5761e-01, 8.9255e-01],
    [1.8726e-01, 8.9339e-01, 9.9796e-01, 5.0506e-01, 6.1439e-01, 4.3617e-01, 7.3369e-01, 1.5565e-01],
    [2.8015e-02, 6.3404e-01, 8.4771e-01, 8.6419e-01, 2.7555e-01, 3.5909e-01, 7.6644e-01, 8.9905e-02],
    [9.1817e-01, 8.6629e-01, 5.9917e-01, 1.9346e-01, 2.1960e-01, 1.8676e-01, 8.7020e-01, 2.7891e-01],
    [3.1999e-01, 5.9988e-01, 8.7402e-01, 5.5710e-01, 2.4707e-01, 7.5652e-01, 8.3682e-01, 6.3145e-01],
    [9.3807e-01, 7.5985e-02, 7.8758e-01, 3.6881e-01, 4.4553e-01, 5.5005e-02, 3.3908e-01, 3.4573e-01],
]
README_B = [0.4377, 0.7328, 0.1227, 0.1817, 0.2634, 0.6876, 0.8711, 0.4201]


def _rel(x, want):
    return np.abs(np.asarray(x) - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("backend", ["device", "host"])
def test_lusol_readme_8x8(monkeypatch, backend):
    monkeypatch.setattr(rt.config, "backend", backend)
    b = list(README_B)
    x = rt.lusol(rt.Sprs.new_from_vec(README_A), b, 1, 1e-6, device="cpu")
    assert abs(x[0] - 0.2646806068156303) <= 1e-15
    assert b[0] == x[0]  # b overwritten
    xj = np.asarray(rs.lusol(rs.Sprs.new_from_vec(README_A), list(README_B),
                             1, 1e-6), np.float64)
    assert _rel(x, xj) <= 1e-12


def _dup_matrix(n, seed):
    """Duplicate (i, j) entries after `sum_dupl` (test_round5_fixes)."""
    rng = np.random.default_rng(seed)
    t = rs.Trpl()
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


def _pivoting_matrix(n, seed):
    """A sparse random matrix with a weak diagonal: partial pivoting must
    swap rows."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 4.0 / n)
    np.fill_diagonal(d, 1e-3 * rng.standard_normal(n))
    d[rng.permutation(n), np.arange(n)] += 3.0 + rng.random(n)
    return rs.Sprs.new_from_vec(d)


@pytest.mark.parametrize("make", ["duplicates", "pivoting"])
def test_lusol_mf_matches_jax_and_dense(monkeypatch, make):
    monkeypatch.setattr(rs.config, "mf_min_n", 50)
    monkeypatch.setattr(rt.config, "mf_min_n", 50)
    aj = _dup_matrix(150, 2) if make == "duplicates" else _pivoting_matrix(200, 3)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    b = np.random.default_rng(4).standard_normal(aj.n)
    dense = np.zeros((aj.n, aj.n))
    nz = aj.nnz()
    np.add.at(dense, (aj.i[:nz], np.repeat(np.arange(aj.n), np.diff(aj.p))),
              aj.x[:nz])
    want = np.linalg.solve(dense, b)
    xj = np.asarray(rs.lusol(aj, list(b), 1, 1e-6), np.float64)
    st = rt.sqr(at, 1, False)
    bl = list(b)
    xt = rt.lusol(at, bl, 1, 1e-6, sym=st, device="cpu")
    assert st._lu_route == "device_mf"
    assert not getattr(st, "_static_rejected", False)
    assert np.array_equal(np.asarray(bl), xt)
    assert _rel(xt, xj) <= 1e-10 and _rel(xt, want) <= 1e-10


def test_lusol_static_rejected_escape(monkeypatch):
    """When the one-shot's accept rule rejects the static pivots, lusol
    marks the analysis and solves on the host engine's exact partial
    pivoting."""
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    monkeypatch.setattr(flu_torch, "lu_mf", lambda *a, **k: None)
    d = _unsym(12, 5)
    a = rt.Sprs.new_from_vec(d)
    b = np.random.default_rng(5).standard_normal(a.n)
    s = rt.sqr(a, 1, False)
    x = rt.lusol(a, b.copy(), 1, 1e-6, sym=s, device="cpu")
    assert s._static_rejected and s._lu_route == "host"
    assert _rel(x, np.linalg.solve(d, b)) <= 1e-12


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
        _scale_tree(mfp.__dict__["_cache_tree"], 1.0 + 1e-6)
        return out

    monkeypatch.setattr(flu_torch, "lu_mf", off)
    monkeypatch.setattr(solve_torch, "_lu_one_shot", functools.partial(
        solve_torch._lu_one_shot, steps=steps))
    d = _unsym(14, 6)
    a = rt.Sprs.new_from_vec(d)
    b = np.random.default_rng(6).standard_normal(a.n)
    s = rt.sqr(a, 1, False)
    bl = list(b)
    x = rt.lusol(a, bl, 1, 1e-6, sym=s, device="cpu")
    assert s._lu_route == ("device_mf" if steps else "host_exact")
    assert not getattr(s, "_static_rejected", False)
    assert np.array_equal(np.asarray(bl), x)
    assert _rel(x, np.linalg.solve(d, b)) <= 1e-10


def test_lusol_singular_raises():
    d = np.eye(6) * 3.0
    d[:, 2] = 0.0
    d[2, 4] = 1.0
    aj = rs.Sprs.new_from_vec(d)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    with pytest.raises(rs.NoPivotError):
        rs.lusol(aj, [1.0] * 6, 1, 1e-6)
    with pytest.raises(rt.NoPivotError):
        rt.lusol(at, [1.0] * 6, 1, 1e-6, device="cpu")


def test_lusol_backend_host_matches(monkeypatch):
    monkeypatch.setattr(rs.config, "backend", "host")
    monkeypatch.setattr(rt.config, "backend", "host")
    aj = rs.Sprs.new_from_vec(_unsym(9, 7))
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    b = np.random.default_rng(8).standard_normal(aj.n)
    xj = np.asarray(rs.lusol(aj, list(b), 1, 1e-6), np.float64)
    assert _rel(rt.lusol(at, list(b), 1, 1e-6, device="cpu"), xj) <= 1e-12
