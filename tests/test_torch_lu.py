"""Port parity, LU factorization: the torch package's `lu` against the JAX
package's on the same matrix under the same analysis (passed across with
`convert`). Patterns and pinv must be equal; values agree to 1e-12
relative (f64, reordered sums only).

Covered: the multifrontal path with a dense skeleton, the recursive
skeleton layer (`DENSE_SKEL_MAX` patched down in both packages), and the
level-scheduled path (`mf_min_n` patched up in both). All matrices are
duplicate-free.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu.factor.frontal_lu as flu_jax  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.factor.frontal_lu as flu_torch  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields, symb_from_fields  # noqa: E402


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
        xt = mt.x[:nz].numpy()
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
    L = rt.Sprs(nm.l.nnz(), a.n, a.n, nm.l.p, nm.l.i, nm.l.x.numpy()).to_dense_np()
    U = rt.Sprs(nm.u.nnz(), a.n, a.n, nm.u.p, nm.u.i, nm.u.x.numpy()).to_dense_np()
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
    assert isinstance(nm.l.x, torch.Tensor) and nm.l.x.dtype == torch.float64


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
    L = rt.Sprs(nm.l.nnz(), n, n, nm.l.p, nm.l.i, nm.l.x.numpy()).to_dense_np()
    U = rt.Sprs(nm.u.nnz(), n, n, nm.u.p, nm.u.i, nm.u.x.numpy()).to_dense_np()
    assert np.abs(L @ U - d).max() < 1e-12 * np.abs(d).max()
