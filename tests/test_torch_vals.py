"""Port parity, the batched-values drivers `cholsol_vals`, `lusol_vals` and
`qrsol_vals`: K systems of one sparsity pattern in the torch package
against the JAX package's on the same seeded inputs, against the port's
per-instance `cholsol`/`lusol`/`qrsol`, and against numpy's dense solves,
at n <= 400 (`mf_min_n` patched down in both packages to force the
multifrontal routes). The JAX answers are computed once per module.

Tolerances: the drivers 1e-10 relative (Cholesky, LU) and 1e-9 (QR) to
the JAX package and to the per-instance drivers, both f64 routes; the
batched factor cores and the plain sweep with [K, L] values 1e-12
relative to K one-instance calls (the same operations, batched).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.solve as solve_torch  # noqa: E402
from rsparse_tpu_torch.factor import frontal as fchol  # noqa: E402
from rsparse_tpu_torch.factor import frontal_lu as flu  # noqa: E402
from rsparse_tpu_torch.factor import frontal_qr as fqr  # noqa: E402
from rsparse_tpu_torch.ops.plan import col_ids  # noqa: E402
from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_plain_multi  # noqa: E402

# the package's functions of these names shadow the modules
chol_device = importlib.import_module("rsparse_tpu_torch.factor.chol_device")
lu_device = importlib.import_module("rsparse_tpu_torch.factor.lu_device")

K = 5
MF_MIN_N = 100


def _rel(x, want):
    x, want = np.asarray(x, np.float64), np.asarray(want, np.float64)
    return np.abs(x - want).max() / max(1.0, np.abs(want).max())


def _jax(a):
    return rs.Sprs(a.nnz(), a.m, a.n, a.p, a.i[: a.nnz()], a.x[: a.nnz()])


def _diag(a):
    nz = a.nnz()
    return a.i[:nz] == col_ids(a.p, a.n)


def _lap(g=20):
    from chip_smoke import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    return rt.Sprs(len(x), n, n, p, i, x)


def _chol_case():
    """The Laplacian (n = 400), diagonals scaled by 1 + 0.25k (the chip
    smoke's family at a test size)."""
    a = _lap()
    AxK = np.tile(a.x[: a.nnz()], (K, 1))
    AxK[:, _diag(a)] *= (1.0 + 0.25 * np.arange(K))[:, None]
    return a, AxK


def _lu_case():
    """chip_smoke.make_matrix(20) (nonsymmetric, n = 400): instances
    0..K-2 with diagonals scaled by 1 + 0.2k, the last with its
    off-diagonals redrawn (other pivots)."""
    from chip_smoke import make_matrix

    a = make_matrix(20, 0)
    d = _diag(a)
    AxK = np.tile(a.x[: a.nnz()], (K, 1))
    AxK[:, d] *= (1.0 + 0.2 * np.arange(K))[:, None]
    rng = np.random.default_rng(7)
    AxK[-1, ~d] = -(1.0 + 0.3 * rng.standard_normal(int((~d).sum())))
    return a, AxK


def _qr_case(branch):
    """[A5; 0.1 I] (m = 288, n = 144) or its transpose, values scaled by
    1 + 0.1k."""
    from chip_smoke import qr_matrix

    a = qr_matrix(0, 12)
    if branch == "mn":
        a = rt.transpose(a, device="cpu")
    AxK = np.asarray(a.x[: a.nnz()]) * (1.0 + 0.1 * np.arange(K))[:, None]
    return a, AxK


def _qr_sym(a, order=2):
    return rt.sqr(a if a.m >= a.n else rt.transpose(a, device="cpu"), order,
                  True)


def _B(rows, seed):
    return np.random.default_rng(seed).standard_normal((K, rows))


@pytest.fixture(autouse=True)
def _mf(monkeypatch):
    monkeypatch.setattr(rs.config, "mf_min_n", MF_MIN_N)
    monkeypatch.setattr(rt.config, "mf_min_n", MF_MIN_N)


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's *_vals on each case, computed once."""
    old = rs.config.mf_min_n
    rs.config.mf_min_n = MF_MIN_N
    try:
        out = {}
        a, AxK = _chol_case()
        out["chol"] = np.asarray(rs.cholsol_vals(_jax(a), AxK, _B(a.n, 1), 1))
        a, AxK = _lu_case()
        out["lu"] = np.asarray(rs.lusol_vals(_jax(a), AxK, _B(a.n, 2), 1,
                                             1e-6))
        for br in ("ls", "mn"):
            a, AxK = _qr_case(br)
            out[br] = np.asarray(rs.qrsol_vals(_jax(a), AxK, _B(a.m, 3), 2))
        return out
    finally:
        rs.config.mf_min_n = old


def _per_instance(driver, a, AxK, B, **kw):
    """Each instance through the port's single-system driver."""
    nz = a.nnz()
    out = []
    for k in range(len(AxK)):
        ak = rt.Sprs(nz, a.m, a.n, a.p, a.i[:nz], AxK[k])
        out.append(np.asarray(driver(ak, B[k].copy(), device="cpu", **kw)))
    return np.stack(out)


# ---------------------------------------------------------------------------
# the drivers against the JAX package and the per-instance drivers
# ---------------------------------------------------------------------------


def test_cholsol_vals_matches_jax_and_cholsol(jax_answers):
    a, AxK = _chol_case()
    B = _B(a.n, 1)
    s = rt.schol(a, 1)
    X = rt.cholsol_vals(a, AxK, B, 1, sym=s, device="cpu")
    assert X.shape == (K, a.n) and X.dtype == np.float64
    assert s._vals_route == ("device_mf", 0)
    assert _rel(X, jax_answers["chol"]) <= 1e-10
    assert _rel(X, _per_instance(rt.cholsol, a, AxK, B, order=1)) <= 1e-10
    k = K - 1
    d = a.to_dense_np()
    d[np.arange(a.n), np.arange(a.n)] *= 1.0 + 0.25 * k
    assert _rel(X[k], np.linalg.solve(d, B[k])) <= 1e-10


def test_lusol_vals_matches_jax_and_lusol(jax_answers):
    a, AxK = _lu_case()
    B = _B(a.n, 2)
    s = rt.sqr(a, 1, False)
    X = rt.lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device="cpu")
    assert s._vals_route == ("device_mf", 0)
    assert _rel(X, jax_answers["lu"]) <= 1e-10
    assert _rel(X, _per_instance(rt.lusol, a, AxK, B, order=1,
                                 tol=1e-6)) <= 1e-10


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_vals_matches_jax_and_qrsol(jax_answers, branch):
    a, AxK = _qr_case(branch)
    B = _B(a.m, 3)
    s = _qr_sym(a)
    X = rt.qrsol_vals(a, AxK, B, 2, sym=s, device="cpu")
    assert X.shape == (K, a.n)
    assert s._vals_route == ("device_mf", 0)
    assert _rel(X, jax_answers[branch]) <= 1e-9
    assert _rel(X, _per_instance(rt.qrsol, a, AxK, B, order=2)) <= 1e-9


# ---------------------------------------------------------------------------
# B broadcast, repeated calls, the per-instance tiers, validation
# ---------------------------------------------------------------------------


def _call(driver, a, AxK, B, s, device="cpu"):
    if driver == "chol":
        return rt.cholsol_vals(a, AxK, B, 1, sym=s, device=device)
    if driver == "lu":
        return rt.lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device=device)
    return rt.qrsol_vals(a, AxK, B, 2, sym=s, device=device)


def _case(driver):
    if driver == "chol":
        a, AxK = _chol_case()
        return a, AxK, rt.schol(a, 1)
    if driver == "lu":
        a, AxK = _lu_case()
        return a, AxK, rt.sqr(a, 1, False)
    a, AxK = _qr_case("ls" if driver == "qr" else "mn")
    return a, AxK, _qr_sym(a)


@pytest.mark.parametrize("driver", ["chol", "lu", "qr", "qr_mn"])
def test_vals_broadcast_b(driver):
    a, AxK, s = _case(driver)
    b = np.random.default_rng(4).standard_normal(a.m)
    X1 = _call(driver, a, AxK, b, s)
    X2 = _call(driver, a, AxK, np.tile(b, (K, 1)), s)
    np.testing.assert_array_equal(X1, X2)


@pytest.mark.parametrize("driver", ["chol", "lu", "qr", "qr_mn"])
def test_vals_new_values_no_stale_cache(driver):
    """A second call on the same analysis with new values answers for the
    new values (nothing of the first call's factors is reused)."""
    a, AxK, s = _case(driver)
    B = _B(a.m, 5)
    X1 = _call(driver, a, AxK, B, s)
    AxK2 = AxK * 1.25
    AxK2[:, _diag(a) if a.m == a.n else slice(None)] *= 1.1
    X2 = _call(driver, a, AxK2, B, s)
    fn = {"chol": lambda ak, b, device: rt.cholsol(ak, b, 1, device=device),
          "lu": lambda ak, b, device: rt.lusol(ak, b, 1, 1e-6, device=device),
          }.get(driver, lambda ak, b, device: rt.qrsol(ak, b, 2,
                                                       device=device))
    want = _per_instance(fn, a, AxK2, B)
    assert _rel(X2, want) <= 1e-9
    assert _rel(X1, X2) > 1e-3


@pytest.mark.parametrize("route", ["mf", "per_instance"])
def test_cholsol_vals_npd_names_all_instances(monkeypatch, route):
    if route == "per_instance":
        monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    a, AxK = _chol_case()
    bad = AxK.copy()
    bad[1, _diag(a)] = -5.0
    bad[3, _diag(a)] = -5.0
    s = rt.schol(a, 1)
    with pytest.raises(rt.NotPositiveDefiniteError,
                       match=r"instances \[1, 3\] are not positive definite"):
        rt.cholsol_vals(a, bad, _B(a.n, 6), 1, sym=s, device="cpu")
    assert s._vals_route[0] == ("device_mf" if route == "mf"
                                else "per_instance")


def test_lusol_vals_pivot_instance_in_batch():
    """One instance with a zeroed diagonal entry (pivoting needed) in the
    batch: it is right, and the other instances equal a clean run's."""
    a, AxK = _lu_case()
    B = _B(a.n, 7)
    s = rt.sqr(a, 1, False)
    X = rt.lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device="cpu")
    bad = AxK.copy()
    bad[2, np.nonzero(_diag(a))[0][7]] = 0.0
    XB = rt.lusol_vals(a, bad, B, 1, 1e-6, sym=s, device="cpu")
    nz = a.nnz()
    d = np.zeros((a.n, a.n))
    d[a.i[:nz], col_ids(a.p, a.n)] = bad[2]
    assert _rel(XB[2], np.linalg.solve(d, B[2])) <= 1e-10
    np.testing.assert_allclose(XB[[0, 1, 3, 4]], X[[0, 1, 3, 4]], rtol=0,
                               atol=1e-12 * np.abs(X).max())


@pytest.mark.parametrize("tier", ["small", "host"])
@pytest.mark.parametrize("driver", ["chol", "lu", "qr", "qr_mn"])
def test_vals_per_instance_tiers(monkeypatch, driver, tier):
    """Below `mf_min_n`, or with the host backend, every instance runs the
    single-system driver (the JAX package's tier), on the same answers."""
    a, AxK, s = _case(driver)
    B = _B(a.m, 8)
    want = _call(driver, a, AxK, B, s)
    if tier == "small":
        monkeypatch.setattr(rt.config, "mf_min_n", 10**9)
    else:
        monkeypatch.setattr(rt.config, "backend", "host")
    a2, AxK2, s2 = _case(driver)
    X = _call(driver, a2, AxK2, B, s2)
    assert s2._vals_route == ("per_instance", K)
    assert _rel(X, want) <= 1e-9


@pytest.mark.parametrize("driver", ["chol", "lu", "qr"])
def test_vals_shape_errors(driver):
    a, AxK, s = _case(driver)
    B = _B(a.m, 9)
    with pytest.raises(ValueError, match="Ax must be"):
        _call(driver, a, AxK[:, :-1], B, s)
    with pytest.raises(ValueError, match="B must be"):
        _call(driver, a, AxK, B[:, :-1], s)
    with pytest.raises(ValueError, match="B must be"):
        _call(driver, a, AxK, B[:-1], s)
    if driver != "qr":
        rect = rt.Sprs(a.nnz(), a.m + 1, a.n, a.p, a.i[: a.nnz()],
                       a.x[: a.nnz()])
        with pytest.raises(ValueError, match="square"):
            _call(driver, rect, AxK, B, None)


def _dup_spd(n, seed):
    """An SPD matrix with duplicate (i, j) entries (`Trpl.sum_dupl` keeps
    the sum in the last slot, zeros in the others)."""
    import rsparse_tpu_torch.data as rd

    rng = np.random.default_rng(seed)
    t = rd.Trpl()
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


@pytest.mark.parametrize("driver", ["chol", "lu"])
def test_vals_duplicate_entries(driver):
    a = _dup_spd(150, 4)
    nz, n = a.nnz(), a.n
    AxK = np.tile(np.asarray(a.x[:nz]), (3, 1))
    AxK[:, _diag(a)] *= (1.0 + 0.5 * np.arange(3))[:, None]
    B = np.random.default_rng(5).standard_normal((3, n))
    if driver == "chol":
        s = rt.schol(a, 0)
        X = rt.cholsol_vals(a, AxK, B, 0, sym=s, device="cpu")
    else:
        s = rt.sqr(a, 1, False)
        X = rt.lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device="cpu")
    assert s._vals_route[0] == "device_mf"
    for k in range(3):
        d = np.zeros((n, n))
        np.add.at(d, (a.i[:nz], col_ids(a.p, n)), AxK[k])
        if driver == "chol":  # chol reads triu (reference)
            d = np.triu(d) + np.triu(d, 1).T
        assert _rel(X[k], np.linalg.solve(d, B[k])) <= 1e-10


# ---------------------------------------------------------------------------
# the plan's single-instance caches survive a batched-values call
# ---------------------------------------------------------------------------


_SLOTS = {"qr": ("_cache_q", "_cache_ax", "_cache_rx", "_cache_rv",
                 "_cache_fp"),
          "chol": ("_cache_tree", "_oneshot_vals"),
          "lu": ("_cache_tree",)}


@pytest.mark.parametrize("driver", ["chol", "lu", "qr", "qr_mn"])
def test_vals_leave_single_instance_caches(driver):
    """single driver warm -> *_vals -> single driver warm: the second
    answer equals the first bit for bit, and the plan's cached factor
    slots are the same objects."""
    a, AxK, s = _case(driver)
    b = np.random.default_rng(10).standard_normal(a.m)
    if driver == "chol":
        one = lambda: rt.cholsol(a, b.copy(), 1, sym=s, device="cpu")
    elif driver == "lu":
        one = lambda: rt.lusol(a, b.copy(), 1, 1e-6, sym=s, device="cpu")
    else:
        one = lambda: rt.qrsol(a, b.copy(), 2, sym=s, device="cpu")
    one()
    x1 = one()  # warm
    plan = {"chol": "_mf_plan", "lu": "_mf_lu_plan"}.get(driver,
                                                         "_mf_qr_plan")
    plan = getattr(s, plan)
    slots = _SLOTS[driver.split("_")[0]]
    before = {k: plan.__dict__[k] for k in slots}
    _call(driver, a, AxK * 1.5, _B(a.m, 11), s)
    assert all(plan.__dict__[k] is before[k] for k in slots)
    np.testing.assert_array_equal(one(), x1)


def test_cholsol_serve_handle_survives_vals():
    a, AxK = _chol_case()
    s = rt.schol(a, 1)
    h = rt.cholsol_serve(a, 1, sym=s, device="cpu")
    Bh = np.random.default_rng(12).standard_normal((a.n, 8))
    X1 = h(Bh).numpy()
    rt.cholsol_vals(a, AxK * 2.0, _B(a.n, 13), 1, sym=s, device="cpu")
    np.testing.assert_array_equal(h(Bh).numpy(), X1)


# ---------------------------------------------------------------------------
# the batched cores against K one-instance calls
# ---------------------------------------------------------------------------


def _close(got, want, tol=1e-12):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= tol * max(1.0, float(want.abs().max()) if want.numel()
                            else 1.0)


def _tree_close(got, want, k):
    if isinstance(got, torch.Tensor):
        _close(got[k], want)
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, k)
    else:
        assert got is None and want is None


@pytest.mark.parametrize("tail", ["none", "dense", "swept"])
def test_batched_chol_core_matches_single(monkeypatch, tail):
    """`_chol_mf_values` of [K, cnnz] against K calls: L, the pivots and
    the whole cache tree; then `_solve_mf_dev` of [K, n, 2]. "dense" and
    "swept" force a dense tail on the innermost skeleton (its leading
    block inverted, or solved by sweeps: the batched W sweep)."""
    if tail != "none":
        monkeypatch.setattr(chol_device, "_choose_cut",
                            lambda level, n: max(n - 24, 0))
        if tail == "swept":
            monkeypatch.setattr(chol_device, "DENSE_NN_MAX", 8)
    a, AxK = _chol_case()
    s = rt.schol(a, 1)
    mfp = solve_torch._chol_mf_plan(a, s)
    perm = solve_torch._chol_oneshot_maps(a, s, "cpu")[0]
    Cx = torch.as_tensor(AxK[:, perm])
    Lx, dmins, tree = fchol._chol_mf_values(Cx, mfp)
    sk = mfp.skel_plan
    assert (sk.tail is not None) == (tail != "none")
    if tail != "none":
        assert (sk.tail.tri is not None) == (tail == "swept")
    X = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (K, a.n, 2)))
    Y = fchol._solve_mf_dev(mfp, X, tree)
    for k in range(K):
        L1, d1, t1 = fchol._chol_mf_values(Cx[k].contiguous(), mfp)
        _close(Lx[k], L1)
        _close(torch.stack(dmins)[:, k], torch.stack(d1))
        _tree_close(tree, t1, k)
        _close(Y[k], fchol._solve_mf_dev(mfp, X[k], t1))


def test_batched_chol_pivots_per_instance():
    """One indefinite instance: its smallest pivot is not positive, the
    others' are, and their factors equal a clean batch's."""
    a, AxK = _chol_case()
    s = rt.schol(a, 1)
    mfp = solve_torch._chol_mf_plan(a, s)
    perm = solve_torch._chol_oneshot_maps(a, s, "cpu")[0]
    bad = AxK.copy()
    bad[2, _diag(a)] = -1.0
    L0, _, _ = fchol._chol_mf_values(torch.as_tensor(AxK[:, perm]), mfp)
    L1, dmins, _ = fchol._chol_mf_values(torch.as_tensor(bad[:, perm]), mfp)
    dmin = torch.stack(dmins).amin(0)
    assert dmin.shape == (K,)
    assert [bool(v > 0) for v in dmin] == [True, True, False, True, True]
    keep = [0, 1, 3, 4]
    _close(L1[keep], L0[keep], 0.0)


@pytest.mark.parametrize("skeleton", ["dense", "levels"])
def test_batched_lu_core_matches_single(monkeypatch, skeleton):
    """`_lu_mf_values` of [K, nnz] against K calls: L, U, margins, bad
    flags, the pivot perms and the cache tree; the host compose per
    instance against `lu_mf`'s; `_solve_lu_mf_dev` with the composed
    [K, ns] inner eliminations. "levels" makes the innermost skeleton a
    level LU (`lu_device`: its batched levels and dense tail)."""
    if skeleton == "levels":
        monkeypatch.setattr(flu, "DENSE_SKEL_MAX", 8)
        monkeypatch.setattr(flu, "MAX_DEPTH", 0)
    a, AxK = _lu_case()
    AxK = AxK.copy()
    AxK[:, _diag(a)] *= 3.0  # static pivots the level LU accepts
    s = rt.sqr(a, 1, False)
    plan = solve_torch._lu_mf_plan(rt.Sprs(a.nnz(), a.n, a.n, a.p,
                                           a.i[: a.nnz()], AxK[0]), s)
    assert isinstance(plan.skel_plan, flu.DenseSkelPlan if skeleton == "dense"
                      else lu_device.LUPlan)
    Ax = torch.as_tensor(AxK[:, plan.vperm])
    Lx, Ux, mg, bd, cache, perms = flu._lu_mf_values(Ax, plan, 1e-6)
    ok, pinK, inners = solve_torch._lu_vals_compose(plan, mg, bd, perms,
                                                    1e-6)
    assert ok.all()
    cacheK, _ = flu._attach_inners(plan, cache,
                                   [torch.as_tensor(v) for v in inners])
    X = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (K, a.n, 2)))
    Y = flu._solve_lu_mf_dev(plan, X, cacheK)
    for k in range(K):
        L1, U1, m1, b1, c1, p1 = flu._lu_mf_values(Ax[k].contiguous(), plan,
                                                   1e-6)
        _close(Lx[k], L1)
        _close(Ux[k], U1)
        _close(torch.stack(mg)[:, k], torch.stack(m1))
        assert torch.equal(torch.stack(bd)[:, k], torch.stack(b1))
        assert all(torch.equal(p[k], q) for p, q in zip(perms, p1))
        elim, c1, _ = flu._finalize_cache(
            plan, c1, torch.cat(p1).numpy(), "cpu")
        einv = np.empty(a.n, np.int64)
        einv[elim] = np.arange(a.n)
        np.testing.assert_array_equal(pinK[k], einv[plan.row_pinv])
        _close(Y[k], flu._solve_lu_mf_dev(plan, X[k], c1))


@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_batched_qr_core_matches_single(branch):
    """`_qr_mf_values` of [K, nnz] against `_qr_mf_factor` per instance:
    R and every bucket's Q; then the least-squares / minimum-norm solve of
    K right-hand sides against the one-instance solve."""
    a, AxK = _qr_case(branch)
    s = _qr_sym(a)
    fa = a if branch == "ls" else rt.transpose(a, device="cpu")
    plan = fqr.build_qr_mf_plan(fa, s)
    from rsparse_tpu_torch.ops.plan import transpose_plan

    Fx = torch.as_tensor(AxK if branch == "ls"
                         else AxK[:, transpose_plan(a).perm])
    qs, Rx = fqr._qr_mf_values(Fx, plan)
    B = _B(a.m, 14)
    solve = fqr.qrsol_mf_ls if branch == "ls" else fqr.qrsol_mf_mn
    got = solve(fa, s, plan, B, (qs, Fx, Rx))
    for k in range(K):
        fqr._qr_mf_factor(Fx[k].contiguous(), plan)
        _close(Rx[k], plan.__dict__["_cache_rx"])
        for Q, Q1 in zip(qs, plan.__dict__["_cache_q"]):
            _close(Q[k], Q1)
        one = solve(fa, s, plan, B[k])
        for g, w in zip(got, one):
            _close(np.asarray(g)[k], np.asarray(w), 1e-10)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_plain_sweep_instances(kind):
    """`sptrsv_plain_multi` with [K, L] values and X [K, n, B] against K
    one-instance calls (the plan with its dense block)."""
    from chip_smoke import make_matrix

    a = make_matrix(16, 0)
    s = rt.sqr(a, 1, False)
    nm = rt.lu(a, s, 1e-6, device="cpu")
    t = nm.l if kind in (0, 2) else nm.u
    plan = rt.tri_plan(t, kind)
    rng = np.random.default_rng(kind)
    x0 = np.asarray(t.x[: t.nnz()])
    tx = torch.as_tensor(x0 * rng.uniform(0.9, 1.1, (K, len(x0))))
    X = torch.as_tensor(rng.standard_normal((K, t.n, 3)))
    got = sptrsv_plain_multi(tx, X, plan, kind)
    for k in range(K):
        _close(got[k], sptrsv_plain_multi(tx[k].contiguous(), X[k], plan,
                                          kind))
    with pytest.raises(ValueError, match="X must be"):
        sptrsv_plain_multi(tx, X[0], plan, kind)


def test_refine_per_instance_matches_single():
    """The batched `_refine` keeps each instance's best iterate and stops
    each on its own: K instances of a weak solver (an inverse off by
    1e-3·k) equal K single refinements."""
    rng = np.random.default_rng(15)
    n = 30
    A = torch.as_tensor(rng.standard_normal((K, n, n)) + 8 * np.eye(n))
    P = torch.linalg.inv(A) * torch.as_tensor(
        1.0 + 1e-3 * np.arange(K))[:, None, None]
    B = torch.as_tensor(rng.standard_normal((K, n, 2)))
    X, rmax = solve_torch._refine(lambda R: P @ R, lambda X: B - A @ X, B, 6)
    assert rmax.shape == (K,)
    for k in range(K):
        x1, r1 = solve_torch._refine(lambda R: P[k] @ R,
                                     lambda X: B[k] - A[k] @ X, B[k], 6)
        _close(X[k], x1, 0.0)
        assert r1 == rmax[k]
