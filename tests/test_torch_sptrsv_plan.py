"""The port's SpTRSV schedule on the CPU: `tri_plan`'s dense split (the
multifrontal LU's dense skeleton as one super-level), the plain version
that follows it (`sptrsv_plain_split_multi`), and the kernel's streams
replayed in numpy, against the whole level schedule and the JAX package.

The factors: the port's LU of chip_smoke.make_matrix(24) with
`config.mf_min_n` lowered so that the route is the device multifrontal one
(a dense skeleton of 109 columns); the host engine's LU of a 12 x 12
Laplacian (no dense block); chip_smoke.synthetic_triangle(400, 70) (a
dense block with entries into outside rows, no LU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu.ops.sptrsv_pallas import sptrsv_pallas_multi  # noqa: E402
from rsparse_tpu.solve import _tri_solve_multi as tri_solve_jax  # noqa: E402
from rsparse_tpu.solve import tri_plan as tri_plan_jax  # noqa: E402

import chip_smoke  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.factor.frontal_lu import DenseSkelPlan  # noqa: E402
from rsparse_tpu_torch.ops import sptrsv_cuda as sc  # noqa: E402

KINDS = [0, 1, 2, 3]
LEVEL_FIELDS = ("ent_pos", "ent_row", "ent_col", "ent_slot", "ent_off",
                "col_id", "col_diag", "col_off")


@pytest.fixture(scope="module")
def mf():
    """(L, U, dense skeleton size) of the port's multifrontal LU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rt.config, "mf_min_n", 100)
        a = chip_smoke.make_matrix(24, 0)
        s = rt.sqr(a, 1, False)
        nm = rt.lu(a, s, 1e-6, device="cpu")
    assert s._lu_route == "device_mf"
    skel = s._mf_lu_plan.skel_plan
    assert isinstance(skel, DenseSkelPlan)
    host = lambda t: sprs_from_fields(t.n, t.n, t.p, t.i, t.x)
    return host(nm.l), host(nm.u), skel.ns


def _host_factor(kind):
    """The host engine's LU of a 12 x 12 Laplacian: L or U."""
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(12)
    a = rs.Sprs(len(x), n, n, p, i, x)
    s = rs.sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, _ = rs.symbolic.native.lu_numeric(
        n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q, 1e-6, s.lnz, s.unz)
    return sprs_from_fields(n, n, *((Lp, Li, Lx) if kind in (0, 2)
                                    else (Up, Ui, Ux)))


def _tri(mf, kind):
    return mf[0] if kind in (0, 2) else mf[1]


def _jax(t):
    return rs.Sprs(t.nnz(), t.m, t.n, t.p, t.i, np.asarray(t.x))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_plan_finds_the_dense_skeleton(mf, kind):
    """D is the whole skeleton: last for kinds 0/3, first for kinds 1/2;
    every column and every off-diagonal entry appears once in the new
    schedule, and the sparse levels are fewer."""
    t = _tri(mf, kind)
    plan = rt.tri_plan(t, kind)
    d = plan.dense
    assert d is not None and d.k == mf[2]
    assert d.first == (kind in (1, 2))
    cols = np.concatenate([d.cols, d.rest.col_id])
    np.testing.assert_array_equal(np.sort(cols), np.arange(t.n))
    pos = np.concatenate([d.tri_pos, d.out_pos, d.rest.ent_pos])
    np.testing.assert_array_equal(np.sort(pos), np.sort(plan.ent_pos))
    assert len(d.tri_pos) == d.k * (d.k - 1) // 2
    assert np.all(d.tri_dst > d.tri_src)
    # outside entries only where the block's closure allows them
    assert (len(d.out_pos) > 0) == (kind in (1, 3))
    assert d.rest.nlev < plan.nlev


@pytest.mark.parametrize("kind", KINDS)
def test_level_fields_match_jax_with_a_block(mf, kind):
    """The whole level schedule stays the JAX package's."""
    t = _tri(mf, kind)
    tt, tj = rt.tri_plan(t, kind), tri_plan_jax(_jax(t), kind)
    for f in ("n", "nlev", "emax", "wmax"):
        assert getattr(tj, f) == getattr(tt, f), f
    for f in LEVEL_FIELDS:
        np.testing.assert_array_equal(getattr(tj, f), getattr(tt, f), f)


@pytest.mark.parametrize("kind", KINDS)
def test_no_dense_block_keeps_todays_schedule(kind):
    t = _host_factor(kind)
    tt, tj = rt.tri_plan(t, kind), tri_plan_jax(_jax(t), kind)
    assert tt.dense is None
    for f in LEVEL_FIELDS:
        np.testing.assert_array_equal(getattr(tj, f), getattr(tt, f), f)


@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_f64_matches_level_loop_and_jax(mf, kind):
    """f64, reordered sums only: 1e-12 relative."""
    t = _tri(mf, kind)
    plan = rt.tri_plan(t, kind)
    X = np.random.default_rng(20 + kind).standard_normal((t.n, 6))
    tx = torch.as_tensor(t.x[: t.nnz()])
    got = sc.sptrsv_plain_split_multi(tx, torch.as_tensor(X), plan, kind)
    assert got.dtype == torch.float64
    ref = sc.sptrsv_plain_multi(tx, torch.as_tensor(X), plan, kind)
    assert _rel(got.numpy(), ref.numpy()) < 1e-12
    want = np.asarray(tri_solve_jax(_jax(t), X, kind))
    assert _rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_f32_matches_pallas(mf, kind):
    """f32 against the Pallas kernel in interpret mode, with another
    accumulation order (the TPU test's tolerance)."""
    t = _tri(mf, kind)
    X = np.random.default_rng(30 + kind).standard_normal((t.n, 4))
    ref = np.asarray(sptrsv_pallas_multi(
        t.x[: t.nnz()], X, tri_plan_jax(_jax(t), kind), kind), np.float64)
    got = sc.sptrsv_plain_split_multi(
        torch.as_tensor(t.x[: t.nnz()], dtype=torch.float32),
        torch.as_tensor(X, dtype=torch.float32), rt.tri_plan(t, kind), kind)
    assert got.dtype == torch.float32
    assert _rel(got.double().numpy(), ref) < 5e-5


@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_on_a_synthetic_block(kind):
    """A block last in L (first in U) with outside entries, against a dense
    solve."""
    L, U = chip_smoke.synthetic_triangle(400, 70, kind)
    t = L if kind in (0, 2) else U
    plan = rt.tri_plan(t, kind)
    assert plan.dense is not None and plan.dense.k == 70
    D = t.to_dense_np()
    X = np.random.default_rng(kind).standard_normal((t.n, 3))
    got = sc.sptrsv_plain_split_multi(torch.as_tensor(t.x[: t.nnz()]),
                                      torch.as_tensor(X), plan, kind)
    want = np.linalg.solve(D if kind in (0, 1) else D.T, X)
    assert _rel(got.numpy(), want) < 1e-12


def _replay_kernel(tx, X, plan, kind):
    """csrc/sptrsv.cu's algorithm, in numpy, from the kernel's own streams
    (`_kernel_streams`): the dense super-level in panels (look-ahead on the
    next panel, staged diagonal blocks), and the sparse phases with
    pre-divided values, the block's outside entries among them."""
    ks = sc._kernel_streams(plan, kind, torch.device("cpu"))
    N = lambda k: ks[k].numpy()
    scatter = kind in (0, 1)
    x = X.copy()

    def dense():
        k, kp = ks["k"], ks["kpad"]
        pan = np.zeros(ks["pan_total"])
        pan[N("pan_slot")] = tx[N("tri_pos")]
        dd = tx[N("ddiag")]
        rd = np.ones(kp)
        rd[:k] = 1.0 / dd
        xd = np.zeros((kp, x.shape[1]))
        xd[:k] = x[N("dcol")]

        def diag(P, R, i0, xb):
            blk = pan[P: P + 32 * R].reshape(32, R)[:, :32]  # [j, r]
            xb = xb.copy()
            for j in range(32):
                xb[j] *= rd[i0 + j]
                xb[j + 1:] -= blk[j, j + 1:, None] * xb[j][None, :]
            return xb

        xd[:32] = diag(0, kp, 0, xd[:32])
        P = 0
        for p0 in range(0, kp - 32, 32):
            R = kp - p0
            M = pan[P: P + 32 * R].reshape(32, R)
            xd[p0 + 32:p0 + 64] = diag(P + 32 * R, R - 32, p0 + 32,
                                       xd[p0 + 32:p0 + 64]
                                       - M[:, 32:64].T @ xd[p0:p0 + 32])
            xd[p0 + 64:p0 + R] -= M[:, 64:R].T @ xd[p0:p0 + 32]
            P += 32 * R
        x[N("dcol")] = xd[:k]

    def levels():
        lvl, cid = N("lvl"), N("cid")
        src, dst = N("esrc"), N("edst")
        if ks["epk"] is not None:
            pk = N("epk").view(np.uint32)
            assert len(pk) == len(src)
            np.testing.assert_array_equal(pk & 0xFFFF, src)
            np.testing.assert_array_equal(pk >> 16, dst)
        ev = tx[N("epos")] / tx[N("ediag")]
        r0, r1 = ks["raw"]
        ev[r0:r1] = tx[N("epos")[r0:r1]]  # the block's outside entries
        assert (r1 > r0) == (ks["k"] > 0 and len(plan.dense.out_pos) > 0)
        dv = tx[N("cdiag")]
        nlev = ks["nlev"]
        at = lambda i: lvl[min(max(i, 0), nlev)] if i >= 0 else (0, 0)
        for p in range(nlev + 1):
            lo, mid, hi = at(p - 1), at(p), at(p + 1)
            e = slice(mid[1], hi[1]) if scatter else slice(lo[1], mid[1])
            c = slice(lo[0], mid[0]) if scatter else slice(mid[0], hi[0])
            assert not set(cid[c]) & set(dst[e])
            upd = np.zeros_like(x)
            np.add.at(upd, dst[e], -ev[e, None] * x[src[e]])
            x[:] += upd
            x[cid[c]] /= dv[c, None]

    if ks["k"] and ks["first"]:
        dense()
    levels()
    if ks["k"] and not ks["first"]:
        dense()
    return x


@pytest.mark.parametrize("case", ["mf", "synthetic", "host"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_streams_replayed(mf, kind, case):
    """The kernel's streams, replayed in numpy, solve the system (f64)."""
    if case == "mf":
        t = _tri(mf, kind)
    elif case == "synthetic":
        L, U = chip_smoke.synthetic_triangle(400, 70, 1)
        t = L if kind in (0, 2) else U
    else:
        t = _host_factor(kind)
    plan = rt.tri_plan(t, kind)
    tx = np.asarray(t.x[: t.nnz()], np.float64)
    X = np.random.default_rng(kind).standard_normal((t.n, 3))
    ref = sc.sptrsv_plain_multi(torch.as_tensor(tx), torch.as_tensor(X),
                                plan, kind).numpy()
    assert _rel(_replay_kernel(tx, X, plan, kind), ref) < 1e-12


def test_remap_positions_maps_the_split(mf):
    plan = rt.tri_plan(mf[1], 1)
    pos = np.arange(mf[1].nnz(), dtype=np.int64) + 7
    moved = plan.remap_positions(pos)
    d, m = plan.dense, moved.dense
    for a, b in ((plan.ent_pos, moved.ent_pos), (plan.col_diag, moved.col_diag),
                 (d.diag, m.diag), (d.tri_pos, m.tri_pos),
                 (d.out_pos, m.out_pos), (d.rest.ent_pos, m.rest.ent_pos),
                 (d.rest.col_diag, m.rest.col_diag)):
        np.testing.assert_array_equal(a + 7, b)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_solves_do_not_split(mf, kind):
    """The split is found at the first read of `dense`: the level loop of a
    CPU solve never pays for it, and the solve returns a contiguous
    [n, B]."""
    t = _tri(mf, kind)
    plan = rt.tri_plan(t, kind)
    X = np.random.default_rng(40 + kind).standard_normal((t.n, 3))
    solve = (rt.lsolve_multi, rt.usolve_multi, rt.ltsolve_multi,
             rt.utsolve_multi)[kind]
    got = solve(t, X, plan, device="cpu")
    assert got.shape == (t.n, 3) and got.is_contiguous()
    assert "dense" not in plan.__dict__
    assert plan.dense is not None and "dense" in plan.__dict__
