"""Port parity, QR factorization: the torch package's multifrontal QR
planner and factorization (`factor.frontal_qr`) and its level-scheduled
`factor.qr` against the JAX package's on the same matrix under the same
analysis (passed across with `convert`, before the JAX planner commits its
composed ordering to its own analysis).

- `build_qr_mf_plan`: every field equal, `q` and `q_host` included, on
  matrices with and without duplicate entries (last-wins lookups).
- `qr_mf`: R against the JAX package's to 1e-12 relative up to the sign of
  each row, and R'R = A'A.
- `factor.qr` (V, R, beta): against the JAX package's and against the host
  engine (`config.backend = "host"`) to 1e-12, patterns equal; the identity
  reflector (sigma == 0) and a structurally rank-deficient matrix with
  fictitious rows (m2 > m) included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu.factor.frontal_qr as fq_jax  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.factor.frontal_qr as fq_torch  # noqa: E402
import torch_cases as C  # noqa: E402


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "dup"])
def mf(request):
    """Both packages' multifrontal plans and factorizations (smax = 16) of
    one 150 x 100 matrix, with or without duplicate entries."""
    aj, at = C.pair("ls_dup" if request.param else "ls")
    sj = rs.sqr(aj, 2, True)
    st = C.symb(sj)  # before the JAX planner rebinds sj.q
    q0 = np.array(sj.q)
    pj = fq_jax.build_qr_mf_plan(aj, sj, smax=16)
    pt = fq_torch.build_qr_mf_plan(at, st, smax=16)
    rj = fq_jax.qr_mf(aj, sj, pj)
    rt_ = fq_torch.qr_mf(at, st, pt, "cpu")
    return dict(aj=aj, at=at, sj=sj, st=st, q0=q0, pj=pj, pt=pt, rj=rj,
                rt=rt_, dup=request.param)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def test_mf_plan_fields_equal(mf):
    pj, pt = mf["pj"], mf["pt"]
    assert mf["dup"] == (mf["aj"].nnz() > np.count_nonzero(
        mf["aj"].to_dense_np()))
    for f in dataclasses.fields(fq_jax.QRMFPlan):
        if f.name != "levels":
            _eq(getattr(pj, f.name), getattr(pt, f.name), f.name)
    assert [len(lv) for lv in pj.levels] == [len(lv) for lv in pt.levels]
    names = [f.name for f in dataclasses.fields(fq_jax.QRFrontBucket)]
    assert names == [f.name for f in dataclasses.fields(fq_torch.QRFrontBucket)]
    for lj, lt in zip(pj.levels, pt.levels):
        for bj, bt in zip(lj, lt):
            for name in names:
                _eq(getattr(bj, name), getattr(bt, name), name)


def test_mf_plan_commits_the_composed_order(mf):
    st, pt = mf["st"], mf["pt"]
    _eq(st.q, pt.q, "s.q")  # the committed, postorder-composed ordering
    _eq(pt.q_host, mf["q0"], "q_host")  # the analysis' own
    assert not np.array_equal(pt.q, pt.q_host)


def _dense_r(Rp, Ri, Rx, n):
    R = np.zeros((n, n))
    R[Ri, np.repeat(np.arange(n), np.diff(Rp))] = Rx
    return R


def test_mf_r_matches_jax(mf):
    n = mf["at"].n
    Rj = _dense_r(*[np.asarray(v) for v in mf["rj"]], n)
    Rt = _dense_r(*mf["rt"], n)
    sign = np.sign(np.diag(Rt)) * np.sign(np.diag(Rj))
    assert (sign != 0).all()
    assert np.abs(Rt - sign[:, None] * Rj).max() <= 1e-12 * np.abs(Rj).max()
    # diagonal last per column (the usolve convention)
    Rp, Ri, _ = mf["rt"]
    assert (Ri[Rp[1:] - 1] == np.arange(n)).all()


def test_mf_r_is_a_qr_of_a(mf):
    """R'R = A'A for the matrix the fronts assembled (duplicates: the last
    stored entry of each (row, col))."""
    at, st = mf["at"], mf["st"]
    n = at.n
    d = np.zeros((at.m, n))
    cols = np.repeat(np.arange(n), np.diff(at.p))
    d[at.i[: at.nnz()], cols] = at.x[: at.nnz()]  # numpy: the last one wins
    Aq = d[:, np.asarray(st.q)]
    R = _dense_r(*mf["rt"], n)
    scale = np.abs(Aq.T @ Aq).max()
    assert np.abs(R.T @ R - Aq.T @ Aq).max() <= 1e-12 * scale


# ---------------------------------------------------------------------------
# factor.qr: the level-scheduled V, R, beta export
# ---------------------------------------------------------------------------


LEVEL_CASES = {"tall_natural": ("tall40x15", -1),
               "tall_amd": ("tall60x40", 2),
               "identity_reflector": ("upper2x2", -1),
               "fictitious_rows": ("deficient", 2)}


@pytest.fixture(scope="module")
def level_factors():
    """{case: (JAX Nmrc, port Nmrc, host-engine Nmrc, port Symb, A)}."""
    out = {}
    for name, (case, order) in LEVEL_CASES.items():
        d = C.dense(case)
        aj, at = C.pair(case)
        sj = rs.sqr(aj, order, True)
        st, sh = C.symb(sj), C.symb(sj)
        nj = rs.factor.qr(aj, sj)
        nt = rt.qr(at, st, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rt.config, "backend", "host")
            nh = rt.qr(at, sh, device="cpu")
        assert sh._qr_route == "host"
        out[name] = (nj, nt, nh, st, d)
    return out


@pytest.mark.parametrize("name", sorted(LEVEL_CASES))
@pytest.mark.parametrize("against", ["jax", "host"])
def test_level_qr_v_r_beta(level_factors, name, against):
    nj, nt, nh, st, _ = level_factors[name]
    ref = nj if against == "jax" else nh
    assert st._qr_route == "device_level"
    for mr, mt in ((ref.l, nt.l), (ref.u, nt.u)):
        nz = mr.nnz()
        assert mt.nnz() == nz and (mt.m, mt.n) == (mr.m, mr.n)
        _eq(mr.p, mt.p, "p")
        _eq(np.asarray(mr.i)[:nz], mt.i[:nz], "i")
        C.close(mt.x[:nz], np.asarray(mr.x)[:nz])
    C.close(nt.b, np.asarray(ref.b))


def test_level_qr_identity_reflector(level_factors):
    """An upper-triangular column gives sigma == 0 in house() (reference
    src/lib.rs:2138-2146): beta in {0, 2}, and |R| = |qr(A).R|."""
    _, nt, _, _, d = level_factors["identity_reflector"]
    assert nt.b[0] in (0.0, 2.0)
    R = np.zeros((2, 2))
    cols = np.repeat(np.arange(2), np.diff(nt.u.p))
    R[nt.u.i[: nt.u.nnz()], cols] = nt.u.x[: nt.u.nnz()]
    np.testing.assert_allclose(np.abs(R), np.abs(np.linalg.qr(d)[1]),
                               atol=1e-12)


def test_level_qr_fictitious_rows(level_factors):
    _, nt, _, st, d = level_factors["fictitious_rows"]
    assert st.m2 > d.shape[0] and nt.l.m == st.m2


def test_symbolic_counts_and_vcount():
    """The two symbolic wrappers against the JAX package's."""
    aj, at = C.pair("deficient")
    parent = rs.symbolic.etree(aj, True)
    post = rs.symbolic.post(aj.n, parent)
    _eq(rs.symbolic.counts(aj, parent, post, True),
        rt.symbolic.counts(at, parent, post, True), "counts")
    for vj, vt in zip(rs.symbolic.vcount(aj, parent),
                      rt.symbolic.vcount(at, parent)):
        _eq(vj, vt, "vcount")
