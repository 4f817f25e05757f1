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
from rsparse_tpu_torch.convert import sprs_from_fields, symb_from_fields  # noqa: E402


def sparse_ls(m, n, extra, seed=0, dup=False):
    """An m x n sparse matrix with a dominant diagonal (the JAX package's
    `_sparse_ls`, tests/test_frontal_qr.py), as CSC arrays; with `dup`
    every 7th entry is stored twice (the first copy a different value)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    d[np.arange(n), np.arange(n)] = 5.0 + rng.random(n)
    for _ in range(extra):
        i, j = rng.integers(0, m), rng.integers(0, n)
        d[i, j] += rng.standard_normal()
    r, c = np.nonzero(d.T)  # column-major: (col, row)
    rows, cols, vals = c, r, d[c, r]
    if dup:
        k = np.arange(0, len(rows), 7)
        rows = np.insert(rows, k, rows[k])
        cols = np.insert(cols, k, cols[k])
        vals = np.insert(vals, k, vals[k] + 0.5)
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=p[1:])
    return p, rows.astype(np.int64), vals, d


def both(m, n, p, i, x):
    """(JAX Sprs, port Sprs) of one CSC matrix."""
    return (rs.Sprs(len(x), m, n, p, i, x),
            sprs_from_fields(m, n, p, i, x))


def port_symb(sj):
    return symb_from_fields(q=sj.q, pinv=sj.pinv, parent=sj.parent, cp=sj.cp,
                            lnz=sj.lnz, unz=sj.unz, m2=sj.m2)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "dup"])
def mf(request):
    """Both packages' multifrontal plans and factorizations (smax = 16) of
    one 300 x 200 matrix, with or without duplicate entries."""
    p, i, x, _ = sparse_ls(300, 200, 900, dup=request.param)
    aj, at = both(300, 200, p, i, x)
    sj = rs.sqr(aj, 2, True)
    st = port_symb(sj)  # before the JAX planner rebinds sj.q
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


def _tall(m, n, seed, density):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    d[np.arange(n), np.arange(n)] += 3.0
    return d


def _deficient():
    """Columns 3 and 4 share their only row: vcount adds fictitious rows."""
    d = _tall(30, 20, 0, 0.1)
    d[:, 3:5] = 0.0
    d[5, 3], d[5, 4] = 1.0, 2.0
    return d


LEVEL_CASES = {
    "tall_natural": (lambda: _tall(40, 15, 1, 0.35), -1),
    "tall_amd": (lambda: _tall(60, 40, 2, 0.08), 2),
    "identity_reflector": (lambda: np.array([[2.0, 1.0], [0.0, 3.0]]), -1),
    "fictitious_rows": (_deficient, 2),
}


@pytest.fixture(scope="module")
def level_factors():
    """{case: (JAX Nmrc, port Nmrc, host-engine Nmrc, port Symb, A)}."""
    out = {}
    for name, (make, order) in LEVEL_CASES.items():
        d = make()
        aj = rs.Sprs.new_from_vec(d.tolist())
        at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
        sj = rs.sqr(aj, order, True)
        st, sh = port_symb(sj), port_symb(sj)
        nj = rs.factor.qr(aj, sj)
        nt = rt.qr(at, st, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rt.config, "backend", "host")
            nh = rt.qr(at, sh, device="cpu")
        assert sh._qr_route == "host"
        out[name] = (nj, nt, nh, st, d)
    return out


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max(initial=0.0) <= 1e-12 * max(
        1.0, np.abs(a).max(initial=0.0))


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
        _close(np.asarray(mr.x)[:nz], mt.x[:nz])
    _close(np.asarray(ref.b), nt.b)


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
    d = _deficient()
    aj = rs.Sprs.new_from_vec(d.tolist())
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    parent = rs.symbolic.etree(aj, True)
    post = rs.symbolic.post(aj.n, parent)
    _eq(rs.symbolic.counts(aj, parent, post, True),
        rt.symbolic.counts(at, parent, post, True), "counts")
    for vj, vt in zip(rs.symbolic.vcount(aj, parent),
                      rt.symbolic.vcount(at, parent)):
        _eq(vj, vt, "vcount")
