"""Port parity, the factorizations' value contract: `chol`, `lu` and `qr`
return `Nmrc` whose factor values are writable float64 numpy arrays (the
reference's contract), so every `Sprs` method and op takes them. Each
method is run on the port's factors and on the JAX package's factors of the
same matrix under the same analysis, and the two results are held to each
other (1e-12 relative on values).

The device copy the solves read (`factor.device_values`) is checked here on
the CPU; the card's case is in `test_torch_kernel.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields, symb_from_fields  # noqa: E402
from rsparse_tpu_torch.factor import device_values  # noqa: E402


def _laplacian(g):
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    return rs.Sprs(len(x), n, n, p, i, x)


def _unsym(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0)
    return rs.Sprs.new_from_vec(d.tolist())


def _tall(m, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.15)
    d[np.arange(n), np.arange(n)] += 3.0
    return rs.Sprs.new_from_vec(d.tolist())


@pytest.fixture(scope="module")
def factors():
    """{kind: (JAX Nmrc, port Nmrc)} for chol, lu and qr (level routes)."""
    out = {}
    aj = _laplacian(6)
    sj = rs.schol(aj, 0)
    st = symb_from_fields(pinv=sj.pinv, parent=sj.parent, cp=sj.cp,
                          lnz=sj.lnz, unz=sj.unz)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    out["chol"] = (rs.chol(aj, sj), rt.chol(at, st, device="cpu"))
    aj = _unsym(30, 1)
    sj = rs.sqr(aj, 1, False)
    st = symb_from_fields(q=sj.q, lnz=sj.lnz, unz=sj.unz)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    out["lu"] = (rs.lu(aj, sj, 1e-6), rt.lu(at, st, 1e-6, device="cpu"))
    aj = _tall(40, 15, 2)
    sj = rs.sqr(aj, 2, True)
    st = symb_from_fields(q=sj.q, pinv=sj.pinv, parent=sj.parent, cp=sj.cp,
                          lnz=sj.lnz, unz=sj.unz, m2=sj.m2)
    at = sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)
    out["qr"] = (rs.factor.qr(aj, sj), rt.qr(at, st, device="cpu"))
    return out


def _mats(nj, nt):
    """(JAX, port) Sprs pairs of one factorization: L (or V) and U (or R)."""
    pairs = [(nj.l, nt.l)]
    if nt.u is not None:
        pairs.append((nj.u, nt.u))
    return pairs


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max())


def _same(mj, mt):
    nz = mj.nnz()
    assert mt.nnz() == nz and (mt.m, mt.n) == (mj.m, mj.n)
    np.testing.assert_array_equal(mj.p, mt.p)
    np.testing.assert_array_equal(np.asarray(mj.i)[:nz], mt.i[:nz])
    _close(np.asarray(mj.x)[:nz], mt.x[:nz])


KINDS = ["chol", "lu", "qr"]


@pytest.mark.parametrize("kind", KINDS)
def test_values_are_writable_float64(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        assert isinstance(mt.x, np.ndarray) and mt.x.dtype == np.float64
        assert mt.x.flags.writeable
        _same(mj, mt)
    if kind == "qr":
        assert isinstance(nt.b, np.ndarray)
        _close(np.asarray(nj.b), nt.b)


@pytest.mark.parametrize("kind", KINDS)
def test_copy(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        cj, ct = mj.copy(), mt.copy()
        _same(cj, ct)
        ct.x[0] += 1.0  # a copy: the factor keeps its values
        assert ct.x[0] != mt.x[0]


@pytest.mark.parametrize("kind", KINDS)
def test_to_dense(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        _close(mj.to_dense(), mt.to_dense())


@pytest.mark.parametrize("kind", KINDS)
def test_eq(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        assert (mj == mj.copy()) and (mt == mt.copy())
        other = mt.copy()
        other.x[0] *= 2.0
        assert not (mt == other)


@pytest.mark.parametrize("kind", KINDS)
def test_trim(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        cj, ct = mj.copy(), mt.copy()
        cj.x = np.asarray(cj.x, np.float64).copy()
        for c in (cj, ct):
            c.x[np.abs(c.x) < 0.1] = 0.0  # stored zeros to remove
        cj.trim()
        ct.trim()
        _same(cj, ct)


@pytest.mark.parametrize("kind", KINDS)
def test_save_load(factors, kind, tmp_path):
    nj, nt = factors[kind]
    for k, (mj, mt) in enumerate(_mats(nj, nt)):
        pj, pt = tmp_path / f"j{k}.sprs", tmp_path / f"t{k}.sprs"
        mj.save(str(pj))
        mt.save(str(pt))
        _same(rs.Sprs.new_from_file(str(pj)), rt.Sprs.new_from_file(str(pt)))


@pytest.mark.parametrize("kind", KINDS)
def test_gaxpy(factors, kind):
    nj, nt = factors[kind]
    rng = np.random.default_rng(3)
    for mj, mt in _mats(nj, nt):
        x, y = rng.standard_normal(mt.n), rng.standard_normal(mt.m)
        got = rt.gaxpy(mt, list(x), list(y), device="cpu")
        _close(rs.gaxpy(mj, list(x), list(y)), got)


@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_device_values_follow_the_array(factors, kind):
    """The solves' device copy is the factor's own values, and an array
    swapped into the factor is what the next read returns."""
    _, nt = factors[kind]
    t = nt.l
    got = device_values(nt, "l", "cpu")
    np.testing.assert_array_equal(got.numpy(), t.x[: t.nnz()])
    old = t.x
    try:
        t.x = old * 2.0
        np.testing.assert_array_equal(device_values(nt, "l", "cpu").numpy(),
                                      t.x[: t.nnz()])
    finally:
        t.x = old
