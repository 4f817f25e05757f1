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
from rsparse_tpu_torch.factor import device_values  # noqa: E402
import torch_cases as C  # noqa: E402


@pytest.fixture(scope="module")
def factors():
    """{kind: (JAX Nmrc, port Nmrc)} for chol, lu and qr (level routes)."""
    out = {}
    aj, at = C.pair("lap8")
    sj = rs.schol(aj, 0)
    st = C.symb(sj)
    out["chol"] = (rs.chol(aj, sj), rt.chol(at, st, device="cpu"))
    aj, at = C.pair("rand50")
    sj = rs.sqr(aj, 1, False)
    st = C.symb(sj)
    out["lu"] = (rs.lu(aj, sj, 1e-6), rt.lu(at, st, 1e-6, device="cpu"))
    aj, at = C.pair("tall60x40")
    sj = rs.sqr(aj, 2, True)
    st = C.symb(sj)
    out["qr"] = (rs.factor.qr(aj, sj), rt.qr(at, st, device="cpu"))
    return out


def _mats(nj, nt):
    """(JAX, port) Sprs pairs of one factorization: L (or V) and U (or R)."""
    pairs = [(nj.l, nt.l)]
    if nt.u is not None:
        pairs.append((nj.u, nt.u))
    return pairs


KINDS = ["chol", "lu", "qr"]


@pytest.mark.parametrize("kind", KINDS)
def test_values_are_writable_float64(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        assert isinstance(mt.x, np.ndarray) and mt.x.dtype == np.float64
        assert mt.x.flags.writeable
        C.same_sprs(mt, mj)
    if kind == "qr":
        assert isinstance(nt.b, np.ndarray)
        C.close(nt.b, np.asarray(nj.b))


@pytest.mark.parametrize("kind", KINDS)
def test_copy(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        cj, ct = mj.copy(), mt.copy()
        C.same_sprs(ct, cj)
        ct.x[0] += 1.0  # a copy: the factor keeps its values
        assert ct.x[0] != mt.x[0]


@pytest.mark.parametrize("kind", KINDS)
def test_to_dense(factors, kind):
    nj, nt = factors[kind]
    for mj, mt in _mats(nj, nt):
        C.close(mt.to_dense(), mj.to_dense())


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
        C.same_sprs(ct, cj)


@pytest.mark.parametrize("kind", KINDS)
def test_save_load(factors, kind, tmp_path):
    nj, nt = factors[kind]
    for k, (mj, mt) in enumerate(_mats(nj, nt)):
        pj, pt = tmp_path / f"j{k}.sprs", tmp_path / f"t{k}.sprs"
        mj.save(str(pj))
        mt.save(str(pt))
        C.same_sprs(rt.Sprs.new_from_file(str(pt)),
                    rs.Sprs.new_from_file(str(pj)))


@pytest.mark.parametrize("kind", KINDS)
def test_gaxpy(factors, kind):
    nj, nt = factors[kind]
    rng = np.random.default_rng(3)
    for mj, mt in _mats(nj, nt):
        x, y = rng.standard_normal(mt.n), rng.standard_normal(mt.m)
        got = rt.gaxpy(mt, list(x), list(y), device="cpu")
        C.close(got, rs.gaxpy(mj, list(x), list(y)))


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
