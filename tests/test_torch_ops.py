"""Port parity, the L2 operator layer: every op of `rsparse_tpu_torch.ops`
and the `Sprs` operator overloads against the JAX package's op of the same
name, on the CPU, on the same inputs (made in-process from numpy seeds).

Patterns (p, i) must be identical and values agree to 1e-12. The port's
value passes run in torch on the device they are given (the CPU here);
the JAX package's run in XLA on the CPU.
"""

import contextlib
import inspect
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from bench import laplacian_5pt, rand_csc  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402

README_8X8 = [
    [8.2541e-01, 9.5622e-01, 4.6698e-01, 8.4410e-03, 6.3193e-01, 7.5741e-01, 5.3584e-01, 3.9448e-01],
    [7.4808e-01, 2.0403e-01, 9.4649e-01, 2.5086e-01, 2.6931e-01, 5.5866e-01, 3.1827e-01, 2.9819e-02],
    [6.3980e-01, 9.1615e-01, 8.5515e-01, 9.5323e-01, 7.8323e-01, 8.6003e-01, 7.5761e-01, 8.9255e-01],
    [1.8726e-01, 8.9339e-01, 9.9796e-01, 5.0506e-01, 6.1439e-01, 4.3617e-01, 7.3369e-01, 1.5565e-01],
    [2.8015e-02, 6.3404e-01, 8.4771e-01, 8.6419e-01, 2.7555e-01, 3.5909e-01, 7.6644e-01, 8.9905e-02],
    [9.1817e-01, 8.6629e-01, 5.9917e-01, 1.9346e-01, 2.1960e-01, 1.8676e-01, 8.7020e-01, 2.7891e-01],
    [3.1999e-01, 5.9988e-01, 8.7402e-01, 5.5710e-01, 2.4707e-01, 7.5652e-01, 8.3682e-01, 6.3145e-01],
    [9.3807e-01, 7.5985e-02, 7.8758e-01, 3.6881e-01, 4.4553e-01, 5.5005e-02, 3.3908e-01, 3.4573e-01],
]


def _pair_fields(m, n, p, i, x):
    return (rs.Sprs(len(x), m, n, p, i, x), sprs_from_fields(m, n, p, i, x))


def _rand(m, n, nnz, seed):
    return _pair_fields(m, n, *rand_csc(m, n, nnz, seed))


def _dups(m, n, seed):
    """Triplets with repeated (i, j) entries, kept (not summed) in CSC."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, 3 * (m + n))
    c = rng.integers(0, n, 3 * (m + n))
    v = rng.standard_normal(len(r))
    tj, tt = rs.Trpl(), rt.Trpl()
    for a, b, x in zip(r, c, v):
        tj.append(int(a), int(b), float(x))
        tt.append(int(a), int(b), float(x))
    tj.m = tt.m = m
    tj.n = tt.n = n
    return tj.to_sprs(), tt.to_sprs()


def _lap(g):
    n, p, i, x = laplacian_5pt(g)
    return _pair_fields(n, n, p, i, x)


def _readme():
    aj = rs.Sprs.new_from_vec(README_8X8)
    return aj, sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)


def _empty(m, n):
    return rs.Sprs.zeros(m, n, 0), rt.Sprs.zeros(m, n, 0)


MATS = {
    "rect_tall": lambda: _rand(40, 25, 160, 1),
    "rect_wide": lambda: _rand(25, 40, 160, 2),
    "square": lambda: _rand(30, 30, 150, 3),
    "dups": lambda: _dups(20, 20, 4),
    "laplacian": lambda: _lap(5),
    "readme_8x8": _readme,
    "empty": lambda: _empty(6, 6),
}


def _same(sj, st):
    """Identical pattern, values to 1e-12."""
    nz = sj.nnz()
    assert (sj.m, sj.n, sj.nzmax) == (st.m, st.n, st.nzmax)
    np.testing.assert_array_equal(sj.p[: sj.n + 1], st.p[: st.n + 1])
    np.testing.assert_array_equal(sj.i[:nz], st.i[:nz])
    xj, xt = np.asarray(sj.x)[:nz], np.asarray(st.x)[:nz]
    assert xj.shape == xt.shape
    assert np.abs(xj - xt).max(initial=0.0) <= 1e-12 * max(1.0, np.abs(xj).max(initial=0.0))


def _partner(name):
    """A second operand of the same shape, with another pattern."""
    aj, _ = MATS[name]()
    if aj.nnz() == 0:
        return _empty(aj.m, aj.n)
    return _rand(aj.m, aj.n, 2 * aj.nnz(), 99)


@pytest.mark.parametrize("name", sorted(MATS))
def test_add(name):
    (aj, at), (bj, bt) = MATS[name](), _partner(name)
    _same(rs.add(aj, bj, 2.0, -0.5), rt.add(at, bt, 2.0, -0.5, device="cpu"))
    _same(rs.add(aj, aj), rt.add(at, at, device="cpu"))


@pytest.mark.parametrize("name", sorted(MATS))
def test_multiply_and_transpose(name):
    aj, at = MATS[name]()
    _same(rs.transpose(aj), rt.transpose(at, device="cpu"))
    bj, bt = rs.transpose(aj), rt.transpose(at, device="cpu")
    _same(rs.multiply(aj, bj), rt.multiply(at, bt, device="cpu"))
    _same(rs.multiply(bj, aj), rt.multiply(bt, at, device="cpu"))


@pytest.mark.parametrize("name", sorted(MATS))
def test_gaxpy_norm_scalar_ops(name):
    aj, at = MATS[name]()
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal(aj.n), rng.standard_normal(aj.m)
    rj, rt_ = rs.gaxpy(aj, x, y), rt.gaxpy(at, x, y, device="cpu")
    assert isinstance(rt_, list) and len(rt_) == len(rj)
    assert np.abs(np.asarray(rj) - np.asarray(rt_)).max(initial=0.0) <= 1e-12
    assert abs(rs.norm(aj) - rt.norm(at, device="cpu")) <= 1e-12
    _same(rs.scpmat(1.5, aj), rt.scpmat(1.5, at, device="cpu"))
    _same(rs.scxmat(-2.5, aj), rt.scxmat(-2.5, at, device="cpu"))


@pytest.mark.parametrize("name", ["square", "dups", "laplacian", "readme_8x8"])
def test_permute_symperm_fkeep_print(name):
    aj, at = MATS[name]()
    rng = np.random.default_rng(8)
    pinv, q = rng.permutation(aj.m), rng.permutation(aj.n)
    _same(rs.permute(aj, pinv, q), rt.permute(at, pinv, q, device="cpu"))
    _same(rs.permute(aj, None, None), rt.permute(at, None, None, device="cpu"))
    _same(rs.symperm(aj, pinv), rt.symperm(at, pinv, device="cpu"))
    keep = lambda i, j, x: x > 0.0 and i != j
    assert rs.fkeep(aj, keep) == rt.fkeep(at, keep)
    _same(aj, at)
    outs = []
    for mod, a, kw in ((rs, aj, {}), (rt, at, {"device": "cpu"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.sprs_print(a, True, **kw)
        outs.append(buf.getvalue().splitlines())
    # the 1-norm is a float sum, which may differ in its last digit
    head = [o[0].split("1-norm:") for o in outs]
    assert head[0][0] == head[1][0]
    assert abs(float(head[0][1]) - float(head[1][1])) <= 1e-12
    assert outs[0][1:] == outs[1][1:]


def test_ops_doctests():
    """The docstring examples of the port's ops (on the CPU)."""
    import doctest

    res = doctest.testmod(rt.ops, verbose=False)
    assert res.attempted > 0 and res.failed == 0


def test_ipvec_pvec_pinvert():
    rng = np.random.default_rng(9)
    p = rng.permutation(7)
    b = rng.standard_normal(7)
    np.testing.assert_array_equal(rs.pinvert(p, 7), rt.pinvert(p, 7))
    for fn in ("ipvec", "pvec"):
        xj, xt = np.zeros(7), np.zeros(7)
        getattr(rs, fn)(7, p, b, xj)
        getattr(rt, fn)(7, p, b, xt)
        np.testing.assert_array_equal(xj, xt)


def test_dimension_mismatch_raises_in_both():
    (aj, at), (bj, bt) = _rand(5, 4, 10, 1), _rand(5, 3, 8, 2)
    for mod, a, b, kw in ((rs, aj, bj, {}), (rt, at, bt, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.add(a, b, **kw)
        with pytest.raises(ValueError):
            mod.multiply(a, b, **kw)


@pytest.mark.parametrize("name", sorted(MATS))
def test_backend_host_matches_device(name, monkeypatch):
    """config.backend = "host" (numpy) and "device" (torch) agree."""
    aj, at = MATS[name]()
    bj, bt = _partner(name)
    x = np.random.default_rng(10).standard_normal(at.n)
    ops = [lambda **k: rt.add(at, bt, 1.0, 2.0, **k),
           lambda **k: rt.multiply(at, rt.transpose(bt, **k), **k),
           lambda **k: rt.transpose(at, **k),
           lambda **k: rt.scpmat(3.0, at, **k),
           lambda **k: rt.scxmat(3.0, at, **k),
           lambda **k: rt.symperm(at, None, **k) if at.m == at.n else at]
    got = {}
    for backend in ("device", "host"):
        monkeypatch.setattr(rt.config, "backend", backend)
        got[backend] = ([op(device="cpu") for op in ops],
                        rt.gaxpy(at, x, np.zeros(at.m), device="cpu"),
                        rt.norm(at, device="cpu"))
    for sd, sh in zip(got["device"][0], got["host"][0]):
        _same(sh, sd)
    assert np.abs(np.asarray(got["device"][1]) - np.asarray(got["host"][1])).max(initial=0.0) <= 1e-12
    assert abs(got["device"][2] - got["host"][2]) <= 1e-12


@pytest.fixture
def ops_on_cpu(monkeypatch):
    """The overloads call the ops with their default device (the card);
    send those defaults to the CPU for this test."""
    for fn in (rt.ops.add, rt.ops.multiply, rt.ops.scpmat, rt.ops.scxmat):
        monkeypatch.setitem(fn.__kwdefaults__, "device", "cpu")


@pytest.mark.parametrize("name", ["rect_tall", "square", "dups", "readme_8x8", "empty"])
def test_operator_overloads(name, ops_on_cpu):
    (aj, at), (bj, bt) = MATS[name](), _partner(name)
    _same(aj + bj, at + bt)
    _same(aj - bj, at - bt)
    _same(aj + 2, at + 2)
    _same(2.5 + aj, 2.5 + at)
    _same(aj - 1, at - 1)
    _same(1 - aj, 1 - at)
    _same(aj * 3, at * 3)
    _same(3 * aj, 3 * at)
    _same(aj / 4, at / 4)
    _same(-aj, -at)
    _same(aj * rs.transpose(aj), at * rt.transpose(at, device="cpu"))
    assert at.__add__("x") is NotImplemented and at.__mul__(None) is NotImplemented


def _device_entry_points():
    """Every public function of the port that takes a `device` argument."""
    import rsparse_tpu_torch.ops.spmm_cuda as spmm_mod
    import rsparse_tpu_torch.ops.spmv as spmv_mod

    found = {}
    for mod in (rt, rt.ops, rt.solve, rt.factor, spmm_mod, spmv_mod):
        for name in getattr(mod, "__all__", []):
            fn = getattr(mod, name)
            if inspect.isfunction(fn) and "device" in inspect.signature(fn).parameters:
                found[f"{fn.__module__}.{name}"] = fn
    found["rsparse_tpu_torch.solve._tri_solve_multi"] = rt.solve._tri_solve_multi
    found["rsparse_tpu_torch.solve._tri_solve"] = rt.solve._tri_solve
    return found


_ENTRY = _device_entry_points()


@pytest.mark.parametrize("name", sorted(_ENTRY))
def test_default_device_is_the_card(name):
    """Each entry point runs on the card unless the caller asks for another
    device. The batched solves' None means X's device for a tensor X, and
    the card otherwise."""
    default = inspect.signature(_ENTRY[name]).parameters["device"].default
    if default is None:
        assert name.endswith("solve_multi")
        assert rt.solve._sweep_device(np.zeros((2, 1)), None) == torch.device("cuda")
        assert rt.solve._sweep_device(torch.zeros((2, 1)), None) == torch.device("cpu")
    else:
        assert torch.device(default) == torch.device("cuda")


def test_default_device_covers_the_slice():
    names = {k.rsplit(".", 1)[1] for k in _ENTRY}
    assert names >= {"lusol_serve", "lu", "lsolve_multi", "ltsolve_multi",
                     "usolve_multi", "utsolve_multi", "_tri_solve_multi",
                     "add", "multiply", "transpose", "gaxpy", "gaxpy_multi",
                     "norm", "scpmat", "scxmat", "permute", "symperm",
                     "sprs_print", "spmm", "spmv", "spgemm_dia",
                     "lusol", "cholsol", "cholsol_serve", "chol", "lsolve",
                     "ltsolve", "usolve", "utsolve", "_tri_solve", "qr",
                     "qrsol", "qrsol_ls", "cholsol_multi", "lusol_multi",
                     "qrsol_multi", "qrsol_serve", "cholsol_ir",
                     "cholsol_vals", "lusol_vals", "qrsol_vals"}
