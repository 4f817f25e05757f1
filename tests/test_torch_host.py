"""Port parity, host layer: the torch package's symbolic analysis and
triangular-solve plans equal the JAX package's exactly on the same input.

Both packages share the C++ engine's source; the port compiles its own copy
into its build directory. Inputs are made in-process from numpy seeds.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields, symb_from_fields  # noqa: E402


def _unsym(g, seed):
    """Nonsymmetric diagonally dominant matrix on the g x g 5-point pattern."""
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(g)
    rng = np.random.default_rng(seed)
    x = -(1.0 + 0.3 * rng.standard_normal(len(x)))
    cols = np.repeat(np.arange(n), np.diff(p))
    d = np.zeros((n, n))
    d[i, cols] = x
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, np.maximum(np.abs(d).sum(0), np.abs(d).sum(1)) + 1.0)
    return d


def _pair(d):
    aj = rs.Sprs.new_from_vec(d)
    return aj, sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)


def test_port_imports_no_jax():
    """The port's modules never import jax or the JAX package (checked in
    a fresh interpreter: this test process has both loaded)."""
    import subprocess

    code = ("import sys, rsparse_tpu_torch, rsparse_tpu_torch.factor.frontal_lu,"
            " rsparse_tpu_torch.ops.spmv, rsparse_tpu_torch.ops.spmm_cuda;"
            "assert 'jax' not in sys.modules, 'jax';"
            "assert 'rsparse_tpu' not in sys.modules, 'rsparse_tpu'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.check_call([sys.executable, "-c", code], cwd=root)


def _code_strings(path):
    """The string literals of a module, its docstrings left out."""
    import ast

    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_engine_source_is_the_ports_own_copy():
    """The C++ engine builds from the port's own copy of its source, byte
    for byte the JAX package's engine it was taken from, and no module of
    the port names a path under the JAX package's directory."""
    from rsparse_tpu_torch.symbolic import native

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "rsparse_tpu_torch")
    src = os.path.realpath(native._SRC)
    assert src.startswith(os.path.realpath(pkg) + os.sep)
    with open(src, "rb") as f, open(os.path.join(
            root, "rsparse_tpu", "native", "rsymbolic.cpp"), "rb") as g:
        assert f.read() == g.read()
    offenders = []
    for d, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(d, fn)
            text = open(path).read()
            if '"rsparse_tpu", "native"' in text or "'rsparse_tpu', 'native'" in text:
                offenders.append(path)
            if any("rsparse_tpu/" in s or s == "rsparse_tpu"
                   for s in _code_strings(path)):
                offenders.append(path)
    assert not offenders, offenders


@pytest.mark.parametrize("order", [-1, 0, 1, 2])
def test_sqr_fields_equal(order):
    aj, at = _pair(_unsym(9, order + 3))
    sj = rs.sqr(aj, order, False)
    st = rt.sqr(at, order, False)
    assert (sj.q is None) == (st.q is None)
    if sj.q is not None:
        np.testing.assert_array_equal(sj.q, st.q)
    assert (sj.lnz, sj.unz) == (st.lnz, st.unz)


def test_schol_fields_equal():
    from bench import laplacian_5pt

    n, p, i, x = laplacian_5pt(8)
    aj = rs.Sprs(len(x), n, n, p, i, x)
    at = rt.Sprs(len(x), n, n, p, i, x)
    sj, st = rs.schol(aj, 0), rt.schol(at, 0)
    for f in ("pinv", "parent", "cp"):
        np.testing.assert_array_equal(getattr(sj, f), getattr(st, f))
    assert (sj.lnz, sj.unz) == (st.lnz, st.unz)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_tri_plan_arrays_equal(kind):
    """Same L/U (from the host engine) -> identical level schedules."""
    from rsparse_tpu.solve import tri_plan as tri_plan_jax

    aj, at = _pair(_unsym(8, 11))
    sj = rs.sqr(aj, 1, False)
    nz = aj.nnz()
    Lp, Li, Lx, Up, Ui, Ux, _ = rs.symbolic.native.lu_numeric(
        aj.n, aj.p, aj.i[:nz], aj.x[:nz], sj.q, 1e-6, sj.lnz, sj.unz)
    p_, i_, x_ = (Lp, Li, Lx) if kind in (0, 2) else (Up, Ui, Ux)
    tj = tri_plan_jax(rs.Sprs(len(x_), aj.n, aj.n, p_, i_, x_), kind)
    tt = rt.tri_plan(sprs_from_fields(aj.n, aj.n, p_, i_, x_), kind)
    for f in ("n", "nlev", "emax", "wmax"):
        assert getattr(tj, f) == getattr(tt, f), f
    for f in ("ent_pos", "ent_row", "ent_col", "ent_slot", "ent_off",
              "col_id", "col_diag", "col_off"):
        np.testing.assert_array_equal(getattr(tj, f), getattr(tt, f), f)


def test_convert_copies_fields():
    aj, at = _pair(_unsym(4, 1))
    sj = rs.sqr(aj, 1, False)
    st = symb_from_fields(q=sj.q, lnz=sj.lnz, unz=sj.unz)
    np.testing.assert_array_equal(st.q, sj.q)
    st.q[0] = -5  # the port owns its copy
    assert sj.q[0] != -5
    assert at.nnz() == aj.nnz() and at.x.flags.writeable
    np.testing.assert_array_equal(at.to_dense_np(), aj.to_dense_np())


def test_sprs_io_roundtrip(tmp_path):
    """The port's .sprs save is byte-identical to the JAX package's."""
    aj, at = _pair(_unsym(3, 2))
    aj.save(str(tmp_path / "j.sprs"))
    at.save(str(tmp_path / "t.sprs"))
    assert (tmp_path / "j.sprs").read_bytes() == (tmp_path / "t.sprs").read_bytes()
    back = rt.Sprs.new_from_file(str(tmp_path / "t.sprs"))
    assert back == at
