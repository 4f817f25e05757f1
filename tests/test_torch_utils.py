"""Port parity, `utils`: the phase-metrics registry (and the phases the
port's `cholsol` and `lusol` record, held to the JAX package's names, calls
and work sizes on the same matrix), `profile_trace`, the kernels' sanitize
mode on the CPU, and `.npz` checkpoints moving both ways between the two
packages: a Cholesky, an LU and a QR factor (betas included) and a `Symb`,
each followed by a solve with what was loaded, held to the other
package's solve to 1e-12 relative. Inputs are made in-process from numpy
seeds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu.utils as jutils  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch import utils  # noqa: E402
from rsparse_tpu_torch.ops import cuda_build  # noqa: E402


# -- the metrics registry ----------------------------------------------------


def test_phase_timer_registry():
    for mod in (utils, jutils):
        mod.reset_metrics()
        with mod.phase_timer("unit.demo", nnz=1000):
            sum(range(1000))
        with mod.phase_timer("unit.demo", nnz=500, barrier=lambda: None):
            pass
        with mod.phase_timer("unit.idle"):
            pass
    got, want = utils.get_metrics(), jutils.get_metrics()
    assert set(got) == set(want) == {"unit.demo", "unit.idle"}
    for name in got:
        assert set(got[name]) == set(want[name])
        assert (got[name]["calls"], got[name]["work"]) == (
            want[name]["calls"], want[name]["work"])
    assert got["unit.demo"]["calls"] == 2 and got["unit.demo"]["work"] == 1500
    assert got["unit.demo"]["seconds"] > 0 and got["unit.demo"]["work_per_s"] > 0
    assert got["unit.idle"]["work_per_s"] is None
    utils.reset_metrics()
    assert utils.get_metrics() == {}


def _phases(mod):
    return {k: (v["calls"], v["work"]) for k, v in mod.get_metrics().items()}


# The spans the port's one-shot solvers open beyond the JAX package's
# phases, by route (PERF.md, "Spans and counters"): the multifrontal
# one-shot's planner, numeric factorization and refinement readbacks.
PORT_ONLY = {"level": set(),
             "mf": {"factor.plan", "factor.numeric", "refine.readback"}}


@pytest.mark.parametrize("solver,route", [("cholsol", "level"), ("cholsol", "mf"),
                                          ("lusol", "level"), ("lusol", "mf")])
def test_solvers_populate_metrics(monkeypatch, solver, route):
    """The port's cholsol and lusol record the JAX package's phases, with
    its calls and work sizes, on both device routes; beside them only the
    port's own spans of that route."""
    if route == "mf":
        C.mf(monkeypatch)
    if solver == "cholsol":
        case, args = "lap12", (1,)
    else:  # natural order on the level route: the JAX level LU takes it
        case, args = ("unsym12", (1, 1e-6)) if route == "mf" else (
            "rand50", (-1, 1e-6))
    aj, at = C.pair(case)
    b = np.random.default_rng(1).standard_normal(aj.n)
    jutils.reset_metrics()
    xj = getattr(rs, solver)(aj, list(b), *args)
    utils.reset_metrics()
    xt = getattr(rt, solver)(at, list(b), *args, device="cpu")
    assert C.rel(xt, xj) <= 1e-10
    got, want = _phases(utils), _phases(jutils)
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) == PORT_ONLY[route]
    assert {f"{solver}.symbolic", f"{solver}.oneshot"} <= set(got)
    if route == "level":
        assert {f"{solver}.factor", f"{solver}.solve"} <= set(got)


# -- checkpoints, both ways --------------------------------------------------


def _kw(pkg):
    return {"device": "cpu"} if pkg is rt else {}


def _factor(pkg, kind, a, s):
    if kind == "chol":
        return pkg.chol(a, s, **_kw(pkg))
    if kind == "lu":
        return pkg.lu(a, s, 1e-6, **_kw(pkg))
    return pkg.qr(a, s, **_kw(pkg))


def _solve(pkg, kind, nm, s, a, b):
    """The reference's solve composition with the factors of `nm`
    (src/lib.rs:377-389, 672-683, 931-942)."""
    kw, n = _kw(pkg), a.n
    out = np.zeros(n)
    if kind == "chol":
        x = np.zeros(n)
        pkg.ipvec(n, s.pinv, b, x)
        x = pkg.ltsolve(nm.l, pkg.lsolve(nm.l, x, **kw), **kw)
        pkg.pvec(n, s.pinv, np.asarray(x), out)
    elif kind == "lu":
        x = np.zeros(n)
        pkg.ipvec(n, nm.pinv, b, x)
        x = pkg.usolve(nm.u, pkg.lsolve(nm.l, x, **kw), **kw)
        pkg.ipvec(n, s.q, np.asarray(x), out)
    else:
        x = np.zeros(s.m2)
        pkg.ipvec(a.m, s.pinv, b, x)
        for k in range(n):
            pkg.solve.happly_dense(nm.l, k, float(nm.b[k]), x)
        pkg.ipvec(n, s.q, np.asarray(pkg.usolve(nm.u, x[:n], **kw)), out)
    return out


def _analysis(kind, aj):
    if kind == "chol":
        return rs.schol(aj, 1)
    return rs.sqr(aj, 1 if kind == "lu" else 2, kind == "qr")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["chol", "lu", "qr"])
def test_factor_checkpoint_between_packages(tmp_path, kind, direction):
    aj, at = C.pair({"chol": "lap12", "lu": "rand50", "qr": "tall60x40"}[kind])
    sj = _analysis(kind, aj)
    st = C.symb(sj)
    src, dst = (rs, rt) if direction == "jax_to_port" else (rt, rs)
    a_src, s_src = (aj, sj) if src is rs else (at, st)
    a_dst, s_dst = (at, st) if dst is rt else (aj, sj)
    nm = _factor(src, kind, a_src, s_src)
    path = str(tmp_path / "factor.npz")
    (jutils if src is rs else utils).save_factor(nm, path)
    with np.load(path) as z:
        keys = set(z.files)
    assert {"l_shape", "l_p", "l_i", "l_x"} <= keys
    assert ("u_p" in keys) == (kind != "chol")
    assert ("pinv" in keys) == (kind == "lu") and ("beta" in keys) == (kind == "qr")
    nm2 = (utils if dst is rt else jutils).load_factor(path)
    assert isinstance(nm2, dst.Nmrc)
    C.same_sprs(nm2.l, nm.l, 0.0, nzmax=True)
    if kind != "chol":
        C.same_sprs(nm2.u, nm.u, 0.0, nzmax=True)
    if kind == "lu":
        assert np.array_equal(nm2.pinv, nm.pinv)
    if kind == "qr":
        assert np.array_equal(nm2.b, nm.b)
    b = np.random.default_rng(2).standard_normal(aj.m)
    x = _solve(dst, kind, nm2, s_dst, a_dst, b)
    assert C.rel(x, _solve(src, kind, nm, s_src, a_src, b)) <= 1e-12
    resid = aj.to_dense_np() @ x - b
    if kind == "qr":  # least squares: the normal equations' residual
        resid = aj.to_dense_np().T @ resid
    assert np.abs(resid).max() <= 1e-9 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("route", ["level", "mf"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_symbolic_checkpoint_between_packages(monkeypatch, tmp_path, direction,
                                              route):
    """A Symb saved by one package drives the other's cholsol (its plans
    built again at first use), giving the first package's x."""
    if route == "mf":
        C.mf(monkeypatch)
    aj, at = C.pair("lap12")
    src, dst = (rs, rt) if direction == "jax_to_port" else (rt, rs)
    s = src.schol(aj if src is rs else at, 1)
    path = str(tmp_path / "symb.npz")
    (jutils if src is rs else utils).save_symbolic(s, path)
    s2 = (utils if dst is rt else jutils).load_symbolic(path)
    assert isinstance(s2, dst.Symb)
    for f in ("pinv", "q", "parent", "cp"):
        v, v2 = getattr(s, f), getattr(s2, f)
        assert (v is None) == (v2 is None)
        if v is not None:
            assert np.array_equal(v, v2) and v2.dtype == np.int64
    assert (s2.lnz, s2.unz, s2.m2) == (s.lnz, s.unz, s.m2)
    assert getattr(s2, "_mf_plan", None) is None and s2.plan is None
    b = np.random.default_rng(3).standard_normal(aj.n)
    x2 = dst.cholsol(aj if dst is rs else at, b.copy(), 1, sym=s2, **_kw(dst))
    x = src.cholsol(aj if src is rs else at, b.copy(), 1, sym=s, **_kw(src))
    assert C.rel(x2, x) <= 1e-12
    if dst is rt:
        assert s2._chol_route == ("device_mf" if route == "mf" else "device_level")
        assert (getattr(s2, "_mf_plan", None) is not None) == (route == "mf")


# -- profile_trace and sanitize ---------------------------------------------


def test_profile_trace_writes_a_trace(tmp_path):
    from rsparse_tpu_torch.ops.spmv_general import spmv_general

    x = np.arange(64, dtype=np.float64)
    logdir = str(tmp_path / "trace")
    with utils.profile_trace(logdir):
        r = spmv_general(C.port("lap8"), x, device="cpu")
    assert np.allclose(r.numpy(), C.dense("lap8") @ x, atol=1e-4)
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert files and os.path.getsize(os.path.join(logdir, files[0])) > 0


def test_sanitize_on_the_cpu():
    """Inside sanitize the CPU paths (the plain versions) give bit-equal
    results; the mode is scoped to the block."""
    at = C.port("lap8")
    X = torch.as_tensor(np.random.default_rng(4).standard_normal((at.n, 3)))
    want = rt.gaxpy_multi(at, X, device="cpu")
    assert not cuda_build.sanitizing()
    with utils.sanitize():
        assert cuda_build.sanitizing()
        got = rt.gaxpy_multi(at, X, device="cpu")
    assert not cuda_build.sanitizing()
    assert torch.equal(got, want)


def test_sanitize_checks_name_the_kernel():
    """The host checks sanitize runs before a launch."""
    cuda_build.check_index("SpMM", "col_idx", torch.tensor([0, 4, 2]), 5)
    with pytest.raises(IndexError, match=r"SpMM kernel: col_idx\[1\] = 5"):
        cuda_build.check_index("SpMM", "col_idx", torch.tensor([0, 5, 2]), 5)
    with pytest.raises(IndexError, match="outside"):
        cuda_build.check_index("DIA SpMV", "offsets", np.array([-7, 0]), 5, -5)
    cuda_build.check_pointers("SpMM", "row_ptr", np.array([0, 2, 2, 5]), 5)
    with pytest.raises(IndexError, match="decreases at 2"):
        cuda_build.check_pointers("SpMM", "row_ptr", np.array([0, 3, 2, 5]), 5)
    with pytest.raises(IndexError, match="from 0 to 5"):
        cuda_build.check_pointers("SpMM", "row_ptr", np.array([0, 2, 4]), 5)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sanitize_checks_the_sweep_streams(kind):
    """The sweep's sanitize checks on its kernel streams (built here on the
    CPU): a good plan passes, a row outside the triangle raises naming the
    kernel's stream."""
    from rsparse_tpu_torch.ops import sptrsv_cuda

    at = C.port("rand50")
    nm = rt.lu(at, rt.sqr(at, -1, False), 1e-6, device="cpu")
    t = nm.l if kind in (0, 2) else nm.u
    plan = rt.tri_plan(t, kind)
    cpu = torch.device("cpu")
    sptrsv_cuda._sanitize_streams(sptrsv_cuda._kernel_streams(plan, kind, cpu),
                                  t.n, t.nnz())
    bad = rt.tri_plan(t, kind)
    (bad if bad.dense is None else bad.dense.rest).ent_row[0] = t.n + 3
    ks = sptrsv_cuda._kernel_streams(bad, kind, cpu)
    with pytest.raises(IndexError, match="SpTRSV kernel: e(dst|src)"):
        sptrsv_cuda._sanitize_streams(ks, t.n, t.nnz())


def test_new_modules_import_no_jax():
    """This slice's modules and names import neither jax nor the JAX
    package (a fresh interpreter: this test process has both loaded)."""
    import subprocess
    import sys

    code = ("import sys, rsparse_tpu_torch, rsparse_tpu_torch.ops.chain,"
            " rsparse_tpu_torch.ops.spmv_general,"
            " rsparse_tpu_torch.ops.spgemm_general, rsparse_tpu_torch.utils;"
            "from rsparse_tpu_torch import CSCDevice;"
            "from rsparse_tpu_torch.ops import ChainExpr, chain;"
            "from rsparse_tpu_torch.ops.device import spmv_csc;"
            "from rsparse_tpu_torch.utils import (phase_timer, profile_trace,"
            " sanitize, get_metrics, reset_metrics, save_symbolic,"
            " load_symbolic, save_factor, load_factor);"
            "assert 'jax' not in sys.modules, 'jax';"
            "assert 'rsparse_tpu' not in sys.modules, 'rsparse_tpu'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.check_call([sys.executable, "-c", code], cwd=root)
