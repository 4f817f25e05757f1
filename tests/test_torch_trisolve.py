"""Port parity, the single-RHS triangular solves: `lsolve`, `ltsolve`,
`usolve` and `utsolve` of the torch package against the JAX package's on
the same factors (the host engine's exact LU of a seeded matrix, passed
across with `convert`), on the device route (the plain sweep on the CPU,
1e-10 relative) and on the host engine (`config.backend = "host"`,
1e-12), with the reference's write-back of b (list, ndarray, read-only
ndarray).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402

KINDS = [("lsolve", "l"), ("ltsolve", "l"), ("usolve", "u"), ("utsolve", "u")]


@pytest.fixture(scope="module")
def factors():
    """Exact L and U (host engine) of a seeded sparse nonsymmetric matrix,
    in both packages."""
    L, U = C.host_lu("rand50")
    return {"l": C.pair(L), "u": C.pair(U)}


@pytest.mark.parametrize("name,which", KINDS)
def test_device_route_matches_jax(factors, name, which):
    tj, tt = factors[which]
    b = np.random.default_rng(3).standard_normal(tj.n)
    xj = np.asarray(getattr(rs, name)(tj, b.copy()), np.float64)
    xt = getattr(rt, name)(tt, b.copy(), device="cpu")
    assert isinstance(xt, np.ndarray) and xt.dtype == np.float64
    assert np.abs(xt - xj).max() <= 1e-10 * max(1.0, np.abs(xj).max())


@pytest.mark.parametrize("name,which", KINDS)
def test_host_backend_matches_jax(factors, name, which, monkeypatch):
    tj, tt = factors[which]
    b = np.random.default_rng(4).standard_normal(tj.n)
    monkeypatch.setattr(rs.config, "backend", "host")
    monkeypatch.setattr(rt.config, "backend", "host")
    xj = np.asarray(getattr(rs, name)(tj, b.copy()), np.float64)
    xt = getattr(rt, name)(tt, b.copy(), device="cpu")
    assert np.abs(xt - xj).max() <= 1e-12 * max(1.0, np.abs(xj).max())


@pytest.mark.parametrize("name,which", KINDS)
def test_factor_values_as_a_tensor(factors, name, which, monkeypatch):
    """`lu` returns the factor's values as a tensor: the solve takes them so
    on the device route and on the host engine."""
    _, tt = factors[which]
    b = np.random.default_rng(5).standard_normal(tt.n)
    want = getattr(rt, name)(tt, b.copy(), device="cpu")
    tv = C.port(tt)
    tv.x = torch.as_tensor(tt.x)
    np.testing.assert_allclose(getattr(rt, name)(tv, b.copy(), device="cpu"),
                               want, rtol=0, atol=1e-14)
    monkeypatch.setattr(rt.config, "backend", "host")
    got = getattr(rt, name)(tv, b.copy(), device="cpu")
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("backend", ["device", "host"])
def test_writeback_semantics(factors, backend, monkeypatch):
    """b is overwritten when it is a list or a writable ndarray (the
    reference's in-place solve); a read-only ndarray is left as it is and
    the solution comes back as the return value."""
    monkeypatch.setattr(rt.config, "backend", backend)
    _, tt = factors["l"]
    b = np.random.default_rng(6).standard_normal(tt.n)
    want = rt.lsolve(tt, b.copy(), device="cpu")
    bl = list(b)
    out = rt.lsolve(tt, bl, device="cpu")
    assert isinstance(bl, list) and np.array_equal(np.asarray(bl), want)
    assert np.array_equal(out, want) and out.flags.writeable
    ba = b.copy()
    rt.lsolve(tt, ba, device="cpu")
    assert np.array_equal(ba, want)
    ro = b.copy()
    ro.flags.writeable = False
    out = rt.lsolve(tt, ro, device="cpu")
    assert np.array_equal(ro, b) and np.array_equal(out, want)
    assert out.flags.writeable


def test_single_rhs_cpu_runs_no_kernel(factors):
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    _, tt = factors["u"]
    before = sptrsv_multi.launches
    rt.usolve(tt, np.ones(tt.n), device="cpu")
    assert sptrsv_multi.launches == before


@pytest.mark.parametrize("module,least", [("solve", 20), ("factor", 10)])
def test_doc_examples(module, least):
    """The solvers' and factorizations' runnable examples (the reference's
    per-function doctests, on the CPU)."""
    import doctest
    import importlib

    res = doctest.testmod(importlib.import_module(f"rsparse_tpu_torch.{module}"),
                          verbose=False)
    assert res.failed == 0 and res.attempted >= least
