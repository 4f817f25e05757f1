"""Port parity, Cholesky factorization: the torch package's `chol` against
the JAX package's on the same matrix under the same analysis (passed across
with `convert`). Patterns must be equal and values agree to 1e-10
relative; the multifrontal planner's fields must equal the JAX package's
entry for entry.

Covered: the level-scheduled path (`mf_min_n` patched up in both), its
all-dense tail (natural order, cut = 0), a tail whose leading block is
swept (the cut rule's defaults and `DENSE_NN_MAX` patched down in both),
the multifrontal path and its recursive skeleton (`mf_min_n` and
`RECURSE_MIN` patched down in both), NotPositiveDefinite on each route,
and the host engine (`config.backend = "host"`, 1e-12).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu.factor.frontal as fr_jax  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import rsparse_tpu_torch.factor.frontal as fr_torch  # noqa: E402

# the modules (each package's `factor` exports a function of that name)
cd_jax = importlib.import_module("rsparse_tpu.factor.chol_device")
cd_torch = importlib.import_module("rsparse_tpu_torch.factor.chol_device")
import torch_cases as C  # noqa: E402


def _jax_chol(aj, order):
    """The JAX package's analysis (its fields before the factorization, and
    itself after) and factor."""
    sj = rs.schol(aj, order)
    before = C.symb_fields(sj)
    return before, sj, rs.chol(aj, sj)


def _both_chol(case, order, extra=()):
    """Both packages' chol of a case under the JAX package's analysis;
    `extra` names the module constants a test patched."""
    before, sj, nj = C.jax_answer(_jax_chol, case, order, extra=extra)
    st = C.symb(before)
    nt = rt.chol(C.port(case), st, device="cpu")
    return (sj, nj), (st, nt)


def test_level_path(monkeypatch):
    """Few levels: the level phase alone, no tail."""
    C.mf(monkeypatch, 10**9)
    (sj, nj), (st, nt) = _both_chol("lap8", 0)
    assert st._chol_route == "device_level" and st.plan.tail is None
    C.same_sprs(nt.l, nj.l, 1e-10)


def test_level_path_dense_tail_cut_zero(monkeypatch):
    """Natural order on a 12 x 12 grid below mf_min_n: a deep level
    structure on a small system factors entirely in the dense tail."""
    C.mf(monkeypatch, 10**9)
    (sj, nj), (st, nt) = _both_chol("lap12", -1)
    assert st._chol_route == "device_level" and st.plan.tail.cut == 0
    C.same_sprs(nt.l, nj.l, 1e-10)


def test_level_path_swept_leading_block(monkeypatch):
    """A tail after a level phase whose leading block L_NN is too large to
    densify: W = L_NN^{-1} C(N, T) is one SpTRSV sweep."""
    C.mf(monkeypatch, 10**9)
    for m in (cd_jax, cd_torch):
        monkeypatch.setattr(m._choose_cut, "__defaults__", (4, 64))
        monkeypatch.setattr(m, "DENSE_NN_MAX", 32)
    (sj, nj), (st, nt) = _both_chol("lap16", 0, extra="swept")
    tail = st.plan.tail
    assert tail is not None and tail.cut > 32 and tail.tri is not None
    assert len(st.plan.levels) > 0
    C.same_sprs(nt.l, nj.l, 1e-10)


def _same_plan(pj, pt):
    if isinstance(pj, fr_jax.MFPlan):
        assert isinstance(pt, fr_torch.MFPlan)
        for f in ("n", "lnz", "Lp", "Li", "skel", "skel_a_src", "skel_a_dst",
                  "skel_l_src", "skel_l_dst", "skel_cnnz"):
            np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
        for u, v in zip(pj.skel_c_pattern, pt.skel_c_pattern):
            np.testing.assert_array_equal(u, v)
        assert len(pj.buckets) == len(pt.buckets)
        for bj, bt in zip(pj.buckets, pt.buckets):
            for f in bj.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(bj, f), getattr(bt, f))
        _same_plan(pj.skel_plan, pt.skel_plan)
    else:
        assert isinstance(pt, cd_torch.CholPlan)
        np.testing.assert_array_equal(pj.Lp, pt.Lp)
        np.testing.assert_array_equal(pj.Li, pt.Li)
        assert (pj.tail is None) == (pt.tail is None)
        if pt.tail is not None:
            assert (pj.tail.cut, pj.tail.d) == (pt.tail.cut, pt.tail.d)


@pytest.mark.parametrize("case,order,recurse", [("lap12", 0, None),
                                                ("lap24", 1, 150)])
def test_mf_path(monkeypatch, case, order, recurse):
    """The multifrontal path (and, with RECURSE_MIN patched down, its
    recursive skeleton): the same plan and factor as the JAX package."""
    C.mf(monkeypatch)
    if recurse:
        monkeypatch.setattr(fr_jax, "RECURSE_MIN", recurse)
        monkeypatch.setattr(fr_torch, "RECURSE_MIN", recurse)
    (sj, nj), (st, nt) = _both_chol(case, order, extra=recurse)
    assert st._chol_route == "device_mf"
    if recurse:
        assert isinstance(st._mf_plan.skel_plan, fr_torch.MFPlan)
    _same_plan(sj._mf_plan, st._mf_plan)
    C.same_sprs(nt.l, nj.l, 1e-10)
    assert "_cache_tree" in st._mf_plan.__dict__


def _negated_diag(case, col):
    """A case with its diagonal entry (col, col) set to -50, as a dense
    array."""
    d = C.dense(case)
    d[col, col] = -50.0
    return d


@pytest.mark.parametrize("route,mf_min_n", [("device_level", 10**9),
                                            ("device_mf", 100)])
def test_not_positive_definite(monkeypatch, route, mf_min_n):
    C.mf(monkeypatch, mf_min_n)
    aj, at = C.pair(_negated_diag("lap12", 3))
    with pytest.raises(rs.NotPositiveDefiniteError):
        rs.chol(aj, rs.schol(aj, 0))
    st = rt.schol(at, 0)
    with pytest.raises(rt.NotPositiveDefiniteError):
        rt.chol(at, st, device="cpu")
    if route == "device_mf":
        assert isinstance(st._mf_plan, fr_torch.MFPlan)
        assert "_cache_tree" not in st._mf_plan.__dict__
    else:
        assert isinstance(st.plan, cd_torch.CholPlan)


def test_backend_host_matches(monkeypatch):
    C.host(monkeypatch)
    (sj, nj), (st, nt) = _both_chol("lap8", 0)
    assert st._chol_route == "host"
    assert isinstance(nt.l.x, np.ndarray) and nt.l.x.dtype == np.float64
    nz = nj.l.nnz()
    np.testing.assert_array_equal(nj.l.i[:nz], nt.l.i[:nz])
    assert np.abs(np.asarray(nj.l.x)[:nz] - nt.l.x[:nz]).max() <= 1e-12
