"""Port parity, the DIA SpMV and `spgemm_dia`: `rsparse_tpu_torch.ops.spmv`
against the JAX package's `rsparse_tpu.ops.spmv` on the CPU.

The JAX package runs its XLA version of the DIA product on the CPU; the
port's CPU path is the kernel's plain torch version. The port builds its
plan vectorized (`np.isin`/`np.searchsorted`), so the field-by-field
equality below also checks that build. Inputs are made in-process from
numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from bench import laplacian_5pt, rand_csc  # noqa: E402
from rsparse_tpu.ops import spmv as sj  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.ops import spmv as st  # noqa: E402
from test_torch_kernel import dia_case  # noqa: E402  (jax-free helpers)


def _pair_dense(d):
    aj = rs.Sprs.new_from_vec(d)
    return aj, sprs_from_fields(aj.m, aj.n, aj.p, aj.i, aj.x)


def _lap(g=12):
    n, p, i, x = laplacian_5pt(g)
    return rs.Sprs(len(x), n, n, p, i, x), sprs_from_fields(n, n, p, i, x)


def _banded(m, n, seed, offs=(-7, -3, -1, 0, 1, 2, 5), far=6):
    """Random values on a few diagonals (some entries dropped), plus `far`
    stray entries off the band."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    for o in offs:
        for j in range(n):
            if 0 <= j + o < m and rng.random() < 0.85:
                d[j + o, j] = rng.standard_normal()
    for _ in range(far):
        d[rng.integers(m), rng.integers(n)] = rng.standard_normal()
    return _pair_dense(d)


MATS = {
    "laplacian": _lap,
    "banded": lambda: _banded(200, 200, 1),
    "banded_tall": lambda: _banded(230, 180, 2),
}

FIELDS = ("dia", "rem_vals", "rem_rows", "rem_cols", "val_kk", "val_rows",
          "val_keep")


def _same_plan(pj, pt):
    for f in ("n", "m", "rr", "offsets", "pad_rows", "tile_rows"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in FIELDS:
        a, b = getattr(pj, f), getattr(pt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, f)


@pytest.mark.parametrize("max_diags", [48, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(MATS))
def test_dia_plan_fields_equal(name, dtype, max_diags):
    aj, at = MATS[name]()
    pj = sj.dia_plan(aj, max_diags=max_diags, dtype=dtype)
    pt = st.dia_plan(at, max_diags=max_diags, dtype=dtype)
    _same_plan(pj, pt)
    if max_diags == 2:
        assert pt.rem_vals is not None


@pytest.mark.parametrize("max_diags", [48, 2])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("name", sorted(MATS))
def test_spmv_matches_jax(name, dtype, tol, max_diags):
    aj, at = MATS[name]()
    pj = sj.dia_plan(aj, max_diags=max_diags, dtype=dtype)
    pt = st.dia_plan(at, max_diags=max_diags, dtype=dtype)
    x = np.random.default_rng(3).standard_normal(at.n)
    want = np.asarray(sj.spmv(aj, x, pj), np.float64)
    got = st.spmv(at, x, pt, device="cpu")
    assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert tuple(got.shape) == (at.m,)
    assert np.abs(got.double().numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
    dense = at.to_dense_np() @ x
    assert np.abs(got.double().numpy() - dense).max() <= 10 * tol * max(1.0, np.abs(dense).max())


def test_spmv_default_plan_and_no_launch_on_cpu():
    aj, at = _lap(6)
    x = np.random.default_rng(4).standard_normal(at.n)
    before = st.dia_spmv.launches
    got = st.spmv(at, x, device="cpu")
    assert st.dia_spmv.launches == before
    want = np.asarray(sj.spmv(aj, x), np.float64)
    assert np.abs(got.double().numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    pt = st.dia_plan(at)
    with pytest.raises(ValueError, match="x must be"):
        st.dia_spmv(torch.as_tensor(pt.dia), torch.zeros(at.n + 1), pt)
    with pytest.raises(ValueError, match="dtype"):
        st.dia_spmv(torch.as_tensor(pt.dia), torch.zeros(at.n, dtype=torch.float64), pt)


@pytest.mark.parametrize("max_diags", [48, 2])
def test_refresh_and_cached_value_refresh(max_diags):
    aj, at = _banded(120, 120, 5)
    nz = at.nnz()
    new = np.random.default_rng(6).standard_normal(nz)
    pt = st.dia_plan(at, max_diags=max_diags, dtype=np.float64)
    pj = sj.dia_plan(aj, max_diags=max_diags, dtype=np.float64)
    rt_plan = st.refresh_dia_values(pt, new)
    _same_plan(sj.refresh_dia_values(pj, new), rt_plan)
    bt = sprs_from_fields(at.m, at.n, at.p, at.i, new)
    _same_plan(st.dia_plan(bt, max_diags=max_diags, dtype=np.float64), rt_plan)
    # the cache: same plan object for unchanged values, refreshed values
    # (same structure) after a change, equal to the JAX cache's plan
    c1 = st.dia_plan_cached(at, max_diags=max_diags)
    assert st.dia_plan_cached(at, max_diags=max_diags) is c1
    at.x[:nz] = new
    aj.x[:nz] = new
    c2 = st.dia_plan_cached(at, max_diags=max_diags)
    assert c2 is not c1 and c2.offsets == c1.offsets
    _same_plan(sj.dia_plan_cached(aj, max_diags=max_diags), c2)


def _same_sprs(cj, ct):
    nz = cj.nnz()
    assert (cj.m, cj.n) == (ct.m, ct.n)
    np.testing.assert_array_equal(cj.p, ct.p)
    np.testing.assert_array_equal(cj.i[:nz], ct.i[:nz])
    xj, xt = np.asarray(cj.x)[:nz], np.asarray(ct.x)[:nz]
    assert np.abs(xj - xt).max(initial=0.0) <= 1e-12 * max(1.0, np.abs(xj).max(initial=0.0))


@pytest.mark.parametrize("shape", ["square", "tall", "wide"])
@pytest.mark.parametrize("trim", [True, False])
def test_spgemm_dia_matches_jax(shape, trim):
    (m, k, n) = {"square": (150, 150, 150), "tall": (220, 150, 130),
                 "wide": (130, 170, 210)}[shape]
    aj, at = _banded(m, k, 7, far=0)
    bj, bt = _banded(k, n, 8, offs=(-2, 0, 3), far=0)
    cj = sj.spgemm_dia(aj, bj, trim=trim, materialize=True)
    ct = rt.ops.spmv.spgemm_dia(at, bt, trim=trim, materialize=True, device="cpu")
    _same_sprs(cj, ct)
    # on the CPU, materialize=None gives the same host result
    _same_sprs(cj, st.spgemm_dia(at, bt, trim=trim, device="cpu"))
    want = at.to_dense_np() @ bt.to_dense_np()
    np.testing.assert_allclose(ct.to_dense_np(), want, rtol=0, atol=1e-12)


def test_spgemm_dia_device_resident_values():
    """materialize=False keeps C.x a tensor on the device (the CPU here) in
    the full structural diagonals."""
    aj, at = _lap(8)
    cj = sj.spgemm_dia(aj, aj, trim=False, materialize=True)
    ct = st.spgemm_dia(at, at, materialize=False, device="cpu")
    assert isinstance(ct.x, torch.Tensor)
    _same_sprs(cj, ct)


def test_spgemm_dia_dense_pattern_falls_back():
    """More than 256 diagonals per operand: both packages route to the ESC
    multiply."""
    p, i, x = rand_csc(300, 300, 4500, 9)
    aj = rs.Sprs(len(x), 300, 300, p, i, x)
    at = sprs_from_fields(300, 300, p, i, x)
    assert len(st.dia_plan_cached(at).offsets) > 256
    _same_sprs(sj.spgemm_dia(aj, aj, materialize=True),
               st.spgemm_dia(at, at, materialize=True, device="cpu"))
    with pytest.raises(ValueError):
        st.spgemm_dia(at, rt.Sprs.zeros(299, 3, 0), device="cpu")


# The DIA kernel's host-side arguments (no JAX reference needed).


@pytest.mark.parametrize("m,n", [(10, 10), (7, 12), (12, 7), (1, 1), (130, 3)])
def test_interior_rows_brute_force(m, n):
    """[lo, hi) is exactly the rows at which every i - off lies in [0, n),
    offsets beyond +-n included."""
    rng = np.random.default_rng(m * 31 + n)
    sets = [(), (0,), (-n - 3,), (m + 2,), (n, -n)]
    sets += [tuple(sorted(rng.choice(np.arange(-20, 21), k, replace=False)))
             for k in (1, 2, 3, 5, 9) for _ in range(6)]
    for offs in sets:
        lo, hi = st.interior_rows(offs, m, n)
        want = [i for i in range(m) if all(0 <= i - o < n for o in offs)]
        assert 0 <= lo <= hi <= m
        assert list(range(lo, hi)) == want, (offs, lo, hi)


@pytest.mark.parametrize("m,n,offsets", [
    (300, 300, (-1, 0, 1)),
    (1027, 1000, (-1000, -1, 0, 3, 1001)),  # m != n, beyond +-n
    (5, 900, (-1200, -899, 0, 4, 6)),
    (900, 5, tuple(range(-9, 0))),  # K = 9
    (513, 260, tuple(range(-140, 140))),  # K = 280: more than 256
])
def test_plain_dia_on_any_offsets(m, n, offsets):
    """The plain version (the kernel's reference) against the defining sum,
    r[i] = sum_k dia[k, i] x[i - off_k] with out-of-range terms 0."""
    plan, x = dia_case(m, n, offsets, np.float64, m + n)
    got = st.dia_spmv_plain(torch.as_tensor(plan.dia), torch.as_tensor(x), plan)
    flat = plan.dia.reshape(len(offsets), -1)
    want = np.zeros(m)
    for k, o in enumerate(offsets):
        for i in range(m):
            if 0 <= i - o < n:
                want[i] += flat[k, i] * x[i - o]
    assert got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g,dtype,want", [(1024, np.float32, False),
                                          (1024, np.float64, True),
                                          (12, np.float64, False)])
def test_streams_dia_above_the_l2(g, dtype, want):
    """The kernel streams dia (evict first) only when dia, x and r together
    exceed the L2 (50 MiB here): the 2^20 Laplacian's float64 plan (50 MB
    of diagonals), not its float32 one."""
    n, p, i, x = laplacian_5pt(g)
    plan = st.dia_plan(sprs_from_fields(n, n, p, i, x), dtype=dtype)
    assert st.streams_dia(plan, np.dtype(dtype).itemsize, 50 * 2**20) is want
