"""Port parity, the rest of the operator layer: `CSCDevice` with
`Sprs.to_device`/`from_device`, `ops.device.spmv_csc` (forward and its
autograd gradients), `ops.spmv_general` and `ops.spgemm_general`, against
the JAX package's functions of the same names on the CPU, on the same
inputs (made in-process from numpy seeds).

Tolerances: 1e-12 relative in float64, 1e-5 * max(1, max|ref|) in float32,
patterns (p, i) exactly equal. The port's SpMV runs the SpMM kernel's plain
version on the CPU; its SpGEMM sums each output entry's products with
`segment_reduce`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu.ops import device as jdev  # noqa: E402
from rsparse_tpu.ops.spgemm_general import (  # noqa: E402
    mxu_spgemm_plan as j_spgemm_plan, spgemm_general as j_spgemm,
    spgemm_general_fn as j_spgemm_fn)
from rsparse_tpu.ops.spmv_general import (  # noqa: E402
    mxu_spmv_plan as j_spmv_plan, spmv_general as j_spmv,
    spmv_general_fn as j_spmv_fn)

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch.ops.device import spmv_csc  # noqa: E402
from rsparse_tpu_torch.ops.spgemm_general import (  # noqa: E402
    mxu_spgemm_plan, spgemm_general, spgemm_general_fn)
from rsparse_tpu_torch.ops.spmv_general import (  # noqa: E402
    mxu_spmv_plan, spmv_general, spmv_general_fn)


def _pair(m, n, nnz, seed, ones=False):
    m, n, p, i, x = C.rand_pattern(m, n, nnz, seed)
    return C.pair((m, n, p, i, np.ones_like(x) if ones else x))


def _tol(f64: bool) -> float:
    return 1e-12 if f64 else 1e-5


# -- CSCDevice, to_device / from_device, spmv_csc ---------------------------


@pytest.mark.parametrize("shape", [(40, 25, 160), (25, 40, 160), (6, 6, 0)])
@pytest.mark.parametrize("dtype", [None, np.float32, torch.float64])
def test_to_device_round_trip(shape, dtype):
    aj, at = _pair(*shape, seed=shape[0]) if shape[2] else (
        rs.Sprs.zeros(6, 6, 0), rt.Sprs.zeros(6, 6, 0))
    jdt = None if dtype is None else (jnp.float64 if dtype is torch.float64 else dtype)
    dj, dt = aj.to_device(jdt), at.to_device(dtype, device="cpu")
    assert isinstance(dt, rt.CSCDevice) and (dt.m, dt.n) == (dj.m, dj.n)
    assert dt.p.dtype == dt.i.dtype == torch.int64
    assert np.array_equal(dt.p.numpy(), np.asarray(dj.p))
    assert np.array_equal(dt.i.numpy(), np.asarray(dj.i))
    assert str(dt.x.dtype).replace("torch.", "") == str(dj.x.dtype)
    assert np.array_equal(dt.x.numpy(), np.asarray(dj.x))
    bj, bt = rs.Sprs.from_device(dj), rt.Sprs.from_device(dt)
    assert (bt.nzmax, bt.m, bt.n) == (bj.nzmax, bj.m, bj.n)
    for f in ("p", "i", "x"):
        assert getattr(bt, f).dtype == getattr(bj, f).dtype
        assert np.array_equal(getattr(bt, f), getattr(bj, f))
    assert np.array_equal(bt.p, at.p) and np.array_equal(bt.i, at.i[: at.nnz()])
    xs = np.asarray(at.x[: at.nnz()])
    assert np.array_equal(bt.x, xs.astype(np.float32) if dtype is np.float32 else xs)


@pytest.mark.parametrize("shape", [(40, 25, 160), (25, 40, 160), (30, 30, 0)])
def test_spmv_csc_and_its_gradients(shape):
    m, n, nnz = shape
    aj, at = _pair(m, n, nnz, seed=m + n) if nnz else (
        rs.Sprs.zeros(m, n, 0), rt.Sprs.zeros(m, n, 0))
    rng = np.random.default_rng(nnz + 1)
    x, y, w = (rng.standard_normal(k) for k in (n, m, m))
    dj = aj.to_device(jnp.float64)
    rj = jdev.spmv_csc(dj, jnp.asarray(x), jnp.asarray(y))
    loss = lambda ax, xx, yy: jnp.vdot(jnp.asarray(w), jdev.spmv_csc(
        rs.CSCDevice(dj.p, dj.i, ax, dj.m, dj.n), xx, yy))
    gax, gx, gy = jax.grad(loss, argnums=(0, 1, 2))(dj.x, jnp.asarray(x),
                                                    jnp.asarray(y))
    d = at.to_device(torch.float64, device="cpu")
    ax = d.x.clone().requires_grad_()
    xt = torch.as_tensor(x).requires_grad_()
    yt = torch.as_tensor(y).requires_grad_()
    r = spmv_csc(rt.CSCDevice(d.p, d.i, ax, d.m, d.n), xt, yt)
    C.close(r.detach(), rj, _tol(True))
    C.close(spmv_csc(d, torch.as_tensor(x)), np.asarray(jdev.spmv_csc(
        dj, jnp.asarray(x))), _tol(True))
    (r * torch.as_tensor(w)).sum().backward()
    C.close(ax.grad, gax, _tol(True))
    C.close(xt.grad, gx, _tol(True))
    C.close(yt.grad, gy, _tol(True))


# -- spmv_general -----------------------------------------------------------


def test_spmv_placement_exact_multi_subtable():
    """n = 20,000 spans two of the JAX kernel's 16,384 subtables; x holds
    subtable-id sentinels: integer results, so both sides are exact."""
    n = 20_000
    aj, at = _pair(n, n, 40_000, seed=0, ones=True)
    x = (np.arange(n) // 16384 + 1).astype(np.float32)
    pj, pt = j_spmv_plan(aj), mxu_spmv_plan(at)
    want = np.asarray(j_spmv_fn(pj)(jnp.asarray(pj.vals), jnp.asarray(x)))
    got = spmv_general_fn(pt)(torch.as_tensor(pt.vals), torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,nnz,seed", [(2000, 2000, 14_000, 3),
                                          (500, 20_000, 8000, 4)])
def test_spmv_general_float32(m, n, nnz, seed):
    """A random square pattern and the rectangular 500 x 20,000 case."""
    aj, at = _pair(m, n, nnz, seed)
    x = np.random.default_rng(seed).standard_normal(n)
    got = spmv_general(at, x, device="cpu")
    assert tuple(got.shape) == (m,) and got.dtype == torch.float32
    C.close(got, j_spmv(aj, x), _tol(False))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_spmv_general_float64_plan(precision):
    aj, at = _pair(300, 200, 2000, seed=8)
    x = np.random.default_rng(9).standard_normal(200)
    pj, pt = j_spmv_plan(aj, np.float64), mxu_spmv_plan(at, np.float64)
    want = j_spmv_fn(pj)(jnp.asarray(pj.vals), jnp.asarray(x))
    got = spmv_general_fn(pt, precision)(torch.as_tensor(pt.vals),
                                         torch.as_tensor(x))
    assert got.dtype == torch.float64
    C.close(got, want, _tol(True))
    assert pt.vals.dtype == np.float64 and pt.perm.shape == (at.nnz(),)


def test_spmv_value_refresh_via_perm():
    """The JAX refresh idiom, unchanged: vals[plan.perm] = a.x[:nnz]."""
    aj, at = _pair(3000, 3000, 15_000, seed=6)
    pj, pt = j_spmv_plan(aj), mxu_spmv_plan(at)
    x = np.random.default_rng(3).standard_normal(3000)
    new = 2.0 * np.asarray(at.x[: at.nnz()]) - 0.5
    vj = np.zeros(pj.vals.shape, pj.vals.dtype).reshape(-1)
    vj[pj.perm] = new.astype(pj.vals.dtype)
    want = j_spmv_fn(pj)(jnp.asarray(vj.reshape(pj.vals.shape)),
                         jnp.asarray(x, np.float32))
    vt = np.zeros(pt.vals.shape, pt.vals.dtype).reshape(-1)
    vt[pt.perm] = new.astype(pt.vals.dtype)
    got = spmv_general_fn(pt)(torch.as_tensor(vt.reshape(pt.vals.shape)),
                              torch.as_tensor(x, dtype=torch.float32))
    C.close(got, want, _tol(False))


def test_spmv_general_rejects_unknown_precision():
    _, at = _pair(10, 10, 20, seed=1)
    with pytest.raises(ValueError, match="precision"):
        spmv_general_fn(mxu_spmv_plan(at), "fast")


# -- spgemm_general ---------------------------------------------------------


@pytest.mark.parametrize("m,k,n,da,db", [
    (40, 30, 50, 0.2, 0.15),   # rectangular, moderate fill
    (7, 9, 5, 0.5, 0.4),       # small dense-ish
    (64, 64, 64, 0.05, 0.05),  # square sparse
    (3, 4, 2, 1.0, 1.0),       # fully dense
])
def test_spgemm_matches_jax(m, k, n, da, db):
    rng = np.random.default_rng(m * 1000 + n)
    aj, at = C.pair(C.rand_density(rng, m, k, da))
    bj, bt = C.pair(C.rand_density(rng, k, n, db))
    cj = j_spgemm(aj, bj, dtype="float64")
    ct = spgemm_general(at, bt, dtype="float64", device="cpu")
    C.same_sprs(ct, cj, values=False)
    C.close(ct.x[: ct.nnz()], cj.x[: cj.nnz()], _tol(True))
    C.same_sprs(ct, rt.multiply(at, bt, device="cpu"), values=False)


def test_spgemm_empty_product():
    cj = j_spgemm(rs.Sprs.zeros(5, 6, 1), rs.Sprs.zeros(6, 4, 1), dtype="float64")
    ct = spgemm_general(rt.Sprs.zeros(5, 6, 1), rt.Sprs.zeros(6, 4, 1),
                        dtype="float64", device="cpu")
    assert ct.nnz() == cj.nnz() == 0 and (ct.m, ct.n) == (5, 4)
    C.same_sprs(ct, cj, values=False)


def test_spgemm_subtable_crossing():
    """nnz = 20,000 > 16,384: the JAX kernel's streams cross subtables."""
    n = 20_000
    rng = np.random.default_rng(7)
    perm = rng.permutation(n)
    va, vb = rng.standard_normal(n), rng.standard_normal(n)
    ar = np.empty(n, np.int64)
    ar[perm] = np.arange(n)  # A(i, perm[i]): column perm[i] holds row i
    ab = perm  # B(perm[i], i): column i holds row perm[i]
    p = np.arange(n + 1, dtype=np.int64)
    xa = np.empty(n)
    xa[perm] = va
    aj, at = C.pair((n, n, p, ar, xa))
    bj, bt = C.pair((n, n, p, ab, vb))
    cj = j_spgemm(aj, bj, dtype="float64")
    ct = spgemm_general(at, bt, dtype="float64", device="cpu")
    C.same_sprs(ct, cj, values=False)
    C.close(ct.x[: ct.nnz()], cj.x[: cj.nnz()], _tol(True))


def test_spgemm_value_refresh_through_run():
    """One plan, fresh values through f.run(ax, bx, *f.consts)."""
    rng = np.random.default_rng(3)
    aj, at = C.pair(C.rand_density(rng, 48, 48, 0.1))
    bj, bt = C.pair(C.rand_density(rng, 48, 48, 0.1))
    fj = j_spgemm_fn(j_spgemm_plan(aj, bj), "float64")
    pt = mxu_spgemm_plan(at, bt)
    ft = spgemm_general_fn(pt, "float64", device="cpu")
    assert len(ft.consts) == 3 and pt.lengths.sum() == len(pt.a_idx)
    for _ in range(2):
        ax, bx = rng.standard_normal(at.nnz()), rng.standard_normal(bt.nnz())
        want = fj.run(jnp.asarray(ax), jnp.asarray(bx), *fj.consts)
        got = ft.run(torch.as_tensor(ax), torch.as_tensor(bx), *ft.consts)
        C.close(got, want, _tol(True))
        C.close(ft(torch.as_tensor(ax), torch.as_tensor(bx)), want, _tol(True))


def test_spgemm_float32():
    rng = np.random.default_rng(11)
    aj, at = C.pair(C.rand_density(rng, 60, 60, 0.1))
    bj, bt = C.pair(C.rand_density(rng, 60, 60, 0.1))
    cj = j_spgemm(aj, bj)  # float32 default
    ct = spgemm_general(at, bt, device="cpu")
    C.same_sprs(ct, cj, values=False)
    C.close(ct.x[: ct.nnz()], cj.x[: cj.nnz()], _tol(False))
    f = spgemm_general_fn(mxu_spgemm_plan(at, bt), device="cpu")
    ax = torch.as_tensor(at.x[: at.nnz()])
    bx = torch.as_tensor(bt.x[: bt.nnz()])
    assert f(ax, bx).dtype == torch.float32
    assert torch.equal(f(ax, bx), f(ax, bx))
