"""Port parity, the streaming SpMM: `rsparse_tpu_torch.ops.spmm_cuda` and
`gaxpy_multi` against the JAX package on the CPU.

The JAX side runs its Pallas kernel (`spmm_pallas`) in interpret mode, as
`tests/test_spmm_pallas.py` does; the port's CPU path is the kernel's plain
torch version. Inputs are made in-process from numpy seeds. The kernel's
launch shape (lanes, tiles of columns, vector width) needs no JAX
reference and is checked on its own.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu.ops.plan import transpose_plan as transpose_plan_jax  # noqa: E402
from rsparse_tpu.ops.spmm_pallas import spmm_pallas  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch.ops import spmm_cuda as st_spmm  # noqa: E402
from rsparse_tpu_torch.ops.spmm_cuda import (  # noqa: E402
    spmm, spmm_csr, spmm_fn, spmm_plain, spmm_plan, spmm_plan_cached,
    spmm_plan_coo)
from rsparse_tpu_torch.ops.plan import col_ids  # noqa: E402
from rsparse_tpu_torch.solve import _coo_amul, _sym_coo  # noqa: E402


# (200, 150, 2600): ~2,580 entries after de-duplication, so the JAX kernel
# streams three 1024-entry chunks
@pytest.mark.parametrize("m,n,nnz", [(300, 211, 1200), (64, 64, 256),
                                     (17, 500, 2000), (200, 150, 2600)])
def test_spmm_matches_pallas_kernel_f32(m, n, nnz):
    aj, at = C.pair(C.rand_pattern(m, n, nnz, m + n))
    if nnz == 2600:
        assert at.nnz() > 2 * 1024
    X = np.random.default_rng(2).standard_normal((n, 16)).astype(np.float32)
    want = np.asarray(spmm_pallas(aj, X), np.float64)
    got = spmm(at, X, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 16)
    assert C.rel(got.double().numpy(), want) < 1e-5


def test_spmm_plan_is_the_csr_copy():
    """The kernel's CSR streams are the JAX transpose plan's arrays, and the
    plan is cached per pattern."""
    aj, at = C.pair(C.rand_pattern(50, 40, 300, 5))
    tj = transpose_plan_jax(aj)
    plan = spmm_plan(at)
    np.testing.assert_array_equal(plan.row_ptr, tj.out_p)
    np.testing.assert_array_equal(plan.col_idx, tj.out_i)
    np.testing.assert_array_equal(plan.perm, tj.perm)
    assert spmm_plan_cached(at) is spmm_plan_cached(at)


def test_spmm_empty_matrix_and_f64():
    e = rt.Sprs.zeros(4, 5, 1)
    out = spmm(e, np.ones((5, 8)), device="cpu")
    assert out.dtype == torch.float64 and tuple(out.shape) == (4, 8)
    assert bool((out == 0).all())
    aj, at = C.pair(C.rand_pattern(30, 20, 120, 6))
    X = np.random.default_rng(3).standard_normal((20, 3))
    assert C.rel(spmm(at, X, device="cpu"), aj.to_dense_np() @ X) < 1e-13
    with pytest.raises(TypeError):
        spmm(at, np.ones((20, 3), np.int64), device="cpu")


@pytest.mark.parametrize("yform", ["none", "full", "per_row"])
def test_gaxpy_multi_matches_jax_f64(yform):
    aj, at = C.pair(C.rand_pattern(120, 90, 600, 5))
    rng = np.random.default_rng(6)
    X = rng.standard_normal((90, 5))
    Y = {"none": None, "full": rng.standard_normal((120, 5)),
         "per_row": rng.standard_normal(120)}[yform]
    want = rs.gaxpy_multi(aj, X, Y)
    got = rt.gaxpy_multi(at, X, Y, device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    # a tensor X gives the same answer
    got_t = rt.gaxpy_multi(at, torch.as_tensor(X), Y, device="cpu")
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.mark.parametrize("X,Y", [
    (np.ones(90), None),  # 1-D X
    (np.ones((89, 5)), None),  # wrong row count
    (np.ones((90, 5)), np.ones((120, 4))),  # wrong Y shape
])
def test_gaxpy_multi_value_errors_in_both(X, Y):
    aj, at = C.pair(C.rand_pattern(120, 90, 600, 5))
    with pytest.raises(ValueError):
        rs.gaxpy_multi(aj, X, Y)
    with pytest.raises(ValueError):
        rt.gaxpy_multi(at, X, Y, device="cpu")


@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("case", ["lap12", "unsym12", "grid_ls6"])
def test_residual_form_matches_coo_chain(case, B):
    """The serve handles' residual S - A X on the plan of their COO (the
    symmetrized one in AMD's order for the Laplacian, as cholsol_serve
    builds it; the CSC entries of the nonsymmetric 5-point matrix and of a
    rectangular least-squares matrix): the plain version's residual form
    and the CSR copy the kernel reads (rows in pointer order, values
    through `perm`) both equal S - `_coo_amul`(X)."""
    a = C.port(case)
    nz = a.nnz()
    if case == "lap12":
        Mi, Mj, Mx = _sym_coo(a, rt.schol(a, 1).pinv)
    else:
        Mi, Mj, Mx = a.i[:nz], col_ids(a.p, a.n), np.asarray(a.x[:nz])
    plan = spmm_plan_coo(Mi, Mj, a.m, a.n)
    rng = np.random.default_rng(B)
    X = torch.as_tensor(rng.standard_normal((a.n, B)))
    S = torch.as_tensor(rng.standard_normal((a.m, B)))
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64))
    vals = torch.as_tensor(np.asarray(Mx, np.float64))
    want = S - _coo_amul(ix(Mi), ix(Mj), vals, a.m)(X)
    got = spmm_plain(vals, X, plan, sub=S)
    assert got.dtype == torch.float64 and tuple(got.shape) == (a.m, B)
    assert C.rel(got, want) < 1e-13
    csr_rows = np.repeat(np.arange(a.m), np.diff(plan.row_ptr))
    R = S.numpy().copy()
    np.subtract.at(R, csr_rows, np.asarray(Mx, np.float64)[plan.perm][:, None]
                   * X.numpy()[plan.col_idx])
    assert C.rel(R, want) < 1e-13
    with pytest.raises(ValueError, match="sub must be"):
        spmm_plain(vals, X, plan, sub=S[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        spmm_plain(vals, X, plan, sub=S.new_zeros((a.m, 2 * B))[:, :B])


def test_cpu_path_counts_no_launch_and_fn_checks():
    _, at = C.pair(C.rand_pattern(40, 30, 150, 7))
    plan = spmm_plan(at)
    f = spmm_fn(plan)
    vals = torch.as_tensor(at.x[: at.nnz()])
    before = spmm_csr.launches
    f(vals, torch.ones((30, 4), dtype=torch.float64))
    assert spmm_csr.launches == before
    with pytest.raises(ValueError, match="dtype"):
        f(vals, torch.ones((30, 4), dtype=torch.float32))
    with pytest.raises(ValueError, match="X must be"):
        f(vals, torch.ones((31, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr(vals, torch.ones((30, 4), dtype=torch.float64), plan)


# The kernel's launch shape (host only).


@pytest.mark.parametrize("B,itemsize,ptr,want", [
    (128, 8, 0, (1, 32, 128, 1)),  # float64: scalars, one tile
    (128, 4, 0, (4, 16, 128, 1)),  # float4, 16 lanes of 8 columns
    (8, 4, 0, (4, 1, 8, 1)),  # a thread per row
    (130, 8, 0, (1, 32, 128, 2)),  # a ragged second tile of 2 columns
    (130, 4, 0, (1, 32, 256, 1)),  # 520-byte rows: scalars
    (300, 4, 0, (4, 32, 256, 2)),
    (1000, 8, 0, (1, 32, 128, 8)),
    (8, 4, 8, (1, 1, 8, 1)),  # X's base not 16-byte aligned
    (129, 4, 16, (1, 32, 256, 1)),
    (40, 8, 0, (1, 16, 64, 1)),
    (5, 8, 0, (1, 2, 8, 1)),
    (1, 4, 0, (1, 1, 8, 1)),
    (1, 8, 0, (1, 1, 4, 1)),
    (257, 4, 0, (1, 32, 256, 2)),
])
def test_launch_config(B, itemsize, ptr, want):
    cfg = st_spmm.launch_config(B, itemsize, ptr)
    assert (cfg["V"], cfg["W"], cfg["tile"], cfg["tiles"]) == want


@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_config_tiles_cover_b(itemsize):
    """For every B up to 600: W is a power of two up to 32, the tiles cover
    B with the last one ragged, and one tile is used while B fits one."""
    for B in range(1, 601):
        cfg = st_spmm.launch_config(B, itemsize, 0)
        W, tile, tiles = cfg["W"], cfg["tile"], cfg["tiles"]
        assert W in (1, 2, 4, 8, 16, 32) and tile == W * 32 // itemsize
        assert (tiles - 1) * tile < B <= tiles * tile
        assert (tiles == 1) == (B <= 32 * 32 // itemsize)
        assert W == 1 or (W // 2) * 32 // itemsize < B


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B", [1, 5, 8, 40, 128, 130, 300])
def test_kernel_lanes_cover_each_column_once(B, itemsize):
    """The kernel's index map (csrc/spmm.cu): tile t, lane l < W, slot
    k < K and vector element j hold column t * tile + (k W + l) V + j when
    it is below B. Every column of R is written by exactly one lane, with
    vector and scalar gathers."""
    for ptr in (0, 8):
        cfg = st_spmm.launch_config(B, itemsize, ptr)
        V, W, tile = cfg["V"], cfg["W"], cfg["tile"]
        K = 32 // itemsize // V
        seen = []
        for t in range(cfg["tiles"]):
            c_lo, c_hi = t * tile, min(B, (t + 1) * tile)
            for lane in range(W):
                for k in range(K):
                    c = c_lo + (k * W + lane) * V
                    if c < c_hi:
                        assert c + V <= c_hi  # a vector never crosses B
                        seen.extend(range(c, c + V))
        assert sorted(seen) == list(range(B))
