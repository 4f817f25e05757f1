"""The port's CUDA kernels against their plain torch versions: the SpTRSV
sweep (csrc/sptrsv.cu), the streaming SpMM (csrc/spmm.cu) and the DIA SpMV
(csrc/spmv_dia.cu), the sweep also over K instances' values at once; and
the solvers that run the sweep (the single-RHS solves, lusol, cholsol,
cholsol_serve, qrsol, the batched and serving drivers cholsol_multi,
lusol_multi, qrsol_multi, qrsol_serve and cholsol_ir, and the
batched-values drivers cholsol_vals, lusol_vals and qrsol_vals) on the card
against their CPU runs.

This file imports neither jax nor the JAX package (only the numpy test
matrix of bench.py), so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

The `gpu` tests skip without a card. The CPU tests hold the plain versions
(the wrappers' path for CPU tensors) to dense numpy products and solves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench import laplacian_5pt, rand_csc  # noqa: E402  (numpy only)
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.convert import sprs_from_fields  # noqa: E402
from rsparse_tpu_torch.ops import spmv as spmv_mod  # noqa: E402
from rsparse_tpu_torch.ops.spmm_cuda import (  # noqa: E402
    spmm_csr, spmm_fn, spmm_plain, spmm_plan)
from rsparse_tpu_torch.ops.sptrsv_cuda import (  # noqa: E402
    sptrsv_multi, sptrsv_plain_multi)
from rsparse_tpu_torch.symbolic import native  # noqa: E402


def _tri(kind, g=12):
    """L (kinds 0/2) or U (kinds 1/3) of the host engine's LU of a g x g
    5-point Laplacian."""
    n, p, i, x = laplacian_5pt(g)
    a = sprs_from_fields(n, n, p, i, x)
    s = rt.sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, _ = native.lu_numeric(
        n, a.p, a.i, a.x, s.q, 1e-6, s.lnz, s.unz)
    return sprs_from_fields(n, n, *((Lp, Li, Lx) if kind in (0, 2)
                                    else (Up, Ui, Ux)))


def _rel(got, ref):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_plain_sweep_vs_dense_solve(kind, dtype, tol):
    t = _tri(kind, g=6)
    D = t.to_dense_np()
    M = D if kind in (0, 1) else D.T
    B = np.random.default_rng(kind).standard_normal((t.n, 5))
    X = sptrsv_plain_multi(torch.as_tensor(t.x[: t.nnz()], dtype=dtype),
                           torch.as_tensor(B, dtype=dtype),
                           rt.tri_plan(t, kind), kind)
    want = torch.as_tensor(np.linalg.solve(M, B))
    assert _rel(X, want) < tol


_SWEEP_CASES: dict = {}


def _sweep_case(name, kind):
    """The triangle and its plan for kind: "dense", L or U of the port's
    multifrontal LU of chip_smoke.make_matrix(24) (a dense skeleton block of
    109 columns); "levels", the host engine's factor of `_tri` (no block);
    "large", chip_smoke.synthetic_triangle(70000, 96), whose n is too large
    for X's column in shared memory (the global-memory variant)."""
    key = (name, kind)
    if key not in _SWEEP_CASES:
        import chip_smoke

        if name == "dense":
            old, rt.config.mf_min_n = rt.config.mf_min_n, 100
            try:
                a = chip_smoke.make_matrix(24, 0)
                s = rt.sqr(a, 1, False)
                nm = rt.lu(a, s, 1e-6, device="cpu")
                assert s._lu_route == "device_mf"
            finally:
                rt.config.mf_min_n = old
            t = nm.l if kind in (0, 2) else nm.u
            t = sprs_from_fields(t.n, t.n, t.p, t.i, t.x)
        elif name == "levels":
            t = _tri(kind)
        else:
            L, U = chip_smoke.synthetic_triangle(70000, 96, 0)
            t = L if kind in (0, 2) else U
        _SWEEP_CASES[key] = (t, rt.tri_plan(t, kind))
    return _SWEEP_CASES[key]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 40, 128, 130])
@pytest.mark.parametrize("case", ["dense", "levels", "large"])
def test_kernel_matches_plain_on_card(case, kind, dtype, tol, B):
    """One launch per sweep, against the level loop. f32: atomics reorder
    the sums from run to run; f64: rounding level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    t, plan = _sweep_case(case, kind)
    assert (plan.dense is not None) == (case != "levels")
    cfg = launch_config(plan, dtype, "cuda")
    assert cfg["variant"] == ("global" if case == "large" else "shared")
    tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((t.n, B)),
                        dtype=dtype, device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
    assert got.shape == X.shape and got.is_contiguous()
    assert _rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 128])
@pytest.mark.parametrize("K", [1, 3, 16])
@pytest.mark.parametrize("case", ["dense", "levels", "large"])
def test_kernel_instances_match_plain_on_card(case, K, B, kind, dtype, tol):
    """K instances' values [K, L] (each entry scaled by its own factor in
    [0.9, 1.1]) in one launch, grid (B, K): against the plain version on
    the same shapes and, per instance, against the kernel's one-instance
    launch on that instance's values (its value streams and X found at
    their instance offsets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, plan = _sweep_case(case, kind)
    rng = np.random.default_rng(K * 1000 + B)
    x0 = np.asarray(t.x[: t.nnz()], np.float64)
    tx = torch.as_tensor(x0 * rng.uniform(0.9, 1.1, (K, len(x0))),
                         dtype=dtype, device="cuda")
    X = torch.as_tensor(rng.standard_normal((K, t.n, B)), dtype=dtype,
                        device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
    assert got.shape == X.shape and got.is_contiguous()
    assert _rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol
    for k in sorted({0, K // 2, K - 1}):
        one = sptrsv_multi(tx[k].contiguous(), X[k], plan, kind)
        assert _rel(got[k], one) < tol


@pytest.mark.gpu
def test_serve_handle_on_card():
    """lusol_serve on the card answers with the kernel in its sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, p, i, x = laplacian_5pt(20)
    a = sprs_from_fields(n, n, p, i, x)
    B = np.random.default_rng(1).standard_normal((n, 64))
    before = sptrsv_multi.launches
    h = rt.lusol_serve(a, 1, 1e-6, device="cuda")
    X = h(B)
    assert X.device.type == "cuda" and sptrsv_multi.launches >= before + 4
    want = rt.lusol_serve(a, 1, 1e-6, device="cpu")(B)
    assert _rel(X, want) < 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("kind,name", [(0, "lsolve"), (1, "usolve"),
                                       (2, "ltsolve"), (3, "utsolve")])
def test_single_rhs_solves_on_card(kind, name):
    """The single-RHS solves launch the kernel once (B = 1, float64) and
    agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = _tri(kind)
    b = np.random.default_rng(kind).standard_normal(t.n)
    before = sptrsv_multi.launches
    got = getattr(rt, name)(t, list(b), device="cuda")
    assert sptrsv_multi.launches == before + 1
    want = getattr(rt, name)(t, list(b), device="cpu")
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["lusol", "cholsol", "cholsol_serve"])
@pytest.mark.parametrize("mf_min_n,route", [(100, "device_mf"),
                                            (10**9, "device_level")])
def test_solvers_on_card(monkeypatch, solver, mf_min_n, route):
    """lusol, cholsol and cholsol_serve on the card agree with their CPU
    runs, on the multifrontal and the level routes (LU's level route may
    take the host engine's exact pivoting)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    n, p, i, x = laplacian_5pt(20)
    a = sprs_from_fields(n, n, p, i, x)
    B = np.random.default_rng(2).standard_normal((n, 3))
    out = {}
    for dev in ("cuda", "cpu"):
        if solver == "cholsol_serve":
            h = rt.cholsol_serve(a, 1, device=dev)
            got = h(B).cpu().numpy()
            r = h.factor_route
        else:
            s = rt.sqr(a, 1, False) if solver == "lusol" else rt.schol(a, 1)
            fn = getattr(rt, solver)
            args = (1, 1e-6) if solver == "lusol" else (1,)
            got = np.stack([fn(a, B[:, j].copy(), *args, sym=s, device=dev)
                            for j in range(3)], 1)
            r = getattr(s, "_lu_route" if solver == "lusol" else "_chol_route")
        out[dev] = (got, r)
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][1] in ((route, "host") if solver == "lusol" else (route,))
    want = out["cpu"][0]
    assert np.abs(out["cuda"][0] - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("mf_min_n", [100, 10**9])
def test_error_contracts_on_card(monkeypatch, mf_min_n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    n, p, i, x = laplacian_5pt(20)
    x = x.copy()
    x[p[7] + int(np.nonzero(i[p[7]: p[8]] == 7)[0][0])] = -4.0
    with pytest.raises(rt.NotPositiveDefiniteError):
        rt.cholsol(sprs_from_fields(n, n, p, i, x), np.ones(n), 1,
                   device="cuda")
    d = np.eye(6) * 3.0
    d[:, 2] = 0.0
    d[2, 4] = 1.0
    with pytest.raises(rt.NoPivotError):
        rt.lusol(rt.Sprs.new_from_vec(d), [1.0] * 6, 1, 1e-6, device="cuda")


def _rand_sprs(m, n, nnz, seed):
    return sprs_from_fields(m, n, *rand_csc(m, n, nnz, seed))


def _banded(n, seed, far):
    """A 5-point Laplacian (g = n**0.5) with `far` stray entries added off
    its band, which a `max_diags=5` plan sends to the COO remainder."""
    g = int(round(n ** 0.5))
    n, p, i, x = laplacian_5pt(g)
    d = sprs_from_fields(n, n, p, i, x).to_dense_np()
    rng = np.random.default_rng(seed)
    for _ in range(far):
        d[rng.integers(n), rng.integers(n)] = rng.standard_normal()
    return rt.Sprs.new_from_vec(d)


@pytest.mark.parametrize("B", [1, 8, 40, 128])
def test_plain_spmm_vs_dense(B):
    a = _rand_sprs(70, 50, 300, B)
    plan = spmm_plan(a)
    X = np.random.default_rng(B).standard_normal((50, B))
    R = spmm_plain(torch.as_tensor(a.x[: a.nnz()]), torch.as_tensor(X), plan)
    assert _rel(R, torch.as_tensor(a.to_dense_np() @ X)) < 1e-13


@pytest.mark.parametrize("far", [0, 7])
def test_plain_dia_vs_dense(far):
    a = _banded(144, far, far)
    plan = spmv_mod.dia_plan(a, max_diags=5, dtype=np.float64)
    assert (plan.rem_vals is not None) == (far > 0)
    x = np.random.default_rng(far).standard_normal(a.n)
    r = spmv_mod.spmv_fn(plan)(torch.as_tensor(plan.dia), torch.as_tensor(x))
    assert _rel(r, torch.as_tensor(a.to_dense_np() @ x)) < 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [1, 8, 40, 128])
@pytest.mark.parametrize("shape", [(700, 500, 4000), (300, 900, 2500),
                                   (64, 64, 0)])
def test_spmm_kernel_matches_plain_on_card(shape, B, dtype, tol):
    """Rows in any order per row, no atomics: rounding-level differences
    from the plain version's CSC-order sums only. m != n, empty rows
    (the sparse shapes have many) and nnz = 0 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n, nnz = shape
    a = _rand_sprs(m, n, nnz, B) if nnz else rt.Sprs.zeros(m, n, 0)
    plan = spmm_plan(a)
    vals = torch.as_tensor(a.x[: a.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((n, B)),
                        dtype=dtype, device="cuda")
    before = spmm_csr.launches
    got = spmm_fn(plan)(vals, X)
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + 1
    assert tuple(got.shape) == (m, B) and got.dtype == dtype
    assert _rel(got, spmm_plain(vals, X, plan)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("far", [0, 9])
def test_dia_kernel_matches_plain_on_card(far, dtype, tol):
    """The diagonal kernel, with and without a COO remainder, and one plan
    with more than 256 diagonals (several chunks of staged offsets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    a = _banded(1024, far, far)
    cases = [spmv_mod.dia_plan(a, max_diags=5, dtype=np_dt)]
    wide = _rand_sprs(600, 600, 6000, far)
    cases.append(spmv_mod.dia_plan(wide, max_diags=10**9, dtype=np_dt))
    assert len(cases[1].offsets) > 256
    for mat, plan in ((a, cases[0]), (wide, cases[1])):
        dia = torch.as_tensor(plan.dia, device="cuda")
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(mat.n),
                            dtype=dtype, device="cuda")
        before = spmv_mod.dia_spmv.launches
        diag = spmv_mod.dia_spmv(dia, x, plan)
        full = spmv_mod.spmv_fn(plan)(dia, x)
        torch.cuda.synchronize()
        assert spmv_mod.dia_spmv.launches == before + 2
        assert _rel(diag, spmv_mod.dia_spmv_plain(dia, x, plan)) < tol
        # with the remainder: against the whole CPU path on the same inputs
        assert _rel(full, spmv_mod.spmv_fn(plan)(dia.cpu(), x.cpu())) < tol


@pytest.mark.gpu
def test_public_ops_launch_on_card():
    """gaxpy_multi and spmv on the card go through their kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _banded(400, 3, 3)
    X = np.random.default_rng(2).standard_normal((a.n, 16))
    before = spmm_csr.launches
    R = rt.gaxpy_multi(a, X, np.ones(a.m), device="cuda")
    assert spmm_csr.launches == before + 1 and R.device.type == "cuda"
    assert _rel(R, torch.as_tensor(a.to_dense_np() @ X + 1.0)) < 1e-12
    before = spmv_mod.dia_spmv.launches
    r = spmv_mod.spmv(a, X[:, 0], device="cuda")
    assert spmv_mod.dia_spmv.launches == before + 1
    assert _rel(r, torch.as_tensor(a.to_dense_np() @ X[:, 0])) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [1, 5, 8, 40, 128, 130, 300])
@pytest.mark.parametrize("pattern", ["random", "empty_rows", "no_entries",
                                     "banded"])
def test_spmm_tiles_on_card(pattern, B, dtype, tol):
    """The kernel with one tile of columns and with ragged tiles (B = 130
    in float64, 300 in both), vector gathers and, from an X whose base is
    not 16-byte aligned, scalar ones, against the plain version; m != n for
    the sparse shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = {"random": lambda: _rand_sprs(700, 500, 4000, B),
         "empty_rows": lambda: _rand_sprs(900, 300, 600, B),
         "no_entries": lambda: rt.Sprs.zeros(64, 50, 0),
         "banded": lambda: _banded(400, 5, 0)}[pattern]()
    plan = spmm_plan(a)
    vals = torch.as_tensor(a.x[: a.nnz()], dtype=dtype, device="cuda")
    vals_csr = vals[torch.as_tensor(plan.perm, device="cuda")]
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((a.n, B)),
                        dtype=dtype, device="cuda")
    flat = X.new_zeros(a.n * B + 1)
    flat[1:] = X.reshape(-1)
    unaligned = flat[1:].view(a.n, B)  # contiguous, base off by one value
    want = spmm_plain(vals, X, plan)
    for x in (X, unaligned):
        before = spmm_csr.launches
        got = spmm_csr(vals_csr, x, plan)
        torch.cuda.synchronize()
        assert spmm_csr.launches == before + 1
        assert tuple(got.shape) == (a.m, B) and got.dtype == dtype
        assert _rel(got, want) < tol


def dia_case(m, n, offsets, dtype, seed):
    """A hand-built DiaPlan (any offsets, beyond +-n too) with random
    diagonal values, and a random x."""
    rr = -(-max(m, n) // 128)
    maxoff = max((abs(o) for o in offsets), default=0)
    rng = np.random.default_rng(seed)
    dia = rng.standard_normal((len(offsets), rr, 128)).astype(dtype)
    plan = spmv_mod.DiaPlan(
        n=n, m=m, rr=rr, offsets=tuple(offsets), dia=dia,
        pad_rows=max(8, (-(-maxoff // 128) + 7) // 8 * 8), tile_rows=1,
        rem_vals=None, rem_rows=None, rem_cols=None)
    return plan, rng.standard_normal(n).astype(dtype)


DIA_CASES = [
    (4099, 4099, (0,)),  # K = 1; m not a multiple of 256
    (5000, 4000, (-64, -1, 0, 1, 64)),  # K = 5, m != n
    (3001, 3500, (-3600, -50, -1, 0, 1, 2, 50, 3502)),  # K = 8, beyond +-n
    (2050, 2050, tuple(range(-4, 5))),  # K = 9: offsets in shared memory
    (1100, 900, tuple(range(-150, 150))),  # K = 300: two chunks
    (3, 7, (-1, 0, 2)),  # one tile, all of it edge
    # 64 MB of float64 diagonals: over the L2, dia streamed (evict first)
    (1_000_000, 1_000_000, (-1000, -2, -1, 0, 1, 2, 7, 1000)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", range(len(DIA_CASES)))
def test_dia_kernel_cases_on_card(case, dtype, tol):
    """K fixed (1, 5, 8) and staged (9, 300), interior and edge CTAs,
    offsets beyond +-n, m != n and m not a multiple of a CTA's 256 rows,
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n, offsets = DIA_CASES[case]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    plan, x = dia_case(m, n, offsets, np_dt, case)
    dia = torch.as_tensor(plan.dia, device="cuda")
    xt = torch.as_tensor(x, device="cuda")
    before = spmv_mod.dia_spmv.launches
    got = spmv_mod.dia_spmv(dia, xt, plan)
    torch.cuda.synchronize()
    assert spmv_mod.dia_spmv.launches == before + 1
    assert tuple(got.shape) == (m,)
    assert _rel(got, spmv_mod.dia_spmv_plain(dia, xt, plan)) < tol


@pytest.mark.gpu
def test_dia_kernel_on_offset_view():
    """A dia view at an offset of one value (no 16-byte alignment) and a
    strided one: the kernel reads any base address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan, x = dia_case(1000, 1000, (-1, 0, 1), np.float32, 0)
    K, rr = len(plan.offsets), plan.rr
    flat = torch.zeros(K * rr * 128 + 1, device="cuda")
    flat[1:] = torch.as_tensor(plan.dia.reshape(-1), device="cuda")
    shifted = flat[1:].view(K, rr, 128)
    wide = torch.zeros(K, rr, 129, device="cuda")
    wide[:, :, 1:] = shifted
    xt = torch.as_tensor(x, device="cuda")
    want = spmv_mod.dia_spmv_plain(shifted, xt, plan)
    for dia in (shifted, wide[:, :, 1:]):
        assert _rel(spmv_mod.dia_spmv(dia, xt, plan), want) < 1e-5


def _qr_case(grid=24, seed=0):
    """chip_smoke's least-squares matrix [A5; 0.1 I] on a grid x grid mesh
    (n = grid², m = 2n) and its minimum-norm transpose."""
    import chip_smoke

    a = chip_smoke.qr_matrix(seed, grid)
    return a, rt.transpose(a, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("kind", [1, 3])
def test_kernel_on_qr_r_plans_on_card(monkeypatch, kind, B):
    """The sweep kernel on the multifrontal QR's R (usolve kind 1, utsolve
    kind 3; float64; R's dense root triangle solved as the kernel's block)
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.factor import frontal_qr

    a, _ = _qr_case()
    s = rt.sqr(a, 2, True)
    plan = frontal_qr.build_qr_mf_plan(a, s)
    frontal_qr.qr_mf(a, s, plan, "cuda")
    tplan = frontal_qr._r_plans(plan, kind)
    assert tplan.dense is not None
    tx = plan.__dict__["_cache_rv"]
    X = torch.as_tensor(np.random.default_rng(kind + B).standard_normal(
        (plan.n, B)), device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, tplan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
    assert _rel(got, sptrsv_plain_multi(tx, X, tplan, kind)) < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["ls", "mn"])
@pytest.mark.parametrize("mf_min_n,route", [(100, "device_mf"),
                                            (10**9, "device_level")])
def test_qrsol_on_card(monkeypatch, branch, mf_min_n, route):
    """qrsol on the card agrees with its CPU run on both branches and both
    routes; the R sweep runs the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    a, aw = _qr_case(grid=12)
    a = a if branch == "ls" else aw
    b = np.random.default_rng(3).standard_normal(a.m)
    out = {}
    for dev in ("cuda", "cpu"):
        s = rt.sqr(a if branch == "ls" else rt.transpose(a, device="cpu"), 2,
                   True)
        before = sptrsv_multi.launches
        x = rt.qrsol(a, b.copy(), 2, sym=s, device=dev)
        out[dev] = (x, s._qr_route, sptrsv_multi.launches - before)
    assert out["cuda"][1] == out["cpu"][1] == route
    assert out["cuda"][2] >= 1 and out["cpu"][2] == 0
    want = out["cpu"][0]
    assert np.abs(out["cuda"][0] - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_ls_on_card(monkeypatch, branch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    a, aw = _qr_case(grid=12)
    a = a if branch == "ls" else aw
    b = np.random.default_rng(4).standard_normal(a.m)
    got = rt.qrsol_ls(a, b, 2, device="cuda")
    want = rt.qrsol_ls(a, b, 2, device="cpu")
    assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["chol", "lu", "qr"])
def test_factor_values_contract_on_card(kind):
    """chol, lu and qr on the card return writable float64 numpy values,
    which copy and gaxpy take; they equal the CPU run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, p, i, x = laplacian_5pt(12)
    a = sprs_from_fields(n, n, p, i, x)
    if kind == "qr":
        a = _qr_case(grid=12)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        if kind == "chol":
            nm = rt.chol(a, rt.schol(a, 1), device=dev)
        elif kind == "lu":
            nm = rt.lu(a, rt.sqr(a, 1, False), 1e-6, device=dev)
        else:
            nm = rt.qr(a, rt.sqr(a, 2, True), device=dev)
        out[dev] = nm
    for which in ("l", "u") if kind != "chol" else ("l",):
        t, ref = getattr(out["cuda"], which), getattr(out["cpu"], which)
        assert isinstance(t.x, np.ndarray) and t.x.dtype == np.float64
        assert t.x.flags.writeable
        c = t.copy()
        assert c == t
        assert np.abs(t.x - ref.x).max() <= 1e-12 * max(1.0, np.abs(ref.x).max())
        v = np.random.default_rng(5).standard_normal(t.n)
        got = np.asarray(rt.gaxpy(t, list(v), [0.0] * t.m, device="cuda"))
        want = np.asarray(rt.gaxpy(ref, list(v), [0.0] * t.m, device="cpu"))
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


def _multi_run(driver, dev, a, B):
    """One call of a batched or serving driver on `dev`: (X as numpy, the
    route, the sweep kernel's launches in the call)."""
    before = sptrsv_multi.launches
    if driver == "cholsol_multi":
        s = rt.schol(a, 1)
        X = rt.cholsol_multi(a, B, 1, sym=s, device=dev)
    elif driver == "lusol_multi":
        s = rt.sqr(a, 1, False)
        X = rt.lusol_multi(a, B, 1, 1e-6, sym=s, device=dev)
    elif driver == "qrsol_multi":
        s = rt.schol(rt.multiply(rt.transpose(a, device="cpu"), a,
                                 device="cpu"), 2)
        X = rt.qrsol_multi(a, B, 2, sym=s, device=dev)
    elif driver == "qrsol_serve":
        h = rt.qrsol_serve(a, 2, device=dev)
        X = h(B)
        assert X.device.type == torch.device(dev).type
        return X.cpu().numpy(), "serve", sptrsv_multi.launches - before
    else:  # cholsol_ir: one RHS
        b = B[:, 0].copy()
        X = rt.cholsol_ir(a, b, 1, "float32", 3, device=dev)
        assert np.array_equal(b, X)
        return X, "ir", sptrsv_multi.launches - before
    assert isinstance(X, np.ndarray)
    return X, s._multi_route, sptrsv_multi.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("driver", ["cholsol_multi", "lusol_multi",
                                    "qrsol_multi", "qrsol_serve",
                                    "cholsol_ir"])
@pytest.mark.parametrize("mf_min_n", [100, 10**9])
def test_multi_drivers_on_card(monkeypatch, driver, mf_min_n):
    """The batched and serving drivers on the card agree with their CPU
    runs (the plain sweeps), on the same route, with the serving path
    forced on both; where the route sweeps, the card's run launches the
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    monkeypatch.setattr(rt.config, "serve_mixed", "force")
    if driver.startswith("qrsol"):
        a = _qr_case(grid=12)[0]
    elif driver == "lusol_multi":
        a = chip_smoke.make_matrix(20, 0)
    else:
        n, p, i, x = laplacian_5pt(20)
        a = sprs_from_fields(n, n, p, i, x)
    B = np.random.default_rng(11).standard_normal((a.m, 8))
    card, cpu = _multi_run(driver, "cuda", a, B), _multi_run(driver, "cpu",
                                                             a, B)
    assert card[1] == cpu[1] and cpu[2] == 0
    if card[1] in ("serve", "device_level", "ir"):
        assert card[2] >= 1
    assert np.abs(card[0] - cpu[0]).max() <= 1e-9 * max(
        1.0, np.abs(cpu[0]).max())


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["ls", "mn"])
def test_qrsol_serve_available_on_card(branch):
    """qrsol_serve's `available` is True exactly when the sweep kernel's
    launch_config takes both Gram sweeps in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    a, aw = _qr_case(grid=24)
    h = rt.qrsol_serve(a if branch == "ls" else aw, 2, device="cuda")
    fits = True
    for plan, v32, _ in h.chain:
        assert v32.dtype == torch.float32 and v32.device.type == "cuda"
        try:
            launch_config(plan, torch.float32, "cuda")
        except ValueError:
            fits = False
    assert h.available == fits


def _vals_run(driver, dev, a, AxK, B):
    """One batched-values call on `dev`: (X, the route, the sweep kernel's
    launches in the call)."""
    before = sptrsv_multi.launches
    if driver == "cholsol_vals":
        s = rt.schol(a, 1)
        X = rt.cholsol_vals(a, AxK, B, 1, sym=s, device=dev)
    elif driver == "lusol_vals":
        s = rt.sqr(a, 1, False)
        X = rt.lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device=dev)
    else:
        s = rt.sqr(a if a.m >= a.n else rt.transpose(a, device="cpu"), 2,
                   True)
        X = rt.qrsol_vals(a, AxK, B, 2, sym=s, device=dev)
    assert isinstance(X, np.ndarray) and X.shape == (len(AxK), a.n)
    return X, s._vals_route, sptrsv_multi.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("driver,case", [
    ("cholsol_vals", "lap"), ("lusol_vals", "unsym"),
    ("qrsol_vals", "ls"), ("qrsol_vals", "mn")])
@pytest.mark.parametrize("mf_min_n", [100, 10**9])
def test_vals_drivers_on_card(monkeypatch, driver, case, mf_min_n):
    """The batched-values drivers (K = 4, values scaled per instance) on
    the card agree with their CPU runs, on the same route; on the device
    route every sweep is one launch for all K: the Cholesky solve's two
    skeleton sweeps per refinement step (n = 400 has no dense tail), the
    QR's one R sweep; the LU's dense skeleton runs none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    if case == "lap":
        n, p, i, x = laplacian_5pt(20)
        a = sprs_from_fields(n, n, p, i, x)
    elif case == "unsym":
        a = chip_smoke.make_matrix(20, 0)
    else:
        a, aw = _qr_case(grid=12)
        a = a if case == "ls" else aw
    K, nz = 4, a.nnz()
    AxK = np.asarray(a.x[:nz]) * (1.0 + 0.1 * np.arange(K))[:, None]
    B = np.random.default_rng(12).standard_normal((K, a.m))
    card = _vals_run(driver, "cuda", a, AxK, B)
    cpu = _vals_run(driver, "cpu", a, AxK, B)
    assert card[1] == cpu[1] and cpu[2] == 0
    if card[1][0] == "device_mf":
        assert card[1][1] == 0
        if driver == "cholsol_vals":  # 1 + up to 4 refinement solves
            assert card[2] in (2, 4, 6, 8, 10)
        else:
            assert card[2] == (1 if driver == "qrsol_vals" else 0)
    assert np.abs(card[0] - cpu[0]).max() <= 1e-9 * max(
        1.0, np.abs(cpu[0]).max())
