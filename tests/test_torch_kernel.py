"""The port's CUDA kernels against their plain torch versions: the SpTRSV
sweep (csrc/sptrsv.cu), the streaming SpMM (csrc/spmm.cu; also in its
residual form, which the serve handles' refinement runs) and the DIA SpMV
(csrc/spmv_dia.cu), the sweep also over K instances' values at once and in
its supernodal variant (lap2d-256's L, n = 65,536: one activity and one
count a call, launches on two streams, the handle build's prepass; and
called directly on the CPU tests' triangles, `snode_patterns`); and
the solvers that run the sweep (the single-RHS solves, lusol, cholsol,
cholsol_serve, qrsol, the batched and serving drivers cholsol_multi,
lusol_multi, qrsol_multi, qrsol_serve and cholsol_ir, and the
batched-values drivers cholsol_vals, lusol_vals and qrsol_vals) on the card
against their CPU runs; the general operators on the card (spmv_general on
the SpMM kernel at B = 1, spgemm_general, spmv_csc, ops.chain), the
kernels' sanitize mode, and the distributed layer on a one-rank NCCL mesh
(the halo and replicated sweeps, dist_cholsol_vals).

This file imports neither jax nor the JAX package (its inputs come from
`torch_cases`, numpy and the port only), so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

The `gpu` tests skip without a card. The CPU tests hold the plain versions
(the wrappers' path for CPU tensors) to dense numpy products and solves.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402  (numpy and the port only)
from rsparse_tpu_torch.ops import spmv as spmv_mod  # noqa: E402
from rsparse_tpu_torch.ops.spmm_cuda import (  # noqa: E402
    spmm_csr, spmm_fn, spmm_plain, spmm_plan)
from rsparse_tpu_torch.ops.sptrsv_cuda import (  # noqa: E402
    sptrsv_multi, sptrsv_plain_multi)
import snode_patterns  # noqa: E402  (numpy and the port only)


def _tri(kind, case="lap12"):
    """L (kinds 0/2) or U (kinds 1/3) of the host engine's LU of a 5-point
    Laplacian."""
    return C.port(C.host_tri(case, kind))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_plain_sweep_vs_dense_solve(kind, dtype, tol):
    t = _tri(kind, "lap8")
    D = t.to_dense_np()
    M = D if kind in (0, 1) else D.T
    B = np.random.default_rng(kind).standard_normal((t.n, 5))
    X = sptrsv_plain_multi(torch.as_tensor(t.x[: t.nnz()], dtype=dtype),
                           torch.as_tensor(B, dtype=dtype),
                           rt.tri_plan(t, kind), kind)
    want = torch.as_tensor(np.linalg.solve(M, B))
    assert C.rel(X, want) < tol


_SWEEP_CASES: dict = {}


def _sweep_case(name, kind):
    """The triangle and its plan for kind: "dense", L or U of the port's
    multifrontal LU of the case "unsym24" (a dense skeleton block of
    109 columns); "levels", the host engine's factor of `_tri` (no block);
    "large", chip_smoke.synthetic_triangle(70000, 96), whose n is too large
    for X's column in shared memory (the global-memory variant)."""
    key = (name, kind)
    if key not in _SWEEP_CASES:
        import chip_smoke

        if name == "dense":
            old, rt.config.mf_min_n = rt.config.mf_min_n, 100
            try:
                a = C.port("unsym24")
                s = rt.sqr(a, 1, False)
                nm = rt.lu(a, s, 1e-6, device="cpu")
                assert s._lu_route == "device_mf"
            finally:
                rt.config.mf_min_n = old
            t = nm.l if kind in (0, 2) else nm.u
            t = C.port(t)
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
    the sums from run to run; f64: rounding level. The L sweeps (kinds 0
    and 2) of the two LU factors, whose L has `snode`, take the supernodal
    variant at B >= 32 (but the `levels` L in float32: 2.1 levels a panel
    of its panel tree's height, under SNODE_LEVELS), the rest the shared
    one (X's column fits); the large triangle, which has no `snode`, the
    global one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    t, plan = _sweep_case(case, kind)
    assert (plan.dense is not None) == (case != "levels")
    snode = case != "large" and kind in (0, 2)
    assert (plan.snode is not None) == snode
    short = case == "dense" or dtype == torch.float64
    cfg = launch_config(plan, dtype, "cuda", kind, B)
    assert cfg["variant"] == (
        "global" if case == "large" else
        "supernodal" if snode and short and B >= 32 else "shared")
    tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((t.n, B)),
                        dtype=dtype, device="cuda")
    before = sptrsv_multi.launches
    got = sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    assert sptrsv_multi.launches == before + 1
    assert got.shape == X.shape and got.is_contiguous()
    assert C.rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol


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
    assert C.rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol
    for k in sorted({0, K // 2, K - 1}):
        one = sptrsv_multi(tx[k].contiguous(), X[k], plan, kind)
        assert C.rel(got[k], one) < tol


_SNODE: dict = {}


def _snode_case():
    """lap2d-256's L: the host engine's Cholesky factor of the 256 x 256
    5-point Laplacian in AMD order (n = 65,536), and its kind 0 and 2
    plans, whose sweeps at B >= 32 take the supernodal variant."""
    if not _SNODE:
        L = snode_patterns.chol(C.port(C.laplacian(256)), 1)
        _SNODE.update(L=L, plans={k: rt.tri_plan(L, k) for k in (0, 2)})
    return _SNODE["L"], _SNODE["plans"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [128, 40])
def test_snode_kernel_chain_matches_plain_on_card(dtype, tol, B):
    """The supernodal variant at n = 65,536: an L then L' chain of two
    launches against the level loop's chain (f32: atomics reorder the
    sums; f64: rounding level)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    L, plans = _snode_case()
    for kind, plan in plans.items():
        cfg = launch_config(plan, dtype, "cuda", kind, B)
        assert cfg["variant"] == "supernodal"
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((L.n, B)),
                        dtype=dtype, device="cuda")
    got = sptrsv_multi(tx, sptrsv_multi(tx, X, plans[0], 0), plans[2], 2)
    want = sptrsv_plain_multi(tx, sptrsv_plain_multi(tx, X, plans[0], 0),
                              plans[2], 2)
    torch.cuda.synchronize()
    assert got.shape == X.shape and got.is_contiguous()
    assert C.rel(got, want) < tol


@pytest.mark.gpu
def test_snode_kernel_one_activity_per_call_on_card():
    """Under the profiler each supernodal sweep is exactly one device
    activity whose name has `sweep_kernel` in it (the benchmark matches
    them with the launch counter): no helper kernel, no counter reset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    L, plans = _snode_case()
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=torch.float32, device="cuda")
    X = torch.randn((L.n, 128), dtype=torch.float32, device="cuda")
    for kind, plan in plans.items():  # warm: the build and the prepass
        sptrsv_multi(tx, X, plan, kind)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for kind, plan in plans.items():
            sptrsv_multi(tx, X, plan, kind)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda]
    sweeps = [nm for nm in names if "sweep_kernel" in nm]
    assert len(sweeps) == 2 and all("snode_sweep_kernel" in nm
                                    for nm in sweeps), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [32, 40, 130])
@pytest.mark.parametrize("kind", [0, 2])
@pytest.mark.parametrize("name", snode_patterns.PATTERNS)
def test_snode_kernel_matches_plain_on_patterns_on_card(name, kind, B, dtype,
                                                        tol):
    """The supernodal variant called directly on each triangle of the CPU
    tests (small tasks, so that each has bottom subtrees, panels above them
    and, in the wide root and the Laplacians, parted groups), three launches
    back to back on one plan's counters (epochs 0-2), each against the level
    loop (f32: atomics reorder the sums; f64: rounding level)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import _sweep_snode

    L = snode_patterns.triangle(name)
    plan = snode_patterns.plan(L, kind)
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=dtype, device="cuda")
    rng = np.random.default_rng(B + kind)
    Xs = [torch.as_tensor(rng.standard_normal((L.n, B)), dtype=dtype,
                          device="cuda") for _ in range(3)]
    gots = [_sweep_snode(tx, X, plan, kind) for X in Xs]
    torch.cuda.synchronize()
    for X, got in zip(Xs, gots):
        assert got.shape == X.shape and got.is_contiguous()
        assert C.rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < tol


@pytest.mark.gpu
def test_snode_kernel_launches_on_two_streams_on_card():
    """Supernodal launches on one plan from two streams, with no wait
    between them in the caller, run one after another (the wrapper's
    event): each answer is the level loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    L, plans = _snode_case()
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=torch.float32, device="cuda")
    Xs = [torch.randn((L.n, 128), dtype=torch.float32, device="cuda")
          for _ in range(4)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for kind, plan in plans.items():
        gots = []
        for k, X in enumerate(Xs):
            with torch.cuda.stream(streams[k % 2]):
                gots.append(sptrsv_multi(tx, X, plan, kind))
        torch.cuda.synchronize()
        for X, got in zip(Xs, gots):
            want = sptrsv_plain_multi(tx, X, plan, kind)
            assert C.rel(got, want) < 1e-4


@pytest.mark.gpu
def test_snode_prepare_makes_the_first_sweeps_work_on_card():
    """`prepare` (the serve handles' build) makes a supernodal sweep's
    schedule, streams and value prepass, which the first sweep then
    finds, and not the dense block, which it does not use, also where X's
    column fits in shared memory (an LU factor's L); a sweep that keeps
    another variant (that factor's U) gets nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops import sptrsv_cuda

    L, _ = _snode_case()
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=torch.float32, device="cuda")
    for kind in (0, 2):
        plan = rt.tri_plan(L, kind)
        sptrsv_cuda.prepare(tx, plan, kind)
        assert "snode" in plan.__dict__ and "dense" not in plan.__dict__
        ks = sptrsv_cuda._snode_streams(plan, kind, tx.device)
        val = ks["values"][2]
        assert ks["values"][0] is tx
        X = torch.randn((L.n, 32), dtype=torch.float32, device="cuda")
        got = sptrsv_multi(tx, X, plan, kind)
        assert ks["values"][2] is val
        torch.cuda.synchronize()
        assert C.rel(got, sptrsv_plain_multi(tx, X, plan, kind)) < 1e-4
    for kind in (0, 1):  # fresh plans: the supernodal, the shared variant
        t, _ = _sweep_case("dense", kind)
        plan = rt.tri_plan(t, kind)
        tx = torch.as_tensor(t.x[: t.nnz()], dtype=torch.float32,
                             device="cuda")
        sptrsv_cuda.prepare(tx, plan, kind)
        assert ("snode" in plan.__dict__) == (kind == 0)
        assert ("dense" in plan.__dict__) == (kind == 1)


@pytest.mark.gpu
def test_snode_counter_counts_each_call_on_card():
    """`sptrsv_multi.supernodal` counts each supernodal launch, each also
    one of `sptrsv_multi.launches`; a sweep on another variant adds to
    `launches` alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    L, plans = _snode_case()
    tx = torch.as_tensor(L.x[: L.nnz()], dtype=torch.float32, device="cuda")
    before = (sptrsv_multi.launches, sptrsv_multi.supernodal)
    for B in (32, 128, 130):
        X = torch.randn((L.n, B), dtype=torch.float32, device="cuda")
        for kind, plan in plans.items():
            sptrsv_multi(tx, X, plan, kind)
    sptrsv_multi(tx, torch.randn((L.n, 8), dtype=torch.float32,
                                 device="cuda"), plans[0], 0)  # global
    torch.cuda.synchronize()
    assert sptrsv_multi.supernodal == before[1] + 6
    assert sptrsv_multi.launches == before[0] + 7


@pytest.mark.gpu
def test_serve_handle_on_card():
    """lusol_serve on the card answers with the kernel in its sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = C.port("lap20")
    B = np.random.default_rng(1).standard_normal((a.n, 64))
    before = sptrsv_multi.launches
    h = rt.lusol_serve(a, 1, 1e-6, device="cuda")
    X = h(B)
    assert X.device.type == "cuda" and sptrsv_multi.launches >= before + 4
    want = rt.lusol_serve(a, 1, 1e-6, device="cpu")(B)
    assert C.rel(X, want) < 1e-10


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
    a = C.port("lap20")
    B = np.random.default_rng(2).standard_normal((a.n, 3))
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
    d = C.dense("lap20")
    d[7, 7] = -4.0
    with pytest.raises(rt.NotPositiveDefiniteError):
        rt.cholsol(C.port(d), np.ones(len(d)), 1, device="cuda")
    d = np.eye(6) * 3.0
    d[:, 2] = 0.0
    d[2, 4] = 1.0
    with pytest.raises(rt.NoPivotError):
        rt.lusol(rt.Sprs.new_from_vec(d), [1.0] * 6, 1, 1e-6, device="cuda")


def _banded(n, seed, far):
    return C.port(C.laplacian_stray(n, seed, far))


@pytest.mark.parametrize("B", [1, 8, 40, 128])
def test_plain_spmm_vs_dense(B):
    a = C.port(C.rand_pattern(70, 50, 300, B))
    plan = spmm_plan(a)
    X = np.random.default_rng(B).standard_normal((50, B))
    R = spmm_plain(torch.as_tensor(a.x[: a.nnz()]), torch.as_tensor(X), plan)
    assert C.rel(R, torch.as_tensor(a.to_dense_np() @ X)) < 1e-13


@pytest.mark.parametrize("far", [0, 7])
def test_plain_dia_vs_dense(far):
    a = _banded(144, far, far)
    plan = spmv_mod.dia_plan(a, max_diags=5, dtype=np.float64)
    assert (plan.rem_vals is not None) == (far > 0)
    x = np.random.default_rng(far).standard_normal(a.n)
    r = spmv_mod.spmv_fn(plan)(torch.as_tensor(plan.dia), torch.as_tensor(x))
    assert C.rel(r, torch.as_tensor(a.to_dense_np() @ x)) < 1e-13


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
    a = C.port(C.rand_pattern(m, n, nnz, B)) if nnz else rt.Sprs.zeros(m, n, 0)
    plan = spmm_plan(a)
    vals = torch.as_tensor(a.x[: a.nnz()], dtype=dtype, device="cuda")
    X = torch.as_tensor(np.random.default_rng(B).standard_normal((n, B)),
                        dtype=dtype, device="cuda")
    before = spmm_csr.launches
    got = spmm_fn(plan)(vals, X)
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + 1
    assert tuple(got.shape) == (m, B) and got.dtype == dtype
    assert C.rel(got, spmm_plain(vals, X, plan)) < tol


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
    wide = C.port(C.rand_pattern(600, 600, 6000, far))
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
        assert C.rel(diag, spmv_mod.dia_spmv_plain(dia, x, plan)) < tol
        # with the remainder: against the whole CPU path on the same inputs
        assert C.rel(full, spmv_mod.spmv_fn(plan)(dia.cpu(), x.cpu())) < tol


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
    assert C.rel(R, torch.as_tensor(a.to_dense_np() @ X + 1.0)) < 1e-12
    before = spmv_mod.dia_spmv.launches
    r = spmv_mod.spmv(a, X[:, 0], device="cuda")
    assert spmv_mod.dia_spmv.launches == before + 1
    assert C.rel(r, torch.as_tensor(a.to_dense_np() @ X[:, 0])) < 1e-5


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
    a = {"random": lambda: C.port(C.rand_pattern(700, 500, 4000, B)),
         "empty_rows": lambda: C.port(C.rand_pattern(900, 300, 600, B)),
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
        assert C.rel(got, want) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("case", ["lap20", "hpcg27", "unsym20"])
def test_spmm_residual_form_on_card(case, B):
    """The kernel's residual form R = S - A X (one launch) in float64 on a
    5-point, a 27-point and a nonsymmetric 5-point pattern: against its
    plain version, and bit for bit against S minus the plain kernel's
    product (the same sums in the same order, then one subtraction). At
    B = 128 also in float32 from an S whose base is not 16-byte aligned
    (scalar gathers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = C.port(C.hpcg27(6) if case == "hpcg27" else case)
    plan = spmm_plan(a)
    rng = np.random.default_rng(B)
    X = torch.as_tensor(rng.standard_normal((a.n, B)), device="cuda")
    S = torch.as_tensor(rng.standard_normal((a.m, B)), device="cuda")
    vals = torch.as_tensor(a.x[: a.nnz()], device="cuda")
    vals_csr = vals[torch.as_tensor(plan.perm, device="cuda")]
    before = spmm_csr.launches
    got = spmm_csr(vals_csr, X, plan, sub=S)
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + 1
    assert tuple(got.shape) == (a.m, B) and got.dtype == torch.float64
    assert C.rel(got, spmm_plain(vals, X, plan, sub=S)) < 1e-12
    assert torch.equal(got, S - spmm_csr(vals_csr, X, plan))
    if B == 128:
        flat = S.new_zeros(a.m * B + 1, dtype=torch.float32)
        flat[1:] = S.reshape(-1)
        s32 = flat[1:].view(a.m, B)  # contiguous, base off by one value
        x32, v32 = X.float(), vals.float()
        got = spmm_csr(v32[torch.as_tensor(plan.perm, device="cuda")], x32,
                       plan, sub=s32)
        assert C.rel(got, spmm_plain(v32, x32, plan, sub=s32)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["cholsol_serve", "lusol_serve"])
def test_serve_residual_on_card(solver):
    """A serve handle on the card makes each refinement residual B - A X in
    one launch of the SpMM kernel's residual form: as many launches a
    request as half its sweeps and one fewer than its readbacks. Its X
    agrees with the handle's COO route on the CPU, and its final residual
    is under the refinement's threshold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch import solve

    a = C.port("lap20" if solver == "cholsol_serve" else "unsym20")
    make = {"cholsol_serve": lambda dev: rt.cholsol_serve(a, 1, device=dev),
            "lusol_serve": lambda dev: rt.lusol_serve(a, 1, 1e-6, device=dev)}
    h = make[solver]("cuda")
    B = np.random.default_rng(3).standard_normal((a.n, 128))
    counters = lambda: np.array([spmm_csr.launches, sptrsv_multi.launches,
                                 solve._amax.readbacks])
    for _ in range(2):
        before = counters()
        X = h(B)
        torch.cuda.synchronize()
        resid, sweeps, reads = counters() - before
        assert resid >= 2 and sweeps == 2 * resid and reads == resid + 1
    assert h.last_residual <= 1e-13 * max(1.0, np.abs(B).max())
    assert C.rel(X, make[solver]("cpu")(B)) < 1e-12


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
    assert C.rel(got, spmv_mod.dia_spmv_plain(dia, xt, plan)) < tol


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
        assert C.rel(spmv_mod.dia_spmv(dia, xt, plan), want) < 1e-5


def _qr_case(grid=24, seed=0):
    """chip_smoke's least-squares matrix [A5; 0.1 I] on a grid x grid mesh
    (n = grid², m = 2n) and its minimum-norm transpose."""
    a = C.port(C.grid_ls(grid, seed))
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
    assert C.rel(got, sptrsv_plain_multi(tx, X, tplan, kind)) < 1e-12


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
    a = C.port("lap12")
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
    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    monkeypatch.setattr(rt.config, "serve_mixed", "force")
    if driver.startswith("qrsol"):
        a = _qr_case(grid=12)[0]
    elif driver == "lusol_multi":
        a = C.port("unsym20")
    else:
        a = C.port("lap20")
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
    launch_config takes both Gram sweeps in float32 at one column."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch.ops.sptrsv_cuda import launch_config

    a, aw = _qr_case(grid=24)
    h = rt.qrsol_serve(a if branch == "ls" else aw, 2, device="cuda")
    fits = True
    for plan, v32, kind in h.chain:
        assert v32.dtype == torch.float32 and v32.device.type == "cuda"
        try:
            launch_config(plan, torch.float32, "cuda", kind, 1)
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
    monkeypatch.setattr(rt.config, "mf_min_n", mf_min_n)
    if case == "lap":
        a = C.port("lap20")
    elif case == "unsym":
        a = C.port("unsym20")
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(700, 500, 4000), (300, 900, 2500),
                                   (64, 64, 0)])
def test_spmv_general_matches_plain_on_card(shape, dtype, tol):
    """spmv_general at B = 1 through the SpMM kernel, one launch per call,
    against the kernel's plain version on the same inputs (rectangular
    shapes and an empty A included)."""
    from rsparse_tpu_torch.ops.spmv_general import (
        mxu_spmv_plan, spmv_general, spmv_general_fn)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n, nnz = shape
    a = C.port(C.rand_pattern(m, n, nnz, 3)) if nnz else rt.Sprs.zeros(m, n, 0)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    plan = mxu_spmv_plan(a, np_dt)
    x = np.random.default_rng(m).standard_normal(n)
    vals = torch.as_tensor(plan.vals, device="cuda")
    xt = torch.as_tensor(x, dtype=dtype, device="cuda")
    before = spmm_csr.launches
    got = spmv_general_fn(plan)(vals, xt)
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + (1 if m else 0)
    assert tuple(got.shape) == (m,) and got.dtype == dtype
    want = spmm_plain(torch.as_tensor(a.x[: a.nnz()], dtype=dtype, device="cuda"),
                      xt[:, None], plan.spmm)[:, 0]
    assert C.rel(got, want) < tol
    public = spmv_general(a, x, plan, device="cuda")
    assert public.device.type == "cuda" and torch.equal(public, got)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spmm", "sptrsv"])
def test_sanitize_rejects_a_corrupted_plan_on_card(monkeypatch, kernel):
    """Inside utils.sanitize a plan whose index stream points outside the
    matrix raises IndexError naming the kernel before the launch; the
    plain version is never run in its place. A good plan runs the kernel,
    synchronized, with the result it gives outside sanitize."""
    from rsparse_tpu_torch import utils
    from rsparse_tpu_torch.ops import spmm_cuda, sptrsv_cuda

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(spmm_cuda, "spmm_plain", no_plain)
    monkeypatch.setattr(sptrsv_cuda, "sptrsv_plain_multi", no_plain)
    monkeypatch.setattr(sptrsv_cuda, "_sweep_plain", no_plain)
    if kernel == "spmm":
        a = C.port(C.rand_pattern(400, 300, 2000, 1))
        X = torch.randn((300, 4), dtype=torch.float64, device="cuda")
        vals = torch.as_tensor(a.x[: a.nnz()], device="cuda")
        run = lambda plan: spmm_fn(plan)(vals, X)
        good = spmm_plan(a)
        bad = dataclasses.replace(good, col_idx=good.col_idx.copy())
        bad.col_idx[7] = 300  # a column outside A
        counter, name = spmm_csr, "SpMM kernel: col_idx"
    else:
        t = _tri(0, "lap8")
        X = torch.randn((t.n, 2), dtype=torch.float64, device="cuda")
        tx = torch.as_tensor(t.x[: t.nnz()], device="cuda")
        good, bad = rt.tri_plan(t, 0), rt.tri_plan(t, 0)
        levels = bad if bad.dense is None else bad.dense.rest
        levels.ent_row[0] = t.n + 3  # a row outside the triangle
        run = lambda plan: sptrsv_multi(tx, X, plan, 0)
        counter, name = sptrsv_multi, "SpTRSV kernel: edst"
    want = run(good)
    with utils.sanitize():
        before = counter.launches
        with pytest.raises(IndexError, match=name):
            run(bad)
        assert counter.launches == before
        got = run(good)
        assert counter.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_spgemm_general_on_card():
    """spgemm_general on the card: C's pattern and values as the CPU run's
    (float64 to 1e-12), float32 bit-equal across runs (no atomics)."""
    from rsparse_tpu_torch.ops.spgemm_general import (
        mxu_spgemm_plan, spgemm_general, spgemm_general_fn)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = C.port(C.rand_pattern(3000, 2500, 20_000, 4))
    b = C.port(C.rand_pattern(2500, 2800, 20_000, 5))
    for dtype, tol in (("float64", 1e-12), ("float32", 1e-5)):
        got = spgemm_general(a, b, dtype=dtype, device="cuda")
        want = spgemm_general(a, b, dtype=dtype, device="cpu")
        assert np.array_equal(got.p, want.p) and np.array_equal(got.i, want.i)
        err = np.abs(got.x - want.x).max() / max(1.0, np.abs(want.x).max())
        assert err <= tol
    f = spgemm_general_fn(mxu_spgemm_plan(a, b), "float32", device="cuda")
    ax = torch.as_tensor(a.x[: a.nnz()], device="cuda")
    bx = torch.as_tensor(b.x[: b.nnz()], device="cuda")
    first = f(ax, bx)
    assert all(torch.equal(first, f(ax, bx)) for _ in range(3))
    assert torch.equal(first, f.run(ax, bx, *f.consts))


@pytest.mark.gpu
def test_general_ops_on_card():
    """spmv_csc with its gradients, and a chain with either multiply
    kernel ("auto" takes "mxu" on a card), against their CPU runs."""
    from rsparse_tpu_torch.ops import chain
    from rsparse_tpu_torch.ops.device import spmv_csc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = C.port(C.rand_pattern(500, 400, 3000, 6))
    x = np.random.default_rng(7).standard_normal(400)
    grads = {}
    for dev in ("cpu", "cuda"):
        d = a.to_device(torch.float64, device=dev)
        ax = d.x.clone().requires_grad_()
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        r = spmv_csc(rt.CSCDevice(d.p, d.i, ax, d.m, d.n), xt)
        (r * r).sum().backward()
        grads[dev] = [t.detach().cpu() for t in (r, ax.grad, xt.grad)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert C.rel(got, want) < 1e-12
    e = chain(a).transpose().multiply(a).scale(2.0).add(rt.Sprs.eye(400), beta=0.5)
    want = e.run(multiply_kernel="esc", device="cpu")
    for kernel in ("auto", "mxu", "esc"):
        got = e.run(multiply_kernel=kernel, device="cuda")
        assert np.array_equal(got.p, want.p) and np.array_equal(got.i, want.i)
        assert np.abs(got.x - want.x).max() <= 1e-12 * max(1.0, np.abs(want.x).max())


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL mesh on the card (`make_mesh(device="cuda")`),
    its process group destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rsparse_tpu_torch import parallel as par

    yield par.make_mesh(device="cuda")
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_dist_tri_solve_halo_on_card(nccl_mesh, kind):
    """The halo sweep (prefetch on and off, bit-equal) and the replicated
    level sweep on a one-rank NCCL mesh against the single-process kernel
    sweep on the card."""
    from rsparse_tpu_torch import parallel as par
    from rsparse_tpu_torch.parallel import halo as H
    from rsparse_tpu_torch.solve import _tri_solve

    t = _tri(kind)
    b = np.random.default_rng(kind).standard_normal(t.n)
    want = _tri_solve(t, b, kind, device="cuda")
    on = H.dist_tri_solve_halo(t, b, kind, nccl_mesh, prefetch=True)
    off = H.dist_tri_solve_halo(t, b, kind, nccl_mesh, prefetch=False)
    rep = par.dist_tri_solve(t, b, kind, nccl_mesh)
    assert rep.device.type == "cuda"
    assert np.array_equal(on, off)
    for got in (on, rep.cpu().numpy()):
        assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
def test_dist_cholsol_vals_on_card(nccl_mesh, monkeypatch):
    """dist_cholsol_vals on a one-rank NCCL mesh (the multifrontal route,
    K = 5) against cholsol_vals on the card; an indefinite instance raises
    NotPositiveDefiniteError naming it."""
    from rsparse_tpu_torch import parallel as par

    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    a = C.port("lap20")
    n, x = a.n, a.x[: a.nnz()]
    K = 5
    diag = C.diag_mask(a)
    AxK = np.tile(x, (K, 1))
    AxK[:, diag] *= (1.0 + 0.2 * np.arange(K))[:, None]
    B = np.random.default_rng(13).standard_normal((K, n))
    s = rt.schol(a, 1)
    got = par.dist_cholsol_vals(a, AxK, B, nccl_mesh, 1, sym=s)
    assert s._vals_route == ("device_mf", 0)
    want = rt.cholsol_vals(a, AxK, B, 1, sym=s, device="cuda")
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    AxK[3, diag] *= -1.0
    with pytest.raises(rt.NotPositiveDefiniteError, match=r"\[3\]"):
        par.dist_cholsol_vals(a, AxK, B, nccl_mesh, 1, sym=s)


@pytest.mark.gpu
def test_dist_spgemm_on_card(nccl_mesh):
    """dist_spgemm and spgemm_general_dist on a one-rank NCCL mesh against
    spgemm_general on the card, and the per-rank value pass with the
    sorted product stream split as D = 3 ranks would split it (one range
    cut inside a run of products, one range empty): C's pattern equal,
    float64 to 1e-12."""
    from rsparse_tpu_torch import parallel as par
    from rsparse_tpu_torch.ops.spgemm_general import (
        _range_part, mxu_spgemm_plan, spgemm_general, spgemm_general_dist)

    a = C.port(C.rand_pattern(3000, 2500, 20_000, 4))
    b = C.port(C.rand_pattern(2500, 2800, 20_000, 5))
    want = spgemm_general(a, b, dtype="float64", device="cuda")
    tol = 1e-12 * max(1.0, np.abs(want.x).max())
    for got in (par.dist_spgemm(a, b, nccl_mesh),
                spgemm_general_dist(a, b, nccl_mesh, dtype="float64")):
        assert np.array_equal(got.p, want.p) and np.array_equal(got.i, want.i)
        assert np.abs(got.x - want.x).max() <= tol
    p = mxu_spgemm_plan(a, b)
    assert p is mxu_spgemm_plan(a, b)  # cached per pattern pair
    E = len(p.a_idx)
    j = int(np.argmax(p.lengths >= 2))
    assert p.lengths[j] >= 2
    cut = int(p.lengths[:j].sum()) + 1  # inside entry j's run of products
    ax = torch.as_tensor(a.x[: a.nnz()], device="cuda")
    bx = torch.as_tensor(b.x[: b.nnz()], device="cuda")
    parts = [_range_part(p, ax, bx, lo, hi, torch.float64, "cuda")
             for lo, hi in ((0, cut), (cut, E), (E, E))]
    assert not parts[2].any()
    got = sum(parts).cpu().numpy()
    assert np.abs(got - want.x).max() <= tol
