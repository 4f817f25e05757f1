"""Port parity, the distributed layer (`rsparse_tpu_torch.parallel`) at
D = 2 and D = 4 gloo ranks against the JAX package's `rsparse_tpu.parallel`
on the conftest's virtual CPU mesh of the same D, on seeded inputs built
in process (`torch_dist_ranks`).

The ranks of each D run as subprocesses (`torch_dist_ranks.Ranks`), and
so do the JAX package's answers (one process per D and part, on the
conftest's virtual mesh), all started once per module so that the JAX
compiles run beside each other; every rank must return the same results.
The plans are host objects, compared here field for field.

Tolerances: f64 results 1e-12 relative to the JAX package; the solves
(`refine_step`, `dist_cholsol`, the batched-values drivers) the JAX
tests' own (1e-9 / 1e-11 / 1e-10); float32 `spgemm_general_dist` 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu import parallel as jpar  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch import parallel as par  # noqa: E402
from rsparse_tpu_torch.symbolic import native  # noqa: E402
import torch_cases as C  # noqa: E402
import torch_dist_ranks as R  # noqa: E402

DS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(suite, D): processes}: the port's ranks and the JAX package's
    reference processes at each D, all started now, read on demand."""
    native.load()  # built once, before the ranks need it
    procs = {(s, D): R.Ranks(s, D, tmp_path_factory.mktemp(f"{s}{D}"))
             for s in ("jax_vals", "jax_parallel", "parallel") for D in DS}
    yield procs
    for p in procs.values():
        p.close()


def test_names():
    """Every public name of the JAX distributed layer has a counterpart."""
    from rsparse_tpu_torch.ops import spgemm_general

    missing = [k for k in jpar.__all__ if not hasattr(par, k)]
    assert not missing and set(jpar.__all__) <= set(par.__all__)
    assert hasattr(spgemm_general, "spgemm_general_dist")


@pytest.mark.parametrize("D", DS)
def test_partition_entries_fields(D):
    f = R.general(50, 50, 1, 300)
    je = jpar.partition_entries(C.jax(f), D)
    te = par.partition_entries(C.port(f), D)
    for k in ("vals", "rows", "cols", "chunk", "m", "n"):
        np.testing.assert_array_equal(getattr(te, k), getattr(je, k), k)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("D", DS)
def test_dist_tri_plan_fields(D, kind):
    f = R.spd(80, 3)
    jl = rs.chol(C.jax(f), rs.schol(C.jax(f), 0)).l
    jl.x = np.asarray(jl.x)
    jt = jl if kind in (0, 2) else rs.transpose(jl)
    tl = rt.chol(C.port(f), rt.schol(C.port(f), 0), device="cpu").l
    tt = tl if kind in (0, 2) else rt.transpose(tl, device="cpu")
    jp, tp = jpar.dist_tri_plan(jt, kind, D), par.dist_tri_plan(tt, kind, D)
    for k in ("n", "nlev", "wmax", "scatter_form"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), k)
    for k, v in R.dist_tri_tables(tp).items():
        np.testing.assert_array_equal(v, getattr(jp, k), k)


@pytest.mark.parametrize("D", DS)
def test_make_mesh_spans_every_rank(ranks, D):
    assert "process group has" in str(ranks["parallel", D].rank0("mesh_error"))


@pytest.mark.parametrize("D", DS)
def test_dist_gaxpy_and_norm(ranks, D):
    ref, port = ranks["jax_parallel", D], ranks["parallel", D]
    assert C.rel(port.rank0("gaxpy"), ref.rank0("gaxpy")) <= 1e-12
    assert C.rel(port.rank0("make_gaxpy"), ref.rank0("gaxpy")) <= 1e-12
    assert C.rel(port.rank0("make_gaxpy_copy"), ref.rank0("gaxpy")) <= 1e-12
    assert C.rel(port.rank0("norm"), ref.rank0("norm")) <= 1e-12


@pytest.mark.parametrize("case", ["sq", "rect"])
@pytest.mark.parametrize("D", DS)
def test_dist_spgemm(ranks, D, case):
    """dist_spgemm (f64) and spgemm_general_dist (f64 and f32): C's
    pattern equal to the JAX package's, values to 1e-12 / 1e-5."""
    ref, port = ranks["jax_parallel", D], ranks["parallel", D]
    for name, tol in ((f"spgemm_{case}", 1e-12),
                      (f"sgd_{case}_float64", 1e-12),
                      (f"sgd_{case}_float32", 1e-5)):
        for k in ("p", "i"):
            np.testing.assert_array_equal(port.rank0(f"{name}_{k}"),
                                          ref.rank0(f"{name}_{k}"))
        assert C.rel(port.rank0(f"{name}_x"), ref.rank0(f"{name}_x")) <= tol


@pytest.mark.parametrize("D", DS)
def test_dist_tri_solve(ranks, D):
    """The replicated level sweep, kinds 0-3, to 1e-12; dist_cholsol to
    the JAX tests' 1e-11."""
    ref, port = ranks["jax_parallel", D], ranks["parallel", D]
    for kind in range(4):
        assert C.rel(port.rank0(f"tri{kind}"), ref.rank0(f"tri{kind}")) \
            <= 1e-12, kind
    np.testing.assert_allclose(port.rank0("cholsol"), ref.rank0("cholsol"),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("D", DS)
def test_refine_step(ranks, D):
    """One step from X = 0 on the natural-order factor is the exact solve
    (and equals the JAX package's step); one from a perturbed X shrinks
    its error by 1e6, as the JAX package's tests ask."""
    a = C.port(R.spd(80, 3))
    port = ranks["parallel", D]
    B = np.random.default_rng(2).standard_normal((4, 80))
    X1 = port.rank0("refine0")
    np.testing.assert_allclose(X1, ranks["jax_parallel", D].rank0("refine0"),
                               rtol=1e-9, atol=1e-9)
    exact = np.linalg.solve(a.to_dense_np(), B.T).T
    np.testing.assert_allclose(X1, exact, rtol=1e-9, atol=1e-9)
    X0 = exact + 1e-3 * np.random.default_rng(3).standard_normal(B.shape)
    err0 = np.abs(X0 - exact).max()
    assert np.abs(port.rank0("refine1") - exact).max() < err0 * 1e-6


@pytest.mark.parametrize("what", ["chol_vals", "lu_vals", "qr_vals_ls",
                                  "qr_vals_mn"])
@pytest.mark.parametrize("D", DS)
def test_dist_vals(ranks, D, what):
    """Instances split over the data axis (K = D + 3: padded with copies of
    instance 0), each rank on the port's batched-values core (the
    multifrontal route), to the JAX tests' 1e-10."""
    port = ranks["parallel", D]
    np.testing.assert_allclose(port.rank0(what),
                               ranks["jax_vals", D].rank0(what),
                               rtol=1e-10, atol=1e-10)
    if what == "chol_vals":
        assert "device_mf" in str(port.rank0("chol_vals_route"))


@pytest.mark.parametrize("D", DS)
def test_dist_cholsol_vals_npd_on_one_rank(ranks, D):
    """An indefinite instance held by the last rank only: every rank
    raises NotPositiveDefiniteError naming its global index, as the JAX
    package does at D = 4 (no rank is left waiting in the all-gather)."""
    K = R.vals_case(D, 6)["K"]
    msg = str(ranks["parallel", D].rank0("chol_vals_npd"))
    assert f"instances [{K - 1}] are not positive definite" in msg
    if D == 4:
        assert str(ranks["jax_vals", D].rank0("chol_vals_npd")) == msg


def test_dryrun_sequence_at_d4(ranks):
    """`__graft_entry__.dryrun_multichip`'s sequence at D = 4 (refine step
    on the (2, 2) mesh, halo SpMV, dist_spgemm, dist_lusol,
    dist_cholsol_vals on the (4, 1) mesh), its checks made on every rank,
    with a seeded SPD matrix in place of its asset."""
    assert bool(ranks["parallel", 4].rank0("dryrun_ok"))


@pytest.mark.parametrize("D", DS)
def test_ranks_made_collectives(ranks, D):
    """Every rank made the same all-reduces and all-gathers (and no jax
    import: a rank asserts it before writing its results)."""
    n_reduce, n_gather, _ = ranks["parallel", D].rank0("comm")
    assert n_reduce > 0 and n_gather > 0
