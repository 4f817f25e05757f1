"""Port parity, the halo layer (`rsparse_tpu_torch.parallel.halo`: x
sharded n/D, entries by row block, ring exchanges of boundary shards) at
D = 2 and D = 4 gloo ranks against the JAX package's
`rsparse_tpu.parallel.halo` on the conftest's virtual CPU mesh of the same
D, on seeded inputs built in process (`torch_dist_ranks`).

The ranks of each D run as subprocesses, and so do the JAX package's
answers (one process per D, on the conftest's virtual mesh), all started
once per module; every rank must return the same results. The
partitions and plans are host objects, compared here field for field
(the halo plan with its level blocks and the prefetch path's F and flo).

Tolerances: f64 results 1e-12 relative to the JAX package; the solvers
the JAX tests' own (1e-8); prefetch on and off bit-equal.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu.parallel import halo as JH  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.parallel import halo as H  # noqa: E402
from rsparse_tpu_torch.symbolic import native  # noqa: E402
import torch_cases as C  # noqa: E402
import torch_dist_ranks as R  # noqa: E402

DS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(suite, D): processes}: the port's ranks and the JAX package's
    reference process at each D, all started now, read on demand."""
    native.load()  # built once, before the ranks need it
    procs = {(s, D): R.Ranks(s, D, tmp_path_factory.mktemp(f"{s}{D}"))
             for s in ("jax_halo", "halo") for D in DS}
    yield procs
    for p in procs.values():
        p.close()


@functools.lru_cache(maxsize=None)
def _tris(name):
    """(JAX L, JAX U, port L, port U) of a test case: "chol", the Cholesky
    factor of a 12 x 12 Laplacian (AMD) and its transpose; "band", the
    banded lower triangle with cross-shard reach."""
    if name == "chol":
        f = C.laplacian(12)
        jl = rs.chol(C.jax(f), rs.schol(C.jax(f), 0)).l
        tl = rt.chol(C.port(f), rt.schol(
            C.port(f), 0), device="cpu").l
    else:
        f = R.banded_lower(96, 3)
        jl, tl = C.jax(f), C.port(f)
    jl.x = np.asarray(jl.x)
    return jl, rs.transpose(jl), tl, rt.transpose(tl, device="cpu")


def test_names():
    missing = [k for k in JH.__all__ if not hasattr(H, k)]
    assert not missing and set(JH.__all__) <= set(H.__all__)


@pytest.mark.parametrize("case", ["lap", "gen"])
@pytest.mark.parametrize("D", DS)
def test_partition_rows_fields(D, case):
    f = C.laplacian(16) if case == "lap" else R.general(90, 90, 4, 400)
    jp = JH.partition_rows(C.jax(f), D)
    tp = H.partition_rows(C.port(f), D)
    for k in ("m", "n", "d", "nb", "hops", "chunk", "vals", "rows", "cols",
              "perm"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), k)
    if case == "lap":
        assert tp.hops == 1


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["chol", "band"])
@pytest.mark.parametrize("D", DS)
def test_halo_tri_plan_fields(D, case, kind):
    """Every field of the JAX package's plan, its level blocks, and its
    `_block_tables`' F and flo (the fresh-patch bounds)."""
    jl, ju, tl, tu = _tris(case)
    jt, tt = (jl, tl) if kind in (0, 2) else (ju, tu)
    jp, tp = JH.halo_tri_plan(jt, kind, D), H.halo_tri_plan(tt, kind, D)
    for k in ("n", "d", "nb", "hops", "nlev", "kfuse", "nblocks", "wmax",
              "emax", "scatter_form"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), k)
    for k, v in R.halo_tables(tp).items():
        np.testing.assert_array_equal(v, getattr(jp, k), k)
    np.testing.assert_array_equal(tp.blocks, jp.__dict__["_blocks"])
    flo, F = H._block_tables(tp)
    jb = JH._block_tables(jp)
    assert F == jb[-1]
    np.testing.assert_array_equal(flo, np.asarray(jb[-2]))


@pytest.mark.parametrize("case", ["lap", "gen"])
@pytest.mark.parametrize("D", DS)
def test_dist_gaxpy_halo(ranks, D, case):
    got = ranks["halo", D].rank0(f"gaxpy_{case}")
    assert C.rel(got, ranks["jax_halo", D].rank0(f"gaxpy_{case}")) <= 1e-12


@pytest.mark.parametrize("case", ["chol", "band"])
@pytest.mark.parametrize("D", DS)
def test_dist_tri_solve_halo(ranks, D, case):
    """Kinds 0-3 (the banded triangle: 0 and 2) against the JAX package's
    halo solve; prefetch on and off bit-equal (the same snapshots reach
    every block)."""
    port, ref = ranks["halo", D], ranks["jax_halo", D]
    for kind in (range(4) if case == "chol" else (0, 2)):
        got = port.rank0(f"tri_{case}{kind}_True")
        np.testing.assert_array_equal(
            got, port.rank0(f"tri_{case}{kind}_False"))
        assert C.rel(got, ref.rank0(f"tri_{case}{kind}")) <= 1e-12, kind


@pytest.mark.parametrize("D", DS)
def test_replicated_route_without_a_halo_plan(ranks, D):
    """With no halo plan the solve takes the replicated route (the JAX
    package's `dist_tri_solve`), and the route counter says so."""
    port = ranks["halo", D]
    assert C.rel(port.rank0("tri_replicated"),
                ranks["jax_halo", D].rank0("tri_replicated")) <= 1e-12
    np.testing.assert_array_equal(port.rank0("routes"), [0, 1])


@pytest.mark.parametrize("D", DS)
def test_dist_lusol(ranks, D):
    """dist_lusol on a random matrix (level route) and on the JAX tests'
    pivot-requiring matrix (multifrontal route, mf_min_n = 100), against
    the JAX package and the residual (1e-8)."""
    b = np.random.default_rng(1).standard_normal(150)
    port, ref = ranks["halo", D], ranks["jax_halo", D]
    for name, f in (("lusol", R.general(120, 120, 5, 600)),
                    ("lusol_mf", R.crossing(150, 0))):
        got, n = port.rank0(name), f[1]
        assert np.abs(got - ref.rank0(name)).max() < 1e-8, name
        assert np.abs(C.jax(f).to_dense_np() @ got - b[:n]).max() < 1e-8, name


@pytest.mark.parametrize("branch", ["ls", "mn"])
@pytest.mark.parametrize("D", DS)
def test_dist_qrsol(ranks, D, branch):
    """CSNE with 2 refinement steps, both branches, against the JAX
    package and the dense least-squares / minimum-norm answer (1e-8)."""
    d = C.jax(R.general(80, 50, 8, 300)).to_dense_np()
    bq = np.random.default_rng(2).standard_normal(80)
    if branch == "mn":
        d, bq = d.T, bq[:50]
    got = ranks["halo", D].rank0(f"qrsol_{branch}")
    assert np.abs(got - ranks["jax_halo", D].rank0(f"qrsol_{branch}")).max() \
        < 1e-8
    ref = (np.linalg.lstsq(d, bq, rcond=None)[0] if branch == "ls"
           else np.linalg.pinv(d) @ bq)
    assert np.abs(got - ref).max() < 1e-8
