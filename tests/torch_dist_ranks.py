"""Rank processes for the distributed port's CPU tests.

`tests/test_torch_parallel.py` and `tests/test_torch_halo.py` hold the
port's distributed layer (`rsparse_tpu_torch.parallel`) at D = 2 and D = 4
gloo ranks against the JAX package on a virtual mesh of the same D. The
ranks run here, one process each, joined through a `FileStore` (no ports),
with a 60 s group timeout:

    python tests/torch_dist_ranks.py <suite> <D> <rank> <store> <out_dir>

Each rank runs its suite's calls on the seeded inputs below (numpy only)
and writes its results to <out_dir>/rank<rank>.npz. The rank processes
import torch and the port, never jax (checked before the results are
written). The JAX package's answers to the same calls come from one
process per D and suite ("jax_parallel", "jax_vals", "jax_halo", rank
0, no store) on the conftest's virtual 8-device CPU mesh, so that its
compiles run beside each other and beside the ranks. `Ranks` starts and
collects either kind; a process that fails, or outlives its time limit,
fails the test with the processes' stderr. Nothing here sleeps or polls:
the first test to read a suite's results waits in `Popen.wait` for its
processes, and for a JAX suite that wait is the JAX package compiling
each call for its mesh (the longest process of a D by far; the port's
ranks take a few seconds).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

import torch_cases as C

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GROUP_TIMEOUT_S = 60
LAUNCH_TIMEOUT_S = 150


# ---------------------------------------------------------------------------
# The JAX package's padded plan tables, from the port's flat windows
# ---------------------------------------------------------------------------


def padded(off: np.ndarray, vals: np.ndarray, rows: int, width: int,
           fill) -> np.ndarray:
    """[rows, width] int32: row r holds vals[off[r]:off[r+1]], then fill."""
    out = np.full((rows, width), fill, dtype=np.int32)
    cnt = np.diff(off)
    r = np.repeat(np.arange(rows), cnt)
    out[r, np.arange(len(vals)) - np.repeat(off[:-1], cnt)] = vals
    return out


def dist_tri_tables(p) -> dict:
    """A port `DistTriPlan`'s level windows as the JAX package's fields:
    `ent_val_idx`, `ent_row`, `ent_col`, `ent_slot` [D, nlev, chunk] (each
    window padded to D*chunk, rank k's slice k), `col_id`, `col_diag`
    [nlev, wmax]; pads -1 / 0 / n."""
    t = p.tri

    def ent(field, fill):
        pad = padded(t.ent_off, getattr(t, field), p.nlev, p.d * p.chunk,
                     fill)
        return np.transpose(pad.reshape(p.nlev, p.d, p.chunk), (1, 0, 2))

    return {"ent_val_idx": ent("ent_pos", -1), "ent_row": ent("ent_row", 0),
            "ent_col": ent("ent_col", 0), "ent_slot": ent("ent_slot", 0),
            "col_id": padded(t.col_off, t.col_id, p.nlev, p.wmax, p.n),
            "col_diag": padded(t.col_off, t.col_diag, p.nlev, p.wmax, -1)}


def halo_tables(p) -> dict:
    """A port `HaloTriPlan`'s (rank, level) windows as the JAX package's
    fields: `col_loc`, `col_diag` [d, nlev, wmax]; `ent_pos`, `ent_row`,
    `ent_col`, `ent_div` [d, nlev, emax]; pads nb / -1 / -1 / nb / 0 / -1."""
    def tab(off, vals, width, fill):
        return padded(off, vals, p.d * p.nlev, width, fill).reshape(
            p.d, p.nlev, width)

    return {"col_loc": tab(p.c_off, p.c_loc, p.wmax, p.nb),
            "col_diag": tab(p.c_off, p.c_diag, p.wmax, -1),
            "ent_pos": tab(p.e_off, p.e_pos, p.emax, -1),
            "ent_row": tab(p.e_off, p.e_row, p.emax, p.nb),
            "ent_col": tab(p.e_off, p.e_col, p.emax, 0),
            "ent_div": tab(p.e_off, p.e_div, p.emax, -1)}


# ---------------------------------------------------------------------------
# Seeded inputs (numpy fields: (m, n, p, i, x); the Laplacians are
# torch_cases.laplacian's)
# ---------------------------------------------------------------------------


def spd(n: int, seed: int, extra: int = 3):
    """A sparse SPD matrix: a random symmetric pattern with `extra`
    off-diagonal pairs per row on average, diagonally dominant."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n))
    k = extra * n
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    v = rng.standard_normal(k)
    d[r, c] += v
    d[c, r] += v
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, np.abs(d).sum(1) + 1.0 + rng.random(n))
    return C.csc(d)


def general(m: int, n: int, seed: int, nnz: int):
    """A random sparse m x n matrix with a strong diagonal."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n))
    k = min(m, n)
    d[np.arange(k), np.arange(k)] = 5.0 + rng.random(k)
    d[rng.integers(0, m, nnz), rng.integers(0, n, nnz)] += \
        rng.standard_normal(nnz)
    return C.csc(d)


def banded_lower(n: int, seed: int):
    """The JAX halo tests' banded lower triangle with cross-shard reach
    (offsets 1, 2, 7, 13), diagonal 4."""
    rng = np.random.default_rng(seed)
    d = np.eye(n) * 4.0
    for off in (1, 2, 7, 13):
        idx = np.arange(n - off)
        d[idx + off, idx] = rng.standard_normal(n - off)
    return C.csc(d)


def crossing(m: int, seed: int):
    """The JAX halo tests' pivot-requiring matrix: density 0.06, a tiny
    diagonal (the multifrontal LU's elimination labels cross fronts)."""
    rng = np.random.default_rng(seed)
    d = (rng.random((m, m)) < 0.06) * rng.standard_normal((m, m))
    np.fill_diagonal(d, d.diagonal() + 0.01 * rng.random(m))
    return C.csc(d)


def vals_case(D: int, seed: int):
    """The batched-values inputs: a 10 x 10 Laplacian (the multifrontal
    tier with mf_min_n = 64), K = D + 3 instances (a batch that does not
    split evenly), diagonals scaled by 1 + 0.2k, B [K, n]; the LU case's
    values nonsymmetric with one pivot-requiring instance; a 90 x 70
    least-squares matrix and a 70 x 90 minimum-norm one for the QR
    cases, their values scaled by 1 + 0.3k."""
    rng = np.random.default_rng(seed)
    m, n, p, i, x = C.laplacian(10)
    K = D + 3
    diag = i == np.repeat(np.arange(n), np.diff(p))
    chol = np.tile(x, (K, 1))
    chol[:, diag] *= (1.0 + 0.2 * np.arange(K))[:, None]
    lu = np.tile(x + 0.3 * rng.standard_normal(len(x)), (K, 1))
    lu[:, diag] += (2.0 + 0.5 * np.arange(K))[:, None]
    lu[K - 2, np.nonzero(diag)[0][3]] = 0.0
    scale = (1.0 + 0.3 * np.arange(K))[:, None]
    qa, qw = general(90, 70, seed + 1, 500), general(70, 90, seed + 2, 500)
    return dict(a=(m, n, p, i, x), diag=diag, K=K, chol=chol, lu=lu,
                B=rng.standard_normal((K, n)), qa=qa, qr=qa[4] * scale,
                qw=qw, qrw=qw[4] * scale, Bq=rng.standard_normal((K, 90)),
                Bw=rng.standard_normal((K, 70)))


def refine_data(D: int) -> int:
    """The refinement step's data-axis size: the batch over 2 ranks and
    the entries over 2 at D = 4, the entries over both at D = 2."""
    return 2 if D == 4 else 1


def dryrun_case():
    """`__graft_entry__.dryrun_multichip`'s inputs with a seeded SPD
    matrix in place of its asset."""
    rng = np.random.default_rng(0)
    a = spd(60, 11)
    return dict(a=a, B=rng.standard_normal((4, 60)), lap=C.laplacian(16),
                x=rng.standard_normal(256), bl=rng.standard_normal(256),
                Bv=rng.standard_normal((5, 256)))


# ---------------------------------------------------------------------------
# The suites (run on every rank)
# ---------------------------------------------------------------------------


def suite_parallel(D: int) -> dict:
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import parallel as par
    from rsparse_tpu_torch.ops.spgemm_general import spgemm_general_dist

    out = {}
    mesh = par.make_mesh(D, data=1, device="cpu")
    try:
        par.make_mesh(D + 1, device="cpu")
    except ValueError as e:
        out["mesh_error"] = np.array(str(e))
    rng = np.random.default_rng(0)
    g = C.port(general(50, 50, 1, 300))
    x, y = rng.standard_normal(50), rng.standard_normal(50)
    ep = par.partition_entries(g, D)
    out["gaxpy"] = par.dist_gaxpy(ep, x, y, mesh).numpy()
    f = par.make_gaxpy(ep, mesh)
    out["make_gaxpy"] = f(ep.vals, ep.rows, ep.cols, x, y).numpy()
    # arrays other than ep's own: uploaded by the call, not read from its cache
    out["make_gaxpy_copy"] = f(ep.vals, ep.rows.copy(), ep.cols.copy(), x,
                               y).numpy()
    out["norm"] = np.array(par.dist_norm(ep, mesh))
    r = C.port(general(40, 30, 2, 150))
    rt_ = rt.transpose(r, device="cpu")
    for name, (u, v) in {"sq": (g, g), "rect": (rt_, r)}.items():
        c = par.dist_spgemm(u, v, mesh)
        out[f"spgemm_{name}_p"], out[f"spgemm_{name}_i"] = c.p, c.i[: c.nnz()]
        out[f"spgemm_{name}_x"] = c.x[: c.nnz()]
        for dt in ("float32", "float64"):
            c = spgemm_general_dist(u, v, mesh, dtype=dt)
            out[f"sgd_{name}_{dt}_p"] = c.p
            out[f"sgd_{name}_{dt}_i"] = c.i[: c.nnz()]
            out[f"sgd_{name}_{dt}_x"] = c.x[: c.nnz()]
    a = C.port(spd(80, 3))
    s = rt.schol(a, 0)
    L = rt.chol(a, s, device="cpu").l
    U = rt.transpose(L, device="cpu")
    b = np.random.default_rng(1).standard_normal(80)
    for kind in range(4):
        t = L if kind in (0, 2) else U
        out[f"tri{kind}"] = par.dist_tri_solve(t, b, kind, mesh).numpy()
    out["cholsol"] = par.dist_cholsol(a, b, mesh, 0)
    # refine_step on the 2-D mesh, natural-order factor: one step from 0
    mesh2 = par.make_mesh(D, data=refine_data(D), device="cpu")
    L1 = rt.chol(a, rt.schol(a, -1), device="cpu").l
    B = np.random.default_rng(2).standard_normal((4, 80))
    out["refine0"] = par.refine_step(a, L1, np.zeros_like(B), B,
                                     mesh2).numpy()
    X0 = np.linalg.solve(a.to_dense_np(), B.T).T + 1e-3 * np.random.default_rng(
        3).standard_normal(B.shape)
    out["refine1"] = par.refine_step(a, L1, X0, B, mesh2).numpy()
    out.update(_vals(D))
    if D == 4:
        out.update(_dryrun(D))
    return out


def _vals(D: int) -> dict:
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import parallel as par

    out = {}
    v = vals_case(D, 6)
    a = C.port(v["a"])
    K = v["K"]
    mesh = par.make_mesh(D, data=D, device="cpu")
    rt.config.mf_min_n = 64
    s = rt.schol(a, 0)
    out["chol_vals"] = par.dist_cholsol_vals(a, v["chol"], v["B"], mesh, 0,
                                             sym=s)
    out["chol_vals_route"] = np.array(str(s._vals_route))
    bad = v["chol"].copy()
    bad[K - 1, v["diag"]] = -3.0
    try:
        par.dist_cholsol_vals(a, bad, v["B"], mesh, 0, sym=s)
    except rt.NotPositiveDefiniteError as e:
        out["chol_vals_npd"] = np.array(str(e))
    out["lu_vals"] = par.dist_lusol_vals(a, v["lu"], v["B"], mesh, 1, 1e-6,
                                         sym=rt.sqr(a, 1, False))
    qa = C.port(v["qa"])
    out["qr_vals_ls"] = par.dist_qrsol_vals(qa, v["qr"], v["Bq"], mesh, 2)
    out["qr_vals_mn"] = par.dist_qrsol_vals(C.port(v["qw"]), v["qrw"], v["Bw"],
                                            mesh, 2)
    rt.config.mf_min_n = 1500
    return out


def _dryrun(D: int) -> dict:
    """The dry run's sequence, its checks made on every rank."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import parallel as par
    from rsparse_tpu_torch.parallel.halo import (dist_gaxpy_halo, dist_lusol,
                                                 partition_rows)

    c = dryrun_case()
    mesh = par.make_mesh(D, data=2, device="cpu")
    a = C.port(c["a"])
    L = rt.chol(a, rt.schol(a, -1), device="cpu").l
    X1 = par.refine_step(a, L, np.zeros_like(c["B"]), c["B"], mesh).numpy()
    resid = np.abs(a.to_dense_np() @ X1.T - c["B"].T).max()
    assert resid < 1e-8, f"refine step residual {resid}"
    mesh1 = par.make_mesh(D, data=1, device="cpu")
    lap_ = C.port(c["lap"])
    dl = lap_.to_dense_np()
    r = dist_gaxpy_halo(partition_rows(lap_, D), c["x"], np.zeros(256), mesh1)
    assert np.abs(r - dl @ c["x"]).max() < 1e-8, "halo SpMV mismatch"
    cc = par.dist_spgemm(lap_, lap_, mesh1)
    assert np.abs(cc.to_dense_np() - dl @ dl).max() < 1e-8, "spgemm mismatch"
    xl = dist_lusol(lap_, c["bl"], mesh1, 1)
    assert np.abs(dl @ xl - c["bl"]).max() < 1e-8, "dist_lusol residual"
    meshd = par.make_mesh(D, data=D, device="cpu")
    nz = lap_.nnz()
    diag = lap_.i[:nz] == np.repeat(np.arange(256), np.diff(lap_.p))
    Kv = D + 1
    AxK = np.tile(lap_.x[:nz], (Kv, 1))
    AxK[:, diag] *= (1.0 + 0.25 * np.arange(Kv))[:, None]
    rt.config.mf_min_n = 64
    Xv = par.dist_cholsol_vals(lap_, AxK, c["Bv"], meshd, 0,
                               sym=rt.schol(lap_, 0))
    rt.config.mf_min_n = 1500
    for k in range(Kv):
        Ak = dl.copy()
        Ak[np.diag_indices(256)] *= 1.0 + 0.25 * k
        rv = np.abs(Ak @ Xv[k] - c["Bv"][k]).max()
        assert rv < 1e-8, f"dist_cholsol_vals instance {k} residual {rv}"
    return {"dryrun_ok": np.array(True)}


def suite_halo(D: int) -> dict:
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import parallel as par
    from rsparse_tpu_torch.parallel import halo as H

    out = {}
    mesh = par.make_mesh(D, data=1, device="cpu")
    rng = np.random.default_rng(0)
    lp = C.port(C.laplacian(16))
    x = rng.standard_normal(256)
    y = rng.standard_normal(256)
    out["gaxpy_lap"] = H.dist_gaxpy_halo(H.partition_rows(lp, D), x, y, mesh)
    g = C.port(general(90, 90, 4, 400))  # entries reach every shard
    out["gaxpy_gen"] = H.dist_gaxpy_halo(H.partition_rows(g, D), x[:90],
                                         y[:90], mesh)
    a = C.port(C.laplacian(12))
    L = rt.chol(a, rt.schol(a, 0), device="cpu").l
    U = rt.transpose(L, device="cpu")
    bt = C.port(banded_lower(96, 3))
    b = np.random.default_rng(1).standard_normal(150)
    for name, lo, up, kinds in (("chol", L, U, range(4)),
                                ("band", bt, None, (0, 2))):
        for kind in kinds:
            t = lo if kind in (0, 2) else up
            for pf in (True, False):
                out[f"tri_{name}{kind}_{pf}"] = H.dist_tri_solve_halo(
                    t, b[: t.n], kind, mesh, prefetch=pf)
    real = H.halo_tri_plan
    before = dict(H.dist_tri_solve_halo.routes)
    H.halo_tri_plan = lambda *args, **kw: None
    try:
        out["tri_replicated"] = H.dist_tri_solve_halo(L, b[:144], 0,
                                                      mesh).numpy()
    finally:
        H.halo_tri_plan = real
    out["routes"] = np.array([H.dist_tri_solve_halo.routes[k] - before[k]
                              for k in ("halo", "replicated")])
    lu_a = C.port(general(120, 120, 5, 600))
    out["lusol"] = H.dist_lusol(lu_a, b[:120], mesh, 1)
    rt.config.mf_min_n = 100
    out["lusol_mf"] = H.dist_lusol(C.port(crossing(150, 0)), b[:150], mesh, 1)
    rt.config.mf_min_n = 1500
    q = C.port(general(80, 50, 8, 300))
    bq = np.random.default_rng(2).standard_normal(80)
    out["qrsol_ls"] = H.dist_qrsol(q, bq, mesh, 0)
    out["qrsol_mn"] = H.dist_qrsol(rt.transpose(q, device="cpu"), bq[:50],
                                   mesh, 0)
    return out


# ---------------------------------------------------------------------------
# The JAX package's answers (one process per D and part, run beside the
# ranks: the JAX package compiles each call for its mesh)
# ---------------------------------------------------------------------------


def jax_parallel(D: int) -> dict:
    import rsparse_tpu as rs
    from rsparse_tpu import parallel as jpar
    from rsparse_tpu.ops.spgemm_general import spgemm_general_dist

    out = {}
    mesh = jpar.make_mesh(D, data=1)
    rng = np.random.default_rng(0)
    g = C.jax(general(50, 50, 1, 300))
    x, y = rng.standard_normal(50), rng.standard_normal(50)
    ep = jpar.partition_entries(g, D)
    out["gaxpy"] = np.asarray(jpar.dist_gaxpy(ep, x, y, mesh))
    out["norm"] = np.array(jpar.dist_norm(ep, mesh))
    r = C.jax(general(40, 30, 2, 150))
    for name, (u, v) in {"sq": (g, g), "rect": (rs.transpose(r), r)}.items():
        c = jpar.dist_spgemm(u, v, mesh)
        out[f"spgemm_{name}_p"], out[f"spgemm_{name}_i"] = c.p, c.i[: c.nnz()]
        out[f"spgemm_{name}_x"] = c.x[: c.nnz()]
        for dt in ("float32", "float64"):
            c = spgemm_general_dist(u, v, mesh, dtype=dt)
            out[f"sgd_{name}_{dt}_p"] = c.p
            out[f"sgd_{name}_{dt}_i"] = c.i[: c.nnz()]
            out[f"sgd_{name}_{dt}_x"] = c.x[: c.nnz()]
    a = C.jax(spd(80, 3))
    L = rs.chol(a, rs.schol(a, 0)).l
    L.x = np.asarray(L.x)
    U = rs.transpose(L)
    b = np.random.default_rng(1).standard_normal(80)
    for kind in range(4):
        t = L if kind in (0, 2) else U
        out[f"tri{kind}"] = np.asarray(jpar.dist_tri_solve(t, b, kind, mesh))
    out["cholsol"] = np.asarray(jpar.dist_cholsol(a, b, mesh, 0))
    L1 = rs.chol(a, rs.schol(a, -1)).l
    B = np.random.default_rng(2).standard_normal((4, 80))
    out["refine0"] = np.asarray(jpar.refine_step(
        a, L1, np.zeros_like(B), B, jpar.make_mesh(D, data=refine_data(D))))
    return out


def jax_vals(D: int) -> dict:
    import rsparse_tpu as rs
    from rsparse_tpu import parallel as jpar

    out = {}
    v = vals_case(D, 6)
    a, K, mesh = C.jax(v["a"]), v["K"], jpar.make_mesh(D, data=D)
    rs.config.mf_min_n = 64
    s = rs.schol(a, 0)
    out["chol_vals"] = jpar.dist_cholsol_vals(a, v["chol"], v["B"], mesh, 0,
                                              sym=s)
    if D == 4:
        bad = v["chol"].copy()
        bad[K - 1, v["diag"]] = -3.0
        try:
            jpar.dist_cholsol_vals(a, bad, v["B"], mesh, 0, sym=s)
        except rs.NotPositiveDefiniteError as e:
            out["chol_vals_npd"] = np.array(str(e))
    out["lu_vals"] = jpar.dist_lusol_vals(a, v["lu"], v["B"], mesh, 1, 1e-6,
                                          sym=rs.sqr(a, 1, False))
    out["qr_vals_ls"] = jpar.dist_qrsol_vals(C.jax(v["qa"]), v["qr"], v["Bq"],
                                             mesh, 2)
    out["qr_vals_mn"] = jpar.dist_qrsol_vals(C.jax(v["qw"]), v["qrw"], v["Bw"],
                                             mesh, 2)
    return out


def jax_halo(D: int) -> dict:
    import rsparse_tpu as rs
    from rsparse_tpu import parallel as jpar
    from rsparse_tpu.parallel import halo as JH

    out = {}
    mesh = jpar.make_mesh(D, data=1)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(256), rng.standard_normal(256)
    out["gaxpy_lap"] = JH.dist_gaxpy_halo(
        JH.partition_rows(C.jax(C.laplacian(16)), D), x, y, mesh)
    out["gaxpy_gen"] = JH.dist_gaxpy_halo(
        JH.partition_rows(C.jax(general(90, 90, 4, 400)), D), x[:90], y[:90],
        mesh)
    a = C.jax(C.laplacian(12))
    L = rs.chol(a, rs.schol(a, 0)).l
    L.x = np.asarray(L.x)
    bt = C.jax(banded_lower(96, 3))
    b = np.random.default_rng(1).standard_normal(150)
    for name, lo, up, kinds in (("chol", L, rs.transpose(L), range(4)),
                                ("band", bt, None, (0, 2))):
        for kind in kinds:
            t = lo if kind in (0, 2) else up
            out[f"tri_{name}{kind}"] = np.asarray(
                JH.dist_tri_solve_halo(t, b[: t.n], kind, mesh))
    out["tri_replicated"] = np.asarray(jpar.dist_tri_solve(L, b[:144], 0,
                                                           mesh))
    out["lusol"] = JH.dist_lusol(C.jax(general(120, 120, 5, 600)), b[:120],
                                 mesh, 1)
    rs.config.mf_min_n = 100
    out["lusol_mf"] = JH.dist_lusol(C.jax(crossing(150, 0)), b[:150], mesh, 1)
    rs.config.mf_min_n = 1500
    q = C.jax(general(80, 50, 8, 300))
    bq = np.random.default_rng(2).standard_normal(80)
    out["qrsol_ls"] = JH.dist_qrsol(q, bq, mesh, 0)
    out["qrsol_mn"] = JH.dist_qrsol(rs.transpose(q), bq[:50], mesh, 0)
    return out


SUITES = {"parallel": suite_parallel, "halo": suite_halo,
          "jax_parallel": jax_parallel, "jax_vals": jax_vals,
          "jax_halo": jax_halo}


def _jax_main(suite: str, D: int, out_dir: str) -> int:
    """A JAX reference process: the conftest's virtual 8-device CPU mesh."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(os.path.join(out_dir, "rank0.npz"), **SUITES[suite](D))
    return 0


def main(argv) -> int:
    suite, D, rank, store, out_dir = argv
    D, rank = int(D), int(rank)
    sys.path[:0] = [HERE, ROOT]
    if suite.startswith("jax_"):
        return _jax_main(suite, D, out_dir)
    import torch

    from rsparse_tpu_torch import parallel as par

    torch.set_num_threads(1)
    par.init_distributed(f"file://{store}", D, rank, device="cpu",
                         timeout=GROUP_TIMEOUT_S)
    out = SUITES[suite](D)
    out["comm"] = np.array([par.comm_counts()[k] for k in
                            ("all_reduce", "all_gather", "ring_exchange")])
    assert "jax" not in sys.modules, "a rank imported jax"
    assert "rsparse_tpu" not in sys.modules, "a rank imported rsparse_tpu"
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Launching (test side)
# ---------------------------------------------------------------------------


class Ranks:
    """The processes of one suite at D, started at construction: D ranks
    of a port suite, or one JAX reference process (a "jax_" suite).
    `result()` waits for them (at most LAUNCH_TIMEOUT_S, then kills them)
    and returns each process's results."""

    def __init__(self, suite: str, D: int, tmp):
        self.D, self.dir = D, str(tmp)
        self.nproc = 1 if suite.startswith("jax_") else D
        store = os.path.join(self.dir, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [HERE, ROOT, os.environ.get("PYTHONPATH", "")]))
        env.pop("RANK", None)
        env.pop("WORLD_SIZE", None)
        self.errs = [open(os.path.join(self.dir, f"rank{r}.err"), "w+")
                     for r in range(self.nproc)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, suite, str(D), str(r), store,
             self.dir], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=self.errs[r]) for r in range(self.nproc)]
        self.t0 = time.monotonic()
        self._res = None
    def _stderr(self) -> str:
        txt = []
        for r, f in enumerate(self.errs):
            f.seek(0)
            txt.append(f"--- rank {r} (rc {self.procs[r].returncode}) ---\n"
                       + f.read()[-4000:])
        return "\n".join(txt)

    def result(self) -> list:
        if self._res is not None:
            return self._res
        for p in self.procs:
            left = LAUNCH_TIMEOUT_S - (time.monotonic() - self.t0)
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                    q.wait()
                raise AssertionError(f"D={self.D} processes outlived "
                                     f"{LAUNCH_TIMEOUT_S} s\n{self._stderr()}")
        if any(p.returncode for p in self.procs):
            raise AssertionError(f"D={self.D} processes failed\n"
                                 f"{self._stderr()}")
        self._res = [dict(np.load(os.path.join(self.dir, f"rank{r}.npz")))
                     for r in range(self.nproc)]
        return self._res

    def close(self) -> None:
        """Kill what still runs (a module whose tests stopped early)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.errs:
            f.close()

    def rank0(self, key: str):
        """Rank 0's result `key`, after checking every rank has the same."""
        res = self.result()
        for r in range(1, self.nproc):
            np.testing.assert_array_equal(res[r][key], res[0][key],
                                          err_msg=f"rank {r}: {key}")
        return res[0][key]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
