#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (rsparse_tpu_torch) on one GPU.

Drives the port's three kernel paths and the solvers on them once each
at full size and checks them:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: the C++ host engine (g++) and the three CUDA kernels (nvcc,
     sm_90a, one process per source, all started together), from this
     checkout's sources, with their build seconds;
  3. SpTRSV kernel vs plain: for kinds 0-3 (L and U of the matrix below,
     from the port's `lu`) each plan's schedule (levels, the dense block
     and its panels, the variant), then the kernel against its plain torch
     version on the card in float32 and float64, B = 128 and B = 2, with
     both times; the global-memory variant on a synthetic triangle with
     n = 70,000 (kinds 0-3, both types); then the L+U pair's bound and a
     cuSPARSE triangular solve's time;
  4. lusol_serve (main path 1): a nonsymmetric 5-point matrix on a 128 x 128
     grid (n = 16,384) made from --seed; `lusol_serve(A, 1, 1e-6,
     device="cuda")` answers 4 requests of B[n, 128]; each answer is held
     to its residual and to the C++ engine's exact LU solves, the factor
     route must be the device multifrontal one, and the kernel launch count
     of the run must be at least 2 per request; then a profile of two
     requests (sweeps against the refinement loop);
  5. DIA SpMV (main path 2): the 1024 x 1024 5-point Laplacian (n = 2^20),
     `dia_plan` in float32 and float64; the kernel against its plain
     version and against the C++ engine's gaxpy, its time beside its bound
     and a cuSPARSE CSR SpMV; then the public `spmv(a, x)` once and a
     50-step dependent chain through `spmv_fn`, as nnz/s beside the C++
     engine's best of 5; the kernel's L2-warm time is taken with its
     launches queued behind a sleep kernel (device time, not launch cost);
  6. SpMM (main path 3): A = rand_csc(2^20, 2^20, 5.2M, seed 0), B = 128 in
     float32 and float64 and B = 8 in float32; the kernel against its plain
     version and, at B = 128, against 128 sequential C++ gaxpy calls; its
     time beside its bound and a cuSPARSE CSR SpMM; the same kernel in
     float64 at B = 128 on the DIA phase's Laplacian (a pattern with
     locality); then the public `gaxpy_multi(a, X, device="cuda")` once;
  7. lusol (main path 4): the lusol_serve phase's matrix, `lusol(A, b, 1,
     1e-6, sym=s, device="cuda")` once cold and three times warm (b a list
     once, an ndarray otherwise); each answer held to its residual and to
     the C++ engine's exact LU solve, b's overwrite checked, every call's
     route must be the device multifrontal one and not rejected; walls
     beside the C++ engine's;
  8. cholsol (main path 5): the 256 x 256 5-point Laplacian (n = 65,536),
     AMD (order 1), `cholsol(A, b, 1, sym=s, device="cuda")` once cold and
     three times warm; each answer held to the C++ engine's chol + two
     triangular solves, every call's route must be the device
     multifrontal one; walls beside one C++ factorization and solve per
     call, the innermost skeleton's size and cut; every kernel sweep of a
     warm call (the factorization's W = L_NN^-1 C(N, T), float64, B =
     2,048, and the solve's two B = 1 sweeps) replayed on its recorded
     inputs against its plain version, with its time and bound; then the
     error contracts on the card: NotPositiveDefiniteError from cholsol
     with one diagonal negated (a 24 x 24 Laplacian on the level route, and
     the full matrix on the multifrontal route with its analysis reused),
     and NoPivotError from lusol on a structurally singular matrix;
  9. cholsol_serve (main path 6): the same Laplacian, 4 requests of
     B[n, 128]; each answer held to its residual and to the C++ engine's 128
     sequential solves, at least 2 kernel launches per request; the
     handle's L-then-L' kernel pair against its plain version on one
     request; the L' (gather form) sweep's time beside its bound and a
     cuSPARSE triangular solve; a profile of two requests;
 10. qrsol (main path 7): least squares on A = [A5; 0.1 I] (A5 the
     lusol phase's matrix, m = 32,768, n = 16,384, a Tikhonov-regularised
     mesh problem), order 2: `qrsol(A, b, 2, sym=s, device="cuda")` once
     cold (b an ndarray) and once warm (b a list), each
     held to the C++ engine's QR + apply on a fresh analysis and to the
     least-squares gradient gate; then minimum norm on A' (16,384 x 32,768)
     the same way, held to the C++ engine's minimum-norm recipe and its
     residual (a list b grows to n values); every call's route must be the
     device multifrontal one; walls beside one C++ factorization and apply
     per call, the cold call's planner and factor seconds; `qrsol_ls` once
     cold and once warm, held to qrsol; the R sweeps of a warm call of each
     branch (kinds 1 and 3, float64, B = 1) replayed against their plain
     version with their times, bounds and a cuSPARSE triangular solve; a
     profile of one warm least-squares call;
 11. the batched and serving drivers (main paths 8-12), each at full width
     with its launch counts set to 0 just before it and read just after:
     `cholsol_multi(A, B, 1, sym=s)` on phase 8's Laplacian and analysis,
     B[n, 128], once cold and three times warm (route device_mf), held to
     one C++ factorization plus 128 sequential C++ solves; `lusol_multi` on
     phase 7's matrix and analysis, B[n, 128], once cold and three times
     warm (route device_mf), held to its residual and to the C++ engine's
     LU plus 128 solves; per qrsol branch (phase 10's matrices, the Gram
     analysis of its qrsol_ls), a `qrsol_serve` handle, 4 requests of
     B[m, 128] and `qrsol_multi` once cold and once warm (route serve), held
     to the least-squares oracle (the residual for the minimum norm), to
     the port's qrsol on two columns and to the C++ engine's QR and 128
     applies; `cholsol_ir(D A D, b, 1, "float32", 3)` (A phase 8's
     Laplacian, D a seeded diagonal scaling) held to cholsol on the same
     matrix; a profile of each, and every new kernel sweep (the skeleton's
     f64 B = 128 pair, the Gram's f32 B = 128 pair of each branch,
     cholsol_ir's f32 B = 1 pair) replayed against its plain version with
     its time, bound and a cuSPARSE triangular solve;
 12. the batched-values drivers (main paths 13-15), each at full width
     with its launch counts set to 0 just before it and read just after,
     one cold and one warm call each (route device_mf, no instance solved
     again one by one), with the upload time of its [K, nnz] values and
     the peak device memory: `cholsol_vals` on phase 8's Laplacian and
     analysis, K = 16 (diagonals scaled by 1 + 0.25k), every instance held
     to the C++ engine's factorization and solve, walls beside those 16 C++
     solves and 16 port cholsol calls, then one instance's diagonal negated
     must raise NotPositiveDefiniteError naming exactly it; `lusol_vals` on
     phase 7's matrix and analysis, K = 8 (7 diagonal scalings, one with its
     off-diagonals redrawn), each instance held to its residual and to the
     C++ engine's LU and solve, walls beside those and 8 port lusol calls;
     `qrsol_vals` on phase 10's matrices, both branches, K = 4 (values
     scaled by 1 + 0.1k), each instance held to the gate and to the port's
     qrsol, instances 0 and 3 to the C++ engine's QR and apply (each takes
     seconds); a profile of a warm call of each, and every instance-batched
     sweep (one launch for all K: cholsol_vals' factor and solve sweeps,
     qrsol_vals' R sweeps) replayed against its plain version with its
     time, its bound (K instances' values and X, the shared pattern once)
     and K cuSPARSE triangular solves.

Every kernel's launch counter is set to 0 just before each main path and
read just after it; a path whose kernel did not launch fails the run.
Then it prints the kernels' JSON line and, last, the device line. Any
failed check exits non-zero before the last line. Without a CUDA device,
or without the package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed 0]

Kernel times are CUDA-event means; the DIA and SpMM phases evict the 50 MB
L2 before every timed launch (their inputs would otherwise sit in it) by
reading a 256 MiB buffer, which leaves no dirty line to be written back
inside the timed window, and queue their timed launches behind a sleep
kernel so that the host's pauses are not timed. A
bound is the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its FLOPs over the
card's rate outside the tensor cores (67 TFLOP/s float32, 34 TFLOP/s
float64; NVIDIA's H100 SXM data sheet). The cuSPARSE calls are yardsticks
only; the port never calls them.

Float32 matmuls and cuDNN are held to full float32 (no TF32) so that the
comparisons measure the algorithm, not the tensor-core rounding mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import warnings
from typing import Optional

import numpy as np

GRID = 128  # n = GRID**2
NRHS = 128
REQUESTS = 4
TOL = {"float32": 1e-4, "float64": 1e-12}  # kernel vs plain, relative
NEW_TOL = {"float32": 1e-5, "float64": 1e-12}  # SpMM / DIA kernel vs plain
GLOBAL_N = 70_000  # a triangle too large for an X column in shared memory
DIA_GRID = 1024  # the JAX bench's DIA SpMV matrix (bench.py:585-621)
SPMM_N, SPMM_NNZ = 1 << 20, 5_200_000  # its arbitrary pattern (bench.py:628-629)
CHAIN = 50
CHOL_GRID = 256  # the cholsol phases' Laplacian, n = CHOL_GRID**2
ERR_GRID = 24  # the error contracts' small matrices
QR_GRID = 128  # qrsol: A = [make_matrix(QR_GRID); 0.1 I], n = QR_GRID**2
QR_REG = 0.1
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


class SmokeError(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def make_matrix(grid: int, seed: int):
    """5-point pattern on a grid x grid mesh; off-diagonals -(1 + 0.3 N(0,1)),
    diagonal 1 + max(row, column) abs-sum. Returns the port's Sprs."""
    from rsparse_tpu_torch import Sprs

    n = grid * grid
    idx = np.arange(n, dtype=np.int64)
    gx, gy = idx // grid, idx % grid
    rows, cols = [], []
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nx, ny = gx + dx, gy + dy
        ok = (nx >= 0) & (nx < grid) & (ny >= 0) & (ny < grid)
        rows.append((nx * grid + ny)[ok])
        cols.append(idx[ok])
    r, c = np.concatenate(rows), np.concatenate(cols)
    rng = np.random.default_rng(seed)
    v = -(1.0 + 0.3 * rng.standard_normal(len(r)))
    absv = np.abs(v)
    diag = 1.0 + np.maximum(np.bincount(r, absv, n), np.bincount(c, absv, n))
    r, c, v = (np.concatenate([r, idx]), np.concatenate([c, idx]),
               np.concatenate([v, diag]))
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return Sprs(len(v), n, n, p, r[order], v[order])


def synthetic_triangle(n: int, k: int, seed: int):
    """(L, U): a lower triangle of n columns, diagonal first, with entries
    at rows j+s and j+2s+1 (s = (n-k)//10 + 1, so ~20 levels) of each
    column j < n-k and a fully dense last block of k columns; U carries L's
    transposed pattern (diagonal last, the block first in its solve, with
    entries into rows outside it) and its own values. Diagonals dominate
    their columns. Returns the port's Sprs."""
    from rsparse_tpu_torch import Sprs

    rng = np.random.default_rng(seed)
    j = np.arange(n - k, dtype=np.int64)
    step = (n - k) // 10 + 1
    rows = [j + step, j + 2 * step + 1]
    cols = [j, j]
    tri = np.tril_indices(k, -1)
    rows.append(n - k + tri[0])
    cols.append(n - k + tri[1])
    r, c = np.concatenate(rows), np.concatenate(cols)
    ok = r < n
    r, c = r[ok], c[ok]
    mats = []
    for rr, cc in ((r, c), (c, r)):
        v = rng.uniform(0.2, 0.3, len(rr)) * rng.choice([-1.0, 1.0], len(rr))
        idx = np.arange(n, dtype=np.int64)
        diag = 1.0 + np.bincount(cc, np.abs(v), n)
        rr, cc, v = (np.concatenate([rr, idx]), np.concatenate([cc, idx]),
                     np.concatenate([v, diag]))
        order = np.lexsort((rr, cc))
        p = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(cc, minlength=n), out=p[1:])
        mats.append(Sprs(len(v), n, n, p, rr[order], v[order]))
    return mats[0], mats[1]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks_up(seconds: float = 0.2) -> None:
    """Keep the card busy for `seconds` (reductions over 256 MiB) so that a
    timing that follows seconds of host work does not start at idle
    clocks."""
    import torch

    buf = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            buf.sum()
        torch.cuda.synchronize()


@contextlib.contextmanager
def queued():
    """Launches made inside run after a ~50 ms sleep kernel, with Python's
    garbage collector off: the host queues them all before the card starts,
    so CUDA events around them time the device, not the host's launch cost
    or a pause of the host."""
    import gc

    import torch

    gc.disable()
    try:
        torch.cuda._sleep(100_000_000)
        yield
    finally:
        gc.enable()


def cuda_ms_queued(fn, reps: int) -> float:
    """Mean milliseconds of fn() back to back on the card (L2-warm), the
    launches `queued`; the clocks raised and one warm-up run first."""
    import torch

    clocks_up()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with queued():
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean milliseconds of fn() by CUDA events around each run, each after
    a 256 MiB read (a sum) that leaves the L2 cache holding clean lines of
    another buffer, so that no write-back of earlier results lands in the
    timed window; the launches `queued`, the clocks raised and one warm-up
    run first."""
    import torch

    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    clocks_up()
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    with queued():
        for start, end in evs:
            flush.sum()
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(least ms, what bounds it) for work moving nbytes and doing flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(plan, B: int, item: int, K: int = 1):
    """(bytes, operations) one sweep of `plan` over X[n, B] of K instances
    must spend: each instance's off-diagonal and diagonal values and its X
    read and written once; the pattern, which the instances share, once:
    each off-diagonal entry's row index (none in a dense block, its place
    implied) and each column's pointer; a multiply-add per entry, RHS
    column and instance, a division per column, RHS column and
    instance."""
    n, nent = plan.n, int(plan.ent_off[-1])
    d = plan.dense
    nblk = d.k * (d.k - 1) // 2 if d is not None else 0
    nbytes = K * (item * (nent + n) + 2 * n * B * item) + 4 * (nent - nblk + n)
    return nbytes, K * (2 * nent * B + n * B)


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def counters():
    """The three kernels' launch counters, by kernel name."""
    from rsparse_tpu_torch.ops import spmv
    from rsparse_tpu_torch.ops.spmm_cuda import spmm_csr
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    return {"sptrsv_sweep": sptrsv_multi, "spmm_stream": spmm_csr,
            "spmv_dia": spmv.dia_spmv}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def rel_err(got, ref) -> tuple:
    """(max abs difference, that over max(1, max|ref|)) of two tensors."""
    err = float((got.double() - ref.double()).abs().max())
    return err, err / max(1.0, float(ref.double().abs().max()))


def laplacian_5pt(g: int):
    """5-point Laplacian on a g x g grid, CSC (the JAX bench's generator)."""
    n = g * g
    idx = np.arange(n, dtype=np.int64)
    gx, gy = idx // g, idx % g
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nx, ny = gx + dx, gy + dy
        ok = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
        rows.append((nx * g + ny)[ok])
        cols.append(idx[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return n, p, r[order], v[order]


def rand_csc(m: int, n: int, nnz: int, seed: int):
    """Uniform random pattern, duplicates merged (the JAX bench's generator)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    k = np.unique(c * np.int64(m) + r)
    c2 = k // m
    r2 = (k % m).astype(np.int64)
    v = rng.standard_normal(len(k))
    p = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(c2, minlength=n), out=p[1:])
    return p, r2, v


def device_profile(fn, steps: int) -> str:
    """Run fn() `steps` times under torch.profiler and summarize: host wall
    and device busy time per step, the device activities per step
    (kernels, copies, fills), the device's idle share, and the top device
    activities by time. Only device activity is recorded: host operators
    add nothing to the summary, and after a call of tens of thousands of
    device ops their events multiply the profiler's own processing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, ops = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            ops += 1
    busy_us = sum(by_name.values())
    if not by_name:
        return f"wall_us_per_step={wall_us / steps:.1f} device time not measured"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"wall_us_per_step={wall_us / steps:.1f} device_us_per_step="
            f"{busy_us / steps:.1f} device_ops_per_step={ops / steps:.0f} "
            f"idle_share={1 - busy_us / wall_us:.3f} top="
            + ";".join(f"{k[:48]}={v / steps:.1f}us" for k, v in top))


def phase_kernels(a, seed: int, device: str = "cuda"):
    """The SpTRSV kernel on the L and U factors of `a`: each plan's
    schedule, kernel vs plain version (kinds 0-3, float32 and float64,
    B = 128 and 2), then the global-memory variant on a large triangle and
    the serve pair's yardsticks."""
    import torch

    from rsparse_tpu_torch import lu, sqr, tri_plan
    from rsparse_tpu_torch.ops.sptrsv_cuda import (launch_config, sptrsv_multi,
                                                   sptrsv_plain_multi)

    nm = lu(a, sqr(a, 1, False), 1e-6, device=device)
    rng = np.random.default_rng(seed + 1)
    max_abs, main = 0.0, {"ms": 0.0, "plain_ms": 0.0, "sweep_ms": []}
    for kind in (0, 1, 2, 3):
        t = nm.l if kind in (0, 2) else nm.u
        t0 = time.perf_counter()
        plan = tri_plan(t, kind)
        t1 = time.perf_counter()
        _ = plan.dense  # the split, found at its first read
        secs = (t1 - t0, time.perf_counter() - t1)
        print_schedule(plan, kind, launch_config(plan, torch.float32, device),
                       secs)
        for dtype in (torch.float32, torch.float64):
            tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device=device)
            for B in (NRHS, 2):
                X = torch.as_tensor(rng.standard_normal((a.n, B)), dtype=dtype,
                                    device=device)
                got = sptrsv_multi(tx, X, plan, kind)
                ref = sptrsv_plain_multi(tx, X, plan, kind)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                # timed as the serve chain calls it: X^T out, no copy back
                ms = cuda_ms(lambda: sptrsv_multi(tx, X, plan, kind,
                                                  contiguous=False), 5)
                plain = cuda_ms(lambda: sptrsv_plain_multi(tx, X, plan, kind), 2)
                name = dname(dtype)
                print(f"kernel kind={kind} {name} B={B}: max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} kernel_ms={ms:.4f} "
                      f"plain_ms={plain:.4f}", flush=True)
                check(bool(torch.isfinite(got).all()), "kernel output not finite")
                check(rel <= TOL[name], f"kernel kind={kind} {name} B={B} "
                      f"disagrees with the plain version: {rel:.3e}")
                max_abs = max(max_abs, err)
                if kind in (0, 1) and dtype == torch.float32 and B == NRHS:
                    # the serve handle's two sweeps per solve
                    main["ms"] += ms
                    main["plain_ms"] += plain
                    main["sweep_ms"].append(ms)
    max_abs = max(max_abs, phase_global_variant(seed, device))
    sweep_pair_yardsticks(a, nm, rng, main, device)
    return max_abs, main


def print_schedule(plan, kind: int, cfg: dict, secs=None) -> None:
    """One line: the level count of the whole schedule and the kernel's
    schedule (sparse levels, dense block size, panels, place, outside
    entries, the most entries in one sparse level) with the kernel's
    variant in float32; with `secs`, the host seconds of the level
    schedule and of the dense split."""
    d = plan.dense
    host = (f"plan_s={secs[0]:.4f} split_s={secs[1]:.4f} "
            if secs is not None else "")
    print(f"schedule kind={kind}: {host}n={plan.n} levels={plan.nlev} "
          f"sparse_levels={d.rest.nlev if d else plan.nlev} "
          f"dense_k={d.k if d else 0} panels={-(-d.k // 32) if d else 0} "
          f"block={('first' if d.first else 'last') if d else 'none'} "
          f"outside_entries={len(d.out_pos) if d else 0} "
          f"sparse_emax={d.rest.emax if d else plan.emax} "
          f"variant={cfg['variant']}", flush=True)


def phase_global_variant(seed: int, device: str = "cuda") -> float:
    """The kernel's global-memory variant, kinds 0-3 in float32 and float64
    at B = NRHS, on synthetic_triangle(GLOBAL_N, 96): n is too large for an
    X column in shared memory. Returns the largest absolute difference."""
    import torch

    from rsparse_tpu_torch import tri_plan
    from rsparse_tpu_torch.ops.sptrsv_cuda import (launch_config, sptrsv_multi,
                                                   sptrsv_plain_multi)

    lo, up = synthetic_triangle(GLOBAL_N, 96, seed)
    rng = np.random.default_rng(seed + 5)
    max_abs = 0.0
    for kind in (0, 1, 2, 3):
        t = lo if kind in (0, 2) else up
        plan = tri_plan(t, kind)
        cfg = launch_config(plan, torch.float32, device)
        print_schedule(plan, kind, cfg)
        check(cfg["variant"] == "global", f"global variant: n = {t.n} took "
              f"the {cfg['variant']} variant")
        for dtype in (torch.float32, torch.float64):
            tx = torch.as_tensor(t.x[: t.nnz()], dtype=dtype, device=device)
            X = torch.as_tensor(rng.standard_normal((t.n, NRHS)), dtype=dtype,
                                device=device)
            got = sptrsv_multi(tx, X, plan, kind)
            ref = sptrsv_plain_multi(tx, X, plan, kind)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            ms = cuda_ms(lambda: sptrsv_multi(tx, X, plan, kind), 3)
            name = dname(dtype)
            print(f"global variant kind={kind} {name} B={NRHS}: "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} kernel_ms={ms:.4f}",
                  flush=True)
            check(bool(torch.isfinite(got).all()) and rel <= TOL[name],
                  f"global variant kind={kind} {name} disagrees with the "
                  f"plain version: {rel:.3e}")
            max_abs = max(max_abs, err)
    return max_abs


def sweep_pair_yardsticks(a, nm, rng, main: dict, device: str) -> None:
    """The serve handle's L+U sweep pair (float32, B = NRHS): its bound from
    the plans' streams, and the time of cuSPARSE's triangular solve
    (`torch.triangular_solve` on CSR copies of L and U) for the same pair."""
    import torch

    from rsparse_tpu_torch import tri_plan
    from rsparse_tpu_torch.ops.plan import transpose_plan
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    n, nbytes, flops, levels = a.n, 0, 0, []
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
    mats, plans = [], []
    for t, kind in ((nm.l, 0), (nm.u, 1)):
        plan = tri_plan(t, kind)
        work = sweep_work(plan, NRHS, 4)
        nbytes += work[0]
        flops += work[1]
        levels.append(plan.nlev)
        vals = torch.as_tensor(t.x[: t.nnz()], dtype=torch.float32,
                               device=device)
        tp = transpose_plan(t)  # CSR of the CSC factor
        mats.append(torch.sparse_csr_tensor(ix(tp.out_p), ix(tp.out_i),
                                            vals[ix(tp.perm)], size=(n, n)))
        plans.append((vals, plan, kind))
    main["bound_ms"], main["bound_by"] = bound_ms(nbytes, flops, "float32")
    X = torch.as_tensor(rng.standard_normal((n, NRHS)), dtype=torch.float32,
                        device=device)

    def lib_pair():
        Z = torch.triangular_solve(X, mats[0], upper=False).solution
        return torch.triangular_solve(Z, mats[1], upper=True).solution

    try:
        got = lib_pair()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"sptrsv library: no single torch call solves with a sparse "
              f"CSR matrix here ({type(e).__name__}: {e})", flush=True)
        main["library_ms"] = None
        return
    Z = X
    for vals, plan, kind in plans:
        Z = sptrsv_multi(vals, Z, plan, kind)
    torch.cuda.synchronize()
    _, rel = rel_err(got, Z)
    main["library_ms"] = cuda_ms(lib_pair, 5)
    print(f"sptrsv pair f32 B={NRHS}: levels={levels[0]}+{levels[1]} "
          f"kernel_ms={main['ms']:.4f} (L {main['sweep_ms'][0]:.4f}, U "
          f"{main['sweep_ms'][1]:.4f}) bound_ms={main['bound_ms']:.5f} "
          f"({main['bound_by']}, {nbytes} bytes) "
          f"bound_share={main['bound_ms'] / main['ms']:.5f} "
          f"library_ms={main['library_ms']:.4f} library_rel_diff={rel:.3e}",
          flush=True)


def host_solves(a, B: np.ndarray, factors):
    """The C++ engine's exact LU, one sequential solve per RHS column."""
    from rsparse_tpu_torch.symbolic import native

    Lp, Li, Lx, Up, Ui, Ux, pinv, q = factors
    n = a.n
    X = np.empty_like(B)
    for j in range(B.shape[1]):
        xx = np.zeros(n)
        xx[pinv] = B[:, j]
        native.lsolve_host(n, Lp, Li, Lx, xx)
        native.usolve_host(n, Up, Ui, Ux, xx)
        out = np.zeros(n)
        out[q] = xx
        X[:, j] = out
    return X


def phase_main(a, seed: int, device: str = "cuda"):
    """lusol_serve on the card: 4 requests, checked; returns launch count."""
    import torch

    from rsparse_tpu_torch import lusol_serve, sqr
    from rsparse_tpu_torch.ops.plan import col_ids
    from rsparse_tpu_torch.symbolic import native

    n, nz = a.n, a.nnz()
    rng = np.random.default_rng(seed + 2)
    requests = [rng.standard_normal((n, NRHS)) for _ in range(REQUESTS)]

    reset_counts()
    t0 = time.perf_counter()
    s = sqr(a, 1, False)
    t_an = time.perf_counter() - t0
    h = lusol_serve(a, 1, 1e-6, sym=s, device=device)
    answers, walls = [], []
    for B in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = h(torch.as_tensor(B, device=device))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        answers.append(X)
    launches = read_counts()["sptrsv_sweep"]

    bs = h.build_seconds
    print(f"main: n={n} nnz={nz} analysis_s={t_an:.4f} factor_s={bs['factor']:.4f} "
          f"probe_s={bs['probe']:.4f} handle_s={bs['handle']:.4f} "
          f"route={h.factor_route} static_rejected="
          f"{bool(getattr(s, '_static_rejected', False))}", flush=True)
    print("main: request_wall_s=" + ",".join(f"{w:.5f}" for w in walls)
          + f" kernel_launches={launches}", flush=True)
    check(h.factor_route == "device_mf"
          and not getattr(s, "_static_rejected", False),
          f"factor route is {h.factor_route}, not the device multifrontal LU")
    check(launches >= 2 * REQUESTS,
          f"only {launches} kernel launches for {REQUESTS} requests")

    # oracles: residual on the card, and the C++ engine's exact LU solves
    Mi = torch.as_tensor(a.i[:nz], device=device)
    Mj = torch.as_tensor(col_ids(a.p, n), device=device)
    Mx = torch.as_tensor(a.x[:nz], device=device)
    s0 = sqr(a, 1, False)
    Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
        n, a.p, a.i[:nz], a.x[:nz], s0.q, 1e-6, s0.lnz, s0.unz)
    factors = (Lp, Li, Lx, Up, Ui, Ux, pinv, np.asarray(s0.q, np.int64))
    for k, (B, X) in enumerate(zip(requests, answers)):
        check(tuple(X.shape) == (n, NRHS) and bool(torch.isfinite(X).all()),
              f"request {k}: bad answer shape or non-finite values")
        Bd = torch.as_tensor(B, device=device)
        AX = torch.zeros_like(X).index_add_(0, Mi, Mx[:, None] * X[Mj])
        res = float((AX - Bd).abs().max())
        t0 = time.perf_counter()
        Xh = host_solves(a, B, factors)
        t_host = time.perf_counter() - t0
        Xc = X.cpu().numpy()
        dev = float(np.abs(Xc - Xh).max() / max(1.0, np.abs(Xh).max()))
        print(f"main: request {k} residual={res:.3e} host_rel_diff={dev:.3e} "
              f"host_engine_128_solves_s={t_host:.4f}", flush=True)
        check(res <= 1e-10 * max(1.0, float(np.abs(B).max())),
              f"request {k}: residual {res:.3e} over bound")
        check(dev <= 1e-8, f"request {k}: differs from the host engine by {dev:.3e}")
    B0 = torch.as_tensor(requests[0], device=device)
    print("main profile (2 requests): " + device_profile(lambda: h(B0), 2),
          flush=True)
    return launches


def phase_dia(seed: int, device: str = "cuda"):
    """DIA SpMV on the 1024 x 1024 5-point Laplacian (n = 2^20): kernel vs
    plain vs the C++ engine in float32 and float64, times and bound; then
    the main path, the public `spmv` once and a 50-step chain."""
    import torch

    from rsparse_tpu_torch import Sprs
    from rsparse_tpu_torch.ops import spmv as sp
    from rsparse_tpu_torch.ops.plan import transpose_plan
    from rsparse_tpu_torch.symbolic import native

    n, Ap, Ai, Ax = laplacian_5pt(DIA_GRID)
    nnz = len(Ax)
    a = Sprs(nnz, n, n, Ap, Ai, Ax)
    x_h = np.random.default_rng(seed + 3).standard_normal(n)
    zeros = np.zeros(n)
    r_host = native.gaxpy_host(n, n, Ap, Ai, Ax, x_h, zeros)
    cpu_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.gaxpy_host(n, n, Ap, Ai, Ax, x_h, zeros)
        cpu_s.append(time.perf_counter() - t0)
    host_scale = max(1.0, float(np.abs(r_host).max()))
    tp = transpose_plan(a)
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
    crow, ccol = ix(tp.out_p), ix(tp.out_i)
    out, plans, max_abs = {}, {}, 0.0
    for np_dt in (np.float32, np.float64):
        t0 = time.perf_counter()
        plan = sp.dia_plan(a, dtype=np_dt)
        t_plan = time.perf_counter() - t0
        dt = torch.float32 if np_dt == np.float32 else torch.float64
        name = dname(dt)
        dia = torch.as_tensor(plan.dia, device=device)
        x = torch.as_tensor(x_h, dtype=dt, device=device)
        plans[name] = (plan, dia, x)
        got = sp.dia_spmv(dia, x, plan)
        ref = sp.dia_spmv_plain(dia, x, plan)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        host_err = float(np.abs(got.double().cpu().numpy() - r_host).max())
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (n,),
              f"dia {name}: bad kernel output")
        check(rel <= NEW_TOL[name],
              f"dia {name}: kernel disagrees with the plain version: {rel:.3e}")
        host_tol = 1e-3 if name == "float32" else 1e-12
        check(host_err <= host_tol * host_scale,
              f"dia {name}: kernel disagrees with the C++ engine: {host_err:.3e}")
        max_abs = max(max_abs, err)
        A_csr = torch.sparse_csr_tensor(crow, ccol, torch.as_tensor(
            Ax[tp.perm], dtype=dt, device=device), size=(n, n))
        _, lib_rel = rel_err(torch.mv(A_csr, x), ref)
        ms = cuda_ms_cold(lambda: sp.dia_spmv(dia, x, plan), 20)
        b2b = cuda_ms(lambda: sp.dia_spmv(dia, x, plan), 20)
        warm = cuda_ms_queued(lambda: sp.dia_spmv(dia, x, plan), 200)
        plain = cuda_ms_cold(lambda: sp.dia_spmv_plain(dia, x, plan), 5)
        lib = cuda_ms_cold(lambda: torch.mv(A_csr, x), 20)
        K, item = len(plan.offsets), dia.element_size()
        b, by = bound_ms(K * plan.rr * 128 * item + 4 * K + 2 * n * item,
                         2 * K * n, name)
        print(f"dia {name}: n={n} nnz={nnz} K={K} plan_s={t_plan:.3f} "
              f"max_abs_err={err:.3e} rel_err={rel:.3e} "
              f"host_abs_err={host_err:.3e} kernel_ms={ms:.5f} "
              f"warm_ms={warm:.5f} back_to_back_with_launch_ms={b2b:.5f} "
              f"plain_ms={plain:.5f} "
              f"library_ms={lib:.5f} library_rel_diff={lib_rel:.3e} "
              f"bound_ms={b:.5f} ({by}) bound_share={b / ms:.4f}", flush=True)
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b, "bound_by": by}

    # main path: the public spmv, then a dependent chain through spmv_fn
    plan, dia, x = plans["float32"]
    f = sp.spmv_fn(plan)
    reset_counts()
    r = sp.spmv(a, x_h, plan, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = x
    for _ in range(CHAIN):
        rr = f(dia, cur)
        cur = rr / rr.abs().max()
    checksum = float(cur.sum())
    t_chain = (time.perf_counter() - t0) / CHAIN
    counts = read_counts()
    host_err = float(np.abs(r.double().cpu().numpy() - r_host).max())
    print(f"dia main: spmv host_abs_err={host_err:.3e} chain_step_s="
          f"{t_chain:.6f} chain_nnz_per_s={nnz / t_chain:.4e} "
          f"host_engine_best_s={min(cpu_s):.6f} host_engine_nnz_per_s="
          f"{nnz / min(cpu_s):.4e} launches={counts}", flush=True)
    check(tuple(r.shape) == (n,) and host_err <= 1e-3 * host_scale,
          f"dia main: spmv disagrees with the C++ engine: {host_err:.3e}")
    check(np.isfinite(checksum), "dia main: chain checksum not finite")
    check(counts["spmv_dia"] == CHAIN + 1,
          f"dia main: {counts['spmv_dia']} kernel launches, not {CHAIN + 1}")

    def step():
        rr = f(dia, x)
        return rr / rr.abs().max()

    print(f"dia main profile (chain step, 10 steps): {device_profile(step, 10)}",
          flush=True)
    return out, max_abs, counts


def phase_spmm(seed: int, device: str = "cuda"):
    """Streaming SpMM on rand_csc(2^20, 2^20, 5.2M, seed 0): kernel vs plain
    (float32 and float64 at B = 128, float32 at B = 8) and vs 128 C++ gaxpy
    calls, times and bound; then the main path, `gaxpy_multi` once."""
    import torch

    from rsparse_tpu_torch import Sprs, gaxpy_multi
    from rsparse_tpu_torch.ops.spmm_cuda import (spmm_csr, spmm_plain,
                                                 spmm_plan_cached)
    from rsparse_tpu_torch.symbolic import native

    n = SPMM_N
    Ap, Ai, Ax = rand_csc(n, n, SPMM_NNZ, seed=0)
    nnz = len(Ax)
    a = Sprs(nnz, n, n, Ap, Ai, Ax)
    t0 = time.perf_counter()
    plan = spmm_plan_cached(a)
    t_plan = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 4)
    X64 = torch.randn((n, NRHS), generator=gen, dtype=torch.float64,
                      device=device)
    X64h = X64.cpu().numpy()
    t0 = time.perf_counter()
    Rh = np.empty((n, NRHS))
    zeros = np.zeros(n)
    for j in range(NRHS):
        Rh[:, j] = native.gaxpy_host(n, n, Ap, Ai, Ax,
                                     np.ascontiguousarray(X64h[:, j]), zeros)
    t_cpp = time.perf_counter() - t0
    Rh_d = torch.as_tensor(Rh, device=device)
    host_scale = max(1.0, float(np.abs(Rh).max()))
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
    perm, crow, ccol = ix(plan.perm), ix(plan.row_ptr), ix(plan.col_idx)
    vals64 = torch.as_tensor(Ax, device=device)
    out, max_abs = {}, 0.0
    for dt, B in ((torch.float32, NRHS), (torch.float64, NRHS),
                  (torch.float32, 8)):
        name = dname(dt)
        X = X64[:, :B].to(dt).contiguous()
        vals = vals64.to(dt)
        vals_csr = vals[perm]
        got = spmm_csr(vals_csr, X, plan)
        ref = spmm_plain(vals, X, plan)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        del ref
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (n, B),
              f"spmm {name} B={B}: bad kernel output")
        check(rel <= NEW_TOL[name], f"spmm {name} B={B}: kernel disagrees "
              f"with the plain version: {rel:.3e}")
        host_rel = None
        if B == NRHS:
            host_rel = float((got.double() - Rh_d).abs().max()) / host_scale
            host_tol = 1e-4 if name == "float32" else 1e-12
            check(host_rel <= host_tol, f"spmm {name}: kernel disagrees with "
                  f"the C++ engine's gaxpy: {host_rel:.3e}")
        del got
        torch.cuda.empty_cache()
        max_abs = max(max_abs, err)
        A_csr = torch.sparse_csr_tensor(crow, ccol, vals_csr, size=(n, n))
        lib_out = torch.sparse.mm(A_csr, X)
        _, lib_rel = rel_err(lib_out, spmm_csr(vals_csr, X, plan))
        del lib_out
        ms = cuda_ms_cold(lambda: spmm_csr(vals_csr, X, plan), 10)
        plain = cuda_ms_cold(lambda: spmm_plain(vals, X, plan), 2)
        torch.cuda.empty_cache()
        lib = cuda_ms_cold(lambda: torch.sparse.mm(A_csr, X), 10)
        item = X.element_size()
        b, by = bound_ms(nnz * (item + 4) + 4 * (n + 1) + 2 * n * B * item,
                         2 * nnz * B, name)
        print(f"spmm {name} B={B}: n={n} nnz={nnz} plan_s={t_plan:.3f} "
              f"max_abs_err={err:.3e} rel_err={rel:.3e} host_rel_err="
              f"{host_rel if host_rel is None else format(host_rel, '.3e')} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"library_rel_diff={lib_rel:.3e} bound_ms={b:.4f} ({by}) "
              f"bound_share={b / ms:.4f}", flush=True)
        out[(name, B)] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": b, "bound_by": by}
        del X, vals, vals_csr, A_csr
        torch.cuda.empty_cache()

    max_abs = max(max_abs, spmm_laplacian(seed, device))

    # main path: the public gaxpy_multi on the card (float64, A's dtype)
    reset_counts()
    R = gaxpy_multi(a, X64, device=device)
    torch.cuda.synchronize()
    counts = read_counts()
    host_rel = float((R - Rh_d).abs().max()) / host_scale
    print(f"spmm main: gaxpy_multi f64 B={NRHS} host_rel_err={host_rel:.3e} "
          f"host_engine_128_gaxpy_s={t_cpp:.4f} launches={counts}", flush=True)
    check(tuple(R.shape) == (n, NRHS) and host_rel <= 1e-12,
          f"spmm main: gaxpy_multi disagrees with the C++ engine: {host_rel:.3e}")
    check(counts["spmm_stream"] >= 1, "spmm main: the kernel did not launch")
    del R
    print("spmm main profile (gaxpy_multi, 3 calls): " + device_profile(
        lambda: gaxpy_multi(a, X64, device=device), 3), flush=True)
    return out, max_abs, counts


def spmm_laplacian(seed: int, device: str = "cuda") -> float:
    """The SpMM kernel in float64 at B = NRHS on the DIA phase's 1024 x 1024
    Laplacian, a pattern with locality (neighbouring rows reuse X's rows
    from L2): kernel vs plain, its time beside its bound. Returns the
    largest absolute difference."""
    import torch

    from rsparse_tpu_torch import Sprs
    from rsparse_tpu_torch.ops.spmm_cuda import (spmm_csr, spmm_plain,
                                                 spmm_plan_cached)

    n, Ap, Ai, Ax = laplacian_5pt(DIA_GRID)
    nnz = len(Ax)
    plan = spmm_plan_cached(Sprs(nnz, n, n, Ap, Ai, Ax))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 6)
    X = torch.randn((n, NRHS), generator=gen, dtype=torch.float64,
                    device=device)
    vals = torch.as_tensor(Ax, device=device)
    vals_csr = vals[torch.as_tensor(plan.perm, device=device)]
    got = spmm_csr(vals_csr, X, plan)
    ref = spmm_plain(vals, X, plan)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (n, NRHS),
          "spmm laplacian: bad kernel output")
    check(rel <= NEW_TOL["float64"], f"spmm laplacian: kernel disagrees "
          f"with the plain version: {rel:.3e}")
    del got, ref
    ms = cuda_ms_cold(lambda: spmm_csr(vals_csr, X, plan), 10)
    b, by = bound_ms(nnz * 12 + 4 * (n + 1) + 2 * n * NRHS * 8,
                     2 * nnz * NRHS, "float64")
    print(f"spmm laplacian float64 B={NRHS}: n={n} nnz={nnz} "
          f"max_abs_err={err:.3e} rel_err={rel:.3e} kernel_ms={ms:.4f} "
          f"bound_ms={b:.4f} ({by}) bound_share={b / ms:.4f}", flush=True)
    del X, vals, vals_csr
    torch.cuda.empty_cache()
    return err


def host_residual(a, x: np.ndarray) -> np.ndarray:
    """A @ x by the C++ engine's gaxpy."""
    from rsparse_tpu_torch.symbolic import native

    return native.gaxpy_host(a.m, a.n, a.p, a.i[: a.nnz()], a.x[: a.nnz()],
                             np.ascontiguousarray(x, np.float64),
                             np.zeros(a.m))


def phase_lusol(a, seed: int, device: str = "cuda"):
    """lusol on the card: one cold and three warm calls with the analysis
    reused, each checked; returns (the kernel launches of the run, the
    analysis)."""
    from rsparse_tpu_torch import lusol, sqr
    from rsparse_tpu_torch.symbolic import native

    n, nz = a.n, a.nnz()
    rng = np.random.default_rng(seed + 7)
    bs = [rng.standard_normal(n) for _ in range(4)]
    s0 = sqr(a, 1, False)
    q = np.asarray(s0.q, np.int64)

    def host_once(b):
        Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
            n, a.p, a.i[:nz], a.x[:nz], s0.q, 1e-6, s0.lnz, s0.unz)
        xx = np.zeros(n)
        xx[pinv] = b
        native.lsolve_host(n, Lp, Li, Lx, xx)
        native.usolve_host(n, Up, Ui, Ux, xx)
        out = np.zeros(n)
        out[q] = xx
        return out

    reset_counts()
    s = sqr(a, 1, False)
    walls, answers, routes = [], [], []
    for k, b in enumerate(bs):
        arg = list(b) if k == 1 else b.copy()
        t0 = time.perf_counter()
        x = lusol(a, arg, 1, 1e-6, sym=s, device=device)
        walls.append(time.perf_counter() - t0)
        routes.append(s._lu_route)
        check(np.array_equal(np.asarray(arg), x),
              f"lusol call {k}: b ({type(arg).__name__}) not overwritten")
        answers.append(x)
    launches = read_counts()["sptrsv_sweep"]
    host_walls = []
    for k, (b, x) in enumerate(zip(bs, answers)):
        t0 = time.perf_counter()
        xh = host_once(b)
        host_walls.append(time.perf_counter() - t0)
        res = float(np.abs(host_residual(a, x) - b).max())
        dev = float(np.abs(x - xh).max() / max(1.0, np.abs(xh).max()))
        print(f"lusol: call {k} ({'cold' if k == 0 else 'warm'}) "
              f"residual={res:.3e} host_rel_diff={dev:.3e}", flush=True)
        check(bool(np.isfinite(x).all()) and x.shape == (n,),
              f"lusol call {k}: bad answer")
        check(res <= 1e-10 * max(1.0, float(np.abs(b).max())),
              f"lusol call {k}: residual {res:.3e} over bound")
        check(dev <= 1e-8, f"lusol call {k}: differs from the host engine "
              f"by {dev:.3e}")
    mfp = s._mf_lu_plan
    print(f"lusol: n={n} nnz={nz} routes={','.join(routes)} static_rejected="
          f"{bool(getattr(s, '_static_rejected', False))} skeleton="
          f"{type(mfp.skel_plan).__name__ if mfp is not None else None} "
          f"wall_s=" + ",".join(f"{w:.4f}" for w in walls)
          + " host_engine_s=" + ",".join(f"{w:.4f}" for w in host_walls)
          + f" sweep_launches={launches}", flush=True)
    check(set(routes) == {"device_mf"}
          and not getattr(s, "_static_rejected", False),
          f"lusol routes {routes}, not all the device multifrontal LU")
    print("lusol profile (1 warm call): " + device_profile(
        lambda: lusol(a, bs[0].copy(), 1, 1e-6, sym=s, device=device), 1),
        flush=True)
    return launches, s


def chol_host_factor(a, s):
    """The C++ engine's exact Cholesky of triu(PAP') for analysis s."""
    from rsparse_tpu_torch import symperm
    from rsparse_tpu_torch.symbolic import native

    c = symperm(a, s.pinv, device="cpu")
    return native.chol_numeric(a.n, c.p, c.i[: c.nnz()], c.x[: c.nnz()],
                               s.parent, s.cp)


def chol_host_solves(n, factors, pinv, B: np.ndarray) -> np.ndarray:
    """One C++ engine solve per column of B on the Cholesky factors."""
    from rsparse_tpu_torch.symbolic import native

    Lp, Li, Lx = factors
    X = np.empty_like(B)
    for j in range(B.shape[1]):
        xx = np.zeros(n)
        xx[pinv] = B[:, j]
        native.lsolve_host(n, Lp, Li, Lx, xx)
        native.ltsolve_host(n, Lp, Li, Lx, xx)
        X[:, j] = xx[pinv]
    return X


def phase_cholsol(seed: int, device: str = "cuda"):
    """cholsol on the card: one cold and three warm calls on the
    CHOL_GRID Laplacian with the analysis reused, checked against the C++
    engine; then the error contracts. Returns (the Laplacian, its
    analysis, the kernel launches of the run)."""
    from rsparse_tpu_torch import NoPivotError, NotPositiveDefiniteError, Sprs
    from rsparse_tpu_torch import cholsol, lusol, schol
    from rsparse_tpu_torch.factor.frontal import MFPlan

    n, Ap, Ai, Ax = laplacian_5pt(CHOL_GRID)
    a = Sprs(len(Ax), n, n, Ap, Ai, Ax)
    rng = np.random.default_rng(seed + 8)
    bs = [rng.standard_normal(n) for _ in range(4)]
    reset_counts()
    t0 = time.perf_counter()
    s = schol(a, 1)
    t_an = time.perf_counter() - t0
    walls, answers, routes = [], [], []
    for b in bs:
        t0 = time.perf_counter()
        answers.append(cholsol(a, b.copy(), 1, sym=s, device=device))
        walls.append(time.perf_counter() - t0)
        routes.append(getattr(s, "_chol_route", None))
    launches = read_counts()["sptrsv_sweep"]
    pinv = np.asarray(s.pinv, np.int64)
    host_walls = []
    for k, (b, x) in enumerate(zip(bs, answers)):
        t0 = time.perf_counter()  # one C++ factorization and solve per call
        xh = chol_host_solves(n, chol_host_factor(a, s), pinv, b[:, None])[:, 0]
        host_walls.append(time.perf_counter() - t0)
        res = float(np.abs(host_residual(a, x) - b).max())
        dev = float(np.abs(x - xh).max() / max(1.0, np.abs(xh).max()))
        print(f"cholsol: call {k} ({'cold' if k == 0 else 'warm'}) "
              f"residual={res:.3e} host_rel_diff={dev:.3e}", flush=True)
        check(bool(np.isfinite(x).all()) and x.shape == (n,),
              f"cholsol call {k}: bad answer")
        check(dev <= 1e-9, f"cholsol call {k}: differs from the host engine "
              f"by {dev:.3e}")
    plan, depth = s._mf_plan, 0
    while isinstance(plan, MFPlan):
        plan, depth = plan.skel_plan, depth + 1
    tail = plan.tail if plan is not None else None
    print(f"cholsol: n={n} nnz={a.nnz()} lnz={int(s.cp[n])} analysis_s="
          f"{t_an:.4f} "
          f"mf_depth={depth} innermost_n={getattr(plan, 'n', None)} "
          f"innermost_levels={len(plan.levels) if plan is not None else None} "
          f"innermost_cut={tail.cut if tail else None} "
          f"innermost_tail={tail.d if tail else None} routes="
          + ",".join(map(str, routes))
          + " wall_s=" + ",".join(f"{w:.4f}" for w in walls)
          + " host_engine_chol_plus_solve_s="
          + ",".join(f"{w:.4f}" for w in host_walls)
          + f" sweep_launches={launches}", flush=True)
    check(set(routes) == {"device_mf"}, f"cholsol routes {routes}, not all "
          "the device multifrontal Cholesky")
    print("cholsol profile (1 warm call): " + device_profile(
        lambda: cholsol(a, bs[0].copy(), 1, sym=s, device=device), 1),
        flush=True)
    replay_cholsol_sweeps(
        lambda: cholsol(a, bs[0].copy(), 1, sym=s, device=device))

    # error contracts on the card
    def negated(m, col):
        x = m.x.copy()
        lo, hi = int(m.p[col]), int(m.p[col + 1])
        x[lo + int(np.nonzero(m.i[lo:hi] == col)[0][0])] = -4.0
        return Sprs(m.nnz(), m.m, m.n, m.p, m.i, x)

    ns, sp_, si, sx = laplacian_5pt(ERR_GRID)
    small = Sprs(len(sx), ns, ns, sp_, si, sx)
    for name, m, sym in (("level", negated(small, ns // 2), None),
                         ("mf", negated(a, n // 2), s)):
        try:
            cholsol(m, np.ones(m.n), 1, sym=sym, device=device)
        except NotPositiveDefiniteError:
            print(f"cholsol: NotPositiveDefiniteError raised ({name} route, "
                  f"n={m.n})", flush=True)
        else:
            raise SmokeError(f"cholsol ({name} route): no "
                             "NotPositiveDefiniteError on an indefinite matrix")
    sing = make_matrix(ERR_GRID, seed)
    x = sing.x.copy()
    x[sing.p[5]: sing.p[6]] = 0.0  # column 5 zero: structurally singular
    sing = Sprs(sing.nnz(), sing.m, sing.n, sing.p, sing.i, x)
    sing.trim()
    try:
        lusol(sing, np.ones(sing.n), 1, 1e-6, device=device)
    except NoPivotError:
        print(f"lusol: NoPivotError raised (n={sing.n})", flush=True)
    else:
        raise SmokeError("lusol: no NoPivotError on a singular matrix")
    return a, s, launches


def record_sweeps(call) -> dict:
    """Run call() with every SpTRSV kernel sweep recorded: {(plan, kind,
    instances, B): (values, X, plan, kind)}, the first launch of each,
    inputs cloned (values [L] with X [n, B], or [K, L] with X [K, n, B])."""
    from rsparse_tpu_torch import solve
    from rsparse_tpu_torch.ops import sptrsv_cuda

    real, seen = sptrsv_cuda.sptrsv_multi, {}

    def record(vals, X, plan, kind, **kw):
        key = (id(plan), kind, tuple(X.shape[:-2]), X.shape[-1])
        if key not in seen:
            seen[key] = (vals.clone(), X.clone(), plan, kind)
        return real(vals, X, plan, kind, **kw)

    record.launches = 0  # the kernel counts its launches on the module's name
    sptrsv_cuda.sptrsv_multi = solve.sptrsv_multi = record
    try:
        call()
    finally:
        sptrsv_cuda.sptrsv_multi = solve.sptrsv_multi = real
    return seen


def plan_csr(vals, plan):
    """The triangle a sweep plan solves, as a CSR tensor on vals' device:
    the plan's off-diagonal entries and diagonal, values gathered from
    vals (for a cuSPARSE yardstick on the same factor)."""
    import torch

    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=vals.device)
    rows = ix(np.concatenate([plan.ent_row, plan.col_id]))
    cols = ix(np.concatenate([plan.ent_col, plan.col_id]))
    pos = ix(np.concatenate([plan.ent_pos, plan.col_diag]))
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals[pos],
                                   (plan.n, plan.n)).coalesce().to_sparse_csr()


def replay_sweeps(label: str, seen: dict, what) -> tuple:
    """Replay recorded kernel sweeps: each held against its plain version,
    its time beside its bound (bytes and operations), the plain version's
    time and a cuSPARSE triangular solve's (`torch.triangular_solve` on
    the same triangle in CSR). what(B) names a sweep in the printed line.
    A sweep of K instances (one launch) is bound by K instances' values
    and X and the shared pattern once (`sweep_work`), and its cuSPARSE
    yardstick is K solves, each on its instance's triangle. Returns (a
    dict of numbers per sweep, the largest difference)."""
    import torch

    from rsparse_tpu_torch.ops.sptrsv_cuda import (launch_config, sptrsv_multi,
                                                   sptrsv_plain_multi)

    out, max_abs = [], 0.0
    for vals, X, plan, kind in seen.values():
        B, dt = X.shape[-1], dname(vals.dtype)
        K = X.shape[0] if X.dim() == 3 else 1
        print_schedule(plan, kind, launch_config(plan, vals.dtype, X.device))
        got = sptrsv_multi(vals, X, plan, kind)
        ref = sptrsv_plain_multi(vals, X, plan, kind)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        check(bool(torch.isfinite(got).all()) and rel <= TOL[dt],
              f"{label} {what(B)} sweep kind={kind} K={K} B={B}: the "
              f"kernel disagrees with the plain version: {rel:.3e}")
        max_abs = max(max_abs, err)
        ms = cuda_ms(lambda: sptrsv_multi(vals, X, plan, kind),
                     5 if B > 1 else 10)
        plain = cuda_ms(lambda: sptrsv_plain_multi(vals, X, plan, kind), 1)
        nbytes, flops = sweep_work(plan, B, vals.element_size(), K)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        Xs, Vs = (list(X), list(vals)) if X.dim() == 3 else ([X], [vals])
        Ts = [plan_csr(v, plan) for v in Vs]
        lib_fn = lambda: torch.stack([torch.triangular_solve(
            x, T, upper=kind in (1, 3), transpose=kind in (2, 3)).solution
            for x, T in zip(Xs, Ts)]).reshape(got.shape)
        try:
            _, lib_rel = rel_err(lib_fn(), got)
            lib = cuda_ms(lib_fn, 3 if B > 1 else 5)
            lib_txt = f"library_ms={lib:.4f} library_rel_diff={lib_rel:.3e}"
        except (RuntimeError, NotImplementedError, TypeError) as e:
            lib, lib_txt = None, f"library: none ({type(e).__name__})"
        print(f"{label}: {what(B)} sweep kind={kind} {dt} K={K} B={B} n={plan.n} "
              f"offdiag={int(plan.ent_off[-1])}: max_abs_err={err:.3e} "
              f"rel_err={rel:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}; {nbytes} bytes, {flops} "
              f"operations) bound_share={b_ms / ms:.5f} {lib_txt}", flush=True)
        out.append({"path": label, "kind": kind, "n": plan.n, "K": K, "B": B,
                    "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib})
    return out, max_abs


def replay_cholsol_sweeps(call) -> None:
    """Every kernel sweep one cholsol call launches, recorded with its
    inputs and replayed (`replay_sweeps`): the factorization's
    W = L_NN^-1 C(N, T) (float64, B = the dense tail's width) and the
    solve's two B = 1 sweeps of L_NN (kinds 0 and 2), when the innermost
    leading block is too large to densify."""
    seen = record_sweeps(call)
    if not seen:
        print("cholsol: no sweep (the innermost leading block is dense)",
              flush=True)
    replay_sweeps("cholsol", seen,
                  lambda B: "L_NN " + ("factor" if B > 1 else "solve"))


def phase_cholsol_serve(a, s, seed: int, device: str = "cuda"):
    """cholsol_serve on the card: 4 requests, checked; the kernel pair
    against its plain version; the L' sweep's time and bound. Returns
    (launches, the L' sweep's numbers, the largest kernel difference)."""
    import torch

    from rsparse_tpu_torch import Sprs, cholsol_serve
    from rsparse_tpu_torch.ops.plan import col_ids, transpose_plan
    from rsparse_tpu_torch.ops.sptrsv_cuda import (launch_config, sptrsv_multi,
                                                   sptrsv_plain_multi)

    n = a.n
    rng = np.random.default_rng(seed + 9)
    requests = [rng.standard_normal((n, NRHS)) for _ in range(REQUESTS)]
    reset_counts()
    h = cholsol_serve(a, 1, sym=s, device=device)
    answers, walls = [], []
    for B in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = h(torch.as_tensor(B, device=device))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        answers.append(X)
    launches = read_counts()["sptrsv_sweep"]
    bsec = h.build_seconds
    print(f"cholsol_serve: n={n} route={h.factor_route} factor_s="
          f"{bsec['factor']:.4f} handle_s={bsec['handle']:.4f} "
          "request_wall_s=" + ",".join(f"{w:.5f}" for w in walls)
          + f" kernel_launches={launches}", flush=True)
    check(h.factor_route == "device_mf", f"cholsol_serve route is "
          f"{h.factor_route}, not the device multifrontal Cholesky")
    check(launches >= 2 * REQUESTS,
          f"cholsol_serve: only {launches} kernel launches for {REQUESTS} "
          "requests")
    factors = chol_host_factor(a, s)
    pinv = np.asarray(s.pinv, np.int64)
    nz = a.nnz()
    Mi = torch.as_tensor(a.i[:nz], device=device)
    Mj = torch.as_tensor(col_ids(a.p, n), device=device)
    Mx = torch.as_tensor(a.x[:nz], device=device)
    for k, (B, X) in enumerate(zip(requests, answers)):
        check(tuple(X.shape) == (n, NRHS) and bool(torch.isfinite(X).all()),
              f"cholsol_serve request {k}: bad answer")
        Bd = torch.as_tensor(B, device=device)
        AX = torch.zeros_like(X).index_add_(0, Mi, Mx[:, None] * X[Mj])
        res = float((AX - Bd).abs().max())
        t0 = time.perf_counter()
        Xh = chol_host_solves(n, factors, pinv, B)
        t_host = time.perf_counter() - t0
        Xc = X.cpu().numpy()
        dev = float(np.abs(Xc - Xh).max() / max(1.0, np.abs(Xh).max()))
        print(f"cholsol_serve: request {k} residual={res:.3e} "
              f"host_rel_diff={dev:.3e} host_engine_128_solves_s="
              f"{t_host:.4f}", flush=True)
        check(dev <= 1e-9, f"cholsol_serve request {k}: differs from the "
              f"host engine by {dev:.3e}")

    # the handle's kernel pair (L then L') against its plain version
    (p0, v32, k0), (p2, _, k2) = h.chain
    Z = torch.as_tensor(requests[0], dtype=torch.float32, device=device)
    Z = torch.zeros_like(Z).index_copy_(
        0, torch.as_tensor(pinv, device=device), Z)
    got = sptrsv_multi(v32, sptrsv_multi(v32, Z, p0, k0), p2, k2)
    ref = sptrsv_plain_multi(v32, sptrsv_plain_multi(v32, Z, p0, k0), p2, k2)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    print(f"cholsol_serve: kernel L,L' pair vs plain float32 B={NRHS}: "
          f"max_abs_err={err:.3e} rel_err={rel:.3e}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= TOL["float32"],
          f"cholsol_serve: the kernel pair disagrees with the plain version: "
          f"{rel:.3e}")
    for plan, kind in ((p0, 0), (p2, 2)):
        print_schedule(plan, kind, launch_config(plan, torch.float32, device))

    # the L' sweep (gather form): time, bound, plain and cuSPARSE
    Y = sptrsv_multi(v32, Z, p0, 0)
    ms = cuda_ms(lambda: sptrsv_multi(v32, Y, p2, 2, contiguous=False), 5)
    plain = cuda_ms(lambda: sptrsv_plain_multi(v32, Y, p2, 2), 1)
    nbytes, flops = sweep_work(p2, NRHS, 4)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    mfp = s._mf_plan  # L's pattern: the multifrontal plan's
    tp = transpose_plan(Sprs(mfp.lnz, n, n, mfp.Lp, mfp.Li, None))
    ix = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
    L_csr = torch.sparse_csr_tensor(ix(tp.out_p), ix(tp.out_i),
                                    v32[ix(tp.perm)], size=(n, n))
    try:
        lib_out = torch.triangular_solve(Y, L_csr, upper=False,
                                         transpose=True).solution
        _, lib_rel = rel_err(lib_out, sptrsv_multi(v32, Y, p2, 2))
        lib = cuda_ms(lambda: torch.triangular_solve(
            Y, L_csr, upper=False, transpose=True).solution, 3)
        lib_txt = f"library_ms={lib:.4f} library_rel_diff={lib_rel:.3e}"
    except (RuntimeError, NotImplementedError, TypeError) as e:
        lib = None
        lib_txt = f"library: none ({type(e).__name__})"
    print(f"cholsol_serve: L' sweep (kind 2) float32 B={NRHS}: "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b_ms:.5f} "
          f"({b_by}, {nbytes} bytes) bound_share={b_ms / ms:.5f} {lib_txt}",
          flush=True)
    B0 = torch.as_tensor(requests[0], device=device)
    print("cholsol_serve profile (2 requests): "
          + device_profile(lambda: h(B0), 2), flush=True)
    return launches, {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib}, err


def qr_matrix(seed: int, grid: Optional[int] = None):
    """A = [A5; QR_REG * I]: A5 = make_matrix(grid, seed) (QR_GRID by
    default: n = 16,384) over a scaled identity, m = 2n, a
    Tikhonov-regularised least-squares problem on the mesh. Returns the
    port's Sprs."""
    from rsparse_tpu_torch import Sprs

    a5 = make_matrix(QR_GRID if grid is None else grid, seed)
    n, nz = a5.n, a5.nnz()
    p = a5.p + np.arange(n + 1)  # one more entry per column, last
    reg = np.zeros(nz + n, dtype=bool)
    reg[p[1:] - 1] = True
    i, x = np.empty(nz + n, np.int64), np.empty(nz + n)
    i[~reg], x[~reg] = a5.i[:nz], a5.x[:nz]
    i[reg], x[reg] = n + np.arange(n), QR_REG
    return Sprs(nz + n, 2 * n, n, p, i, x)


@contextlib.contextmanager
def phase_seconds(module, names, out: dict):
    """Time each call of module.<name> for the names given (device work
    included), summing the seconds into out[name]."""
    import torch

    real = {k: getattr(module, k) for k in names}

    def wrap(k):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            r = real[k](*args, **kw)
            torch.cuda.synchronize()
            out[k] = out.get(k, 0.0) + time.perf_counter() - t0
            return r
        return timed

    for k in names:
        setattr(module, k, wrap(k))
    try:
        yield out
    finally:
        for k, f in real.items():
            setattr(module, k, f)


def coo_mul(a, device: str):
    """(x -> A x, y -> A' y) on the card for the port's Sprs a (float64),
    x and y vectors or [n, B] / [m, B] blocks."""
    import torch

    from rsparse_tpu_torch.ops.plan import col_ids

    nz = a.nnz()
    Mi = torch.as_tensor(a.i[:nz], device=device)
    Mj = torch.as_tensor(col_ids(a.p, a.n), device=device)
    Mx = torch.as_tensor(a.x[:nz], device=device)
    w = lambda v: Mx.view((-1,) + (1,) * (v.dim() - 1))
    amul = lambda x: x.new_zeros((a.m,) + x.shape[1:]).index_add_(
        0, Mi, w(x) * x[Mj])
    atmul = lambda y: y.new_zeros((a.n,) + y.shape[1:]).index_add_(
        0, Mj, w(y) * y[Mi])
    return amul, atmul


def qrsol_calls(label: str, a, bs, s, device: str, check_one):
    """One cold and len(bs) - 1 warm qrsol calls with `s` (b a list on the
    second call, an ndarray otherwise), each checked by check_one(k, b, x)
    -> (host seconds, text); the warm calls reuse the cached factors (A's
    values are unchanged). Then one more call of bs[0] with the value
    fingerprint cleared, which refactors: its wall is a warm call's with
    new values. Returns the x's of the first calls."""
    import torch

    from rsparse_tpu_torch import qrsol
    from rsparse_tpu_torch.factor import frontal_qr

    walls, xs, routes, secs = [], [], [], {}
    for k, b in enumerate(bs):
        arg = list(b) if k == 1 else b.copy()
        torch.cuda.synchronize()
        with phase_seconds(frontal_qr, ("build_qr_mf_plan", "_qr_mf_factor"),
                           secs if k == 0 else {}):
            t0 = time.perf_counter()
            x = qrsol(a, arg, 2, sym=s, device=device)
            walls.append(time.perf_counter() - t0)
        routes.append(s._qr_route)
        if isinstance(arg, list):  # overwritten, grown to n when m < n
            check(len(arg) == max(len(b), len(x))
                  and np.array_equal(np.asarray(arg[: len(x)]), x),
                  f"{label} call {k}: the list b does not hold x")
        xs.append(x)
    host = []
    for k, (b, x) in enumerate(zip(bs, xs)):
        check(bool(np.isfinite(x).all()) and x.shape == (a.n,),
              f"{label} call {k}: bad answer")
        t_host, text = check_one(k, b, x)
        host.append(t_host)
        print(f"{label}: call {k} ({'cold' if k == 0 else 'warm'}) {text}",
              flush=True)
    s._mf_qr_plan.__dict__.pop("_cache_fp")
    t0 = time.perf_counter()
    x = qrsol(a, bs[0].copy(), 2, sym=s, device=device)
    refactor_s = time.perf_counter() - t0
    routes.append(s._qr_route)
    dev = float(np.abs(x - xs[0]).max() / max(1.0, np.abs(xs[0]).max()))
    print(f"{label}: m={a.m} n={a.n} nnz={a.nnz()} routes={','.join(routes)} "
          f"cold_planner_s={secs.get('build_qr_mf_plan', 0.0):.4f} "
          f"cold_factor_s={secs.get('_qr_mf_factor', 0.0):.4f} wall_s="
          + ",".join(f"{w:.4f}" for w in walls)
          + f" refactor_wall_s={refactor_s:.4f} refactor_rel_diff={dev:.3e}"
          + " host_engine_qr_apply_s=" + ",".join(f"{w:.4f}" for w in host),
          flush=True)
    check(set(routes) == {"device_mf"}, f"{label} routes {routes}, not all "
          "the device multifrontal QR")
    check(dev <= 1e-12, f"{label}: the refactored call differs by {dev:.3e}")
    return xs


def phase_qrsol(seed: int, device: str = "cuda"):
    """qrsol on the card, both branches, checked against the C++ engine;
    qrsol_ls; the R sweeps replayed; a profile. Returns (the kernel
    launches of the qrsol and qrsol_ls runs, the R sweeps' numbers, the
    largest kernel difference, the matrices and analyses phase 11
    reuses)."""
    import torch

    from rsparse_tpu_torch import (multiply, qrsol, qrsol_ls, schol, sqr,
                                   transpose)
    from rsparse_tpu_torch.factor.frontal_qr import _qr_mf_factor
    from rsparse_tpu_torch.solve import _qr_ls_host_exact, _qr_mn_host_exact

    a = qr_matrix(seed)
    m, n = a.m, a.n
    rng = np.random.default_rng(seed + 10)
    # one cold and one warm call per branch: each is held to a C++ QR +
    # apply of ~9 s on the card's host, so more warm repeats cost the
    # smoke's time limit more than they tell
    bs = [rng.standard_normal(m) for _ in range(2)]
    bw = [rng.standard_normal(n) for _ in range(2)]
    aw = transpose(a, device="cpu")  # n x m: underdetermined
    amul, atmul = coo_mul(a, device)
    s_ref = sqr(a, 2, True)  # the C++ engine's fresh analysis

    def ls_check(k, b, x):
        t0 = time.perf_counter()
        xp = _qr_ls_host_exact(a, s_ref, b, s_ref.q)
        t_host = time.perf_counter() - t0
        xh = np.zeros(n)
        xh[np.asarray(s_ref.q, np.int64)] = xp
        bd = torch.as_tensor(b, device=device)
        g = float(atmul(bd - amul(torch.as_tensor(x, device=device))).abs().max())
        gs = max(1.0, float(atmul(bd).abs().max()))
        dev = float(np.abs(x - xh).max() / max(1.0, np.abs(xh).max()))
        check(dev <= 1e-9, f"qrsol ls call {k}: differs from the C++ engine "
              f"by {dev:.3e}")
        check(g <= 1e-8 * gs, f"qrsol ls call {k}: gradient {g:.3e} over "
              f"the gate (scale {gs:.3e})")
        return t_host, f"host_rel_diff={dev:.3e} gradient={g:.3e} scale={gs:.3e}"

    reset_counts()
    t0 = time.perf_counter()
    s = sqr(a, 2, True)
    t_an = time.perf_counter() - t0
    x_ls = qrsol_calls("qrsol ls", a, bs, s, device, ls_check)
    plan = s._mf_qr_plan
    print(f"qrsol ls: analysis_s={t_an:.4f} m2={s.m2} rnz={plan.rnz} "
          f"buckets={sum(len(lv) for lv in plan.levels)} "
          f"levels={len(plan.levels)} fronts="
          f"{sum(b.F for lv in plan.levels for b in lv)} largest_front="
          f"{max((b.rp, b.cp) for lv in plan.levels for b in lv)}", flush=True)

    at_ref = transpose(aw, device="cpu")
    sw_ref = sqr(at_ref, 2, True)
    wmul = coo_mul(aw, device)[0]

    def mn_check(k, b, x):
        t0 = time.perf_counter()
        xh = _qr_mn_host_exact(at_ref, sw_ref, b, sw_ref.q)
        t_host = time.perf_counter() - t0
        r = float((torch.as_tensor(b, device=device)
                   - wmul(torch.as_tensor(x, device=device))).abs().max())
        dev = float(np.abs(x - xh).max() / max(1.0, np.abs(xh).max()))
        check(dev <= 1e-9, f"qrsol mn call {k}: differs from the C++ engine "
              f"by {dev:.3e}")
        check(r <= 1e-10 * max(1.0, float(np.abs(b).max())),
              f"qrsol mn call {k}: residual {r:.3e} over bound")
        return t_host, f"host_rel_diff={dev:.3e} residual={r:.3e}"

    sw = sqr(transpose(aw, device="cpu"), 2, True)
    qrsol_calls("qrsol mn", aw, bw, sw, device, mn_check)
    launches = read_counts()["sptrsv_sweep"]
    calls = 2 * (len(bs) + 1)
    print(f"qrsol: sweep_launches={launches} ({calls} calls)", flush=True)
    check(launches >= calls, f"qrsol: only {launches} kernel launches in "
          f"{calls} calls")

    reset_counts()
    t0 = time.perf_counter()
    s_g = schol(multiply(transpose(a, device=device), a, device=device), 2)
    t_an = time.perf_counter() - t0
    walls, xl = [], None
    for _ in range(2):  # cold (the Cholesky plan built) and warm
        t0 = time.perf_counter()
        xl = qrsol_ls(a, bs[0], sym=s_g, device=device)
        walls.append(time.perf_counter() - t0)
    ls_launches = read_counts()["sptrsv_sweep"]
    dev = float(np.abs(xl - x_ls[0]).max() / max(1.0, np.abs(x_ls[0]).max()))
    print(f"qrsol_ls: gram_analysis_s={t_an:.4f} route={s_g._chol_route} "
          f"wall_s={walls[0]:.4f},{walls[1]:.4f} qrsol_rel_diff={dev:.3e} "
          f"sweep_launches={ls_launches}", flush=True)
    check(bool(np.isfinite(xl).all()) and dev <= 1e-8,
          f"qrsol_ls differs from qrsol by {dev:.3e}")

    sweeps, max_abs = [], 0.0
    for label, aa, b, ss in (("ls", a, bs[0], s), ("mn", aw, bw[0], sw)):
        seen = record_sweeps(
            lambda: qrsol(aa, b.copy(), 2, sym=ss, device=device))
        check(len(seen) >= 1, f"qrsol {label}: no R sweep recorded")
        out, err = replay_sweeps(f"qrsol {label}", seen, lambda B: "R")
        sweeps += out
        max_abs = max(max_abs, err)
    print("qrsol ls profile (1 warm call): " + device_profile(
        lambda: qrsol(a, bs[0].copy(), 2, sym=s, device=device), 1),
        flush=True)
    Ax = plan.__dict__["_cache_ax"]
    print("qrsol ls factorization profile (1 warm factorization): "
          + device_profile(lambda: _qr_mf_factor(Ax, plan), 1), flush=True)
    return launches + ls_launches, sweeps, max_abs, {
        "a": a, "aw": aw, "ls": s, "mn": sw, "gram": s_g, "ls_ref": s_ref,
        "at_ref": at_ref}


def timed_calls(call, k: int) -> tuple:
    """k calls of call(), each timed with the card synchronized around it:
    (the results, the walls in seconds)."""
    import torch

    outs, walls = [], []
    for _ in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(call())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return outs, walls


def walls_txt(walls) -> str:
    return ",".join(f"{w:.4f}" for w in walls)


def replay_new(label: str, seen: dict, keep) -> tuple:
    """Replay (`replay_sweeps`) the recorded kernel sweeps (`record_sweeps`)
    that keep(values dtype, B) selects; at least one must be."""
    seen = {k: v for k, v in seen.items() if keep(v[0].dtype, v[1].shape[-1])}
    check(len(seen) >= 1, f"{label}: no kernel sweep recorded")
    return replay_sweeps(label, seen, lambda B: f"B={B}")


def multi_cholsol(lap, lap_sym, seed: int, device: str):
    """cholsol_multi on the CHOL_GRID Laplacian with phase 8's analysis,
    B[n, 128]: one cold (its first call) and three warm calls, route
    device_mf, held to one C++ factorization plus 128 sequential C++ solves;
    the skeleton's f64 B = 128 sweeps replayed. Returns (launches, sweep
    numbers, the largest kernel difference)."""
    from rsparse_tpu_torch import cholsol_multi

    n = lap.n
    B = np.random.default_rng(seed + 11).standard_normal((n, NRHS))
    reset_counts()
    routes = []

    def call():
        X = cholsol_multi(lap, B, 1, sym=lap_sym, device=device)
        routes.append(lap_sym._multi_route)
        return X

    xs, walls = timed_calls(call, 4)
    launches = read_counts()["sptrsv_sweep"]
    t0 = time.perf_counter()
    Xh = chol_host_solves(n, chol_host_factor(lap, lap_sym),
                          np.asarray(lap_sym.pinv, np.int64), B)
    t_host = time.perf_counter() - t0
    devs = [float(np.abs(X - Xh).max() / max(1.0, np.abs(Xh).max()))
            for X in xs]
    print(f"cholsol_multi: n={n} B={NRHS} routes={','.join(routes)} wall_s="
          f"{walls_txt(walls)} host_engine_chol_plus_128_solves_s={t_host:.4f} "
          f"host_rel_diff={max(devs):.3e} sweep_launches={launches}",
          flush=True)
    for X in xs:
        check(X.shape == (n, NRHS) and bool(np.isfinite(X).all()),
              "cholsol_multi: bad answer")
    check(set(routes) == {"device_mf"}, f"cholsol_multi routes {routes}, not "
          "all the device multifrontal tree")
    check(max(devs) <= 1e-9, f"cholsol_multi differs from the C++ engine by "
          f"{max(devs):.3e}")
    check(launches >= 4, f"cholsol_multi: only {launches} kernel launches in "
          "4 calls")
    print("cholsol_multi profile (1 warm call): " + device_profile(call, 1),
          flush=True)
    sweeps, err = replay_new("cholsol_multi", record_sweeps(call),
                             lambda dt, b: b == NRHS)
    return launches, sweeps, err


def multi_lusol(a, s, seed: int, device: str):
    """lusol_multi on the lusol matrix with phase 7's analysis, B[n, 128]:
    one cold and three warm calls, route device_mf, held to its residual
    and to the C++ engine's LU plus 128 solves. Returns the launches."""
    import torch

    from rsparse_tpu_torch import lusol_multi, sqr
    from rsparse_tpu_torch.symbolic import native

    n, nz = a.n, a.nnz()
    B = np.random.default_rng(seed + 12).standard_normal((n, NRHS))
    reset_counts()
    routes = []

    def call():
        X = lusol_multi(a, B, 1, 1e-6, sym=s, device=device)
        routes.append(s._multi_route)
        return X

    xs, walls = timed_calls(call, 4)
    launches = read_counts()["sptrsv_sweep"]
    s0 = sqr(a, 1, False)
    t0 = time.perf_counter()
    Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
        n, a.p, a.i[:nz], a.x[:nz], s0.q, 1e-6, s0.lnz, s0.unz)
    Xh = host_solves(a, B, (Lp, Li, Lx, Up, Ui, Ux, pinv,
                            np.asarray(s0.q, np.int64)))
    t_host = time.perf_counter() - t0
    amul = coo_mul(a, device)[0]
    Bd = torch.as_tensor(B, device=device)
    res = max(float((amul(torch.as_tensor(X, device=device)) - Bd).abs().max())
              for X in xs)
    devs = max(float(np.abs(X - Xh).max() / max(1.0, np.abs(Xh).max()))
               for X in xs)
    print(f"lusol_multi: n={n} B={NRHS} routes={','.join(routes)} wall_s="
          f"{walls_txt(walls)} host_engine_lu_plus_128_solves_s={t_host:.4f} "
          f"residual={res:.3e} host_rel_diff={devs:.3e} "
          f"sweep_launches={launches}", flush=True)
    for X in xs:
        check(X.shape == (n, NRHS) and bool(np.isfinite(X).all()),
              "lusol_multi: bad answer")
    check(set(routes) == {"device_mf"}, f"lusol_multi routes {routes}, not "
          "all the device multifrontal one-shot")
    check(res <= 1e-10 * max(1.0, float(np.abs(B).max())),
          f"lusol_multi: residual {res:.3e} over bound")
    check(devs <= 1e-8, f"lusol_multi differs from the C++ engine by "
          f"{devs:.3e}")
    print("lusol_multi profile (1 warm call): " + device_profile(call, 1),
          flush=True)
    return launches


def host_qr_apply(label: str, V, beta, R, sref, B, m: int, n: int):
    """The C++ engine's QR (V, beta, R; analysis sref) applied to the
    columns of B for the m x n system of one branch: least squares (the QR
    is of A) by the C++ `qr_ls_apply` per column, or minimum norm (the QR
    is of A') by the C++ utsolve per column, then the Householder
    reflections over all columns at once in numpy."""
    from rsparse_tpu_torch.symbolic import native

    q, pinv = np.asarray(sref.q, np.int64), np.asarray(sref.pinv, np.int64)
    if label == "ls":
        X = np.empty((n, B.shape[1]))
        for j in range(B.shape[1]):
            xx = np.zeros(sref.m2)
            xx[pinv[:m]] = B[:, j]
            native.qr_ls_apply(n, V.p, V.i, V.x, beta, R.p, R.i, R.x, xx)
            X[q, j] = xx[:n]
        return X
    Z = np.zeros((sref.m2, B.shape[1]))
    Z[:m] = B[q]
    for j in range(B.shape[1]):
        col = np.ascontiguousarray(Z[:m, j])
        native.utsolve_host(m, R.p, R.i, R.x, col)
        Z[:m, j] = col
    for k in range(m - 1, -1, -1):
        lo, hi = int(V.p[k]), int(V.p[k + 1])
        rows, v = V.i[lo:hi], V.x[lo:hi]
        Z[rows] -= np.outer(v, beta[k] * (v @ Z[rows]))
    return Z[pinv[:n]]


def multi_qrsol(qr: dict, seed: int, device: str):
    """qrsol_serve and qrsol_multi on phase 10's matrices, both branches,
    B[m, 128], with the Gram analysis of phase 10's qrsol_ls (A'A of A is
    also the minimum-norm branch's Gram): per branch one handle build, 4
    requests, then qrsol_multi once cold (its own cached handle) and once
    warm; every answer held to the JAX package's oracle (least squares:
    max|A'(B - AX)| <= 1e-8 max(1, max|B|); minimum norm: max|B - AX| <=
    1e-10 max(1, max|B|)), columns 0 and 1 to the port's qrsol, and all of
    it to the C++ engine's QR and 128 applies; the handle's f32 B = 128
    Gram sweeps replayed. Returns (launches of qrsol_serve, of
    qrsol_multi, sweep numbers, the largest kernel difference)."""
    import torch

    from rsparse_tpu_torch import qrsol, qrsol_multi, qrsol_serve
    from rsparse_tpu_torch.solve import _qr_host

    rng = np.random.default_rng(seed + 13)
    t0 = time.perf_counter()
    V, beta, R = _qr_host(qr["at_ref"], qr["ls_ref"], qr["ls_ref"].q)
    t_qr = time.perf_counter() - t0
    launches = {"qrsol_serve": 0, "qrsol_multi": 0}
    sweeps, max_abs = [], 0.0
    for label in ("ls", "mn"):
        a = qr["a"] if label == "ls" else qr["aw"]
        m, n = a.m, a.n
        s, s_qr = qr["gram"], qr[label]
        B = rng.standard_normal((m, NRHS))
        amul, atmul = coo_mul(a, device)
        Bd = torch.as_tensor(B, device=device)
        scale = max(1.0, float(np.abs(B).max()))

        def oracle(X):
            Xd = torch.as_tensor(X, device=device)
            r = Bd - amul(Xd)
            return float((atmul(r) if label == "ls" else r).abs().max())

        bound = (1e-8 if label == "ls" else 1e-10) * scale
        reset_counts()
        t0 = time.perf_counter()
        h = qrsol_serve(a, 2, sym=s, device=device)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        xs, walls = timed_calls(lambda: h(Bd), REQUESTS)
        n_serve = read_counts()["sptrsv_sweep"]
        launches["qrsol_serve"] += n_serve
        check(h.available, f"qrsol_serve {label}: the kernel does not take "
              "the Gram factor's plans")
        check(n_serve >= 2 * REQUESTS, f"qrsol_serve {label}: only "
              f"{n_serve} kernel launches in {REQUESTS} requests")
        reset_counts()
        routes = []

        def multi():
            X = qrsol_multi(a, B, 2, sym=s, device=device)
            routes.append(s._multi_route)
            return X

        xm, mwalls = timed_calls(multi, 2)
        n_multi = read_counts()["sptrsv_sweep"]
        launches["qrsol_multi"] += n_multi
        t0 = time.perf_counter()
        Xh = host_qr_apply(label, V, beta, R, qr["ls_ref"], B, m, n)
        t_apply = time.perf_counter() - t0
        answers = [X.cpu().numpy() for X in xs] + xm
        opts = [oracle(X) for X in answers]
        devs = [float(np.abs(X - Xh).max() / max(1.0, np.abs(Xh).max()))
                for X in answers]
        cols = max(float(np.abs(answers[-1][:, j] - x).max()
                         / max(1.0, np.abs(x).max()))
                   for j, x in enumerate(
                       qrsol(a, B[:, j].copy(), 2, sym=s_qr, device=device)
                       for j in range(2)))
        print(f"qrsol_serve {label}: m={m} n={n} B={NRHS} route="
              f"{h.factor_route} build_s={t_build:.4f} request_wall_s="
              f"{walls_txt(walls)} last_residual={h.last_residual:.3e} "
              f"sweep_launches={n_serve}", flush=True)
        print(f"qrsol_multi {label}: routes={','.join(routes)} wall_s="
              f"{walls_txt(mwalls)} oracle_max={max(opts):.3e} (bound "
              f"{bound:.3e}) qrsol_cols_rel_diff={cols:.3e} host_rel_diff="
              f"{max(devs):.3e} host_engine_qr_s={t_qr:.4f} "
              f"host_engine_128_applies_s={t_apply:.4f} "
              f"sweep_launches={n_multi}", flush=True)
        for X in answers:
            check(X.shape == (n, NRHS) and bool(np.isfinite(X).all()),
                  f"qrsol {label}: bad batched answer")
        check(set(routes) == {"serve"}, f"qrsol_multi {label} routes "
              f"{routes}, not all the serving handle")
        check(n_multi >= 4, f"qrsol_multi {label}: only {n_multi} kernel "
              "launches in 2 calls")
        check(max(opts) <= bound, f"qrsol {label} batched: oracle "
              f"{max(opts):.3e} over {bound:.3e}")
        check(cols <= 1e-8, f"qrsol_multi {label}: columns differ from "
              f"qrsol by {cols:.3e}")
        check(max(devs) <= 1e-8, f"qrsol {label} batched: differs from "
              f"the C++ engine by {max(devs):.3e}")
        print(f"qrsol_serve {label} profile (1 request): "
              + device_profile(lambda: h(Bd), 1), flush=True)
        if label == "ls":  # the minimum norm's Gram sweeps are the same
            out, err = replay_new("qrsol_serve", record_sweeps(lambda: h(Bd)),
                                  lambda dt, b: True)
            sweeps += out
            max_abs = max(max_abs, err)
    return launches["qrsol_serve"], launches["qrsol_multi"], sweeps, max_abs


def multi_cholsol_ir(lap, lap_sym, seed: int, device: str):
    """cholsol_ir on D A D (A the CHOL_GRID Laplacian, D = 1 + 0.1 U(0, 1)
    from the seed: values that lose bits in float32), one b, float32,
    refine = 3: held to cholsol on the same matrix (phase 8's analysis)
    and timed beside the C++ engine's factorization and solve; its f32
    B = 1 sweeps replayed. Returns (launches, sweep numbers, the largest
    kernel difference)."""
    import torch

    from rsparse_tpu_torch import Sprs, cholsol, cholsol_ir
    from rsparse_tpu_torch.ops.plan import col_ids

    n, nz = lap.n, lap.nnz()
    rng = np.random.default_rng(seed + 14)
    d = 1.0 + 0.1 * rng.random(n)
    dad = Sprs(nz, n, n, lap.p, lap.i[:nz],
               lap.x[:nz] * d[lap.i[:nz]] * d[col_ids(lap.p, n)])
    b = rng.standard_normal(n)
    reset_counts()
    bl = b.copy()
    (x,), walls = timed_calls(
        lambda: cholsol_ir(dad, bl, 1, "float32", 3, device=device), 1)
    launches = read_counts()["sptrsv_sweep"]
    check(np.array_equal(bl, x), "cholsol_ir: b not overwritten")
    xc = cholsol(dad, b.copy(), 1, sym=lap_sym, device=device)
    t0 = time.perf_counter()
    xh = chol_host_solves(n, chol_host_factor(dad, lap_sym),
                          np.asarray(lap_sym.pinv, np.int64), b[:, None])[:, 0]
    t_host = time.perf_counter() - t0
    dev = float(np.abs(x - xc).max() / max(1.0, np.abs(xc).max()))
    hdev = float(np.abs(x - xh).max() / max(1.0, np.abs(xh).max()))
    print(f"cholsol_ir: n={n} float32 refine=3 wall_s={walls_txt(walls)} "
          f"host_engine_chol_plus_solve_s={t_host:.4f} cholsol_rel_diff="
          f"{dev:.3e} host_rel_diff={hdev:.3e} sweep_launches={launches}",
          flush=True)
    check(bool(np.isfinite(x).all()) and x.shape == (n,),
          "cholsol_ir: bad answer")
    check(dev <= 1e-8, f"cholsol_ir differs from cholsol by {dev:.3e}")
    check(launches >= 2, f"cholsol_ir: only {launches} kernel launches")
    seen = {}
    call = lambda: seen.update(record_sweeps(lambda: cholsol_ir(
        dad, b.copy(), 1, "float32", 3, device=device)))
    print("cholsol_ir profile (1 call, its sweeps recorded): "
          + device_profile(call, 1), flush=True)
    sweeps, err = replay_new("cholsol_ir", seen,
                             lambda dt, B: B == 1 and dt == torch.float32)
    return launches, sweeps, err


def phase_multi(a, lu_sym, lap, lap_sym, qr: dict, seed: int,
                device: str = "cuda"):
    """Phase 11: the batched and serving drivers at full width, each
    driven with the launch counts set to 0 just before it and read just
    after. Returns (launches by path, the new sweeps' numbers, the largest
    kernel difference)."""
    t0 = time.perf_counter()
    by_path, sweeps, max_abs = {}, [], 0.0
    by_path["cholsol_multi"], out, err = multi_cholsol(lap, lap_sym, seed,
                                                       device)
    sweeps, max_abs = sweeps + out, max(max_abs, err)
    by_path["lusol_multi"] = multi_lusol(a, lu_sym, seed, device)
    by_path["qrsol_serve"], by_path["qrsol_multi"], out, err = multi_qrsol(
        qr, seed, device)
    sweeps, max_abs = sweeps + out, max(max_abs, err)
    by_path["cholsol_ir"], out, err = multi_cholsol_ir(lap, lap_sym, seed,
                                                       device)
    sweeps, max_abs = sweeps + out, max(max_abs, err)
    print(f"multi: phase_s={time.perf_counter() - t0:.1f} sweep_launches="
          f"{by_path}", flush=True)
    return by_path, sweeps, max_abs


VALS_K = {"chol": 16, "lu": 8, "qr": 4}  # phase 12's instances per driver


def upload_s(AxK: np.ndarray, device: str) -> float:
    """Seconds to move a [K, nnz] value batch to the card, synchronized
    (the upload each batched-values call makes of its instances)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.as_tensor(AxK, device=device)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def vals_calls(call, s):
    """One cold (the first of its shapes in this run) and one warm call of
    a batched-values driver on analysis s: (answers, walls, routes, peak
    device bytes of the two calls)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    routes = []

    def run():
        X = call()
        routes.append(s._vals_route)
        return X

    xs, walls = timed_calls(run, 2)
    return xs, walls, routes, torch.cuda.max_memory_allocated()


def inst_rel(X, Xh, ks) -> list:
    """Per instance k of ks: max|X[k] - Xh[k]| / max(1, max|Xh[k]|)."""
    return [float(np.abs(X[k] - Xh[k]).max() / max(1.0, np.abs(Xh[k]).max()))
            for k in ks]


def errs_txt(errs) -> str:
    return ",".join(f"{e:.2e}" for e in errs)


def check_vals(label: str, xs, routes, K: int, n: int, launches: int,
               most: int) -> None:
    """The checks every phase 12 driver shares: finite [K, n] answers, the
    device route with no instance re-solved, and at most `most` kernel
    launches over its two calls (one launch per sweep for all K)."""
    for X in xs:
        check(X.shape == (K, n) and bool(np.isfinite(X).all()),
              f"{label}: bad answer")
    check(set(routes) == {("device_mf", 0)}, f"{label}: routes {routes}, "
          "not all the device multifrontal route with no re-solve")
    check(launches <= most, f"{label}: {launches} kernel launches in 2 "
          f"calls (at most {most}: one per sweep for all {K} instances)")


def vals_cholsol(lap, lap_sym, seed: int, device: str):
    """cholsol_vals on the CHOL_GRID Laplacian with phase 8's analysis:
    K = 16 instances, diagonals scaled by 1 + 0.25k (the JAX bench's
    family, bench.py:336-340), B[K, n] from the seed. One cold and one warm
    call (route device_mf, no instance re-solved), every instance held to
    the C++ engine's factorization and solve (1e-9 relative), walls beside
    those K C++ solves and K port cholsol calls; then one instance's
    diagonal negated must raise NotPositiveDefiniteError naming exactly it;
    the instance-batched sweeps replayed. Returns (launches, sweep
    numbers, the largest kernel difference)."""
    from rsparse_tpu_torch import (NotPositiveDefiniteError, Sprs, cholsol,
                                   cholsol_vals)
    from rsparse_tpu_torch.ops.plan import col_ids

    K, n, nz = VALS_K["chol"], lap.n, lap.nnz()
    diag = lap.i[:nz] == col_ids(lap.p, n)
    AxK = np.tile(lap.x[:nz], (K, 1))
    AxK[:, diag] *= (1.0 + 0.25 * np.arange(K))[:, None]
    B = np.random.default_rng(seed + 15).standard_normal((K, n))
    inst = lambda k: Sprs(nz, n, n, lap.p, lap.i[:nz], AxK[k])
    call = lambda: cholsol_vals(lap, AxK, B, 1, sym=lap_sym, device=device)
    up = upload_s(AxK, device)
    reset_counts()
    xs, walls, routes, peak = vals_calls(call, lap_sym)
    launches = read_counts()["sptrsv_sweep"]
    pinv = np.asarray(lap_sym.pinv, np.int64)
    t0 = time.perf_counter()
    Xh = np.stack([chol_host_solves(n, chol_host_factor(inst(k), lap_sym),
                                    pinv, B[k][:, None])[:, 0]
                   for k in range(K)])
    t_host = time.perf_counter() - t0
    _, loop = timed_calls(lambda: [cholsol(inst(k), B[k].copy(), 1,
                                           sym=lap_sym, device=device)
                                   for k in range(K)], 1)
    errs = inst_rel(xs[-1], Xh, range(K))
    dev = max(max(inst_rel(X, Xh, range(K))) for X in xs)
    print(f"cholsol_vals: n={n} K={K} routes={routes} wall_s="
          f"{walls_txt(walls)} host_engine_{K}_chol_plus_solve_s="
          f"{t_host:.4f} port_{K}_cholsol_loop_s={loop[0]:.4f} upload_s="
          f"{up:.4f} ({AxK.nbytes} bytes) peak_mem_bytes={peak} "
          f"host_rel_diff_per_instance={errs_txt(errs)} "
          f"sweep_launches={launches}", flush=True)
    # a call: the factor's W sweep, then two per solve (at most 5 solves)
    check_vals("cholsol_vals", xs, routes, K, n, launches, 2 * 11)
    check(launches >= 2 * 2, f"cholsol_vals: only {launches} kernel "
          "launches in 2 calls")
    check(dev <= 1e-9, f"cholsol_vals differs from the C++ engine by "
          f"{dev:.3e}")
    kb = K // 2 + 1
    bad = AxK.copy()
    bad[kb, diag] *= -1.0
    try:
        cholsol_vals(lap, bad, B, 1, sym=lap_sym, device=device)
    except NotPositiveDefiniteError as e:
        check(f"instances [{kb}] are not" in str(e), f"cholsol_vals: the "
              f"error names other instances: {e}")
        print(f"cholsol_vals: NotPositiveDefiniteError raised naming "
              f"instance {kb} ({lap_sym._vals_route})", flush=True)
    else:
        raise SmokeError("cholsol_vals: no NotPositiveDefiniteError on an "
                         "indefinite instance")
    print("cholsol_vals profile (1 warm call): " + device_profile(call, 1),
          flush=True)
    sweeps, err = replay_sweeps(
        "cholsol_vals", {k: v for k, v in record_sweeps(call).items()
                         if v[1].dim() == 3},
        lambda B: "L_NN " + ("factor" if B > 1 else "solve"))
    check(len(sweeps) >= 1, "cholsol_vals: no instance-batched sweep")
    return launches, sweeps, err


def vals_lusol(a, s, seed: int, device: str):
    """lusol_vals on phase 7's matrix and analysis: K = 8 instances, 0-6
    with diagonals scaled by 1 + 0.2k, 7 with its off-diagonals redrawn
    from the seed (other pivots), B[K, n]. One cold and one warm call
    (route device_mf, no instance re-solved), every instance held to its
    residual and to the C++ engine's LU and solve (1e-8 relative), walls
    beside those K C++ solves and K port lusol calls. The dense skeleton
    runs no sweep. Returns the launches."""
    from rsparse_tpu_torch import Sprs, lusol, lusol_vals, sqr
    from rsparse_tpu_torch.ops.plan import col_ids
    from rsparse_tpu_torch.symbolic import native

    K, n, nz = VALS_K["lu"], a.n, a.nnz()
    diag = a.i[:nz] == col_ids(a.p, n)
    AxK = np.tile(a.x[:nz], (K, 1))
    AxK[:-1, diag] *= (1.0 + 0.2 * np.arange(K - 1))[:, None]
    rng = np.random.default_rng(seed + 16)
    AxK[-1, ~diag] = -(1.0 + 0.3 * rng.standard_normal(int((~diag).sum())))
    B = rng.standard_normal((K, n))
    inst = lambda k: Sprs(nz, n, n, a.p, a.i[:nz], AxK[k])
    call = lambda: lusol_vals(a, AxK, B, 1, 1e-6, sym=s, device=device)
    up = upload_s(AxK, device)
    reset_counts()
    xs, walls, routes, peak = vals_calls(call, s)
    launches = read_counts()["sptrsv_sweep"]
    s0 = sqr(a, 1, False)
    q = np.asarray(s0.q, np.int64)
    t0 = time.perf_counter()
    Xh = []
    for k in range(K):
        f = native.lu_numeric(n, a.p, a.i[:nz], AxK[k], s0.q, 1e-6, s0.lnz,
                              s0.unz)
        Xh.append(host_solves(inst(k), B[k][:, None], (*f, q))[:, 0])
    t_host = time.perf_counter() - t0
    _, loop = timed_calls(lambda: [lusol(inst(k), B[k].copy(), 1, 1e-6,
                                         sym=s, device=device)
                                   for k in range(K)], 1)
    errs = inst_rel(xs[-1], Xh, range(K))
    dev = max(max(inst_rel(X, Xh, range(K))) for X in xs)
    res = [float(np.abs(host_residual(inst(k), X[k]) - B[k]).max()
                 / max(1.0, float(np.abs(B[k]).max())))
           for X in xs for k in range(K)]
    print(f"lusol_vals: n={n} K={K} routes={routes} wall_s="
          f"{walls_txt(walls)} host_engine_{K}_lu_plus_solve_s={t_host:.4f} "
          f"port_{K}_lusol_loop_s={loop[0]:.4f} upload_s={up:.4f} "
          f"({AxK.nbytes} bytes) peak_mem_bytes={peak} "
          f"host_rel_diff_per_instance={errs_txt(errs)} residual_max="
          f"{max(res):.3e} sweep_launches={launches}", flush=True)
    check_vals("lusol_vals", xs, routes, K, n, launches, 0)
    check(max(res) <= 1e-10, f"lusol_vals: residual {max(res):.3e} over "
          "1e-10 max(1, max|b|)")
    check(dev <= 1e-8, f"lusol_vals differs from the C++ engine by "
          f"{dev:.3e}")
    print("lusol_vals profile (1 warm call): " + device_profile(call, 1),
          flush=True)
    return launches


def vals_qrsol(qr: dict, seed: int, device: str):
    """qrsol_vals on phase 10's matrices and analyses, both branches, K = 4
    instances with values scaled by 1 + 0.1k, B[K, m]. Per branch one cold
    and one warm call (route device_mf, no instance re-solved), every
    instance held to the gate (the least-squares gradient, or the
    residual, as phase 10) and to the port's qrsol (1e-9 relative),
    instances 0 and K-1 to the C++ engine's QR and apply (1e-9; each QR
    takes seconds, so only those two; the QR of A_k serves both branches,
    the minimum norm factoring (A_k')' = A_k); the R sweeps replayed.
    Returns (launches, sweep numbers, the largest kernel difference)."""
    import torch

    from rsparse_tpu_torch import Sprs, qrsol, qrsol_vals
    from rsparse_tpu_torch.solve import _qr_host

    K = VALS_K["qr"]
    f = 1.0 + 0.1 * np.arange(K)
    a, sref = qr["a"], qr["ls_ref"]
    host, host_s = {}, {}
    for k in (0, K - 1):
        t0 = time.perf_counter()
        host[k] = _qr_host(Sprs(a.nnz(), a.m, a.n, a.p, a.i[: a.nnz()],
                                a.x[: a.nnz()] * f[k]), sref, sref.q)
        host_s[k] = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 17)
    launches, sweeps, max_abs = 0, [], 0.0
    for label in ("ls", "mn"):
        aa, s = (a if label == "ls" else qr["aw"]), qr[label]
        m, n, nz = aa.m, aa.n, aa.nnz()
        AxK = aa.x[:nz][None, :] * f[:, None]
        B = rng.standard_normal((K, m))
        inst = lambda k: Sprs(nz, m, n, aa.p, aa.i[:nz], AxK[k])
        call = lambda: qrsol_vals(aa, AxK, B, 2, sym=s, device=device)
        up = upload_s(AxK, device)
        reset_counts()
        xs, walls, routes, peak = vals_calls(call, s)
        n_l = read_counts()["sptrsv_sweep"]
        launches += n_l
        xq, loop = timed_calls(lambda: [qrsol(inst(k), B[k].copy(), 2, sym=s,
                                              device=device)
                                        for k in range(K)], 1)
        qdev = max(max(inst_rel(X, xq[0], range(K))) for X in xs)
        gates = []
        for k in range(K):
            amul, atmul = coo_mul(inst(k), device)
            bd = torch.as_tensor(B[k], device=device)
            r = bd - amul(torch.as_tensor(xs[-1][k], device=device))
            if label == "ls":
                g, gs = float(atmul(r).abs().max()), float(atmul(bd).abs().max())
                gates.append(g / (1e-8 * max(1.0, gs)))
            else:
                gates.append(float(r.abs().max())
                             / (1e-10 * max(1.0, float(np.abs(B[k]).max()))))
        hdev, happly = [], []
        for k in (0, K - 1):
            t0 = time.perf_counter()
            xh = host_qr_apply(label, *host[k], sref, B[k][:, None], m, n)[:, 0]
            happly.append(time.perf_counter() - t0)
            hdev.append(max(float(np.abs(X[k] - xh).max()
                                  / max(1.0, np.abs(xh).max())) for X in xs))
        print(f"qrsol_vals {label}: m={m} n={n} K={K} routes={routes} wall_s="
              f"{walls_txt(walls)} port_{K}_qrsol_loop_s={loop[0]:.4f} "
              f"host_engine_qr_s(instances 0,{K - 1})="
              f"{host_s[0]:.4f},{host_s[K - 1]:.4f} host_engine_apply_s="
              f"{walls_txt(happly)} upload_s={up:.4f} ({AxK.nbytes} bytes) "
              f"peak_mem_bytes={peak} gate_share_per_instance="
              f"{errs_txt(gates)} qrsol_rel_diff={qdev:.3e} "
              f"host_rel_diff(instances 0,{K - 1})={errs_txt(hdev)} "
              f"sweep_launches={n_l}", flush=True)
        check_vals(f"qrsol_vals {label}", xs, routes, K, n, n_l, 2)
        check(n_l == 2, f"qrsol_vals {label}: {n_l} kernel launches in 2 "
              "calls, not one R sweep each")
        check(max(gates) <= 1.0, f"qrsol_vals {label}: an instance misses "
              f"the gate ({max(gates):.3e} of it)")
        check(qdev <= 1e-9, f"qrsol_vals {label} differs from qrsol by "
              f"{qdev:.3e}")
        check(max(hdev) <= 1e-9, f"qrsol_vals {label} differs from the C++ "
              f"engine by {max(hdev):.3e}")
        if label == "ls":
            print("qrsol_vals ls profile (1 warm call): "
                  + device_profile(call, 1), flush=True)
        out, err = replay_sweeps(f"qrsol_vals {label}", record_sweeps(call),
                                 lambda B: "R")
        sweeps, max_abs = sweeps + out, max(max_abs, err)
    return launches, sweeps, max_abs


def phase_vals(a, lu_sym, lap, lap_sym, qr: dict, seed: int,
               device: str = "cuda"):
    """Phase 12: the batched-values drivers at full width, each driven
    with the launch counts set to 0 just before it and read just after.
    Returns (launches by path, the instance-batched sweeps' numbers, the
    largest kernel difference)."""
    t0 = time.perf_counter()
    by_path, sweeps, max_abs = {}, [], 0.0
    by_path["cholsol_vals"], out, err = vals_cholsol(lap, lap_sym, seed,
                                                     device)
    sweeps, max_abs = sweeps + out, max(max_abs, err)
    by_path["lusol_vals"] = vals_lusol(a, lu_sym, seed, device)
    by_path["qrsol_vals"], out, err = vals_qrsol(qr, seed, device)
    sweeps, max_abs = sweeps + out, max(max_abs, err)
    print(f"vals: phase_s={time.perf_counter() - t0:.1f} sweep_launches="
          f"{by_path}", flush=True)
    return by_path, sweeps, max_abs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    warnings.filterwarnings("ignore", message=".*[Ss]parse")  # beta CSR notes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rsparse_tpu_torch.ops import cuda_build, spmm_cuda, spmv, sptrsv_cuda
    from rsparse_tpu_torch.symbolic import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    native.load()
    t1 = time.perf_counter()
    secs = cuda_build.compile_all(["sptrsv", "spmm", "spmv_dia"])
    for mod in (sptrsv_cuda, spmm_cuda, spmv):
        mod.build()
    t2 = time.perf_counter()
    print(f"build: host_engine_s={t1 - t0:.2f} sptrsv_kernel_s="
          f"{secs['sptrsv']:.2f} spmm_kernel_s={secs['spmm']:.2f} "
          f"spmv_dia_kernel_s={secs['spmv_dia']:.2f} kernels_wall_s="
          f"{t2 - t1:.2f} ({sptrsv_cuda.SOURCE}, {spmm_cuda.SOURCE}, "
          f"{spmv.SOURCE})", flush=True)

    a = make_matrix(GRID, args.seed)
    try:
        max_abs, main_ms = phase_kernels(a, args.seed)
        launches = phase_main(a, args.seed)
        dia, dia_err, dia_counts = phase_dia(args.seed)
        spmm, spmm_err, spmm_counts = phase_spmm(args.seed)
        lusol_launches, lu_sym = phase_lusol(a, args.seed)
        lap, lap_sym, cholsol_launches = phase_cholsol(args.seed)
        serve_launches, kind2, kind2_err = phase_cholsol_serve(
            lap, lap_sym, args.seed)
        qr_launches, r_sweeps, r_err, qr = phase_qrsol(args.seed)
        multi_paths, multi_sweeps, multi_err = phase_multi(
            a, lu_sym, lap, lap_sym, qr, args.seed)
        vals_paths, vals_sweeps, vals_err = phase_vals(
            a, lu_sym, lap, lap_sym, qr, args.seed)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    entry = lambda name, src, rep, n, err, t: dict(
        name=name, route="cuda", source=f"rsparse_tpu_torch/csrc/{src}",
        replaces=rep, launches=n, max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"])
    by_path = {"lusol_serve": launches, "cholsol_serve": serve_launches,
               "cholsol": cholsol_launches, "lusol": lusol_launches,
               "qrsol": qr_launches, **multi_paths, **vals_paths}
    print(f"sptrsv_sweep launches by main path: {by_path}; the L' (kind 2) "
          f"sweep: {kind2}", flush=True)
    sweep = entry("sptrsv_sweep", "sptrsv.cu",
                  "rsparse_tpu/ops/sptrsv_pallas.py:191",
                  sum(by_path.values()),
                  max(max_abs, kind2_err, r_err, multi_err, vals_err),
                  main_ms)
    sweep["launches_by_path"] = by_path
    sweep["qr_r_sweeps"] = r_sweeps
    sweep["multi_sweeps"] = multi_sweeps
    sweep["vals_sweeps"] = vals_sweeps
    print(json.dumps({"kernels": [
        sweep,
        entry("spmm_stream", "spmm.cu", "rsparse_tpu/ops/spmm_pallas.py:105",
              spmm_counts["spmm_stream"], spmm_err, spmm[("float64", NRHS)]),
        entry("spmv_dia", "spmv_dia.cu", "rsparse_tpu/ops/spmv.py:194",
              dia_counts["spmv_dia"], dia_err, dia["float32"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
