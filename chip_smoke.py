#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (rsparse_tpu_torch) on one GPU.

Drives the port's `lusol_serve` path once at full size and checks it:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: the C++ host engine (g++) and the SpTRSV kernel (nvcc, sm_90a),
     both from this checkout's sources, with their build seconds;
  3. kernel vs plain: the SpTRSV kernel against its plain torch version on
     the card, kinds 0-3 (L and U of the matrix below, from the port's
     `lu`), float32 and float64, B = 128 and B = 2, with both times;
  4. main path: a nonsymmetric 5-point matrix on a 128 x 128 grid
     (n = 16,384) made from --seed; `lusol_serve(A, 1, 1e-6,
     device="cuda")` answers 4 requests of B[n, 128]; each answer is held
     to its residual and to the C++ engine's exact LU solves, the factor
     route must be the device multifrontal one, and the kernel launch count
     of the run must be at least 2 per request.

Then it prints the kernels' JSON line and, last, the device line. Any
failed check exits non-zero before the last line. Without a CUDA device,
or without the package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed 0]

Float32 matmuls and cuDNN are held to full float32 (no TF32) so that the
comparisons measure the algorithm, not the tensor-core rounding mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

GRID = 128  # n = GRID**2
NRHS = 128
REQUESTS = 4
TOL = {"float32": 1e-4, "float64": 1e-12}  # kernel vs plain, relative


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


def phase_kernels(a, seed: int, device: str = "cuda"):
    """Kernel vs plain version on the L and U factors of `a`."""
    import torch

    from rsparse_tpu_torch import lu, sqr, tri_plan
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi, sptrsv_plain_multi

    nm = lu(a, sqr(a, 1, False), 1e-6, device=device)
    rng = np.random.default_rng(seed + 1)
    max_abs, main = 0.0, {"ms": 0.0, "plain_ms": 0.0}
    for kind in (0, 1, 2, 3):
        t = nm.l if kind in (0, 2) else nm.u
        plan = tri_plan(t, kind)
        for dtype in (torch.float32, torch.float64):
            tx = t.x[: t.nnz()].to(dtype)
            for B in (NRHS, 2):
                X = torch.as_tensor(rng.standard_normal((a.n, B)), dtype=dtype,
                                    device=device)
                got = sptrsv_multi(tx, X, plan, kind)
                ref = sptrsv_plain_multi(tx, X, plan, kind)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rel = err / max(1.0, float(ref.abs().max()))
                ms = cuda_ms(lambda: sptrsv_multi(tx, X, plan, kind), 5)
                plain = cuda_ms(lambda: sptrsv_plain_multi(tx, X, plan, kind), 2)
                name = str(dtype).replace("torch.", "")
                print(f"kernel kind={kind} {name} B={B} nlev={plan.nlev}: "
                      f"max_abs_err={err:.3e} rel_err={rel:.3e} "
                      f"kernel_ms={ms:.4f} plain_ms={plain:.4f}", flush=True)
                check(bool(torch.isfinite(got).all()), "kernel output not finite")
                check(rel <= TOL[name], f"kernel kind={kind} {name} B={B} "
                      f"disagrees with the plain version: {rel:.3e}")
                max_abs = max(max_abs, err)
                if kind in (0, 1) and dtype == torch.float32 and B == NRHS:
                    # the serve handle's two sweeps per solve
                    main["ms"] += ms
                    main["plain_ms"] += plain
    return max_abs, main


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
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi
    from rsparse_tpu_torch.symbolic import native

    n, nz = a.n, a.nnz()
    rng = np.random.default_rng(seed + 2)
    requests = [rng.standard_normal((n, NRHS)) for _ in range(REQUESTS)]

    sptrsv_multi.launches = 0
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
    launches = sptrsv_multi.launches

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
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rsparse_tpu_torch.ops import sptrsv_cuda
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
    sptrsv_cuda.build()
    t2 = time.perf_counter()
    print(f"build: host_engine_s={t1 - t0:.2f} sptrsv_kernel_s={t2 - t1:.2f} "
          f"({sptrsv_cuda.SOURCE})", flush=True)

    a = make_matrix(GRID, args.seed)
    try:
        max_abs, main_ms = phase_kernels(a, args.seed)
        launches = phase_main(a, args.seed)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "sptrsv_sweep", "route": "cuda",
        "source": "rsparse_tpu_torch/csrc/sptrsv.cu",
        "replaces": "rsparse_tpu/ops/sptrsv_pallas.py:191",
        "launches": launches, "max_abs_err": max_abs,
        "ms": main_ms["ms"], "plain_ms": main_ms["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
