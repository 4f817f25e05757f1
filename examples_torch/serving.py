"""Serving workflow of rsparse_tpu_torch: analyse and factor once, then
stream batched solves.

The reference is single-RHS and host-only. A serving process amortises one
symbolic analysis and one factorization over batches of right-hand sides:
each handle call runs float32 SpTRSV sweeps (the hand-written kernel) and
float64 iterative refinement on the card. The SPD system is the 5-point
Laplacian on a `--grid` x `--grid` mesh (default 128: n = 16,384), the
right-hand sides are drawn from `--seed`. Every call runs on the card
unless `--device cpu` is given; without a card and without it, the
example stops with a RuntimeError.

    python examples_torch/serving.py                          # on the card
    python examples_torch/serving.py --device cpu --grid 24   # on the CPU

`--save out.npz` also writes the inputs and answers for a caller that
checks them.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from examples_torch.laplacian import laplacian_5pt  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.config import config  # noqa: E402
from rsparse_tpu_torch.ops.cuda_build import require_card  # noqa: E402
from rsparse_tpu_torch.utils import load_factor, save_factor  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--grid", type=int, default=128, help="mesh side (n = grid^2)")
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("--save", help="write the inputs and answers to this .npz")
args = ap.parse_args()
dev = require_card(args.device)

# The batched solves take the serving path on a card by default; on the
# CPU it runs through the kernel's plain version only when forced.
if dev.type != "cuda":
    config.serve_mixed = "force"

spd = laplacian_5pt(args.grid)
n = spd.n
rng = np.random.default_rng(args.seed)


def resid(a, X, B) -> float:
    """max |A X - B| by the port's batched SpMV on the device."""
    X = np.asarray(X, np.float64).reshape(a.n, -1)
    B = np.asarray(B, np.float64).reshape(a.n, -1)
    return float(rt.gaxpy_multi(a, X, -B, device=dev).abs().max())


# 1. Build the handle: one analysis + factorization, device-resident values
#    (order 1: AMD; the mesh's natural order would give a banded factor
#    whose sweeps take one level per row)
handle = rt.cholsol_serve(spd, order=1, device=dev)
print(f"handle: n={n} factor route {handle.factor_route}")

# 2. Stream batches: each call runs two sweeps and the refinement steps on
#    the device. Keep inputs and outputs as tensors in real pipelines to
#    avoid host transfers.
for step in range(3):
    B = rng.standard_normal((n, 64))
    X = handle(B)
    print(f"batch {step}: solved 64 RHS, residual {resid(spd, X.cpu(), B):.2e}")

# 3. The same shape exists for LU and least squares:
#    rt.lusol_serve(A, order=1, tol=1e-6)   - square nonsymmetric systems
#    rt.qrsol_serve(A, order=2)             - rectangular (CSNE least squares)
# and as one-shot batched solves with the same dispatch underneath:
Bm = rng.standard_normal((n, 32))
Xm = rt.cholsol_multi(spd, Bm, 1, device=dev)
print("cholsol_multi residual:", f"{resid(spd, Xm, Bm):.2e}")

# 4. Analysis and factor reuse across related solves: pass `sym=` explicitly
s = rt.schol(spd, 1)
x1 = rt.cholsol(spd, list(Bm[:, 0]), 1, sym=s, device=dev)
x2 = rt.cholsol(spd, list(Bm[:, 1]), 1, sym=s, device=dev)  # plans reused
print(f"sym-reuse solves done: route {s._chol_route}, residuals "
      f"{resid(spd, x1, Bm[:, 0]):.2e} {resid(spd, x2, Bm[:, 1]):.2e}")

# 5. Factor checkpointing for serving restarts
nm = rt.chol(spd, s, device=dev)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "spd_factor.npz")
    save_factor(nm, path)
    nm2 = load_factor(path)
print("factor checkpoint round-trip ok:",
      np.array_equal(nm.l.x[: nm.l.nnz()], nm2.l.x[: nm2.l.nnz()]))

# 6. Batched-VALUES solves: K systems sharing one sparsity pattern
#    (time stepping, parameter sweeps) factor and solve together, with a
#    leading instance dimension through the factorization and the sweeps.
K = 8
nz = spd.nnz()
diag = spd.i[:nz] == np.repeat(np.arange(n), np.diff(spd.p))
AxK = np.tile(spd.x[:nz], (K, 1))
AxK[:, diag] *= (1.0 + 0.1 * np.arange(K))[:, None]  # K diagonal shifts
BK = rng.standard_normal((K, n))
XK = rt.cholsol_vals(spd, AxK, BK, 1, sym=s, device=dev)
worst = max(resid(rt.Sprs(nz, n, n, spd.p, spd.i[:nz], AxK[k]), XK[k], BK[k])
            for k in range(K))
print(f"cholsol_vals: {K} same-pattern systems, route {s._vals_route}, "
      f"worst residual {worst:.2e}")

# 7. The same axis exists for LU and least squares:
#    rt.lusol_vals(A, AxK, B, order=1, tol=1e-6) - K square nonsymmetric
#      systems through the pivoting multifrontal LU
#    rt.qrsol_vals(A, AxK, B, order=2)           - K rectangular systems
# and distribution shards the instance axis over the ranks:
#    rsparse_tpu_torch.parallel.dist_cholsol_vals(A, AxK, B, mesh)

if args.save:
    np.savez(args.save, Bm=Bm, Xm=Xm, x1=x1, x2=x2, AxK=AxK, BK=BK, XK=XK)
