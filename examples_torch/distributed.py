"""Distributed workflow of rsparse_tpu_torch: one process per rank.

Each rank calls the same functions on the same host inputs and works on
its own shard: the halo SpMV (x sharded n/D, boundary segments exchanged
with ring neighbours), the distributed direct solves (factor on every
rank, halo-sharded sweeps), the distributed SpGEMM and one batched
refinement step on a 2-D mesh. The system is the 5-point Laplacian on a
`--grid` x `--grid` mesh (default 24), the right-hand sides drawn from
`--seed`. Ranks are NCCL processes, one per card, unless `--device cpu`
gives gloo processes; without a card and without it, the example stops
with a RuntimeError.

    torchrun --standalone --nproc-per-node 1 examples_torch/distributed.py
    torchrun --standalone --nproc-per-node 4 examples_torch/distributed.py --device cpu

Without a launcher, give each process its rank, the world size and a
shared file for the rendezvous (no port is opened):

    python examples_torch/distributed.py --device cpu --world-size 2 \\
        --rank 0 --store /some/dir/store &   # and --rank 1

With neither, the process is a one-rank group. `--save out.npz` makes
rank 0 write the inputs and answers for a caller that checks them.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch.laplacian import laplacian_5pt  # noqa: E402
import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch import parallel as par  # noqa: E402
from rsparse_tpu_torch.ops.cuda_build import require_card  # noqa: E402
from rsparse_tpu_torch.parallel import halo  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--grid", type=int, default=24, help="mesh side (n = grid^2)")
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("--store", help="a file path for the rendezvous of "
                "--world-size processes (no launcher)")
ap.add_argument("--rank", type=int, default=0)
ap.add_argument("--world-size", type=int, default=1)
ap.add_argument("--save", help="rank 0 writes the inputs and answers here")
args = ap.parse_args()
dev = require_card(args.device)

if args.store:
    par.init_distributed(f"file://{os.path.abspath(args.store)}",
                         args.world_size, args.rank, device=dev.type)
mesh = par.make_mesh(device=dev.type)  # every rank of the group, "model" axis
D = mesh["model"].size()
rank = torch.distributed.get_rank()
say = print if rank == 0 else (lambda *a, **k: None)
say("mesh:", mesh)

# A 5-point Laplacian system, solved distributed three ways
A = laplacian_5pt(args.grid)
n = A.n
rng = np.random.default_rng(args.seed)
b = rng.standard_normal(n)

# SpMV with halo exchange: x sharded n/D, boundary segments to ring neighbours
rp = halo.partition_rows(A, D)
r = halo.dist_gaxpy_halo(rp, b, np.zeros(n), mesh)
say("halo SpMV max |r|:", float(np.abs(r).max()))

# Distributed direct solves (factor on every rank, sharded sweeps)
x1 = par.dist_cholsol(A, b.copy(), mesh, 0)
x2 = halo.dist_lusol(A, b.copy(), mesh, 1)
want = rt.cholsol(A, list(b), 0, device=dev)
say("dist_cholsol vs single process:", float(np.abs(x1 - want).max()))
say("dist_lusol  vs single process:", float(np.abs(x2 - want).max()))

# Distributed SpGEMM: the product stream split over the ranks
C = par.dist_spgemm(A, A, mesh)
say("dist_spgemm nnz(A@A):", C.nnz())

# Batched iterative refinement: the RHS batch over "data", the entries over
# "model". refine_step takes an unpermuted factor (natural order: L L' = A),
# so the analysis is order -1; ordered factors go through dist_cholsol.
mesh2 = par.make_mesh(D, data=2 if D % 2 == 0 else 1, device=dev.type)
s = rt.schol(A, -1)
nm = rt.chol(A, s, device=dev)
B = rng.standard_normal((4, n))
X1 = par.refine_step(A, nm.l, np.zeros_like(B), B, mesh2).cpu().numpy()
res = float(rt.gaxpy_multi(A, X1.T.copy(), -B.T, device=dev).abs().max())
say("refine_step residual:", res)

if args.save and rank == 0:
    np.savez(args.save, b=b, r=r, x1=x1, x2=x2, want=want,
             nnz_c=C.nnz(), B=B, X1=X1, refine_residual=res)
torch.distributed.destroy_process_group()
