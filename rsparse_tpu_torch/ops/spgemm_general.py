"""General-sparsity SpGEMM C = A @ B: a deterministic ESC value pass.

The JAX package's `rsparse_tpu/ops/spgemm_general.py` computes the ESC
(expand, sort, compress) numeric phase of `multiply` as one-hot matmuls,
because XLA on a TPU pays about 10 ns per gathered index. The port keeps the
module's public functions and computes the phase the way a GPU does: gather
A(i,k) and B(k,j) for every product, multiply, and sum each output entry's
run of products with `torch.segment_reduce` (one reduction per run, no
atomics), so that a float32 result is the same from run to run, unlike the
`index_add_` of `ops.device.spgemm_values`.

  - `mxu_spgemm_plan(a, b)`: from `ops.plan.spgemm_plan` (the cached ESC
    expansion), the products sorted by output entry (a static permutation)
    and each output entry's run length; C's pattern `out_p`, `out_i` in the
    canonical rows-ascending order of `multiply`.
  - `spgemm_general_fn(plan, dtype)` returns `f(ax, bx) -> Cx` on `device`,
    with `f.run(ax, bx, *f.consts)` for callers that hold the index tensors
    themselves (`ops.chain`).
  - `spgemm_general(a, b)`: C as a host `Sprs`.
  - `spgemm_general_dist(a, b, mesh)`: the same value pass with the
    sorted products split over the ranks of a mesh axis, one all-reduce
    (`parallel.dist_spgemm` runs it in A's value dtype).

Reference semantics: multiply, src/lib.rs:713-748.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data import Sprs
from . import plan as _plan

__all__ = ["MxuSpgemmPlan", "mxu_spgemm_plan", "spgemm_general",
           "spgemm_general_fn", "spgemm_general_dist"]


@dataclasses.dataclass(frozen=True)
class MxuSpgemmPlan:
    """Static per-pattern-pair plan of the general SpGEMM."""

    m: int
    n: int
    anz: int
    bnz: int
    nnz: int  # nnz(C)
    a_idx: np.ndarray  # [E] A entry of each product, sorted by output entry
    b_idx: np.ndarray  # [E] B entry of each product, in the same order
    lengths: np.ndarray  # [nnz] products per output entry (each >= 1)
    out_p: np.ndarray  # [n+1] C column pointers
    out_i: np.ndarray  # [nnz] C row indices


def mxu_spgemm_plan(a: Sprs, b: Sprs) -> MxuSpgemmPlan:
    """The plan of A's and B's patterns, built once per pattern pair and
    kept on `ops.plan.spgemm_plan`'s cached plan (so are the device index
    tensors made from it)."""
    base = _plan.spgemm_plan(a, b)
    p = base.__dict__.get("_sorted")
    if p is None:
        order = np.argsort(base.seg, kind="stable")
        p = base.__dict__["_sorted"] = MxuSpgemmPlan(
            m=base.m, n=base.n, anz=a.nnz(), bnz=b.nnz(), nnz=base.nnz,
            a_idx=base.a_idx[order], b_idx=base.b_idx[order],
            lengths=np.bincount(base.seg, minlength=base.nnz).astype(np.int64),
            out_p=base.out_p, out_i=base.out_i)
    return p


def _run(ax, bx, a_idx, b_idx, lengths, dtype):
    prods = ax.to(dtype)[a_idx] * bx.to(dtype)[b_idx]
    if not len(lengths):
        return prods.new_zeros(0)
    # The callers guarantee lengths >= 0 summing to len(prods) (a run of
    # length 0, an entry none of whose products lies in a rank's range,
    # sums to 0): unsafe skips the checks, which would read back to the
    # host. A [E, 1] column takes torch's one-thread-per-segment kernel;
    # 1-D data goes to CUB's segmented reduce, one thread block per
    # segment, which took most of a 7.5 ms value pass on 6.4 M short runs
    # on an H100 (PERF.md, §6).
    return torch.segment_reduce(prods[:, None], "sum", lengths=lengths,
                                unsafe=True)[:, 0]


def spgemm_general_fn(plan: MxuSpgemmPlan, dtype: str = "float32",
                      precision: str = "highest", *, device="cuda"):
    """Return `f(ax, bx) -> Cx` for the plan, on `device`.

    ax, bx: A's and B's values (tensors on `device`, any float dtype; cast
    to `dtype`). The index tensors are uploaded once; `f.run(ax, bx,
    *f.consts)` is the same call with them passed in. `precision` keeps the
    JAX signature: "high" (a TPU matmul mode there) gives the same exact
    products as "highest" here.
    """
    if precision not in ("highest", "high"):
        raise ValueError(f"precision must be 'highest' or 'high', got {precision!r}")
    dt = getattr(torch, dtype)
    ix = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
    consts = (ix(plan.a_idx), ix(plan.b_idx), ix(plan.lengths))

    def run(ax, bx, a_idx, b_idx, lengths):
        return _run(ax, bx, a_idx, b_idx, lengths, dt)

    def f(ax, bx):
        return run(ax, bx, *consts)

    f.run = run
    f.consts = consts
    return f


def spgemm_general(a: Sprs, b: Sprs, plan: Optional[MxuSpgemmPlan] = None,
                   dtype: str = "float32", *, device="cuda") -> Sprs:
    """C = A @ B with the value pass on `device` (float32 sums by default;
    dtype="float64" for the reference's precision). Rows per column sorted
    ascending (canonical form, matching ops.multiply)."""
    p = plan or mxu_spgemm_plan(a, b)
    f = spgemm_general_fn(p, dtype, device=device)
    cx = f(torch.as_tensor(a.x[: a.nnz()], device=device),
           torch.as_tensor(b.x[: b.nnz()], device=device))
    return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i,
                cx.cpu().numpy().astype(a.x.dtype if a.nnz() else np.float64))


def _range_part(p: MxuSpgemmPlan, ax, bx, lo: int, hi: int, dtype,
                device) -> torch.Tensor:
    """C's values [nnz] summed over the products lo:hi of p's sorted
    stream only (0 where an entry has none there); the index tensors are
    cached on p, per range and device."""
    def build():
        end = np.cumsum(p.lengths)
        mine = np.clip(np.minimum(end, hi) - np.maximum(end - p.lengths, lo),
                       0, None)
        ix = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
        return ix(p.a_idx[lo:hi]), ix(p.b_idx[lo:hi]), ix(mine)

    ai, bi, mine = _plan.device_cache(p, f"_range_{lo}_{hi}", device, build)
    return _run(ax, bx, ai, bi, mine, dtype)


def spgemm_general_dist(a: Sprs, b: Sprs, mesh, axis: str = "model",
                        dtype: str = "float32") -> Sprs:
    """SPMD C = A @ B over the ranks of `mesh`'s `axis` (a torch
    `DeviceMesh`, `parallel.make_mesh`): the products of `spgemm_general`,
    sorted by output entry, are split into D contiguous ranges; each rank
    sums its range's part of every output entry's run (`segment_reduce`,
    an entry whose run lies outside the range gets 0) and one all-reduce
    combines the ranks. A run split across two ranks is summed in the
    all-reduce, so a float32 C is not bit-equal to `spgemm_general`'s;
    a float64 one agrees to 1e-12. The JAX package shards its one-hot-MXU
    chunk stream instead. `parallel.dist_spgemm` is this pass in A's value
    dtype. Returns C as a host `Sprs` (every rank).
    Reference semantics: multiply, src/lib.rs:713-748."""
    from ..parallel import _all_reduce, _device, _index, _on, _size

    p = mxu_spgemm_plan(a, b)
    D, k = _size(mesh, axis), _index(mesh, axis)
    dev = _device(mesh)
    E = len(p.a_idx)
    chunk = -(-E // D) if E else 0
    ax = _on(a.x[: a.nnz()] if a.nnz() else np.zeros(1), dev)
    bx = _on(b.x[: b.nnz()] if b.nnz() else np.zeros(1), dev)
    part = _range_part(p, ax, bx, min(k * chunk, E), min((k + 1) * chunk, E),
                       getattr(torch, dtype), dev)
    cx = _all_reduce(part, mesh, axis).cpu().numpy()
    return Sprs(p.nnz, p.m, p.n, p.out_p, p.out_i,
                cx.astype(a.x.dtype if a.nnz() else np.float64))
