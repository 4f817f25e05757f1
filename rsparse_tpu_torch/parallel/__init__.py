"""L6' distributed layer: SPMD sparse kernels over a torch `DeviceMesh`.

The port of `rsparse_tpu.parallel` to `torch.distributed`: one process
per rank, one rank per card (NCCL), or one per CPU process (gloo). Every
rank calls the same function on the same host inputs; each rank takes its
own shard of the partition built on the host, where the JAX package's
`shard_map` gave each device its `P(axis)` block. The CSC entry stream is
partitioned across the "model" axis of a ("data", "model") mesh, each rank
reduces its slice with `index_add_`, and one `all_reduce` over the axis
combines the ranks (the JAX package's `psum`). Independent RHS batches
and batched-values instances shard over the "data" axis.

Components:
  - `init_distributed`, `make_mesh` — process group and mesh.
  - `partition_entries`, `dist_gaxpy`, `dist_norm` — entry-partitioned
    SpMV and 1-norm.
  - `dist_spgemm` — the ESC product stream split over the ranks.
  - `dist_tri_plan` / `dist_tri_solve` — the replicated level sweep, each
    level's entry window split across the axis, one all-reduce per level.
  - `dist_cholsol` — chol on every rank, both sweeps through the halo
    layer (`parallel.halo`).
  - `make_refine_step` / `refine_step` — one iterative-refinement step
    over a batch of RHS on the 2-D mesh.
  - `dist_cholsol_vals`, `dist_lusol_vals`, `dist_qrsol_vals` — the
    batched-values cores on each rank's share of the instances, one
    all-gather of the answers and their status.

Return types follow the JAX package: what it returns as a replicated JAX
array is a tensor on the rank's device, equal on every rank; numpy stays
numpy and a `Sprs` stays a `Sprs`. An error one rank meets inside a
batched-values call is exchanged before anyone raises, so every rank
raises (no rank is left waiting in a collective).

The three collectives (`_all_reduce`, `_ring_start`/`_ring_finish`,
`_all_gather`) count their calls in `.calls` (`comm_counts`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..data import Sprs
from ..errors import NotPositiveDefiniteError
from ..ops.cuda_build import require_card
from ..ops.plan import col_ids, device_cache

__all__ = [
    "init_distributed",
    "make_mesh",
    "partition_entries",
    "dist_gaxpy",
    "dist_norm",
    "dist_spgemm",
    "DistTriPlan",
    "dist_tri_plan",
    "dist_tri_solve",
    "dist_cholsol",
    "make_refine_step",
    "refine_step",
]

# Seconds a collective may wait for the other ranks before it raises.
TIMEOUT_S = 300


def _backend(device: str) -> str:
    """The process-group backend for `device`: NCCL on the card, gloo on
    the CPU. No card for "cuda" raises: nothing falls back to gloo."""
    kind = require_card(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: str = "cuda",
                     timeout: float = TIMEOUT_S) -> None:
    """Join the process group: one process per rank.

    `coordinator_address` is "host:port" (TCP) or an init URL
    ("tcp://...", "file://..."), with `num_processes` and `process_id`;
    without it a launcher's environment (`torchrun`: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) is read. NCCL for device="cuda" (each rank
    on cuda:LOCAL_RANK), gloo for "cpu"; collectives wait at most
    `timeout` seconds. A no-op when a group exists, or with neither an
    address nor a launcher (one process: `make_mesh` then makes a
    one-rank group in it)."""
    if dist.is_initialized():
        return
    backend = _backend(device)
    td = datetime.timedelta(seconds=timeout)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=url, timeout=td,
                                world_size=num_processes, rank=process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", timeout=td)


def make_mesh(n_devices: Optional[int] = None, data: int = 1,
              axis_names: Tuple[str, str] = ("data", "model"), *,
              device: str = "cuda", timeout: float = TIMEOUT_S) -> DeviceMesh:
    """A (data, n_devices // data) `DeviceMesh` named `axis_names` over
    every rank of the process group (NCCL on the card, gloo on the CPU).

    `n_devices` must equal the world size (a ValueError otherwise): the
    JAX package takes the first n of its devices, but a rank cannot leave
    a collective that the others enter. Without a group (and without a
    launcher's environment, see `init_distributed`) a one-rank group is
    made in this process, the JAX package's single-process default.
    `mesh.size(i)` / `mesh[name].size()` give an axis's size."""
    backend = _backend(device)
    init_distributed(device=device, timeout=timeout)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=timeout))
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"device={device!r} needs {backend}")
    ws = dist.get_world_size()
    nd = ws if n_devices is None else n_devices
    if nd != ws:
        raise ValueError(f"n_devices={nd} but the process group has {ws} "
                         "ranks: a mesh spans every rank")
    if nd % data != 0:
        raise ValueError(f"{nd} devices not divisible by data={data}")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    return init_device_mesh(torch.device(device).type, (data, nd // data),
                            mesh_dim_names=tuple(axis_names))


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def _index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def _device(mesh: DeviceMesh) -> torch.device:
    """The rank's device: cuda:<current> for a card mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _own(length: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's block of a length-`length` axis split in equal parts
    over `axis` (the JAX package's P(axis))."""
    d = _size(mesh, axis)
    if length % d:
        raise ValueError(f"{length} entries do not split over {d} ranks")
    k = _index(mesh, axis)
    return slice(k * (length // d), (k + 1) * (length // d))


# ---------------------------------------------------------------------------
# Collectives (counted: `comm_counts`)
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum t over the ranks of `axis`, in place (the JAX package's psum)."""
    dist.all_reduce(t, group=mesh.get_group(axis))
    _all_reduce.calls += 1
    return t


_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' t [r, ...] along `axis`, stacked in rank order
    [d * r, ...] on every rank."""
    t = t.contiguous()
    out = t.new_empty((_size(mesh, axis) * t.shape[0],) + tuple(t.shape[1:]))
    _gather_into(out, t, group=mesh.get_group(axis))
    _all_gather.calls += 1
    return out


def _ring_start(x_own: torch.Tensor, hops: int, mesh: DeviceMesh, axis: str):
    """Post a halo exchange along the ring of `axis`: x_own to the ranks
    h = 1..hops away on either side (cyclic), and the receives of theirs.
    Sends go straight to (r ± h) mod d, one round: the JAX package chains
    one-hop permutes for a torus; NVLink joins every pair. Every rank
    posts the same (hop, direction) sequence with tags 2h (rightward) and
    2h + 1 (leftward), so a peer that is both neighbours (d = 2, or
    h = d/2) matches its pairs in order. x_own must not change until
    `_ring_finish`. Returns the pending exchange."""
    left = [torch.empty_like(x_own) for _ in range(hops)]
    right = [torch.empty_like(x_own) for _ in range(hops)]
    if not hops:
        return [], left, right
    g = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(g)
    d, r = len(ranks), _index(mesh, axis)
    ops = []
    for h in range(1, hops + 1):
        ops += [dist.P2POp(dist.isend, x_own, ranks[(r + h) % d], g, 2 * h),
                dist.P2POp(dist.irecv, left[h - 1], ranks[(r - h) % d], g,
                           2 * h),
                dist.P2POp(dist.isend, x_own, ranks[(r - h) % d], g,
                           2 * h + 1),
                dist.P2POp(dist.irecv, right[h - 1], ranks[(r + h) % d], g,
                           2 * h + 1)]
    _ring_start.calls += 1
    return dist.batch_isend_irecv(ops), left, right


def _ring_finish(pending) -> Tuple[list, list]:
    """Wait for a posted exchange: (left halos far to near, right halos
    near to far), the order of the extended vector."""
    works, left, right = pending
    for w in works:
        w.wait()
    return left[::-1], right


def comm_counts() -> dict:
    """Collectives issued since the last `reset_comm_counts`."""
    return {"all_reduce": _all_reduce.calls, "all_gather": _all_gather.calls,
            "ring_exchange": _ring_start.calls}


def reset_comm_counts() -> None:
    for f in (_all_reduce, _all_gather, _ring_start):
        f.calls = 0


reset_comm_counts()


def _on(v, dev: torch.device, dtype=None) -> torch.Tensor:
    """v (numpy or tensor) as a tensor on dev."""
    return torch.as_tensor(v, device=dev, dtype=dtype)


# ---------------------------------------------------------------------------
# Entry-partitioned SpMV
# ---------------------------------------------------------------------------


def _pad_to(a: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


@dataclasses.dataclass(frozen=True)
class EntryPartition:
    """Flattened CSC entry stream padded to D equal chunks.

    Padding entries carry val=0 scattered to row 0 — additive identity, so
    the all-reduced SpMV is exact.
    """

    vals: np.ndarray  # [D*chunk] float
    rows: np.ndarray  # [D*chunk] int32
    cols: np.ndarray  # [D*chunk] int32
    chunk: int
    m: int
    n: int


def partition_entries(a: Sprs, n_shards: int) -> EntryPartition:
    nz = a.nnz()
    chunk = max(1, -(-nz // n_shards))
    E = chunk * n_shards
    return EntryPartition(
        vals=_pad_to(a.x[:nz], E, 0.0),
        rows=_pad_to(a.i[:nz].astype(np.int32), E, 0),
        cols=_pad_to(col_ids(a.p, a.n).astype(np.int32), E, 0),
        chunk=chunk,
        m=a.m,
        n=a.n,
    )


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """v [k] shaped to multiply rows of like [k, ...]."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _spmv_local(vals, rows, cols, x, m: int) -> torch.Tensor:
    """This rank's partial A@x of its entries (x [n] or [n, b])."""
    out = x.new_zeros((m,) + tuple(x.shape[1:]))
    g = x[cols]
    return out.index_add_(0, rows, _bcast(vals.to(x.dtype), g) * g)


def _entry_shard(ep: EntryPartition, mesh: DeviceMesh, axis: str):
    """This rank's (rows, cols) of ep as int64 tensors (cached on ep)."""
    sl = _own(len(ep.vals), mesh, axis)
    dev = _device(mesh)
    return sl, device_cache(ep, f"_shard_{sl.start}_{sl.stop}", dev, lambda: (
        _on(ep.rows[sl], dev, torch.int64), _on(ep.cols[sl], dev, torch.int64)))


def make_gaxpy(ep: EntryPartition, mesh: DeviceMesh, axis: str = "model"):
    """The SPMD r = A@x + y of a partition on `mesh`.

    Returns `f(vals, rows, cols, x, y) -> r`: vals/rows/cols the whole
    partition's [D*chunk] arrays (numpy or tensors; each rank takes its
    block; ep's own rows and cols are read from their device copy cached
    on ep), x and y replicated; r [m] in x's dtype on the rank's device,
    equal on every rank. Nothing is compiled: `dist_gaxpy` is the one-shot
    form."""
    dev = _device(mesh)

    def f(vals, rows, cols, x, y):
        if rows is ep.rows and cols is ep.cols:
            sl, (r, c) = _entry_shard(ep, mesh, axis)
        else:
            sl = _own(len(vals), mesh, axis)
            r, c = _on(rows[sl], dev, torch.int64), _on(cols[sl], dev,
                                                         torch.int64)
        xx = _on(x, dev)
        part = _spmv_local(_on(vals[sl], dev), r, c, xx, ep.m)
        return _all_reduce(part, mesh, axis) + _on(y, dev, xx.dtype)

    return f


def dist_gaxpy(ep: EntryPartition, x, y, mesh: DeviceMesh,
               axis: str = "model") -> torch.Tensor:
    """SPMD r = A@x + y (reference semantics: src/lib.rs:411-421).

    x, y replicated (host arrays); entries sharded over `axis`. Returns r
    [m] in ep's value dtype on the rank's device, equal on every rank."""
    dt = ep.vals.dtype
    return make_gaxpy(ep, mesh, axis)(ep.vals, ep.rows, ep.cols,
                                      np.asarray(x, dtype=dt),
                                      np.asarray(y, dtype=dt))


def dist_norm(ep: EntryPartition, mesh: DeviceMesh,
              axis: str = "model") -> float:
    """SPMD 1-norm: max column abs-sum (reference src/lib.rs:771-782)."""
    dev = _device(mesh)
    sl, (_, cols) = _entry_shard(ep, mesh, axis)
    v = _on(ep.vals[sl], dev).abs()
    sums = _all_reduce(v.new_zeros(ep.n).index_add_(0, cols, v), mesh, axis)
    return float(sums.max()) if ep.n else 0.0


def dist_spgemm(a: Sprs, b: Sprs, mesh: DeviceMesh,
                axis: str = "model") -> Sprs:
    """SPMD C = A @ B (reference Gustavson multiply, src/lib.rs:713-748).

    `ops.spgemm_general.spgemm_general_dist` in A's value dtype: the host
    ESC planner (cached per pattern pair) fixes C's pattern and the
    product stream sorted by output entry; each rank sums a contiguous
    1/D of the stream into C's entries (`segment_reduce`, deterministic)
    and one all-reduce combines the ranks. C's pattern and pointers are
    those of the single-process `ops.multiply`; its values a host array."""
    from ..ops.spgemm_general import spgemm_general_dist

    return spgemm_general_dist(a, b, mesh, axis, dtype=np.dtype(a.x.dtype).name)


# ---------------------------------------------------------------------------
# Distributed level-scheduled SpTRSV
# ---------------------------------------------------------------------------


def _share(off: np.ndarray, chunk: int, k: int):
    """Rank k's part of each window [off[v], off[v+1]) split in blocks of
    `chunk` (the last ranks may get less or none): (the positions into the
    flat arrays, their window offsets [nwin + 1])."""
    lo = np.minimum(off[:-1] + k * chunk, off[1:])
    hi = np.minimum(lo + chunk, off[1:])
    cnt = hi - lo
    loff = np.zeros(len(cnt) + 1, dtype=np.int64)
    np.cumsum(cnt, out=loff[1:])
    sel = np.arange(loff[-1]) - np.repeat(loff[:-1] - lo, cnt)
    return sel, loff


@dataclasses.dataclass(frozen=True)
class DistTriPlan:
    """Level schedule with each level's entry window split into D slices of
    `chunk` entries (the JAX package pads each window to D*chunk and ships
    [D, nlev, chunk] tables; rank k takes slice k of each window).

    The sweep reads the flat `TriPlan` windows (`tri`) through offsets:
    the JAX package's padded tables exist for XLA's static shapes."""

    n: int
    nlev: int
    wmax: int
    chunk: int
    d: int
    scatter_form: bool
    tri: object = dataclasses.field(repr=False, compare=False)  # TriPlan


def dist_tri_plan(t: Sprs, kind: int, n_shards: int) -> DistTriPlan:
    """kind: 0=lsolve, 1=usolve (scatter form), 2=ltsolve, 3=utsolve (gather)."""
    from ..solve import tri_plan

    p = tri_plan(t, kind)
    ecnts = np.diff(p.ent_off)
    emax = int(ecnts.max()) if len(ecnts) else 0
    return DistTriPlan(n=p.n, nlev=p.nlev, wmax=p.wmax,
                       chunk=max(1, -(-emax // n_shards)), d=n_shards,
                       scatter_form=kind in (0, 1), tri=p)


def _tri_tables(p: DistTriPlan, k: int, dev: torch.device):
    """Rank k's sweep tables on dev (cached on the plan): the columns'
    ids and diagonal positions, this rank's entries (positions, rows,
    columns, slots) and their per-level offsets (host)."""
    def build():
        t = p.tri
        sel, loff = _share(t.ent_off.astype(np.int64), p.chunk, k)
        ix = lambda v: _on(np.asarray(v, np.int64), dev)
        return (ix(t.col_id), ix(t.col_diag), ix(t.ent_pos[sel]),
                ix(t.ent_row[sel]), ix(t.ent_col[sel]), ix(t.ent_slot[sel]),
                loff, t.col_off.astype(np.int64))
    return device_cache(p, f"_rank{k}", dev, build)


def _tri_sweep_local(tx, x, p: DistTriPlan, mesh: DeviceMesh, axis: str):
    """The per-rank level sweep of x [n] or [n, b] (replicated, solved in
    place): each level divides its columns by their diagonal on every rank
    alike; the off-diagonal update of this rank's share of the level's
    entries is all-reduced over `axis` so that every replica stays equal.
    A level with no off-diagonal entry on any rank skips its all-reduce
    (the JAX package's psum of zeros there changes nothing)."""
    k = _index(mesh, axis)
    cid, cdg, epos, erow, ecol, eslot, loff, coff = _tri_tables(
        p, k, x.device)
    eoff = p.tri.ent_off
    dv = tx[cdg].to(x.dtype)
    ev = tx[epos].to(x.dtype)
    for v in range(p.nlev):
        c0, c1 = int(coff[v]), int(coff[v + 1])
        e0, e1 = int(loff[v]), int(loff[v + 1])
        cols, d = cid[c0:c1], dv[c0:c1]
        if p.scatter_form:
            x[cols] = x[cols] / _bcast(d, x)
            if eoff[v + 1] == eoff[v]:
                continue
            g = x[ecol[e0:e1]]
            delta = x.new_zeros(x.shape).index_add_(
                0, erow[e0:e1], _bcast(ev[e0:e1], g) * g)
            x -= _all_reduce(delta, mesh, axis)
        else:
            xc = x[cols]
            if eoff[v + 1] != eoff[v]:
                g = x[erow[e0:e1]]
                contrib = xc.new_zeros(xc.shape).index_add_(
                    0, eslot[e0:e1], _bcast(ev[e0:e1], g) * g)
                xc = xc - _all_reduce(contrib, mesh, axis)
            x[cols] = xc / _bcast(d, xc)
    return x


def dist_tri_solve(t: Sprs, x, kind: int, mesh: DeviceMesh,
                   axis: str = "model", plan: Optional[DistTriPlan] = None,
                   *, tx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distributed level-scheduled triangular solve (same kinds as
    solve._tri_solve; reference sequential loops src/lib.rs:464-471 etc.).

    x replicated; returns the solution [n] in t's value dtype on the
    rank's device, equal on every rank. `tx`: t's values already on that
    device (a factorization's `device_values`), else t.x is uploaded."""
    D = _size(mesh, axis)
    p = plan or dist_tri_plan(t, kind, D)
    if p.d != D:
        raise ValueError(f"the plan splits levels over {p.d} ranks, the "
                         f"mesh axis {axis!r} has {D}")
    dev = _device(mesh)
    if tx is None:
        tx = _on(t.x[: t.nnz()], dev)
    xx = _on(np.asarray(x, dtype=t.x.dtype), dev).clone()
    return _tri_sweep_local(tx, xx, p, mesh, axis)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def dist_cholsol(a: Sprs, b, mesh: DeviceMesh, order: int = 0,
                 axis: str = "model") -> np.ndarray:
    """Distributed A\\b for SPD A: `schol` and `chol` on every rank's
    device, then both triangular sweeps as halo-sharded SPMD solves
    (`parallel.halo`: x sharded n/D, boundary exchange with ring
    neighbours) on the factor's device copy; a pattern the row-block
    partition cannot cover takes the replicated `dist_tri_solve`.
    Semantics match single-process `cholsol` (reference
    src/lib.rs:377-389). Returns x as a host array."""
    from ..factor import chol, device_values
    from ..symbolic import schol
    from .halo import dist_tri_solve_halo

    n = a.n
    dev = _device(mesh)
    s = schol(a, order)
    nm = chol(a, s, device=dev)
    lx = device_values(nm, "l", dev)
    bb = np.asarray(b, dtype=np.float64)
    x = np.zeros(n)
    if s.pinv is not None:
        x[np.asarray(s.pinv, dtype=np.int64)] = bb
    else:
        x[:] = bb
    x = _host(dist_tri_solve_halo(nm.l, x, 0, mesh, axis, tx=lx))
    x = _host(dist_tri_solve_halo(nm.l, x, 2, mesh, axis, tx=lx))
    if s.pinv is not None:
        return x[np.asarray(s.pinv, dtype=np.int64)]
    return x


# ---------------------------------------------------------------------------
# Composite step: iterative refinement over a batch of RHS
# ---------------------------------------------------------------------------


def make_refine_step(ep: EntryPartition, lp: DistTriPlan, ltp: DistTriPlan,
                     lx_len: int, mesh: DeviceMesh,
                     data_axis: str = "data", model_axis: str = "model"):
    """The SPMD iterative-refinement step of a partition and two plans.

    Given the Cholesky factor L of SPD A, one step refines a batch of
    solutions X [B, n] toward A\\B:  R = B - A@X;  Z = L'\\(L\\R);  X += Z.
    The batch splits over `data_axis` (no communication); the SpMV and
    both triangular sweeps split their entries over `model_axis`
    (all-reduce). Returns `f(lx, vals, X, B) -> X'`: lx L's [lx_len]
    values, vals the partition's [D*chunk] values (both numpy or tensors),
    X and B [B, n] replicated; X' [B, n] on the rank's device, equal on
    every rank (one all-gather over `data_axis`)."""
    n, m = ep.n, ep.m
    dev = _device(mesh)

    def f(lx, vals, X, B):
        Xd, Bd = _on(X, dev), _on(B, dev)
        if Xd.shape[0] != Bd.shape[0] or Xd.shape[0] % _size(mesh, data_axis):
            raise ValueError(f"the batch of {Xd.shape[0]} does not split "
                             f"over {_size(mesh, data_axis)} ranks")
        rs_ = _own(Xd.shape[0], mesh, data_axis)
        sl, (rows, cols) = _entry_shard(ep, mesh, model_axis)
        txd = _on(lx, dev)[:lx_len]
        Xl, Bl = Xd[rs_].T.contiguous(), Bd[rs_].T  # [n, b]
        R = Bl - _all_reduce(_spmv_local(_on(vals[sl], dev), rows, cols, Xl,
                                         m), mesh, model_axis)
        Z = _tri_sweep_local(txd, R[:n].contiguous(), lp, mesh, model_axis)
        Z = _tri_sweep_local(txd, Z, ltp, mesh, model_axis)
        return _all_gather((Xl + Z).T, mesh, data_axis)

    return f


def refine_step(a: Sprs, l: Sprs, X, B, mesh: DeviceMesh,
                data_axis: str = "data", model_axis: str = "model"):
    """One distributed iterative-refinement step for a batch of RHS (the
    plans built on the fly; loops should keep `make_refine_step`'s
    function). Returns X' [B, n] on the rank's device."""
    D = _size(mesh, model_axis)
    ep = partition_entries(a, D)
    lp = dist_tri_plan(l, 0, D)
    ltp = dist_tri_plan(l, 2, D)
    nzl = l.nnz()
    fn = make_refine_step(ep, lp, ltp, nzl, mesh, data_axis, model_axis)
    dt = a.x.dtype
    return fn(l.x[:nzl], ep.vals, np.asarray(X, dtype=dt),
              np.asarray(B, dtype=dt))


# ---------------------------------------------------------------------------
# Batched-values solves: instances sharded over a mesh axis
# ---------------------------------------------------------------------------


def _instances(mesh: DeviceMesh, axis: str, K: int) -> np.ndarray:
    """This rank's instances of K padded to Kp, a multiple of the axis
    size, with copies of instance 0 (valid, their results dropped)."""
    D = _size(mesh, axis)
    per = -(-K // D)
    idx = np.arange(_index(mesh, axis) * per, (_index(mesh, axis) + 1) * per)
    idx[idx >= K] = 0
    return idx


def _gathered(solve, mesh: DeviceMesh, axis: str, K: int, per: int,
              n: int) -> np.ndarray:
    """Run solve() -> X [per, n] (this rank's instances) and assemble X
    [K, n] on every rank with one all-gather that carries each instance's
    status beside its answer, so that every rank raises the same error:
    NotPositiveDefiniteError naming the global instances that raised it,
    or, when a rank failed otherwise, that rank its own error and the
    others a RuntimeError naming it."""
    err = None
    status = np.zeros(per)
    X = np.zeros((per, n))
    try:
        X = solve()
    except NotPositiveDefiniteError as e:
        status[np.asarray(getattr(e, "instances", range(per)), np.int64)] = 1
    except Exception as e:  # noqa: BLE001 - re-raised after the exchange
        status[:], err = 2, e
    buf = np.concatenate([np.asarray(X, np.float64), status[:, None]], 1)
    allb = _all_gather(_on(buf, _device(mesh)), mesh, axis).cpu().numpy()
    st = allb[:, -1]
    if (st == 2).any():
        if err is not None:
            raise err
        ranks = sorted(set(np.nonzero(st == 2)[0] // per))
        raise RuntimeError(f"batched-values solve failed on the ranks at "
                           f"{axis} index {ranks}")
    bad = [int(k) for k in np.nonzero(st[:K] == 1)[0]]
    if bad:
        raise NotPositiveDefiniteError(
            f"instances {bad} are not positive definite")
    return allb[:K, :-1].copy()


def dist_cholsol_vals(a: Sprs, Ax, B, mesh: DeviceMesh, order: int = 0, *,
                      sym=None, axis: str = "data") -> np.ndarray:
    """Distributed batched-VALUES SPD solve: K systems sharing `a`'s
    sparsity pattern, instances sharded over the mesh `axis` (K padded to a
    multiple of its size with copies of instance 0). Each rank runs the
    port's batched-values core (`cholsol_vals`: one multifrontal
    factorization and solve of its instances on its device, f64
    refinement, its own instances re-solved one by one where refinement
    falls short) and one all-gather assembles X. Below the multifrontal
    tier (or with the host backend) every rank solves all K instance by
    instance, as the JAX package does. One symbolic analysis is shared.

    Ax: [K, nnz(a)]; B: [K, n] or [n] broadcast. Returns X [K, n] (host
    array, equal on every rank). Raises NotPositiveDefiniteError naming
    the failing instances, on every rank."""
    from ..factor import require_square
    from ..solve import _chol_mf_plan, _instance, _vals_batch, _vals_mf
    from ..solve import cholsol_vals
    from ..symbolic import schol

    require_square(a, "cholsol_vals")
    n = a.n
    AxK, Bm = _vals_batch(a, Ax, B, n, "n")
    K = AxK.shape[0]
    a0 = _instance(a, AxK, 0)
    s = sym if sym is not None else schol(a0, order)
    dev = _device(mesh)
    if not _vals_mf(n) or _chol_mf_plan(a0, s) is None:
        return cholsol_vals(a, AxK, Bm, order, sym=s, device=dev)
    idx = _instances(mesh, axis, K)
    return _gathered(lambda: cholsol_vals(a, AxK[idx], Bm[idx], order, sym=s,
                                          device=dev),
                     mesh, axis, K, len(idx), n)


def dist_lusol_vals(a: Sprs, Ax, B, mesh: DeviceMesh, order: int = 1,
                    tol: float = 1e-6, *, sym=None,
                    axis: str = "data") -> np.ndarray:
    """Distributed batched-VALUES LU solve: K same-pattern square systems
    with instances sharded over the mesh `axis`. Each rank runs
    `lusol_vals`' core on its instances (the pivoting multifrontal LU,
    the host compose of each instance's pivots, tree solves and f64
    refinement; an instance that misses the accept rule or the residual
    solved again by `lusol` on that rank); one all-gather assembles X.
    The multifrontal plan is built once from instance 0's values on every
    rank, as the JAX package's. Below the multifrontal tier every rank
    solves all K by `lusol`."""
    from ..factor import require_square
    from ..solve import _instance, _lu_mf_plan, _vals_batch, _vals_mf
    from ..solve import lusol_vals
    from ..symbolic import sqr

    require_square(a, "lusol_vals")
    n = a.n
    AxK, Bm = _vals_batch(a, Ax, B, n, "n")
    K = AxK.shape[0]
    a0 = _instance(a, AxK, 0)
    s = sym if sym is not None else sqr(a0, order, False)
    dev = _device(mesh)
    if not _vals_mf(n) or _lu_mf_plan(a0, s) is None:
        return lusol_vals(a, AxK, Bm, order, tol, sym=s, device=dev)
    idx = _instances(mesh, axis, K)
    return _gathered(lambda: lusol_vals(a, AxK[idx], Bm[idx], order, tol,
                                        sym=s, device=dev),
                     mesh, axis, K, len(idx), n)


def dist_qrsol_vals(a: Sprs, Ax, B, mesh: DeviceMesh, order: int = 2, *,
                    sym=None, axis: str = "data") -> np.ndarray:
    """Distributed batched-VALUES QR solve: K same-pattern rectangular
    systems (least squares m >= n, minimum norm m < n) with instances
    sharded over the mesh `axis`: `qrsol_vals`' core (the multifrontal QR
    of the rank's instances, one R sweep for all of them, each held to
    qrsol's gate) on each rank, one all-gather. `sym`: `sqr(a)` for
    m >= n, `sqr(transpose(a))` for m < n. Below the multifrontal tier
    every rank solves all K by `qrsol`."""
    from .. import ops
    from ..solve import _instance, _qr_mf_plan, _vals_batch, qrsol_vals
    from ..symbolic import sqr

    m, n = a.m, a.n
    AxK, Bm = _vals_batch(a, Ax, B, m, "m")
    K = AxK.shape[0]
    a0 = _instance(a, AxK, 0)
    fa = a0 if m >= n else ops.transpose(a0, device="cpu")
    s = sym if sym is not None else sqr(fa, order, True)
    dev = _device(mesh)
    if _qr_mf_plan(fa, s) is None:
        return qrsol_vals(a, AxK, Bm, order, sym=s, device=dev)
    idx = _instances(mesh, axis, K)
    return _gathered(lambda: qrsol_vals(a, AxK[idx], Bm[idx], order, sym=s,
                                        device=dev),
                     mesh, axis, K, len(idx), n)


__all__ += ["dist_cholsol_vals", "dist_lusol_vals", "dist_qrsol_vals"]


# Halo-sharded layer (x sharded n/D, ring boundary exchange); see
# parallel/halo.py.
from .halo import (  # noqa: E402,F401
    RowPartition, partition_rows, make_gaxpy_halo, dist_gaxpy_halo,
    HaloTriPlan, halo_tri_plan, dist_tri_solve_halo, dist_lusol, dist_qrsol,
)

__all__ += [
    "RowPartition", "partition_rows", "make_gaxpy_halo", "dist_gaxpy_halo",
    "HaloTriPlan", "halo_tri_plan", "dist_tri_solve_halo", "dist_lusol",
    "dist_qrsol",
]
