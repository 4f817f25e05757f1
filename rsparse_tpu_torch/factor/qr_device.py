"""Device QR: level-scheduled blocked-Householder factorization.

The reference's Householder QR (src/lib.rs:788-877) applies, per column k,
the reflectors of its R-pattern ancestors one by one (happly,
src/lib.rs:2099-2111), then forms a new reflector (house,
src/lib.rs:2116-2147). The patterns of V and R are static (native
rt_qr_pattern), so whole elimination levels batch, and the reflector chain
of each column becomes dense work in compact-WY form:

  applying reflectors j1..jr (the R-pattern order) to x equals
      y = Vᵀ x,   (diag(1/beta) + stril(VᵀV)) w = y,   x -= V w
  one batched product, one batched small lower-triangular solve
  (`torch.linalg.solve_triangular`), one batched product per level.

An identity reflector (beta == 0) takes part with its column of V zeroed
and a unit diagonal, so its w is exactly 0, as happly with beta = 0 leaves
x unchanged. The new reflector follows house() bit for bit (the v[0] sign
rule, the sigma == 0 branch); R(k,k) = ±‖v‖ with the reference's sign.

The levels run in eager torch on the values' device, each level (up to
`level_batch` columns) one group of batched tensors padded to its own
largest support, reflector count and reflector length. The JAX package's
TPU shape ladders and scan grouping have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data import Sprs, Symb
from ..ops.plan import device_cache
from ..symbolic import native
from .frontal import _ranges
from .lu_device import _gather, _index_tensors


@dataclasses.dataclass
class QRLevel:
    """One batch of K columns of one level, padded to s support slots, r
    applied reflectors and v reflector rows. -1 marks an absent gather;
    scatter padding points at the value arrays' spare slot."""

    vmat_idx: np.ndarray  # [K, s, r] V positions of the applied reflectors
    beta_idx: np.ndarray  # [K, r] their columns (beta positions)
    a_idx: np.ndarray  # [K, s] A value positions of column q[k]
    rslot: np.ndarray  # [K, r] support slot of each R off-diagonal row (s: pad)
    rpos: np.ndarray  # [K, r] R position of each off-diagonal (rnz: pad)
    vslot: np.ndarray  # [K, v] support slots of V(:, k), pivot row first
    vposk: np.ndarray  # [K, v] V positions of V(:, k) (vnz: pad)
    dpos: np.ndarray  # [K] R(k, k) position
    bpos: np.ndarray  # [K] k


@dataclasses.dataclass
class QRPlan:
    m2: int
    n: int
    vnz: int
    rnz: int
    Vp: np.ndarray
    Vi: np.ndarray
    Rp: np.ndarray
    Ri: np.ndarray
    levels: List[QRLevel]
    plan_entries: int


# A design boundary of the algorithm, not of a device: the reference-exact
# V/R/beta export is a column-sequential reflector recurrence whose supports
# grow with fill. The plan's estimate counts sum |S_k| * r_k element
# operations; above the cap the export runs on the host engine (the JAX
# package measured qrsol_3, 8000², at 7.4e9 over 2,420 levels). Solves at
# that scale run the multifrontal tree (factor/frontal_qr), never this path.
PLAN_ENTRY_CAP = 300_000_000


def _pattern(a: Sprs, s: Symb):
    """(q, V and R patterns, the work estimate) of the QR of `a` under s."""
    q = np.asarray(s.q, dtype=np.int64) if s.q is not None else None
    Vp, Vi, Rp, Ri = native.qr_pattern(
        a.m, a.n, a.p, a.i[: a.nnz()], q, s.parent, s.pinv, s.m2,
        s.lnz + 8, s.unz + a.n + 8)
    rlen = np.diff(Rp) - 1
    est = int(np.sum((np.diff(Vp) + rlen) * np.maximum(rlen, 1)))
    return q, Vp, Vi, Rp, Ri, est


def qr_plan_estimate(a: Sprs, s: Symb) -> int:
    """The work estimate `build_qr_plan` holds to PLAN_ENTRY_CAP: the sum
    over columns of |support| * reflectors applied."""
    return _pattern(a, s)[-1]


def build_qr_plan(a: Sprs, s: Symb, level_batch: int = 1024) -> Optional[QRPlan]:
    """Static per-level gather/scatter maps (host, once per pattern); None
    when the work estimate exceeds PLAN_ENTRY_CAP."""
    m, n = a.m, a.n
    m2 = s.m2
    q, Vp, Vi, Rp, Ri, est = _pattern(a, s)
    if est > PLAN_ENTRY_CAP:
        return None
    vnz, rnz = int(Vp[n]), int(Rp[n])
    # dependency levels: column k applies the reflectors j in R(:, k)'s
    # off-diagonal (rows < k, so one ascending pass settles them)
    level = np.zeros(n, dtype=np.int64)
    for k in range(n):
        deps = Ri[Rp[k]: Rp[k + 1] - 1]
        if len(deps):
            level[k] = int(level[deps].max()) + 1
    vlen = np.diff(Vp)

    pinv_rows = np.asarray(s.pinv[:m2], dtype=np.int64)
    supports = []  # per column: sorted support rows
    for k in range(n):
        B = Ri[Rp[k]: Rp[k + 1] - 1]
        col = int(q[k]) if q is not None else k
        parts = [Vi[Vp[k]: Vp[k + 1]], B,
                 pinv_rows[a.i[a.p[col]: a.p[col + 1]]]]
        if len(B):
            parts.append(Vi[_ranges(Vp[B], vlen[B])])
        supports.append(np.unique(np.concatenate(parts)))

    nlev = int(level.max()) + 1 if n else 0
    order_by_level = np.argsort(level, kind="stable")
    lev_off = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(level, minlength=nlev), out=lev_off[1:])
    levels, total = [], 0
    for lev in range(nlev):
        ks_all = order_by_level[lev_off[lev]: lev_off[lev + 1]]
        for s0 in range(0, len(ks_all), level_batch):
            lv = _level(ks_all[s0: s0 + level_batch], a, q, pinv_rows,
                        supports, Vp, Vi, Rp, Ri, vnz, rnz)
            levels.append(lv)
            total += lv.vmat_idx.size
    return QRPlan(m2=m2, n=n, vnz=vnz, rnz=rnz, Vp=Vp, Vi=Vi, Rp=Rp, Ri=Ri,
                  levels=levels, plan_entries=total)


def _level(ks, a, q, pinv_rows, supports, Vp, Vi, Rp, Ri, vnz, rnz) -> QRLevel:
    K = len(ks)
    smax = max(len(supports[k]) for k in ks)
    rmax = max(max(int(Rp[k + 1] - 1 - Rp[k]) for k in ks), 1)
    vmax = max(int(Vp[k + 1] - Vp[k]) for k in ks)
    vmat_idx = np.full((K, smax, rmax), -1, dtype=np.int64)
    beta_idx = np.full((K, rmax), -1, dtype=np.int64)
    a_idx = np.full((K, smax), -1, dtype=np.int64)
    rslot = np.full((K, rmax), smax, dtype=np.int64)
    rpos = np.full((K, rmax), rnz, dtype=np.int64)
    vslot = np.full((K, vmax), smax, dtype=np.int64)
    vposk = np.full((K, vmax), vnz, dtype=np.int64)
    for t, k in enumerate(ks):
        S = supports[k]
        col = int(q[k]) if q is not None else int(k)
        lo, hi = int(a.p[col]), int(a.p[col + 1])
        # duplicate entries: the last one wins, as the reference's scatter
        slots = np.searchsorted(S, pinv_rows[a.i[lo:hi]])
        last = len(slots) - 1 - np.unique(slots[::-1], return_index=True)[1]
        a_idx[t, slots[last]] = lo + last
        B = Ri[Rp[k]: Rp[k + 1] - 1]
        r = len(B)
        beta_idx[t, :r] = B
        rslot[t, :r] = np.searchsorted(S, B)
        rpos[t, :r] = Rp[k] + np.arange(r)
        if r:
            lens = Vp[B + 1] - Vp[B]
            vp = _ranges(Vp[B], lens)
            vmat_idx[t, np.searchsorted(S, Vi[vp]),
                     np.repeat(np.arange(r), lens)] = vp
        vk = Vi[Vp[k]: Vp[k + 1]]
        vslot[t, : len(vk)] = np.searchsorted(S, vk)
        vposk[t, : len(vk)] = Vp[k] + np.arange(len(vk))
    return QRLevel(vmat_idx=vmat_idx, beta_idx=beta_idx, a_idx=a_idx,
                   rslot=rslot, rpos=rpos, vslot=vslot, vposk=vposk,
                   dpos=Rp[np.asarray(ks) + 1] - 1,
                   bpos=np.asarray(ks, dtype=np.int64))


def _level_dev(plan: QRPlan, device) -> list:
    """The levels' index tensors on `device`, made once per device; the
    scatter maps are range-checked against their value arrays."""

    def make():
        vsz, rsz, bsz = plan.vnz + 1, plan.rnz + 1, plan.n + 1
        return [_index_tensors(
            (lv.vmat_idx, lv.beta_idx, lv.a_idx, lv.rslot, lv.rpos,
             lv.vslot, lv.vposk, lv.dpos, lv.bpos),
            ((4, rsz), (6, vsz), (7, rsz), (8, bsz)), device)
            for lv in plan.levels]

    return device_cache(plan, "_torch_level_dev", device, make)


def _qr_step(Vx, Rx, Bt, Ax, lv) -> None:
    """One level: the compact-WY application of the earlier reflectors, then
    the new reflectors (house). Writes Vx, Rx and Bt in place."""
    vmat_idx, beta_idx, a_idx, rslot, rpos, vslot, vposk, dpos, bpos = lv
    betas = _gather(Bt, beta_idx)  # [K, r]
    live = betas != 0  # beta == 0: identity reflector, w_j = 0 exactly
    V = _gather(Vx, vmat_idx) * live[:, None, :]  # [K, s, r]
    x0 = _gather(Ax, a_idx)  # [K, s]
    y = torch.einsum("ksr,ks->kr", V, x0)
    G = V.mT @ V
    diag = torch.where(live, 1.0 / torch.where(live, betas, 1.0),
                       betas.new_ones(()))
    T = torch.tril(G, -1) + torch.diag_embed(diag)
    w = torch.linalg.solve_triangular(T, y[..., None], upper=False)[..., 0]
    x1 = x0 - torch.einsum("ksr,kr->ks", V, w)
    xpad = torch.cat([x1, x1.new_zeros((x1.shape[0], 1))], dim=1)
    Rx[rpos.reshape(-1)] = torch.gather(xpad, 1, rslot).reshape(-1)
    # the new reflector (house, reference src/lib.rs:2116-2147)
    v = torch.gather(xpad, 1, vslot)  # [K, v]; v[:, 0] is the pivot row
    v0 = v[:, 0]
    tail = v.clone()
    tail[:, 0] = 0.0
    sigma = (tail * tail).sum(dim=1)
    s_nz = torch.sqrt(v0 * v0 + sigma)
    v0_nz = torch.where(v0 <= 0, v0 - s_nz, -sigma / (v0 + s_nz))
    beta_nz = 1.0 / (-s_nz * v0_nz)
    nz = sigma != 0
    s_out = torch.where(nz, s_nz, v0.abs())
    beta_out = torch.where(nz, beta_nz, 2.0 * (v0 <= 0).to(v0.dtype))
    tail[:, 0] = torch.where(nz, v0_nz, v0.new_ones(()))
    Vx[vposk.reshape(-1)] = tail.reshape(-1)
    Rx[dpos] = s_out
    Bt[bpos] = beta_out


def qr_device(a: Sprs, s: Symb, device="cuda") -> Tuple[np.ndarray, ...]:
    """Blocked-Householder QR on `device` (float64), or the host engine when
    the plan exceeds PLAN_ENTRY_CAP. Returns (Vp, Vi, Vx, Rp, Ri, Rx, beta)
    as host arrays, and whether the host engine ran."""
    plan = getattr(s, "plan", None)
    if not isinstance(plan, QRPlan):
        plan = build_qr_plan(a, s)
        if plan is not None:
            s.plan = plan
    nz = a.nnz()
    if plan is None:
        return native.qr_numeric(
            a.m, a.n, a.p, a.i[:nz], a.x[:nz], s.q, s.parent, s.pinv, s.m2,
            s.lnz + 8, s.unz + 8) + (True,)
    dev = torch.device(device)
    Ax = torch.as_tensor(np.asarray(a.x[:nz], np.float64), device=dev)
    Vx = Ax.new_zeros(plan.vnz + 1)
    Rx = Ax.new_zeros(plan.rnz + 1)
    Bt = Ax.new_zeros(plan.n + 1)
    for lv in _level_dev(plan, dev):
        _qr_step(Vx, Rx, Bt, Ax, lv)
    host = lambda t, k: t[:k].cpu().numpy().copy()
    return (plan.Vp, plan.Vi, host(Vx, plan.vnz), plan.Rp, plan.Ri,
            host(Rx, plan.rnz), host(Bt, plan.n), False)


__all__ = ["QRPlan", "QRLevel", "PLAN_ENTRY_CAP", "build_qr_plan",
           "qr_plan_estimate", "qr_device"]
