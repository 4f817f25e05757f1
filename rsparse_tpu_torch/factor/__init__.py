"""L4' numeric factorization: chol, lu and qr.

Dispatch between the device path (torch on the caller's device: the
multifrontal Cholesky and LU, or the level-scheduled ones below
`config.mf_min_n`; the level-scheduled Householder QR) and the native host
engine (C++, reference-exact, used for `config.backend == "host"`, as the
LU fallback when device pivoting is rejected and as the QR export above
`qr_device.PLAN_ENTRY_CAP`). The port factors in float64 on every route.

Every factorization returns an `Nmrc` whose values are writable float64
numpy arrays, the reference's contract. A factor made on a card keeps its
device copy beside the array it mirrors (`device_values`), so the solves
that follow a factorization read it without an upload.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..data import Nmrc, Sprs, Symb
from ..symbolic import native
from .chol_device import chol_device
from .lu_device import lu_device
from .qr_device import qr_device

__all__ = ["chol", "lu", "qr"]


def _card(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" pinned to the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _set_values(nm: Nmrc, which: str, vals, dev: torch.device) -> None:
    """Give factor `which` ("l" or "u") of nm its values as a writable
    float64 host array; a card's copy stays in nm's device cache."""
    t = torch.as_tensor(vals).detach()
    host = t.cpu().to(torch.float64).numpy().copy()
    getattr(nm, which).x = host
    if t.device.type != "cpu":
        nm.__dict__.setdefault("_device_x", {})[which] = (host, t)


def device_values(nm: Nmrc, which: str, device) -> torch.Tensor:
    """The values of nm.l ("l") or nm.u ("u") as a float64 tensor on
    `device`: the factorization's own device copy while the factor still
    holds the array it was returned with, else that array (an upload on a
    card, a view on the CPU). Callers read it right after factoring; an
    edit made in place to the returned array is not seen by the copy."""
    t = getattr(nm, which)
    dev = _card(device)
    hit = nm.__dict__.get("_device_x", {}).get(which)
    if hit is not None and hit[0] is t.x and hit[1].device == dev:
        return hit[1][: t.nnz()]
    return torch.as_tensor(np.asarray(t.x[: t.nnz()], np.float64), device=dev)


def _values_fp(a: Sprs):
    """Cheap value fingerprint for caches keyed on A's values (sym reuse
    with refreshed values must rebuild them; O(nnz) hash per call)."""
    nz = a.nnz()
    return (nz, hash(np.ascontiguousarray(a.x[:nz]).tobytes()))


def chol(a: Sprs, s: Symb, *, device="cuda") -> Nmrc:
    """L = chol(A) given `schol` analysis (reference src/lib.rs:278-337).

    Factors triu(PAP') in float64 on `device` (multifrontal at or above
    `config.mf_min_n` when the plan applies, level-scheduled otherwise);
    L's values come back as a float64 numpy array. Raises
    NotPositiveDefiniteError if A is not SPD. `s._chol_route` records the
    route taken ("device_mf", "device_level" or "host").

    >>> from rsparse_tpu_torch import Sprs, schol
    >>> from rsparse_tpu_torch.factor import chol
    >>> a = Sprs.new_from_vec([[4.0, 2.0], [2.0, 5.0]])
    >>> nm = chol(a, schol(a, 0), device="cpu")
    >>> [round(float(v), 6) for v in nm.l.x[: nm.l.nnz()]]  # L: [2,1;0,2]
    [2.0, 1.0, 2.0]
    """
    from ..symbolic import _symperm_host

    n = a.n
    dev = torch.device(device)
    if s.pinv is not None:
        # value-fingerprint cache: warm re-solves with unchanged values
        # (sym reuse) skip the O(nnz) symperm rebuild
        fp = _values_fp(a)
        hit = s.__dict__.get("_symperm_cache")
        if hit is not None and hit[0] == fp:
            c = hit[1]
        else:
            c = _symperm_host(a, s.pinv)
            s.__dict__["_symperm_cache"] = (fp, c)
    else:
        c = a
    if config.backend == "host":
        mfp = getattr(s, "_mf_plan", None)
        if mfp is not None and not isinstance(mfp, str):
            # host factors invalidate the device front cache
            mfp.__dict__.pop("_cache_tree", None)
        Lp, Li, Lx = native.chol_numeric(n, c.p, c.i[: c.nnz()],
                                         c.x[: c.nnz()], s.parent, s.cp)
        s._chol_route = "host"
    else:
        from .frontal import build_mf_plan, chol_mf

        mfp = getattr(s, "_mf_plan", "unset")
        if isinstance(mfp, str):
            mfp = build_mf_plan(c, s) if n >= config.mf_min_n else None
            s._mf_plan = mfp
        if mfp is not None:
            Lp, Li, Lx = chol_mf(c, s, mfp, dev)
            s._chol_route = "device_mf"
        else:
            Lp, Li, Lx = chol_device(c, s, dev)
            s._chol_route = "device_level"
    nm = Nmrc()
    nm.l = Sprs(int(s.cp[n]), n, n, Lp, Li, None)
    _set_values(nm, "l", Lx, dev)
    return nm


def lu(a: Sprs, s: Symb, tol: float, *, device="cuda") -> Nmrc:
    """(L,U,pinv) = lu(A) given `sqr` analysis (reference src/lib.rs:519-622).

    Factors in float64 on `device`; L and U values come back as float64
    numpy arrays, like the patterns and pinv. Raises NoPivotError if no
    pivot can be found. `s._lu_route` records the route taken.

    >>> from rsparse_tpu_torch import Sprs, sqr
    >>> from rsparse_tpu_torch.factor import lu
    >>> a = Sprs.new_from_vec([[1.0, 3.0], [2.0, 4.0]])
    >>> nm = lu(a, sqr(a, -1, False), 1.0, device="cpu")  # tol=1: strict pivot
    >>> [int(v) for v in nm.pinv]  # row 1 (|2| > |1|) pivots first
    [1, 0]
    """
    n = a.n
    dev = torch.device(device)
    if config.backend == "host":
        mfp = getattr(s, "_mf_lu_plan", None)
        if mfp is not None and not isinstance(mfp, str):
            # host factors invalidate the device front cache
            mfp.__dict__.pop("_cache_tree", None)
        Lp, Li, Lx, Up, Ui, Ux, pinv = native.lu_numeric(
            n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q, tol, s.lnz, s.unz
        )
        s._lu_route = "host"
    else:
        Lp, Li, Lx, Up, Ui, Ux, pinv = lu_device(a, s, tol, dev)
    nm = Nmrc()
    nm.l = Sprs(int(Lp[n]), n, n, Lp, Li, None)
    nm.u = Sprs(int(Up[n]), n, n, Up, Ui, None)
    _set_values(nm, "l", Lx, dev)
    _set_values(nm, "u", Ux, dev)
    nm.pinv = pinv
    s.lnz = int(Lp[n])  # reference mutates s with the actual counts
    s.unz = int(Up[n])
    return nm


def qr(a: Sprs, s: Symb, *, device="cuda") -> Nmrc:
    """(V,beta,R) = qr(A) given `sqr(qr=True)` analysis (reference
    src/lib.rs:788-877). V is returned in `l`, R in `u` and the betas in
    `b`, the reference's Nmrc layout (src/data.rs:1064-1074), all as float64
    numpy arrays.

    Factors on `device` with the level-scheduled blocked Householder QR
    (`qr_device`), or with the host engine when `config.backend == "host"`
    or the plan exceeds `qr_device.PLAN_ENTRY_CAP`; `s._qr_route` records
    which ("device_level" or "host").

    >>> from rsparse_tpu_torch import Sprs, sqr
    >>> from rsparse_tpu_torch.factor import qr
    >>> a = Sprs.new_from_vec([[3.0, 0.0], [4.0, 5.0]])
    >>> nm = qr(a, sqr(a, -1, True), device="cpu")  # R diag: column norms up to sign
    >>> [round(abs(float(nm.u.x[0])), 6)]
    [5.0]
    """
    n = a.n
    if config.backend == "host":
        Vp, Vi, Vx, Rp, Ri, Rx, beta = native.qr_numeric(
            a.m, n, a.p, a.i[: a.nnz()], a.x[: a.nnz()], s.q,
            s.parent, s.pinv, s.m2, s.lnz + 8, s.unz + 8)
        on_host = True
    else:
        Vp, Vi, Vx, Rp, Ri, Rx, beta, on_host = qr_device(a, s, device)
    s._qr_route = "host" if on_host else "device_level"
    nm = Nmrc()
    nm.l = Sprs(int(Vp[n]), s.m2, n, Vp, Vi, Vx)
    nm.u = Sprs(int(Rp[n]), s.m2, n, Rp, Ri, Rx)
    nm.b = beta
    return nm
