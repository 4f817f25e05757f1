"""Checkpoint / resume of symbolic analyses and numeric factorizations.

A `Symb` round-trips through a compact .npz bundle (orderings, counts and
the elimination tree: pure functions of the sparsity pattern, which
dominate set-up for repeated solves), and an `Nmrc` through another (its
factors' numpy values, `pinv`, the QR betas). The keys are the JAX
package's (`rsparse_tpu/utils/checkpoint.py`), so files move between the
two packages both ways. Device state is not written: a loaded `Symb`
builds its plans (`plan`, `_mf_plan`, ...) again at first use, and a loaded
`Nmrc`'s solves upload its values (`factor.device_values`).
"""

from __future__ import annotations

import numpy as np

from ..data import Nmrc, Sprs, Symb

__all__ = ["save_symbolic", "load_symbolic", "save_factor", "load_factor"]

_FIELDS = ("pinv", "q", "parent", "cp")


def save_symbolic(s: Symb, path: str) -> None:
    """Serialize a Symb (without its device plans) to `path` (.npz)."""
    payload = {"m2": np.int64(s.m2), "lnz": np.int64(s.lnz), "unz": np.int64(s.unz)}
    for f in _FIELDS:
        v = getattr(s, f)
        if v is not None:
            payload[f] = np.asarray(v, dtype=np.int64)
    np.savez(path, **payload)


def load_symbolic(path: str) -> Symb:
    with np.load(path) as z:
        s = Symb(m2=int(z["m2"]), lnz=int(z["lnz"]), unz=int(z["unz"]))
        for f in _FIELDS:
            if f in z:
                setattr(s, f, z[f])
    return s


def _pack_sprs(tag: str, t: Sprs, payload: dict) -> None:
    nz = t.nnz()
    payload[tag + "_shape"] = np.asarray([t.nzmax, t.m, t.n], dtype=np.int64)
    payload[tag + "_p"] = np.asarray(t.p, dtype=np.int64)
    payload[tag + "_i"] = np.asarray(t.i[:nz], dtype=np.int64)
    payload[tag + "_x"] = np.asarray(t.x[:nz], dtype=np.float64)


def _unpack_sprs(tag: str, z) -> Sprs:
    nzmax, m, n = (int(v) for v in z[tag + "_shape"])
    return Sprs(nzmax, m, n, z[tag + "_p"], z[tag + "_i"], z[tag + "_x"])


def save_factor(nm: Nmrc, path: str) -> None:
    """Serialize a numeric factorization (Nmrc: L/V in `l`, U/R in `u`,
    `pinv`, QR betas in `b` — reference layout src/data.rs:1064-1074) so a
    serving process can restore factors without factoring again. The
    factors' numpy values are written, not the card's cached copy."""
    payload: dict = {}
    if nm.l is not None:
        _pack_sprs("l", nm.l, payload)
    if nm.u is not None:
        _pack_sprs("u", nm.u, payload)
    if nm.pinv is not None:
        payload["pinv"] = np.asarray(nm.pinv, dtype=np.int64)
    if nm.b is not None:
        payload["beta"] = np.asarray(nm.b, dtype=np.float64)
    np.savez(path, **payload)


def load_factor(path: str) -> Nmrc:
    nm = Nmrc()
    with np.load(path) as z:
        if "l_p" in z:
            nm.l = _unpack_sprs("l", z)
        if "u_p" in z:
            nm.u = _unpack_sprs("u", z)
        if "pinv" in z:
            nm.pinv = z["pinv"]
        if "beta" in z:
            nm.b = z["beta"]
    return nm
