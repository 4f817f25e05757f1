"""ctypes binding to the native symbolic/numeric engine (C++ host code).

The engine's source is the port's own copy, `rsparse_tpu_torch/native/
rsymbolic.cpp` (byte for byte the JAX package's engine, so the two packages
compute the same analyses and host factors). It is compiled with g++ into
this package's build directory (`rsparse_tpu_torch/_build/`, gitignored),
under a name keyed on a hash of the source, so an edit rebuilds it. The
build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(os.path.join(_HERE, "..", "native", "rsymbolic.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_int = ctypes.c_int
_dbl = ctypes.c_double


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librsymbolic_{tag}.so")


def _build(so: str) -> None:
    # Build to a per-process temp path and atomically swap: concurrent test
    # workers may build the same library at once.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.check_call(["g++", "-O3", "-fPIC", "-shared", _SRC, "-o", tmp])
    os.replace(tmp, so)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rt_etree.argtypes = [_i64, _i64, _i64p, _i64p, _int, _i64p]
    lib.rt_post.argtypes = [_i64, _i64p, _i64p]
    lib.rt_counts.argtypes = [_i64, _i64, _i64p, _i64p, _i64p, _i64p, _int, _i64p]
    lib.rt_amd.argtypes = [_int, _i64, _i64, _i64p, _i64p, _i64p]
    lib.rt_amd.restype = _int
    lib.rt_vcount.argtypes = [_i64, _i64, _i64p, _i64p, _i64p, _i64p,
                              ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
    lib.rt_chol_pattern.argtypes = [_i64, _i64p, _i64p, _i64p, _i64p,
                                    _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.rt_chol_numeric.argtypes = [_i64, _i64p, _i64p, _f64p, _i64p, _i64p,
                                    _i64p, _i64p, _f64p]
    lib.rt_chol_numeric.restype = _int
    lib.rt_lu_numeric.argtypes = [_i64, _i64p, _i64p, _f64p,
                                  ctypes.c_void_p, _dbl, _i64, _i64,
                                  _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
                                  _i64p, ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
    lib.rt_lu_numeric.restype = _int
    lib.rt_lu_pattern.argtypes = [_i64, _i64p, _i64p, ctypes.c_void_p, _i64, _i64,
                                  _i64p, _i64p, _i64p, _i64p, _i64p,
                                  ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
    lib.rt_lu_pattern.restype = _int
    lib.rt_qr_pattern.argtypes = [_i64, _i64, _i64p, _i64p, ctypes.c_void_p,
                                  _i64p, _i64p, _i64, _i64p, _i64p, _i64p, _i64p]
    lib.rt_qr_numeric.argtypes = [_i64, _i64, _i64p, _i64p, _f64p, ctypes.c_void_p,
                                  _i64p, _i64p, _i64, _i64p, _i64p, _f64p,
                                  _i64p, _i64p, _f64p, _f64p]
    lib.rt_qr_ls_apply.argtypes = [_i64, _i64p, _i64p, _f64p, _f64p,
                                   _i64p, _i64p, _f64p, _f64p]
    lib.rt_lsolve.argtypes = [_i64, _i64p, _i64p, _f64p, _f64p]
    lib.rt_ltsolve.argtypes = [_i64, _i64p, _i64p, _f64p, _f64p]
    lib.rt_usolve.argtypes = [_i64, _i64p, _i64p, _f64p, _f64p]
    lib.rt_utsolve.argtypes = [_i64, _i64p, _i64p, _f64p, _f64p]
    lib.rt_tri_levels.argtypes = [_i64, _i64p, _i64p, _int, _i64p]
    lib.rt_gaxpy.argtypes = [_i64, _i64, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p]
    lib.rt_match.argtypes = [_i64, _i64p, _i64p, _f64p, _i64p]
    lib.rt_match.restype = _int
    lib.rt_multiply.argtypes = [_i64, _i64, _i64p, _i64p, _f64p,
                                _i64, _i64p, _i64p, _f64p,
                                _i64, _i64p, _i64p, _f64p]
    lib.rt_multiply.restype = _i64
    return lib


_LIB: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The engine library, compiled from source on first call."""
    global _LIB
    if _LIB is None:
        so = _so_path()
        if not os.path.exists(so):
            _build(so)
        _LIB = _declare(ctypes.CDLL(so))
    return _LIB


def _c(a: np.ndarray, dtype=np.int64) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _opt_ptr(a: Optional[np.ndarray]):
    """Optional int64 array -> void* (nullptr for None)."""
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.c_void_p)


def etree(m: int, n: int, Ap: np.ndarray, Ai: np.ndarray, ata: bool) -> np.ndarray:
    parent = np.empty(n, dtype=np.int64)
    load().rt_etree(m, n, _c(Ap), _c(Ai), int(ata), parent)
    return parent


def post(n: int, parent: np.ndarray) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    load().rt_post(n, _c(parent), out)
    return out


def counts(m, n, Ap, Ai, parent, post_, ata: bool) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    load().rt_counts(m, n, _c(Ap), _c(Ai), _c(parent), _c(post_), int(ata), out)
    return out


def amd(order: int, m: int, n: int, Ap, Ai) -> Optional[np.ndarray]:
    """Returns the fill-reducing permutation, or None for natural order."""
    if order < 0:
        return None
    perm = np.empty(n + 1, dtype=np.int64)
    ok = load().rt_amd(order, m, n, _c(Ap), _c(Ai), perm)
    return perm[:n].copy() if ok else None


def vcount(m, n, Ap, Ai, parent) -> Tuple[np.ndarray, int, int]:
    """Returns (pinv in the reference 2m+n layout, m2, vnz)."""
    pinv = np.zeros(2 * m + n, dtype=np.int64)
    m2 = _i64(0)
    vnz = _i64(0)
    load().rt_vcount(m, n, _c(Ap), _c(Ai), _c(parent), pinv,
                   ctypes.byref(m2), ctypes.byref(vnz))
    return pinv, int(m2.value), int(vnz.value)


def chol_pattern(n, Cp, Ci, parent, cp):
    """L pattern (CSC, diag-first), per-row (ereach) patterns, etree levels."""
    lnz = int(cp[n])
    Lp = np.empty(n + 1, dtype=np.int64)
    Li = np.empty(lnz, dtype=np.int64)
    Rp = np.empty(n + 1, dtype=np.int64)
    Rj = np.empty(max(lnz - n, 0), dtype=np.int64)
    level = np.empty(n, dtype=np.int64)
    load().rt_chol_pattern(n, _c(Cp), _c(Ci), _c(parent), _c(cp), Lp, Li, Rp, Rj, level)
    return Lp, Li, Rp, Rj, level


def chol_numeric(n, Cp, Ci, Cx, parent, cp):
    lnz = int(cp[n])
    Lp = np.empty(n + 1, dtype=np.int64)
    Li = np.empty(lnz, dtype=np.int64)
    Lx = np.empty(lnz, dtype=np.float64)
    rc = load().rt_chol_numeric(n, _c(Cp), _c(Ci), _c(Cx, np.float64), _c(parent), _c(cp), Lp, Li, Lx)
    if rc != 0:
        from ..errors import NotPositiveDefiniteError

        raise NotPositiveDefiniteError()
    return Lp, Li, Lx


def lu_numeric(n, Ap, Ai, Ax, q, tol, cap_l, cap_u):
    Ap, Ai, Ax = _c(Ap), _c(Ai), _c(Ax, np.float64)
    q = _c(q) if q is not None else None
    while True:
        Lp = np.zeros(n + 1, dtype=np.int64)
        Li = np.zeros(cap_l, dtype=np.int64)
        Lx = np.zeros(cap_l, dtype=np.float64)
        Up = np.zeros(n + 1, dtype=np.int64)
        Ui = np.zeros(cap_u, dtype=np.int64)
        Ux = np.zeros(cap_u, dtype=np.float64)
        pinv = np.empty(n, dtype=np.int64)
        lnz = _i64(0)
        unz = _i64(0)
        rc = load().rt_lu_numeric(n, Ap, Ai, Ax, _opt_ptr(q), float(tol),
                                cap_l, cap_u, Lp, Li, Lx, Up, Ui, Ux, pinv,
                                ctypes.byref(lnz), ctypes.byref(unz))
        if rc == -2:  # capacity overflow: retry with the suggested sizes
            cap_l, cap_u = int(lnz.value), int(unz.value)
            continue
        if rc == -1:
            from ..errors import NoPivotError

            raise NoPivotError()
        ln, un = int(lnz.value), int(unz.value)
        return (Lp, Li[:ln], Lx[:ln], Up, Ui[:un], Ux[:un], pinv)


def lu_pattern(n, Ap, Ai, q, cap_l, cap_u):
    """Static-pivot LU pattern + level schedule (device-LU symbolic phase).

    Returns (Lp, Li, Up, Ui, level); raises NoPivotError if structurally
    singular under static pivoting.
    """
    Ap, Ai = _c(Ap), _c(Ai)
    q = _c(q) if q is not None else None
    while True:
        Lp = np.zeros(n + 1, dtype=np.int64)
        Li = np.zeros(cap_l, dtype=np.int64)
        Up = np.zeros(n + 1, dtype=np.int64)
        Ui = np.zeros(cap_u, dtype=np.int64)
        level = np.zeros(n, dtype=np.int64)
        lnz = _i64(0)
        unz = _i64(0)
        rc = load().rt_lu_pattern(n, Ap, Ai, _opt_ptr(q), cap_l, cap_u,
                                Lp, Li, Up, Ui, level,
                                ctypes.byref(lnz), ctypes.byref(unz))
        if rc == -2:
            cap_l, cap_u = int(lnz.value), int(unz.value)
            continue
        if rc == -1:
            from ..errors import NoPivotError

            raise NoPivotError()
        return Lp, Li[: int(lnz.value)], Up, Ui[: int(unz.value)], level


def qr_pattern(m, n, Ap, Ai, q, parent, pinv, m2, vnz_cap, rnz_cap):
    Vp = np.empty(n + 1, dtype=np.int64)
    Vi = np.empty(vnz_cap, dtype=np.int64)
    Rp = np.empty(n + 1, dtype=np.int64)
    Ri = np.empty(rnz_cap, dtype=np.int64)
    q = _c(q) if q is not None else None
    load().rt_qr_pattern(m, n, _c(Ap), _c(Ai), _opt_ptr(q), _c(parent), _c(pinv),
                       m2, Vp, Vi, Rp, Ri)
    return Vp, Vi[: int(Vp[n])], Rp, Ri[: int(Rp[n])]


def qr_numeric(m, n, Ap, Ai, Ax, q, parent, pinv, m2, vnz_cap, rnz_cap):
    Vp = np.empty(n + 1, dtype=np.int64)
    Vi = np.empty(vnz_cap, dtype=np.int64)
    Vx = np.empty(vnz_cap, dtype=np.float64)
    Rp = np.empty(n + 1, dtype=np.int64)
    Ri = np.empty(rnz_cap, dtype=np.int64)
    Rx = np.empty(rnz_cap, dtype=np.float64)
    beta = np.zeros(n, dtype=np.float64)
    q = _c(q) if q is not None else None
    load().rt_qr_numeric(m, n, _c(Ap), _c(Ai), _c(Ax, np.float64), _opt_ptr(q),
                       _c(parent), _c(pinv), m2, Vp, Vi, Vx, Rp, Ri, Rx, beta)
    vn, rn = int(Vp[n]), int(Rp[n])
    return Vp, Vi[:vn], Vx[:vn], Rp, Ri[:rn], Rx[:rn], beta


def qr_ls_apply(n, Vp, Vi, Vx, beta, Rp, Ri, Rx, x):
    """happly(k=0..n-1) then R\\x on the dense workspace x — the reference
    qrsol m>=n apply phase (src/lib.rs:936-940). x: f64, length >= m2."""
    load().rt_qr_ls_apply(n, _c(Vp), _c(Vi), _c(Vx, np.float64),
                        _c(beta, np.float64), _c(Rp), _c(Ri),
                        _c(Rx, np.float64), x)


def tri_levels(n, Tp, Ti, kind: int) -> np.ndarray:
    level = np.empty(n, dtype=np.int64)
    load().rt_tri_levels(n, _c(Tp), _c(Ti), kind, level)
    if n and level[0] == -1:
        raise ValueError(
            "triangular-solve dependency graph has a cycle — corrupt "
            "factor (labels do not describe a valid elimination order)")
    return level


def lsolve_host(n, Lp, Li, Lx, x):
    load().rt_lsolve(n, _c(Lp), _c(Li), _c(Lx, np.float64), x)


def ltsolve_host(n, Lp, Li, Lx, x):
    load().rt_ltsolve(n, _c(Lp), _c(Li), _c(Lx, np.float64), x)


def usolve_host(n, Up, Ui, Ux, x):
    load().rt_usolve(n, _c(Up), _c(Ui), _c(Ux, np.float64), x)


def utsolve_host(n, Up, Ui, Ux, x):
    load().rt_utsolve(n, _c(Up), _c(Ui), _c(Ux, np.float64), x)


def gaxpy_host(m, n, Ap, Ai, Ax, x, y):
    """Sequential reference-shaped SpMV (bench denominator)."""
    r = np.empty(m, dtype=np.float64)
    load().rt_gaxpy(m, n, _c(Ap), _c(Ai), _c(Ax, np.float64),
                  _c(x, np.float64), _c(y, np.float64), r)
    return r


def match(n: int, Ap: np.ndarray, Ai: np.ndarray, Ax: np.ndarray):
    """Static-pivoting row matching (MC64-flavoured; SuperLU_DIST GESP prep).

    Returns pinv with pinv[row] = matched column (the row's new position) so
    A(pinv,:) has large entries on its diagonal, or None when the nonzero
    values are structurally singular. No reference counterpart (the
    reference pivots dynamically, src/lib.rs:565-589); this is the
    preprocessing that makes static/front-restricted pivoting stable on
    device.
    """
    pinv = np.empty(n, dtype=np.int64)
    ok = load().rt_match(n, _c(Ap), _c(Ai), _c(Ax, np.float64), pinv)
    return pinv if ok else None


def multiply_host(am, an, Ap, Ai, Ax, bn, Bp, Bi, Bx):
    """Reference-exact Gustavson SpGEMM in C++ (bench denominator;
    reference src/lib.rs:713-748). Returns (Cp, Ci, Cx)."""
    cap = max(int(len(Ax)) + int(len(Bx)), 16)
    while True:
        Cp = np.zeros(bn + 1, dtype=np.int64)
        Ci = np.zeros(cap, dtype=np.int64)
        Cx = np.zeros(cap, dtype=np.float64)
        nz = load().rt_multiply(am, an, _c(Ap), _c(Ai), _c(Ax, np.float64),
                              bn, _c(Bp), _c(Bi), _c(Bx, np.float64),
                              cap, Cp, Ci, Cx)
        if nz >= 0:
            return Cp, Ci[:nz], Cx[:nz]
        cap *= 2
