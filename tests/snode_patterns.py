"""The triangles of the supernodal sweep's tests, on the CPU
(`test_torch_sptrsv_snode.py`) and on the card (`test_torch_kernel.py`):
Cholesky factors (AMD order) of 5-point Laplacians on grids of 16, 27 and
40, of HPCG's 27-point problem on a 10^3 grid (a 3D factor: separators of
about a hundred columns, so that the panels above the bottom subtrees have
up to 226 rows below them, in up to 4 parts) and of a random SPD matrix; a
band matrix in natural order, whose last 71 columns are one wide root cut
into panels; and a lower triangle whose panels all have one column (two
stars). The matrices come from `torch_cases`' families. numpy and the
port only: no JAX.
"""

import dataclasses

import numpy as np

import rsparse_tpu_torch as rt
import torch_cases as C
from rsparse_tpu_torch.ops import snode
from rsparse_tpu_torch.symbolic import _symperm_host, native

PATTERNS = ["poisson16", "poisson27", "poisson40", "hpcg27_10", "random",
            "wide_root", "width1"]
# small tasks, so that every pattern has bottom subtrees and panels above
TASK_ENTRIES = 600


def chol(a, order):
    """The host engine's Cholesky factor L of a (port Sprs) in `order`."""
    s = rt.schol(a, order)
    c = _symperm_host(a, s.pinv) if s.pinv is not None else a
    n = a.n
    Lp, Li, Lx = native.chol_numeric(n, c.p, c.i[: c.nnz()], c.x[: c.nnz()],
                                     s.parent, s.cp)
    return rt.Sprs(len(Lx), n, n, Lp, Li, Lx)


def _random_spd(n=300, seed=3):
    m, _, p, i, x = C.rand_pattern(n, n, 4 * n, seed)
    d = C.dense((m, n, p, i, x))
    d = d + d.T
    d += np.diag(np.abs(d).sum(1) + 1.0)
    return C.port(d)


def _band(n=400, bw=70, seed=5):
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n))
    for k in range(1, bw + 1):
        v = rng.uniform(-1, 1, n - k)
        m[np.arange(k, n), np.arange(n - k)] = v
    m = m + m.T
    m += np.diag(np.abs(m).sum(1) + 1.0)
    return C.port(m)


def _two_stars(n=2000, seed=7):
    """L with column j < n-2 holding row n-2 (j even) or n-1 (j odd): no
    column's pattern nests in the next, so every panel has one column."""
    rng = np.random.default_rng(seed)
    cols = np.arange(n - 2)
    rows = np.where(cols % 2 == 0, n - 2, n - 1)
    r = np.concatenate([np.arange(n), rows])
    c = np.concatenate([np.arange(n), cols])
    v = np.concatenate([np.full(n, 2.0), rng.uniform(-0.5, 0.5, n - 2)])
    v[n - 2:n] = 1.0 + 0.25 * n  # the centres dominate their rows
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return rt.Sprs(len(v), n, n, p, r[order], v[order])


_TRI: dict = {}


def triangle(name):
    """The lower triangle of PATTERNS' `name` (built once)."""
    if name not in _TRI:
        if name.startswith("poisson"):
            L = chol(C.port(C.laplacian(int(name[7:]))), 1)
        elif name.startswith("hpcg27"):
            L = chol(C.port(C.hpcg27(int(name[7:]))), 1)
        elif name == "random":
            L = chol(_random_spd(), 1)
        elif name == "wide_root":
            L = chol(_band(), -1)
        else:
            L = _two_stars()
        _TRI[name] = L
    return _TRI[name]


def plan(L, kind, entries=TASK_ENTRIES):
    """tri_plan(L, kind) whose `snode` has bottom subtrees of at most
    `entries` entries."""
    return dataclasses.replace(
        rt.tri_plan(L, kind), supernodes=lambda: snode.snode_schedule(
            snode.snode_panels(L.n, L.p, L.i, entries), kind))


