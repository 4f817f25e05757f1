"""HPCG's 27-point problem (HPCG 3.1, `src/GenerateProblem_ref.cpp`): on an
nx x ny x nz local grid, row `iz*nx*ny + iy*nx + ix` holds 26 on the
diagonal and -1 for each of its up to 26 neighbours (ix + sx, iy + sy,
iz + sz), sx, sy, sz in {-1, 0, 1}, that lie inside the box; outside it
the boundary is zero Dirichlet and gives no entry. The matrix is SPD and
symmetric, and in this row order block tridiagonal by z-planes with
blocks of nx*ny rows. The box here is cubic (nx = ny = nz). Its values
take nothing from the seed."""

import numpy as np


def make(params: dict, rng: np.random.Generator):
    """(n, p, i, x) of the 27-point stencil on a params["grid"]^3 box,
    unknown k at (iz, iy, ix) = (k // g^2, k // g % g, k % g)."""
    g = int(params["grid"])
    n = g ** 3
    idx = np.arange(n, dtype=np.int64)
    iz, iy, ix = idx // (g * g), idx // g % g, idx % g
    rows, cols, vals = [], [], []
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                z, y, x = iz + sz, iy + sy, ix + sx
                ok = ((z >= 0) & (z < g) & (y >= 0) & (y < g)
                      & (x >= 0) & (x < g))
                rows.append(idx[ok])
                cols.append((z * g * g + y * g + x)[ok])
                diag = (sz, sy, sx) == (0, 0, 0)
                vals.append(np.full(int(ok.sum()), 26.0 if diag else -1.0))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return n, p, r[order], v[order]
