"""The 5-point Poisson matrix on a g x g grid (MATLAB's
`gallery('poisson', g)`): 4 on the diagonal, -1 to each neighbour. Its
values take nothing from the seed."""

import numpy as np


def make(params: dict, rng: np.random.Generator):
    """(n, p, i, x) of the 5-point Laplacian on a params["grid"]^2 mesh,
    unknown k at mesh point (k // g, k % g)."""
    g = int(params["grid"])
    n = g * g
    idx = np.arange(n, dtype=np.int64)
    gx, gy = idx // g, idx % g
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nx, ny = gx + dx, gy + dy
        ok = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
        rows.append((nx * g + ny)[ok])
        cols.append(idx[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return n, p, r[order], v[order]
