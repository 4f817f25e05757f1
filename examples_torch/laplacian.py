"""The system the serving and distributed examples solve: the 5-point
Laplacian on a g x g mesh, built with numpy."""

import numpy as np

import rsparse_tpu_torch as rt


def laplacian_5pt(g: int) -> rt.Sprs:
    """The 5-point Laplacian on a g x g mesh (4 on the diagonal, -1 to each
    neighbour), as CSC with rows ascending in each column."""
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
    return rt.Sprs(len(v), n, n, p, r[order], v[order])
