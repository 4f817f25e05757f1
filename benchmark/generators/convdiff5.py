"""The 5-point central-difference matrix of the convection-diffusion
equation -Δu + b·∇u = f on the unit square with Dirichlet boundaries
(Saad, Iterative Methods for Sparse Linear Systems, 2nd ed., §2.1.2 for
the equation, §2.2.4-2.2.5 for central differences on 1-D and 2-D grids).

On a g x g grid of interior points, h = 1/(g + 1), unknown k at mesh point
(k // g, k % g), each row scaled by h²: 4 on the diagonal, -1 - p_x and
-1 + p_x to the neighbours at x - h and x + h, -1 - p_y and -1 + p_y at
y - h and y + h, where p = b h / 2 are the cell Péclet numbers. For |p| < 1
the matrix is a nonsymmetric M-matrix, weakly diagonally dominant. Its
values take nothing from the seed."""

import numpy as np


def make(params: dict, rng: np.random.Generator):
    """(n, p, i, x) on a params["grid"]^2 mesh with cell Péclet numbers
    params["peclet"] = [p_x, p_y]."""
    g = int(params["grid"])
    px, py = (float(v) for v in params["peclet"])
    n = g * g
    idx = np.arange(n, dtype=np.int64)
    gx, gy = idx // g, idx % g
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for dx, dy, v in ((-1, 0, -1.0 - px), (1, 0, -1.0 + px),
                      (0, -1, -1.0 - py), (0, 1, -1.0 + py)):
        nx, ny = gx + dx, gy + dy
        ok = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
        rows.append(idx[ok])  # the equation at k ...
        cols.append((nx * g + ny)[ok])  # ... couples its neighbour's unknown
        vals.append(np.full(int(ok.sum()), v))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    order = np.lexsort((r, c))
    p = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=p[1:])
    return n, p, r[order], v[order]
