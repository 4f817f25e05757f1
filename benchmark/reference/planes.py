"""Plain reference for a 3D stencil in plane order: block Gaussian
elimination by z-planes.

A 27-point (or 7-point) matrix on a g x g x g box, unknown k at
(k // g^2, k // g % g, k % g), couples only neighbouring z-planes, so it
is block tridiagonal with blocks of g^2 rows: one block per plane. The
elimination is `blocktri.BlockTri`'s (S_0 = D_0, S_k = D_k -
L_k S_{k-1}^-1 U_{k-1}, dense LU with partial pivoting inside each block,
then back substitution), in plain torch, from the matrix's CSC arrays and
the block size alone: no ordering, analysis or factor of the program. It
refuses a matrix with an entry outside the three block diagonals.

`dtype` float64 is the reference; float32 is the control (TF32 off).
"""

import torch

from benchmark.reference.blocktri import BlockTri


def build(cfg: dict, n, p, i, x, dtype=torch.float64,
          device="cpu") -> BlockTri:
    """The reference for a configuration on a grid^3 box: blocks of grid^2."""
    g = int(cfg["params"]["grid"])
    return BlockTri(n, p, i, x, g * g, dtype, device)
