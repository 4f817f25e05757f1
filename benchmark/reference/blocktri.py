"""Plain reference: block Gaussian elimination of a block-tridiagonal
matrix in its natural order.

A 5-point matrix on a g x g grid, unknown k at mesh point (k // g, k % g),
is block tridiagonal with g x g blocks: block (I, J) couples mesh rows I
and J, and only |I - J| <= 1 is present. The reference eliminates the
block rows in order (S_0 = D_0, S_k = D_k - L_k S_{k-1}^-1 U_{k-1}), with
partial pivoting inside each dense block (`torch.linalg.lu_factor`), then
substitutes back. It takes only the matrix's CSC arrays and the block
size: no ordering, analysis or factor of the program. Diagonally dominant
and SPD matrices need no pivoting across blocks.

`dtype` float64 is the reference; float32 is the control, the same
solver one precision lower (TF32 off).
"""

import numpy as np
import torch


class BlockTri:
    """The blocks of one matrix on `device`, and its block elimination."""

    def __init__(self, n, p, i, x, block: int, dtype=torch.float64,
                 device="cpu"):
        if n % block:
            raise ValueError(f"n = {n} is not a multiple of the block {block}")
        p = np.asarray(p, np.int64)
        rows = np.asarray(i[: p[-1]], np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(p))
        br, bc = rows // block, cols // block
        off = bc - br
        if np.abs(off).max(initial=0) > 1:
            raise ValueError("the matrix is not block tridiagonal")
        nb, g = n // block, block
        self.n, self.g, self.nb = n, g, nb
        self.dtype, self.device = dtype, torch.device(device)
        vals = torch.as_tensor(np.asarray(x[: p[-1]], np.float64),
                               device=self.device)
        ix = lambda v: torch.as_tensor(v, device=self.device)
        # blocks[d + 1][I] = A(I, I + d) for d = -1, 0, 1
        self.blocks = torch.zeros((3, nb, g, g), dtype=dtype, device=self.device)
        self.blocks.index_put_((ix(off + 1), ix(br), ix(rows % g), ix(cols % g)),
                               vals.to(dtype), accumulate=True)
        self.coo = (ix(rows), ix(cols), vals)
        self._factors = None

    def factor(self):
        """Eliminate the block rows: per block row k the LU of S_k and
        Z_k = S_k^-1 U_k."""
        with _exact_matmul():
            lower, diag, upper = self.blocks
            lus, zs = [], []
            for k in range(self.nb):
                s = diag[k] if k == 0 else diag[k] - lower[k] @ zs[k - 1]
                lu, piv = torch.linalg.lu_factor(s)
                lus.append((lu, piv))
                if k < self.nb - 1:
                    zs.append(torch.linalg.lu_solve(lu, piv, upper[k]))
        self._factors = (lus, zs)

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        """X with A X = B, B [n, m] (or [n]), in the reference's dtype."""
        if self._factors is None:
            self.factor()
        lus, zs = self._factors
        lower = self.blocks[0]
        vec = B.dim() == 1
        Bb = B.reshape(self.nb, self.g, -1).to(self.dtype)
        with _exact_matmul():
            ys = []
            for k in range(self.nb):
                y = Bb[k] if k == 0 else Bb[k] - lower[k] @ ys[k - 1]
                ys.append(torch.linalg.lu_solve(*lus[k], y))
            xs = [None] * self.nb
            xs[-1] = ys[-1]
            for k in range(self.nb - 2, -1, -1):
                xs[k] = ys[k] - zs[k] @ xs[k + 1]
        X = torch.cat(xs).reshape(self.n, -1)
        return X[:, 0] if vec else X

    def residual(self, X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """B - A X in float64, from the matrix's float64 COO."""
        r, c, v = self.coo
        X = X.to(torch.float64).reshape(self.n, -1)
        AX = torch.zeros_like(X).index_add_(0, r, v[:, None] * X[c])
        return B.to(torch.float64).reshape(self.n, -1) - AX

    def norm_inf(self) -> float:
        """The largest row abs-sum of A."""
        r, _, v = self.coo
        sums = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        return float(sums.index_add_(0, r, v.abs()).max())


class _exact_matmul:
    """Matrix products in the tensors' own precision: no TF32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def build(cfg: dict, n, p, i, x, dtype=torch.float64, device="cpu") -> BlockTri:
    """The reference for a configuration on a g x g grid: blocks of g."""
    return BlockTri(n, p, i, x, int(cfg["params"]["grid"]), dtype, device)
