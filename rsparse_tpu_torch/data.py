"""Sparse data structures: CSC (`Sprs`), triplet (`Trpl`), `Symb`, `Nmrc`.

The host-side canonical representation is a struct-of-arrays of numpy buffers
(`p: int64[n+1]`, `i: int64[nzmax]`, `x: float64[nzmax]`) mirroring the
reference containers (reference: src/data.rs:194-208 for `Sprs`,
src/data.rs:877-889 for `Trpl`). Device work reads these buffers through
torch tensors made by the numeric layers; the factorizations return their
values as numpy arrays too (`spgemm_dia` may leave C's values on a device
when asked to). `CSCDevice` is the immutable tensor view of a `Sprs` on one
device (`Sprs.to_device` / `Sprs.from_device`).

Behavioural parity notes (each with the reference location):
  - `from_vec` column-scans a dense matrix dropping explicit zeros
    (src/data.rs:289-314).
  - `from_trpl`/`Trpl.to_sprs` do counting-sort by column and keep duplicate
    entries (NOT summed; last one wins when rendered dense)
    (src/data.rs:345-367, 919-947).
  - `trim` removes stored zeros with column-pointer fixups
    (src/data.rs:371-387); `quick_trim` truncates to p[n]
    (src/data.rs:391-395).
  - `.sprs` plain-text save/load format: `nzmax:/m:/n:/p:/i:/x:` lines
    (src/data.rs:414-517).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import config

__all__ = ["Sprs", "Trpl", "Symb", "Nmrc", "CSCDevice", "cumsum"]


def _f_dtype():
    return np.dtype(config.dtype)


def cumsum(p: np.ndarray, c: np.ndarray, n: int) -> int:
    """p[0..n] = exclusive prefix sum of c[0..n-1]; copy p back into c.

    Reference: src/data.rs:176-186 (and the duplicate at src/lib.rs:1901-1911).
    """
    nz = int(np.sum(c[:n]))
    p[0] = 0
    np.cumsum(c[:n], out=p[1 : n + 1])
    c[:n] = p[:n]
    return nz


@dataclasses.dataclass(frozen=True)
class CSCDevice:
    """Immutable CSC view on one device: int64 tensors `p` [n+1] and `i`
    [nnz], the value tensor `x` [nnz], and the dimensions `m`, `n` as ints.

    `ops.device.spmv_csc` consumes it, and autograd flows through `x`."""

    p: object  # torch int64 [n+1]
    i: object  # torch int64 [nnz]
    x: object  # torch float [nnz]
    m: int
    n: int


class Sprs:
    """Compressed sparse column matrix (reference: src/data.rs:194-208)."""

    __slots__ = ("nzmax", "m", "n", "p", "i", "x")

    def __init__(
        self,
        nzmax: int = 0,
        m: int = 0,
        n: int = 0,
        p: Optional[Sequence[int]] = None,
        i: Optional[Sequence[int]] = None,
        x: Optional[Sequence[float]] = None,
    ):
        def _own(v, dt):
            a = np.asarray(v if v is not None else [], dtype=dt)
            # np.asarray of a read-only buffer is a zero-copy READ-ONLY view;
            # Sprs fields are mutable by contract (the reference idiom
            # `a.x[k] = v` must work) — copy only when needed. A CPU
            # tensor's .numpy() shares memory and stays writable.
            return a if a.flags.writeable else a.copy()

        self.nzmax = int(nzmax)
        self.m = int(m)
        self.n = int(n)
        self.p = _own(p, np.int64)
        self.i = _own(i, np.int64)
        self.x = _own(x, _f_dtype())

    # -- constructors (src/data.rs:210-267) --------------------------------

    @classmethod
    def new(cls) -> "Sprs":
        return cls()

    @classmethod
    def zeros(cls, m: int, n: int, nzmax: int) -> "Sprs":
        return cls(
            nzmax=nzmax,
            m=m,
            n=n,
            p=np.zeros(n + 1, dtype=np.int64),
            i=np.zeros(nzmax, dtype=np.int64),
            x=np.zeros(nzmax, dtype=_f_dtype()),
        )

    @classmethod
    def eye(cls, n: int) -> "Sprs":
        s = cls.zeros(n, n, n)
        s.p = np.arange(n + 1, dtype=np.int64)
        s.i = np.arange(n, dtype=np.int64)
        s.x = np.ones(n, dtype=_f_dtype())
        return s

    @classmethod
    def new_from_vec(cls, t) -> "Sprs":
        s = cls()
        s.from_vec(t)
        return s

    @classmethod
    def new_from_trpl(cls, t: "Trpl") -> "Sprs":
        s = cls()
        s.from_trpl(t)
        return s

    # -- element access (src/data.rs:274-284) ------------------------------

    def get(self, row: int, column: int) -> Optional[float]:
        """O(nnz) scan; returns the first stored entry at (row, column)."""
        for j in range(len(self.p) - 1):
            for q in range(int(self.p[j]), int(self.p[j + 1])):
                if int(self.i[q]) == row and j == column:
                    return float(self.x[q])
        return None

    # -- conversions --------------------------------------------------------

    def from_vec(self, a) -> None:
        """Dense (list-of-rows or 2-D array) -> CSC, dropping explicit zeros.

        Reference: src/data.rs:289-314 (column scan + trim).
        """
        d = np.asarray(a, dtype=_f_dtype())
        if d.ndim != 2:
            raise ValueError("from_vec expects a 2-D structure")
        r, c = d.shape
        mask = d != 0.0  # column-major scan drops zeros
        cols_nnz = mask.sum(axis=0)
        self.m, self.n = int(r), int(c)
        self.p = np.zeros(c + 1, dtype=np.int64)
        np.cumsum(cols_nnz, out=self.p[1:])
        # column-major (Fortran) order = scan each column top-to-bottom
        order = np.nonzero(mask.T)
        self.i = order[1].astype(np.int64)
        self.x = d.T[mask.T].astype(_f_dtype())
        self.nzmax = int(self.x.size)

    def from_trpl(self, t: "Trpl") -> None:
        """Triplet -> CSC by counting sort; duplicates kept, not summed.

        Reference: src/data.rs:345-367.
        """
        nz = len(t.x)
        self.nzmax = nz
        self.m, self.n = int(t.m), int(t.n)
        self.p = np.zeros(self.n + 1, dtype=np.int64)
        self.i = np.zeros(nz, dtype=np.int64)
        self.x = np.zeros(nz, dtype=_f_dtype())
        if nz == 0:
            return
        tp = np.asarray(t.p, dtype=np.int64)
        w = np.bincount(tp, minlength=self.n).astype(np.int64)
        self.p[1:] = np.cumsum(w)
        # The reference's counting sort (src/data.rs:356-366) places entries
        # of each column in original triplet order == stable sort by column.
        order = np.argsort(tp, kind="stable")
        self.i = np.asarray(t.i, dtype=np.int64)[order]
        self.x = np.asarray(t.x, dtype=_f_dtype())[order]

    def trim(self) -> None:
        """Drop stored zeros, fixing column pointers (src/data.rs:371-387)."""
        keep = self.x != 0.0
        # new pointer j = count of kept entries before old p[j]
        kept_before = np.concatenate([[0], np.cumsum(keep)])
        self.p = kept_before[self.p].astype(np.int64)
        self.i = self.i[keep]
        self.x = self.x[keep]
        self.nzmax = int(self.x.size)

    def quick_trim(self) -> None:
        """Truncate storage to p[n] entries (src/data.rs:391-395)."""
        self.nzmax = int(self.p[self.n])
        self.i = self.i[: self.nzmax].copy() if self.i.size > self.nzmax else np.resize(self.i, self.nzmax)
        self.x = self.x[: self.nzmax].copy() if self.x.size > self.nzmax else np.resize(self.x, self.nzmax)

    def to_dense(self) -> List[List[float]]:
        """CSC -> dense list-of-rows (src/data.rs:399-408).

        Later duplicate entries overwrite earlier ones, matching the
        reference's scatter order.

        >>> s = Sprs.new_from_vec([[1.0, 0.0], [2.0, 3.0]])
        >>> s.to_dense()
        [[1.0, 0.0], [2.0, 3.0]]
        """
        return [[float(v) for v in row] for row in self.to_dense_np()]

    def to_dense_np(self) -> np.ndarray:
        r = np.zeros((self.m, self.n), dtype=_f_dtype())
        for j in range(self.n):
            lo, hi = int(self.p[j]), int(self.p[j + 1])
            r[self.i[lo:hi], j] = self.x[lo:hi]
        return r

    # -- device handoff ------------------------------------------------------

    def to_device(self, dtype=None, device="cuda") -> CSCDevice:
        """The first nnz entries as a `CSCDevice` on `device`: int64 indices,
        values in `dtype` (a torch or numpy dtype; default `config.dtype`)."""
        import torch

        dt = dtype if dtype is not None else _f_dtype()
        if not isinstance(dt, torch.dtype):
            dt = torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype
        nnz = self.nnz()
        return CSCDevice(
            p=torch.as_tensor(self.p[: self.n + 1], dtype=torch.int64, device=device),
            i=torch.as_tensor(self.i[:nnz], dtype=torch.int64, device=device),
            x=torch.as_tensor(self.x[:nnz], dtype=dt, device=device),
            m=self.m,
            n=self.n,
        )

    @classmethod
    def from_device(cls, d: CSCDevice) -> "Sprs":
        """A host `Sprs` of a `CSCDevice` (values in `config.dtype`, as the
        constructor stores them)."""
        return cls(
            nzmax=int(d.i.shape[0]),
            m=d.m,
            n=d.n,
            p=d.p.detach().cpu().numpy().astype(np.int64),
            i=d.i.detach().cpu().numpy().astype(np.int64),
            x=d.x.detach().cpu().numpy(),
        )

    # -- IO (src/data.rs:414-517) -------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"nzmax: {self.nzmax}\n")
            f.write(f"m: {self.m}\n")
            f.write(f"n: {self.n}\n")
            f.write("p: [" + ", ".join(str(int(v)) for v in self.p) + "]\n")
            f.write("i: [" + ", ".join(str(int(v)) for v in self.i) + "]\n")
            # Rust's {:?} prints floats with a trailing .0 for integral values
            f.write("x: [" + ", ".join(repr(float(v)) for v in self.x) + "]\n")

    def load(self, path: str) -> None:
        """Parse the reference's plain-text format (src/data.rs:432-517)."""
        p: list = []
        i: list = []
        x: list = []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if "nzmax:" in line:
                    self.nzmax = int(line.split(":", 1)[1].replace(" ", ""))
                    if self.nzmax == 0:
                        self._clear()
                        return
                elif line.strip().startswith("m:"):
                    self.m = int(line.split(":", 1)[1].replace(" ", ""))
                    if self.m == 0:
                        self._clear()
                        return
                elif line.strip().startswith("n:"):
                    self.n = int(line.split(":", 1)[1].replace(" ", ""))
                    if self.n == 0:
                        self._clear()
                        return
                elif line.strip().startswith("p:"):
                    body = line.split(":", 1)[1].replace("[", "").replace("]", "")
                    p = [int(v.replace(" ", "")) for v in body.split(",")]
                elif line.strip().startswith("i:"):
                    body = line.split(":", 1)[1].replace("[", "").replace("]", "")
                    i = [int(v.replace(" ", "")) for v in body.split(",")]
                elif line.strip().startswith("x:"):
                    body = line.split(":", 1)[1].replace("[", "").replace("]", "")
                    x = [float(v.replace(" ", "")) for v in body.split(",")]
        self.p = np.asarray(p, dtype=np.int64)
        self.i = np.asarray(i, dtype=np.int64)
        self.x = np.asarray(x, dtype=_f_dtype())

    def _clear(self) -> None:
        self.nzmax = 0
        self.m = 0
        self.n = 0
        self.p = np.asarray([], dtype=np.int64)
        self.i = np.asarray([], dtype=np.int64)
        self.x = np.asarray([], dtype=_f_dtype())

    @classmethod
    def new_from_file(cls, path: str) -> "Sprs":
        s = cls()
        s.load(path)
        return s

    # -- misc -----------------------------------------------------------------

    def copy(self) -> "Sprs":
        return Sprs(self.nzmax, self.m, self.n, self.p.copy(), self.i.copy(), self.x.copy())

    def nnz(self) -> int:
        return int(self.p[self.n]) if self.n < len(self.p) else 0

    def __repr__(self) -> str:
        return f"Sprs({self.m}x{self.n}, nnz={self.nnz()}, nzmax={self.nzmax})"

    def __eq__(self, other) -> bool:  # structural equality, test convenience
        if not isinstance(other, Sprs):
            return NotImplemented
        return (
            self.m == other.m
            and self.n == other.n
            and np.array_equal(self.p, other.p)
            and np.array_equal(self.i, other.i)
            and np.array_equal(self.x, other.x)
        )

    # -- operator overloads (src/data.rs:527-869); the ops' value passes run
    # on their default device, the card ------------------------------------

    def __add__(self, other):
        from . import ops

        if isinstance(other, Sprs):
            return ops.add(self, other, 1.0, 1.0)
        if isinstance(other, (int, float)):
            return ops.scpmat(float(other), self)
        return NotImplemented

    def __radd__(self, other):
        from . import ops

        if isinstance(other, (int, float)):
            return ops.scpmat(float(other), self)
        return NotImplemented

    def __sub__(self, other):
        from . import ops

        if isinstance(other, Sprs):
            return ops.add(self, other, 1.0, -1.0)
        if isinstance(other, (int, float)):
            return ops.scpmat(-float(other), self)
        return NotImplemented

    def __rsub__(self, other):
        from . import ops

        if isinstance(other, (int, float)):
            return ops.scpmat(float(other), ops.scxmat(-1.0, self))
        return NotImplemented

    def __mul__(self, other):
        from . import ops

        if isinstance(other, Sprs):
            return ops.multiply(self, other)
        if isinstance(other, (int, float)):
            return ops.scxmat(float(other), self)
        return NotImplemented

    def __rmul__(self, other):
        from . import ops

        if isinstance(other, (int, float)):
            return ops.scxmat(float(other), self)
        return NotImplemented

    def __truediv__(self, other):
        from . import ops

        if isinstance(other, (int, float)):
            return ops.scxmat(1.0 / float(other), self)
        return NotImplemented

    def __neg__(self):
        from . import ops

        return ops.scxmat(-1.0, self)


class Trpl:
    """Triplet (COO) builder (reference: src/data.rs:877-1011)."""

    __slots__ = ("m", "n", "p", "i", "x")

    def __init__(self, m: int = 0, n: int = 0, p=None, i=None, x=None):
        self.m = int(m)
        self.n = int(n)
        self.p: list = list(p) if p is not None else []  # column indices
        self.i: list = list(i) if i is not None else []  # row indices
        self.x: list = list(x) if x is not None else []

    @classmethod
    def new(cls) -> "Trpl":
        return cls()

    def append(self, row: int, column: int, value: float) -> None:
        """Append an entry, growing m/n automatically (src/data.rs:906-917)."""
        if row + 1 > self.m:
            self.m = row + 1
        if column + 1 > self.n:
            self.n = column + 1
        self.p.append(column)
        self.i.append(row)
        self.x.append(value)

    def to_sprs(self) -> Sprs:
        s = Sprs()
        s.from_trpl(self)
        return s

    def sum_dupl(self) -> None:
        """Sum duplicate (i,j) entries in place; all but the LAST occurrence
        are zeroed and the last gets the sum (src/data.rs:954-972)."""
        from collections import defaultdict

        groups = defaultdict(list)
        for k in range(len(self.x)):
            groups[(self.i[k], self.p[k])].append(k)
        for _, idxs in groups.items():
            total = sum(self.x[k] for k in idxs)
            for k in idxs:
                self.x[k] = 0.0
            self.x[idxs[-1]] = total

    def get(self, row: int, column: int) -> Optional[float]:
        for k in range(len(self.x)):
            if self.i[k] == row and self.p[k] == column:
                return self.x[k]
        return None

    def get_all(self, row: int, column: int) -> Optional[Tuple[List[int], List[float]]]:
        pos, vals = [], []
        for k in range(len(self.x)):
            if self.i[k] == row and self.p[k] == column:
                pos.append(k)
                vals.append(self.x[k])
        if vals:
            return pos, vals
        return None


@dataclasses.dataclass
class Symb:
    """Symbolic analysis result (reference: src/data.rs:1022-1060).

    Extended with the device plans the factorization builds from it (level
    schedules, multifrontal plans); those are attached lazily by `lu`.
    """

    pinv: Optional[np.ndarray] = None  # inverse row perm (QR) / fill perm (Chol)
    q: Optional[np.ndarray] = None  # fill-reducing column permutation (LU/QR)
    parent: Optional[np.ndarray] = None  # elimination tree
    cp: Optional[np.ndarray] = None  # col pointers (Chol) / col counts (QR)
    m2: int = 0  # rows after adding fictitious rows (QR)
    lnz: int = 0  # entries in L (LU/Chol) or V (QR)
    unz: int = 0  # entries in U (LU) or R (QR)
    # --- device extensions (not in reference) ---
    plan: Optional[object] = None  # level-scheduled LU plan (lu_device.LUPlan)


@dataclasses.dataclass
class Nmrc:
    """Numeric factorization result (reference: src/data.rs:1064-1093)."""

    l: Optional[Sprs] = None  # L (LU/Chol) or V (QR)
    u: Optional[Sprs] = None  # U (LU) or R (QR)
    pinv: Optional[np.ndarray] = None  # partial-pivoting row perm (LU)
    b: Optional[np.ndarray] = None  # Householder betas (QR)
