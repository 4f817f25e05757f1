"""Build the port's containers from plain numpy fields.

The state that crosses from another implementation (for example the JAX
package the port is checked against) is a sparse matrix and its symbolic
analysis. Both are plain arrays and integers, so the crossing is a copy of
fields: nothing here imports the other package, and callers hand over the
numpy arrays they hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .data import Sprs, Symb

__all__ = ["sprs_from_fields", "symb_from_fields"]


def _opt(a) -> Optional[np.ndarray]:
    return None if a is None else np.array(a, dtype=np.int64)


def sprs_from_fields(m: int, n: int, p, i, x) -> Sprs:
    """A CSC matrix from its dimensions and (p, i, x) arrays (copied)."""
    p = np.array(p, dtype=np.int64)
    return Sprs(len(np.asarray(x)), m, n, p, np.array(i, dtype=np.int64),
                np.array(x, dtype=np.float64))


def symb_from_fields(q=None, pinv=None, parent=None, cp=None, lnz: int = 0,
                     unz: int = 0, m2: int = 0) -> Symb:
    """A symbolic analysis from its fields (arrays copied; None = absent)."""
    s = Symb()
    s.q = _opt(q)
    s.pinv = _opt(pinv)
    s.parent = _opt(parent)
    s.cp = _opt(cp)
    s.lnz = int(lnz)
    s.unz = int(unz)
    s.m2 = int(m2)
    return s
