"""Level-scheduled Cholesky support.

Only the trailing-dense cut rule lives here for now: the level LU
(`lu_device.build_lu_plan`) shares it, and the Cholesky slice will add the
rest of this module.
"""

from __future__ import annotations

import numpy as np


def _choose_cut(level: np.ndarray, n: int, target_levels: int = 48,
                dense_tail_max: int = 2048) -> int:
    """Largest cut with max(level[:cut]) < target_levels, tail capped.

    Columns past the cut factor as one dense trailing block: a deep level
    structure costs one dependent step per level, while a dense block of up
    to `dense_tail_max` columns is a handful of large dense operations."""
    nlev = int(level.max()) + 1 if n else 0
    if nlev <= 2 * target_levels:
        return n
    if n <= dense_tail_max:
        # deep level structure, small system: all-dense tail
        return 0
    pmax = np.maximum.accumulate(level)
    ok = np.nonzero(pmax < target_levels)[0]
    cut = int(ok[-1]) + 1 if len(ok) else 0
    cut = max(cut, n - dense_tail_max)
    return cut if n - cut >= 32 else n  # tiny tails aren't worth a launch
