"""The numbers that decide `correct`, and their limits.

For each answer X of A X = B that is compared:
- `fwd_err`: max|X - X_ref| / max|X_ref|, X_ref the plain reference's
  float64 answer on the same A and B;
- `bwd_err`: max|B - A X| / (||A||_inf max|X| + max|B|), the normwise
  backward error, in float64 from A's own entries.
A run's number is the largest over its answers compared. A run is
correct when every number is at or below its limit and no item failed.
"""

import math
from typing import Dict

import torch


def answer_numbers(ref, X: torch.Tensor, B: torch.Tensor,
                   X_ref: torch.Tensor, norm_a: float) -> Dict[str, float]:
    X = X.to(torch.float64)
    X_ref = X_ref.to(torch.float64).reshape(X.shape)
    fwd = float((X - X_ref).abs().max()) / max(float(X_ref.abs().max()), 1e-300)
    r = ref.residual(X, B)
    scale = norm_a * float(X.abs().max()) + float(B.abs().max())
    bwd = float(r.abs().max()) / max(scale, 1e-300)
    if not (math.isfinite(fwd) and math.isfinite(bwd)):
        fwd = bwd = math.inf
    return {"fwd_err": fwd, "bwd_err": bwd}


def worst(readings) -> Dict[str, float]:
    """The largest of each number over a list of answers' readings."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) for the numbers against limits;
    a missing number is not correct."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        ok &= value <= limit
        rows.append((name, value, limit))
    return ok, rows
