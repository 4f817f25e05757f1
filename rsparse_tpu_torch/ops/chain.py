"""Device-resident op chaining: every value pass of an L2-op pipeline back
to back on one device.

The eager L2 ops (`ops.add`/`multiply`/`transpose`/...) each upload their
operands' values and bring the result back to a host `Sprs`. `chain` builds
the expression DAG lazily, computes every intermediate PATTERN on the host
at build time (the same cached plans the eager ops use), uploads each
plan's index tensors once, and returns a callable that runs the value
passes one after another on the device: intermediates never leave it.

    e = chain(A).transpose().multiply(A).add(I, beta=mu)   # (AᵀA + muI)
    C = e.run()                 # Sprs out
    f = e.values_fn()           # f(*leaf value tensors) -> Cx, for serving
                                # loops that refresh the values

A multiply in a chain runs `spgemm_general_fn` (deterministic sums) with
multiply_kernel="mxu", or the `index_add_` pass of `ops.device` with "esc";
"auto" takes "mxu" on a CUDA device and "esc" elsewhere, as the JAX package
picks by backend. Reference semantics per op are unchanged: multiply
src/lib.rs:713-748, add src/lib.rs:247-271, transpose src/lib.rs:1178-1197,
scpmat src/lib.rs:1019-1029 (stored entries), scxmat src/lib.rs:1062-1072.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import Sprs
from . import device as dev
from . import plan as _plan
from . import spgemm_general as _sg

__all__ = ["chain", "ChainExpr"]


def _pattern_sprs(m: int, n: int, p: np.ndarray, i: np.ndarray) -> Sprs:
    """Pattern-only Sprs (zero values) for feeding the plan cache."""
    nnz = len(i)
    return Sprs(nnz, m, n, np.asarray(p), np.asarray(i), np.zeros(nnz))


@dataclasses.dataclass(frozen=True)
class ChainExpr:
    """Lazy L2-op expression; immutable — every method returns a new node.

    `pattern` is the host-computed (m, n, p, i) of this node's result;
    building a node costs only symbolic work (cached per input pattern).
    """

    kind: str  # leaf | multiply | add | transpose | scale | add_scalar
    pattern: Tuple[int, int, np.ndarray, np.ndarray]
    operands: tuple = ()
    params: tuple = ()
    leaf: Optional[Sprs] = None

    # -- builders ---------------------------------------------------------
    def _lift(self, other) -> "ChainExpr":
        return other if isinstance(other, ChainExpr) else chain(other)

    def multiply(self, other) -> "ChainExpr":
        o = self._lift(other)
        pl = _plan.spgemm_plan(self._psprs(), o._psprs())
        return ChainExpr("multiply", (pl.m, pl.n, pl.out_p, pl.out_i),
                         (self, o))

    def add(self, other, alpha: float = 1.0,
            beta: float = 1.0) -> "ChainExpr":
        o = self._lift(other)
        pl = _plan.add_plan(self._psprs(), o._psprs())
        return ChainExpr("add", (pl.m, pl.n, pl.out_p, pl.out_i),
                         (self, o), (float(alpha), float(beta)))

    def transpose(self) -> "ChainExpr":
        pl = _plan.transpose_plan(self._psprs())
        return ChainExpr("transpose", (pl.m, pl.n, pl.out_p, pl.out_i),
                         (self,))

    def scale(self, alpha: float) -> "ChainExpr":
        return ChainExpr("scale", self.pattern, (self,), (float(alpha),))

    def add_scalar(self, alpha: float) -> "ChainExpr":
        return ChainExpr("add_scalar", self.pattern, (self,),
                         (float(alpha),))

    # -- evaluation -------------------------------------------------------
    def _psprs(self) -> Sprs:
        if self.leaf is not None:
            return self.leaf
        return _pattern_sprs(*self.pattern)

    def _topo(self):
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for op in node.operands:
                visit(op)
            order.append(node)

        visit(self)
        return order

    def leaves(self):
        """Distinct leaf matrices in first-use order — the argument order
        of `values_fn()` (the same Sprs appearing twice gets ONE slot)."""
        out, seen = [], set()
        for nd in self._topo():
            if nd.kind == "leaf" and id(nd.leaf) not in seen:
                seen.add(id(nd.leaf))
                out.append(nd)
        return out

    def values_fn(self, dtype: str = "float64", multiply_kernel: str = "auto",
                  device="cuda"):
        """`f(*leaf value tensors) -> result values`, every value pass on
        `device`, in `dtype`.

        multiply_kernel: "mxu" runs each multiply through
        `spgemm_general_fn` (deterministic sums), "esc" through
        `ops.device.spgemm_values` (`index_add_`), "auto" picks "mxu" on a
        CUDA device and "esc" elsewhere. The index tensors are uploaded
        here, once; `f.run(*leaf values, *f.consts)` is the same call with
        them passed in."""
        device = torch.device(device)
        if multiply_kernel == "auto":
            multiply_kernel = "mxu" if device.type == "cuda" else "esc"
        if multiply_kernel not in ("mxu", "esc"):
            raise ValueError(f"multiply_kernel must be 'auto', 'mxu' or 'esc', "
                             f"got {multiply_kernel!r}")
        dt = getattr(torch, dtype)
        ix = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.int64,
                                       device=device)
        leaf_slot = {id(nd.leaf): k for k, nd in enumerate(self.leaves())}

        consts = []
        steps = []  # (kind, operand slots, first const slot, params, aux)
        slot_of = {}
        for nd in self._topo():
            if nd.kind == "leaf":
                slot_of[id(nd)] = ("leaf", leaf_slot[id(nd.leaf)])
                continue
            ops_slots = tuple(slot_of[id(o)] for o in nd.operands)
            c0, params, aux = len(consts), nd.params, None
            if nd.kind == "multiply":
                a_s, b_s = (o._psprs() for o in nd.operands)
                if multiply_kernel == "mxu":
                    f = _sg.spgemm_general_fn(_sg.mxu_spgemm_plan(a_s, b_s),
                                              dtype, device=device)
                    consts.extend(f.consts)
                    kind, aux = "multiply_mxu", f.run
                else:
                    pl = _plan.spgemm_plan(a_s, b_s)
                    consts.extend([ix(pl.a_idx), ix(pl.b_idx), ix(pl.seg)])
                    kind, aux = "multiply_esc", pl.nnz
            elif nd.kind == "add":
                pl = _plan.add_plan(*(o._psprs() for o in nd.operands))
                consts.append(ix(pl.seg))
                kind, aux = "add", pl.nnz
            elif nd.kind == "transpose":
                consts.append(ix(_plan.transpose_plan(
                    nd.operands[0]._psprs()).perm))
                kind = "transpose"
            else:  # scale / add_scalar
                kind = nd.kind
            steps.append((kind, ops_slots, c0, params, aux))
            slot_of[id(nd)] = ("step", len(steps) - 1)

        nleaf = len(leaf_slot)
        result = slot_of[id(self)]

        def run(*args):
            vals = [a.to(dt) for a in args[:nleaf]]
            cn = args[nleaf:]
            out = []

            def get(slot):
                return vals[slot[1]] if slot[0] == "leaf" else out[slot[1]]

            for kind, ops_slots, c0, params, aux in steps:
                x = [get(s) for s in ops_slots]
                if kind == "multiply_mxu":
                    out.append(aux(x[0], x[1], *cn[c0: c0 + 3]))
                elif kind == "multiply_esc":
                    out.append(dev.spgemm_values(x[0], x[1], *cn[c0: c0 + 3],
                                                 aux))
                elif kind == "add":
                    out.append(dev.add_values(x[0], x[1], *params, cn[c0], aux))
                elif kind == "transpose":
                    out.append(dev.gather_values(x[0], cn[c0]))
                elif kind == "scale":
                    out.append(dev.scxmat_values(params[0], x[0]))
                else:  # add_scalar (reference scpmat: stored entries only)
                    out.append(dev.scpmat_values(params[0], x[0]))
            return get(result)

        consts = tuple(consts)

        def f(*leaf_vals):
            return run(*leaf_vals, *consts)

        f.run = run
        f.consts = consts
        return f

    def run(self, dtype: str = "float64", multiply_kernel: str = "auto",
            device="cuda") -> Sprs:
        """Evaluate the chain on `device`: Sprs result (float64 values)."""
        f = self.values_fn(dtype, multiply_kernel, device)
        feeds = [torch.as_tensor(nd.leaf.x[: nd.leaf.nnz()], device=device)
                 for nd in self.leaves()]
        cx = f(*feeds)
        m, n, p, i = self.pattern
        return Sprs(len(i), m, n, p, i, cx.cpu().numpy().astype(np.float64))


def chain(a: Sprs) -> ChainExpr:
    """Start a device-resident op chain at `a` (values read at run)."""
    nz = a.nnz()
    return ChainExpr("leaf", (a.m, a.n, np.asarray(a.p),
                              np.asarray(a.i[:nz])), leaf=a)
