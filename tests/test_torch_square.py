"""Every LU entry point of the port refuses a non-square matrix.

The C++ engine's LU reads past its buffers on a non-square A (the JAX
package aborts the process on a 3x2 A and raises NoPivotError on a 2x3
one). The port raises ValueError("<name> needs a square matrix, got mxn")
before the engine is called, as `lusol_vals` does, so these calls run in
the test process. The JAX package is not called on these inputs.
"""

import numpy as np
import pytest

import rsparse_tpu_torch as rt
from rsparse_tpu_torch.config import config
from rsparse_tpu_torch.parallel import halo

SHAPES = {"3x2": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]],
          "2x3": [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]}


def _lu(backend):
    def call(a):
        old = config.backend
        config.backend = backend
        try:
            rt.lu(a, rt.sqr(a, 1, False), 1e-6, device="cpu")
        finally:
            config.backend = old
    return call


class _NoMesh:
    """A stand-in mesh: the check must come before any mesh read."""

    def __getattr__(self, name):
        raise AssertionError(f"dist_lusol read mesh.{name} before the check")


CALLS = {
    "lu_host": ("lu", _lu("host")),
    "lu_device": ("lu", _lu("device")),
    "lusol_order0": ("lusol", lambda a: rt.lusol(a, [1.0] * a.m, 0, 1e-6,
                                                  device="cpu")),
    "lusol_order1": ("lusol", lambda a: rt.lusol(a, [1.0] * a.m, 1, 1e-6,
                                                  device="cpu")),
    "lusol_multi": ("lusol_multi", lambda a: rt.lusol_multi(
        a, np.ones((a.m, 2)), 1, 1e-6, device="cpu")),
    "lusol_serve": ("lusol_serve", lambda a: rt.lusol_serve(
        a, 1, 1e-6, device="cpu")),
    "dist_lusol": ("dist_lusol", lambda a: halo.dist_lusol(
        a, np.ones(a.m), _NoMesh(), 1)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("call", sorted(CALLS))
def test_lu_entry_points_refuse_non_square(call, shape):
    a = rt.Sprs.new_from_vec(SHAPES[shape])
    name, fn = CALLS[call]
    with pytest.raises(ValueError, match=rf"^{name} needs a square matrix, "
                       rf"got {a.m}x{a.n}$"):
        fn(a)
