"""Basic usage of rsparse_tpu_torch: the reference README's two examples.

Matrix operations (a CSC matrix built three ways, C = (A + A2) * A) and the
README's 8x8 linear solve, `lusol(a, b, 1, 1e-6)`, whose first unknown is
x[0] = 0.2646806068156303. Every call runs on the card unless
`--device cpu` is given; without a card and without it, the example
stops with a RuntimeError.

    python examples_torch/basic.py                # on the card
    python examples_torch/basic.py --device cpu   # on the CPU

`--save out.npz` also writes C (dense), the 8x8 system (a, b) and x for
a caller that checks them.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch.ops.cuda_build import require_card  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--save", help="write C and x to this .npz")
args = ap.parse_args()
dev = require_card(args.device)

# --- Build a CSC matrix directly (reference README "Basic matrix operations")
a = rt.Sprs(5, 3, 3,
            p=np.array([0, 2, 3, 5]),
            i=np.array([1, 2, 2, 0, 2]),
            x=np.array([1., 9., 9., 2., 9.]))

# ...or from a dense structure
a2 = rt.Sprs.new_from_vec([
    [0., 0., 2.],
    [1., 0., 0.],
    [9., 9., 9.],
])

# ...or incrementally from triplets
t = rt.Trpl()
t.append(0, 0, 2.)
t.append(1, 1, 3.)
t.append(2, 2, 4.)
eye_ish = t.to_sprs()

# The operators `a + a2` and `b * a` are exactly these two calls on the card
# (they take the ops' default device); naming the device runs them anywhere.
b = rt.add(a, a2, device=dev)
c = rt.multiply(b, a, device=dev)
print("C = (A + A2) * A, dense:")
for row in c.to_dense():
    print(row)

# --- Solve a linear system (reference README "Solve a linear system")
dense = [
    [8.2541e-01, 9.5622e-01, 4.6698e-01, 8.4410e-03, 6.3193e-01, 7.5741e-01, 5.3584e-01, 3.9448e-01],
    [7.4808e-01, 2.0403e-01, 9.4649e-01, 2.5086e-01, 2.6931e-01, 5.5866e-01, 3.1827e-01, 2.9819e-02],
    [6.3980e-01, 9.1615e-01, 8.5515e-01, 9.5323e-01, 7.8323e-01, 8.6003e-01, 7.5761e-01, 8.9255e-01],
    [1.8726e-01, 8.9339e-01, 9.9796e-01, 5.0506e-01, 6.1439e-01, 4.3617e-01, 7.3369e-01, 1.5565e-01],
    [2.8015e-02, 6.3404e-01, 8.4771e-01, 8.6419e-01, 2.7555e-01, 3.5909e-01, 7.6644e-01, 8.9905e-02],
    [9.1817e-01, 8.6629e-01, 5.9917e-01, 1.9346e-01, 2.1960e-01, 1.8676e-01, 8.7020e-01, 2.7891e-01],
    [3.1999e-01, 5.9988e-01, 8.7402e-01, 5.5710e-01, 2.4707e-01, 7.5652e-01, 8.3682e-01, 6.3145e-01],
    [9.3807e-01, 7.5985e-02, 7.8758e-01, 3.6881e-01, 4.4553e-01, 5.5005e-02, 3.3908e-01, 3.4573e-01],
]
a_sparse = rt.Sprs.new_from_vec(dense)
b_vec = [0.4377, 0.7328, 0.1227, 0.1817, 0.2634, 0.6876, 0.8711, 0.4201]
rhs = np.array(b_vec)  # kept for --save: lusol overwrites b_vec

# A*x=b -> solve for x -> x also written back into b (reference semantics)
x = rt.lusol(a_sparse, b_vec, 1, 1e-6, device=dev)
print("\nX")
print([float(v) for v in x])  # shortest round-trip digits of each value
print("b overwritten:", b_vec == [float(v) for v in x])

if args.save:
    np.savez(args.save, c=np.asarray(c.to_dense_np()), x=np.asarray(x),
             a=np.asarray(dense), b=rhs)
