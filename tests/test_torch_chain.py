"""Port parity, `ops.chain`: every case of the JAX package's
`tests/test_chain.py`, each with the port's multiply kernels "mxu"
(`spgemm_general_fn`) and "esc" (`ops.device.spgemm_values`), against the
JAX package's chain on the same inputs, on the CPU. Patterns exactly equal,
values to 1e-12 relative in float64 and 1e-5 * max(1, max|ref|) in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import rsparse_tpu as rs  # noqa: E402
from rsparse_tpu.ops import chain as jchain  # noqa: E402

import rsparse_tpu_torch as rt  # noqa: E402
import torch_cases as C  # noqa: E402
from rsparse_tpu_torch.ops import ChainExpr, chain  # noqa: E402

KERNELS = ["mxu", "esc"]
TOL = {"float64": 1e-12, "float32": 1e-5}



@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gram_chain(kernel, dtype):
    """(AᵀA)*2 + I·0.5 — the qrsol/CSNE Gram pipeline."""
    rng = np.random.default_rng(0)
    aj, at = C.pair(C.rand_density(rng, 30, 22, 0.25))
    ej = jchain(aj).transpose().multiply(aj).scale(2.0).add(rs.Sprs.eye(22), beta=0.5)
    et = chain(at).transpose().multiply(at).scale(2.0).add(rt.Sprs.eye(22), beta=0.5)
    assert isinstance(et, ChainExpr)
    C.same_sprs(et.run(dtype, kernel, device="cpu"), ej.run(dtype),
          TOL[dtype])
    C.same_sprs(et.run(dtype, kernel, device="cpu"),
          rt.add(rt.scxmat(2.0, rt.multiply(rt.transpose(at, device="cpu"), at,
                                            device="cpu"), device="cpu"),
                 rt.Sprs.eye(22), 1.0, 0.5, device="cpu"), TOL[dtype])


@pytest.mark.parametrize("kernel", KERNELS)
def test_chain_reuse_fresh_values(kernel):
    """values_fn is a serving handle: same pattern, fresh values, no
    rebuild; distinct leaf matrices get one arg slot each."""
    rng = np.random.default_rng(1)
    aj, at = C.pair(C.rand_density(rng, 20, 20, 0.3))
    bj, bt = C.pair(C.rand_density(rng, 20, 20, 0.3))
    ej = jchain(aj).multiply(bj).add(aj, alpha=1.0, beta=-3.0)
    et = chain(at).multiply(bt).add(at, alpha=1.0, beta=-3.0)
    fj, ft = ej.values_fn(), et.values_fn("float64", kernel, device="cpu")
    assert len(et.leaves()) == len(ej.leaves()) == 2
    for seed in (2, 3):
        r2 = np.random.default_rng(seed)
        ax, bx = r2.standard_normal(at.nnz()), r2.standard_normal(bt.nnz())
        want = fj(jnp.asarray(ax), jnp.asarray(bx))
        got = ft(torch.as_tensor(ax), torch.as_tensor(bx))
        C.close(got, want)
        C.close(ft.run(torch.as_tensor(ax), torch.as_tensor(bx), *ft.consts),
                want)


@pytest.mark.parametrize("kernel", KERNELS)
def test_chain_leaf_dedup(kernel):
    """chain(A)ᵀ·A uses ONE slot for A."""
    rng = np.random.default_rng(4)
    aj, at = C.pair(C.rand_density(rng, 15, 15, 0.3))
    ej = jchain(aj).transpose().multiply(aj)
    et = chain(at).transpose().multiply(at)
    assert len(et.leaves()) == len(ej.leaves()) == 1
    C.same_sprs(et.run(multiply_kernel=kernel, device="cpu"), ej.run())


@pytest.mark.parametrize("kernel", KERNELS)
def test_chain_scalar_ops_and_transpose(kernel):
    """add_scalar adds to stored entries only (scpmat)."""
    rng = np.random.default_rng(5)
    aj, at = C.pair(C.rand_density(rng, 12, 18, 0.4))
    ej = jchain(aj).add_scalar(1.25).transpose().scale(-2.0)
    et = chain(at).add_scalar(1.25).transpose().scale(-2.0)
    C.same_sprs(et.run(multiply_kernel=kernel, device="cpu"), ej.run())
    C.same_sprs(et.run(multiply_kernel=kernel, device="cpu"),
          rt.scxmat(-2.0, rt.transpose(rt.scpmat(1.25, at, device="cpu"),
                                       device="cpu"), device="cpu"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_chain_multiply_kernel(kernel):
    """Each multiply kernel inside a chain is exact in float64 (the JAX
    chain's "mxu" kernel on the same product)."""
    rng = np.random.default_rng(6)
    aj, at = C.pair(C.rand_density(rng, 40, 30, 0.2))
    bj, bt = C.pair(C.rand_density(rng, 30, 25, 0.2))
    C.same_sprs(chain(at).multiply(bt).run(multiply_kernel=kernel,
                                           device="cpu"),
          jchain(aj).multiply(bj).run(multiply_kernel="mxu"))


def test_chain_auto_kernel_and_leaf_only(monkeypatch):
    """"auto" takes "esc" off a CUDA device (spgemm_general_fn is not
    reached); a bare leaf evaluates to its own values; an unknown kernel
    name raises."""
    import rsparse_tpu_torch.ops.spgemm_general as sg

    rng = np.random.default_rng(7)
    _, at = C.pair(C.rand_density(rng, 10, 10, 0.3))
    e = chain(at).multiply(at)
    calls = []
    real = sg.spgemm_general_fn
    monkeypatch.setattr(sg, "spgemm_general_fn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = e.run(multiply_kernel="esc", device="cpu")
    C.same_sprs(e.run(device="cpu"), want)
    assert calls == []
    C.same_sprs(e.run(multiply_kernel="mxu", device="cpu"), want)
    assert calls == [1]
    C.close(chain(at).run(device="cpu").x, at.x[: at.nnz()])
    with pytest.raises(ValueError, match="multiply_kernel"):
        e.values_fn(multiply_kernel="onehot", device="cpu")
