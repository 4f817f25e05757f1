"""The port's examples (`examples_torch/`) against the JAX package.

Each example runs in a subprocess on the CPU (`--device cpu`), with its own
time limit, and writes its inputs and answers with `--save`; the JAX
package answers the same inputs here, with `config.backend = "host"` (the
exact C++ engine, no XLA compile) where the call allows. Sizes: basic at
its own size, serving on the 24 x 24 Laplacian, distributed as two gloo
ranks joined through a file store (no port is opened). Each process
fails unless it ran without importing jax or the JAX package. Without a
card, an example run without `--device cpu` must stop.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import rsparse_tpu as rs
import torch_cases as C
from rsparse_tpu.config import config as jconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
TIMEOUT_S = 120
SERVE_GRID = 24


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


# Runs an example as its own `__main__`, then fails unless it ran without
# importing jax or the JAX package.
_RUN = ("import runpy, sys; path = sys.argv[1]; sys.argv = sys.argv[1:]; "
        "runpy.run_path(path, run_name='__main__'); "
        "bad = [m for m in ('jax', 'rsparse_tpu') if m in sys.modules]; "
        "sys.exit(f'imported {bad}' if bad else 0)")


def _start(name, *args):
    return subprocess.Popen(
        [sys.executable, "-c", _RUN, os.path.join(EXAMPLES, name), *args],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"example outlived {TIMEOUT_S} s\n{err[-4000:]}")
    return proc.returncode, out, err


def _run(name, *args):
    rc, out, err = _finish(_start(name, *args))
    assert rc == 0, f"{name} exited {rc}\n{err[-4000:]}"
    return out


@pytest.fixture
def host_backend():
    """The JAX package's exact C++ engine for the duration of a test."""
    old = jconfig.backend
    jconfig.backend = "host"
    yield
    jconfig.backend = old


def test_basic_example(tmp_path, host_backend):
    out = _run("basic.py", "--device", "cpu", "--save",
               str(tmp_path / "basic.npz"))
    got = np.load(tmp_path / "basic.npz")
    a = rs.Sprs(5, 3, 3, p=np.array([0, 2, 3, 5]), i=np.array([1, 2, 2, 0, 2]),
                x=np.array([1., 9., 9., 2., 9.]))
    a2 = rs.Sprs.new_from_vec([[0., 0., 2.], [1., 0., 0.], [9., 9., 9.]])
    c = (a + a2) * a
    np.testing.assert_array_equal(got["c"], np.asarray(c.to_dense_np()))
    dense_rows = [[float(v) for v in re.findall(r"-?\d+\.\d+", line)]
                  for line in out.splitlines()[1:4]]
    np.testing.assert_array_equal(dense_rows, np.asarray(c.to_dense_np()))
    # the README 8 x 8, the JAX example's own matrix and right-hand side
    src = open(os.path.join(ROOT, "examples", "basic.py")).read()
    dense = eval(re.search(r"dense = (\[.*?\n\])", src, re.S).group(1))
    b = eval(re.search(r"b_vec = (\[.*?\])", src).group(1))
    want = C.jax_answer("lusol", np.array(dense), list(b), 1, 1e-6)
    assert np.abs(got["x"] - want).max() <= 1e-12
    printed = eval(out.split("\nX\n")[1].splitlines()[0])
    assert printed == [float(v) for v in got["x"]]
    assert abs(printed[0] - 0.2646806068156303) <= 1e-12
    assert "b overwritten: True" in out


def test_serving_example(tmp_path, host_backend):
    out = _run("serving.py", "--device", "cpu", "--grid", str(SERVE_GRID),
               "--save", str(tmp_path / "serving.npz"))
    got = np.load(tmp_path / "serving.npz")
    lap = f"lap{SERVE_GRID}"
    n, _, p, i, _ = C.fields(lap)
    Bm = got["Bm"]
    for key, col in (("x1", 0), ("x2", 1)):
        want = C.jax_answer("cholsol", lap, list(Bm[:, col]), 1)
        assert C.rel(got[key], want) <= 1e-9, key
    want = C.jax_answer("cholsol_multi", lap, Bm, 1)
    assert C.rel(got["Xm"], want) <= 1e-9
    for k, (ax, bk) in enumerate(zip(got["AxK"], got["BK"])):
        want = C.jax_answer("cholsol", (n, n, p, i, ax), list(bk), 1)
        assert C.rel(got["XK"][k], want) <= 1e-9, k
    resids = [float(v) for line in out.splitlines() if "residual" in line
              for v in re.findall(r"\d\.\d+e[+-]\d+", line)]
    assert len(resids) == 7 and max(resids) <= 1e-9, out
    assert "factor checkpoint round-trip ok: True" in out


def test_distributed_example_two_gloo_ranks(tmp_path, host_backend):
    store = str(tmp_path / "store")
    save = str(tmp_path / "dist.npz")
    procs = [_start("distributed.py", "--device", "cpu", "--world-size", "2",
                    "--rank", str(r), "--store", store, "--save", save)
             for r in range(2)]
    done = [_finish(p) for p in procs]
    for r, (rc, _, err) in enumerate(done):
        assert rc == 0, f"rank {r} exited {rc}\n{err[-4000:]}"
    assert "model=2" in done[0][1]
    got = np.load(save)
    a = C.jax("lap24")
    b = got["b"]
    r = np.asarray(rs.gaxpy(a, list(b), [0.0] * a.n))
    assert C.rel(got["r"], r) <= 1e-12
    want = C.jax_answer("cholsol", "lap24", list(b), 0)
    assert C.rel(got["x1"], want) <= 1e-9
    assert C.rel(got["x2"], want) <= 1e-9
    assert C.rel(got["want"], want) <= 1e-9
    assert int(got["nnz_c"]) == rs.multiply(a, a).nnz()
    assert float(got["refine_residual"]) <= 1e-8


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_example_without_device_needs_a_card():
    rc, _, err = _finish(_start("basic.py"))
    assert rc != 0 and "CUDA" in err, err[-2000:]
