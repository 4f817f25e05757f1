"""The HPCG cell on the CPU at a small grid: the program reads `correct`,
the control and the planted faults of `test_harness_cells` read not
correct, the `planes` reference refuses a matrix that couples planes two
apart, and the two readers of the wide fronts read the program's span and
counters (None on a program without them)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import manifest as manifest_mod
from benchmark import seeds
from benchmark.control import Control
from benchmark.run import run_cell
from test_harness_cells import Broken

MAN = manifest_mod.Manifest()
CELL = "hpcg27-24.serve-b128"
SMALL = {"grid": 6}
SEED = 2**31 + 4242


def run(solver=None, seconds=0.3):
    return run_cell(CELL, SEED, seconds, False, "cpu", MAN, solver, SMALL)


def test_cell_is_correct_at_a_small_grid():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in MAN.end_to_end(CELL)}


def test_control_is_not_correct():
    res = run(Control(MAN))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
def test_broken_program_is_not_correct(fault):
    res = run(Broken(fault), seconds=1.0)
    assert res["attempted"] >= 2
    assert not res["correct"], (fault, res["checks"])


def test_planes_refuses_a_coupling_two_planes_apart():
    cfg = MAN.config("hpcg27-24")
    cfg["params"] = {"grid": 4}
    n, p, i, x = MAN.generator("hpcg27").make(cfg["params"],
                                              seeds.rng(1, seeds.MATRIX))
    planes = MAN.reference("planes")
    ref = planes.build(cfg, n, p, i, x)
    assert (ref.g, ref.nb) == (16, 4)
    A = np.zeros((n, n))
    for j in range(n):
        A[i[p[j]:p[j + 1]], j] = x[p[j]:p[j + 1]]
    B = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 2)))
    X = torch.as_tensor(np.linalg.solve(A, B.numpy()))
    assert torch.allclose(ref.solve(B), X, rtol=0, atol=1e-12)
    A[0, 2 * 16] = A[2 * 16, 0] = -1.0  # plane 0 to plane 2
    cols = [np.nonzero(A[:, j])[0] for j in range(n)]
    p2 = np.r_[0, np.cumsum([len(c) for c in cols])]
    i2 = np.concatenate(cols)
    x2 = np.concatenate([A[c, j] for j, c in enumerate(cols)])
    with pytest.raises(ValueError, match="block tridiagonal"):
        planes.build(cfg, n, p2, i2, x2)


def test_wide_front_readers(monkeypatch):
    from rsparse_tpu_torch import utils
    from rsparse_tpu_torch.factor import frontal

    share = MAN.metric("factor.wide_front_share").read
    seconds = MAN.metric("factor.fronts_s").read
    r = SimpleNamespace()
    utils.reset_metrics()
    monkeypatch.setattr(frontal._chol_mf_values, "cols", 0)
    monkeypatch.setattr(frontal._chol_mf_values, "wide_front_cols", 0)
    assert share(r) is None and seconds(r) is None  # nothing factored yet
    frontal._chol_mf_values.cols += 400
    frontal._chol_mf_values.wide_front_cols += 100
    with utils.phase_timer("factor.fronts"):
        pass
    assert share(r) == 25.0 and seconds(r) >= 0.0
    monkeypatch.delattr(frontal._chol_mf_values, "wide_front_cols")
    assert share(r) is None  # a program without the counter
    utils.reset_metrics()


def test_manifest_lists_the_cell():
    names = {m["name"] for m in MAN.per_layer(CELL)}
    assert {"factor.fronts_s", "factor.wide_front_share", "factor.plan_s",
            "solve.handle_build_s"} <= names
    assert "sptrsv.supernodal_per_request" not in names
    for m in MAN.spec["per_layer"]:
        if m["name"] in ("factor.fronts_s", "factor.wide_front_share"):
            assert m["workloads"] == [CELL]
