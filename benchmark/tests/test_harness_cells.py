"""Each cell end to end at grid 24 on the port's CPU path, the control
that must come out not correct, and the program broken underneath the
timed path, which must come out not correct too."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import manifest as manifest_mod
from benchmark import program
from benchmark.control import Control
from benchmark.run import run_cell

# The refactor cells are kept out of BENCHMARK.json (host noise, see
# PERF.md) but their driver, traffic, limits and metric files stay, so that
# a later change can add them back with manifest entries alone. The tests
# run them from a manifest with those entries added, as that change would.
HELD = [
    {"name": "cd2d-128.refactor", "config": "cd2d-128",
     "traffic": "refactor-euler", "chips": 1, "why": "held"},
    {"name": "lap2d-256.refactor", "config": "lap2d-256",
     "traffic": "refactor-euler", "chips": 1, "why": "held"},
]
HELD_METRICS = [
    {"name": "step_s", "unit": "s", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": [w["name"] for w in HELD]},
] + [
    {"name": name, "unit": unit, "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "step_s",
     "workloads": [w["name"] for w in HELD]}
    for name, unit in (("device.idle_share.refactor", "%"),
                       ("device.ops_per_step", "ops"),
                       ("device.busy_ms_per_step", "ms"))]


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(manifest_mod.ROOT, "benchmark"),
                    root / "benchmark")
    spec = json.loads(json.dumps(manifest_mod.Manifest().spec))
    spec["workloads"] += HELD
    spec["end_to_end"] += HELD_METRICS[:1]
    spec["per_layer"] += HELD_METRICS[1:]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return manifest_mod.Manifest(str(root))


CELLS = [w["name"] for w in manifest_mod.Manifest().spec["workloads"]] + \
    [w["name"] for w in HELD]
SMALL = {"grid": 24}
SEED = 2**31 + 12345


def run(man, cell, solver=None, seconds=0.3, seed=SEED):
    return run_cell(cell, seed, seconds, False, "cpu", man, solver, SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(man, cell):
    res = run(man, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in man.end_to_end(cell)}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(man, cell):
    """The reference in float32 in the program's place fails a limit."""
    res = run(man, cell, Control(man))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


class Broken:
    """The program with one fault planted where an answer is produced."""

    def __init__(self, fault):
        self.fault = fault

    def _break(self, answer, last):
        if self.fault == "unchanged" and last:
            return last[0]  # the previous request's or step's answer again
        if self.fault == "altered":
            out = answer.clone() if torch.is_tensor(answer) else np.array(answer)
            k = int(abs(out).argmax())
            out.reshape(-1)[k] *= 1 + 1e-6
            return out
        if self.fault == "half":  # half the columns solved, the mean for the rest
            out = answer.clone()
            half = out.shape[1] // 2
            out[:, half:] = out[:, :half].mean(1, keepdim=True)
            return out
        return answer

    def server(self, cfg, arrays, device):
        h, info = program.server(cfg, arrays, device)
        last = []

        def handle(B):
            X = h(B)
            out = self._break(X, last)
            last[:] = [X]
            return out

        return handle, info

    def refactor(self, cfg, arrays, device):
        solve, info = program.refactor(cfg, arrays, device)
        last = []

        def step(values, b):
            x = solve(values, b)
            out = self._break(x, last)
            last[:] = [x]
            return out

        return step, info


FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "altered")] + \
    [(c, "half") for c in CELLS if c.endswith("serve-b128")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_program_is_not_correct(man, cell, fault):
    res = run(man, cell, Broken(fault), seconds=1.5)
    assert res["attempted"] >= 2
    assert not res["correct"], (fault, res["checks"])
