"""The command itself: without a card it refuses, and on a card each cell
runs briefly with `correct` true (marked `gpu`; skips where there is no
card)."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest as manifest_mod
from benchmark.run import main

ROOT = manifest_mod.ROOT
CELLS = [w["name"] for w in manifest_mod.Manifest().spec["workloads"]]


def test_command_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         "4000000001", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    assert res["device"]["busy_s"] > 0
