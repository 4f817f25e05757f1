"""CPU tests of the benchmark's parts: generators, work counts, trace
arithmetic, the manifest, the module check and the reference."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import manifest as manifest_mod
from benchmark import peaks, seeds, trace
from benchmark.reference import blocktri
from benchmark.run import forbidden_modules, run_cell

MAN = manifest_mod.Manifest()


def _dense(n, p, i, x):
    A = np.zeros((n, n))
    for j in range(n):
        A[i[p[j]:p[j + 1]], j] = x[p[j]:p[j + 1]]
    return A


PARAMS = {"poisson5": {"grid": 6}, "convdiff5": {"grid": 6, "peclet": [0.5, 0.25]}}


@pytest.mark.parametrize("name", ["poisson5", "convdiff5"])
def test_generator_pattern_and_seed(name):
    gen = MAN.generator(name)
    params = PARAMS[name]
    n, p, i, x = gen.make(params, seeds.rng(5, seeds.MATRIX))
    assert n == 36 and len(p) == n + 1 and p[-1] == len(i) == len(x)
    assert p[-1] == 5 * n - 4 * 6  # 5-point stencil on a 6 x 6 grid
    for j in range(n):  # rows ascending in each column, diagonal present
        rows = i[p[j]:p[j + 1]]
        assert np.all(np.diff(rows) > 0) and j in rows
    A = _dense(n, p, i, x)
    assert np.array_equal(A != 0, A.T != 0)  # symmetric pattern
    # the values take nothing from the seed
    again = gen.make(params, seeds.rng(6, seeds.MATRIX))
    assert all(np.array_equal(a, b) for a, b in zip((n, p, i, x), again))
    if name == "poisson5":
        assert np.array_equal(A, A.T)
        assert np.linalg.eigvalsh(A).min() > 0  # SPD
    else:  # a nonsymmetric M-matrix, weakly diagonally dominant by rows
        off = A - np.diag(np.diag(A))
        assert not np.array_equal(A, A.T) and np.all(off <= 0)
        assert np.all(np.diag(A) >= np.abs(off).sum(1))
        assert np.all(np.linalg.eigvals(A).real > 0)


def test_convdiff5_is_the_central_difference_operator():
    """Central differences are exact on quadratics: at a point whose
    neighbours are all interior, (A u)_k = h^2 (-Δu + b·∇u) with
    b = 2 p / h, for u = x^2 + 3 y^2 + x y."""
    g, (px, py) = 7, (0.5, 0.25)
    n, p, i, x = MAN.generator("convdiff5").make({"grid": g, "peclet": [px, py]}, None)
    h = 1.0 / (g + 1)
    k = np.arange(n)
    X, Y = (k // g + 1) * h, (k % g + 1) * h
    u = X**2 + 3 * Y**2 + X * Y
    bx, by = 2 * px / h, 2 * py / h
    want = h * h * (-8.0 + bx * (2 * X + Y) + by * (6 * Y + X))
    inner = (k // g > 0) & (k // g < g - 1) & (k % g > 0) & (k % g < g - 1)
    got = _dense(n, p, i, x) @ u
    assert np.allclose(got[inner], want[inner], rtol=0, atol=1e-12)


def test_seed_streams_are_independent_of_order():
    a = seeds.rng(2**31 + 99, seeds.RHS, seeds.WINDOW, 3).standard_normal(4)
    seeds.rng(2**31 + 99, seeds.RHS, seeds.WINDOW, 2).standard_normal(4)
    b = seeds.rng(2**31 + 99, seeds.RHS, seeds.WINDOW, 3).standard_normal(4)
    assert np.array_equal(a, b)
    assert 0 <= seeds.torch_seed(-1, 1) < 2**63


def test_sweep_work_hand_count():
    # L of a 3 x 3 factor: diagonal plus entries (1, 0), (2, 0), (2, 1)
    n, nnz, nrhs = 3, 6, 2
    nbytes, flops = peaks.sweep_work(n, nnz, nrhs, "float32")
    values, rows, pointers = 6 * 4, 6 * 4, 4 * 4
    x_in_out = 2 * 3 * 2 * 4
    assert nbytes == values + rows + pointers + x_in_out
    assert flops == (2 * 3 + 3) * 2  # 2 per off-diagonal, 1 per diagonal
    nb64, _ = peaks.sweep_work(n, nnz, nrhs, "float64")
    assert nb64 == 6 * 8 + 6 * 4 + 4 * 4 + 2 * 3 * 2 * 8
    # the serve cell's L' at n = 65,536, B = 128, float32: bytes bound
    t, by = peaks.least_seconds(*peaks.sweep_work(65536, 3066169, 128, "float32"),
                                "float32")
    assert by == "bytes" and 2.7e-5 < t < 2.8e-5


def test_union_and_gaps_with_overlaps():
    acts = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25),
            ("e", 40, 41)]
    assert trace.union_ns(acts) == 15 + 10 + 1
    assert trace.union_ns(acts[::-1]) == 26
    assert trace.idle_gaps(acts, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    assert trace.idle_gaps(acts, 2, 35) == [(15, 20), (30, 35)]
    samples = [(16, "x"), (17, "x"), (18, "y"), (33, "z")]
    named = trace.name_gaps([(15, 20), (30, 40), (41, 50)], samples, 0)
    assert named == {"x": 5e-9, "z": 1e-8 + 9e-9}


def test_stretch_breakdown_sorted():
    st = trace.Stretch(items=2, wall_s=1.0, counters={},
                       acts=[("k1", 0, 10), ("k2", 0, 30), ("k1", 40, 50)],
                       busy_s=5e-8, gaps={"g1": 0.1, "g2": 0.3})
    assert st.top_ops() == [["k2", 3e-8], ["k1", 2e-8]]
    assert st.top_gaps() == [["g2", 0.3], ["g1", 0.1]]


def test_frame_label_names_the_program():
    import sys

    assert trace.frame_label(sys._getframe()).startswith("benchmark/tests/")


@pytest.mark.parametrize("names,bad", [
    (["rsparse_tpu_torch", "rsparse_tpu_torch.solve", "numpy"], []),
    (["rsparse_tpu", "numpy"], ["rsparse_tpu"]),
    (["rsparse_tpu.solve"], ["rsparse_tpu"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "jaxtyping", "jax_utils"], ["flax"]),
])
def test_module_check_compares_whole_names(names, bad):
    assert forbidden_modules(names) == bad


def test_manifest_names_and_units():
    spec = MAN.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in spec["workloads"]]:
        assert manifest_mod.NAME.match(name), name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert manifest_mod.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e == {"setup_s", "solve_ms_p95", "rhs_per_s", "solve_ms_p95.short",
                   "rhs_per_s.short"}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip() == m["layer"]
        assert callable(MAN.metric(m["name"]).read)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        MAN.config(w["config"]), MAN.traffic(w["traffic"]), MAN.limits(w["name"])
        assert MAN.end_to_end(w["name"]) and MAN.per_layer(w["name"])
    for c in spec["configs"]:
        cfg = MAN.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for e in spec["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25


def test_new_parts_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and manifest entries run with no edit to an existing file."""
    shutil.copytree(os.path.join(MAN.root, "benchmark"), tmp_path / "benchmark")
    spec = json.loads(json.dumps(MAN.spec))
    spec["configs"].append({"name": "lap2d-new", "source": "x",
                            "file": "benchmark/configs/lap2d-new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "lap2d-new.serve-b4", "config": "lap2d-new",
                              "traffic": "serve-b4", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "lap2d-256.serve-b128" in m["workloads"]:
            m["workloads"].append("lap2d-new.serve-b4")
    spec["per_layer"].append({"name": "solve.answer_columns", "unit": "rhs",
                              "better": "higher", "source": "program_counter",
                              "layer": "solve", "moves": "rhs_per_s",
                              "workloads": ["lap2d-new.serve-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = json.loads((tmp_path / "benchmark/configs/lap2d-256.json").read_text())
    cfg["params"] = {"grid": 12}
    (tmp_path / "benchmark/configs/lap2d-new.json").write_text(json.dumps(cfg))
    traffic = MAN.traffic("serve-b128") | {"nrhs": 4, "sample": 2}
    (tmp_path / "benchmark/traffic/serve-b4.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/lap2d-new.serve-b4.json").write_text(
        (tmp_path / "benchmark/limits/lap2d-256.serve-b128.json").read_text())
    (tmp_path / "benchmark/metrics/solve.answer_columns.py").write_text(
        "def read(r):\n    return 4.0 * r.items if r.items else None\n")
    man = manifest_mod.Manifest(str(tmp_path))
    assert [m["name"] for m in man.per_layer("lap2d-new.serve-b4")] == [
        "solve.answer_columns"]
    res = run_cell("lap2d-new.serve-b4", 3, 0.2, False, "cpu", man)
    assert res["correct"] and set(res["metrics"]) == {
        "setup_s", "solve_ms_p95", "rhs_per_s"}
    assert man.metric("solve.answer_columns").read(
        type("R", (), {"items": 2})()) == 8.0


def test_qualified_metric_shares_its_quantitys_reader():
    assert MAN.metric("sptrsv_roofline.short") is MAN.metric("sptrsv_roofline")
    assert MAN.metric("device.idle_share.serve.short") is \
        MAN.metric("device.idle_share")
    with pytest.raises(KeyError):
        MAN.metric("nothing.measured")


@pytest.mark.parametrize("grid,dtype", [(5, torch.float64), (4, torch.float32)])
def test_reference_matches_numpy(grid, dtype):
    gen = MAN.generator("convdiff5")
    n, p, i, x = gen.make(PARAMS["convdiff5"] | {"grid": grid}, seeds.rng(1, 1))
    ref = blocktri.BlockTri(n, p, i, x, grid, dtype)
    B = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)))
    X = ref.solve(B)
    want = np.linalg.solve(_dense(n, p, i, x), B.numpy())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert X.dtype == dtype
    assert np.abs(X.double().numpy() - want).max() <= tol * np.abs(want).max()
    assert float(ref.residual(torch.as_tensor(want), B).abs().max()) < 1e-12
    assert ref.solve(B[:, 0]).shape == (n,)


def test_reference_refuses_a_wide_band():
    n, p, i, x = MAN.generator("poisson5").make({"grid": 6}, None)
    with pytest.raises(ValueError):
        blocktri.BlockTri(n, p, i, x, 3)  # couples blocks two apart


def test_result_line_schema():
    res = run_cell("lap2d-256.serve-b128", 2**31 + 5, 0.2, False, "cpu",
                   params={"grid": 12})
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name

