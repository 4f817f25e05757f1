"""CPU tests of the readings of the program's own spans and counters
(`benchmark/spans.py` and the readers that use it): the stretch's records
moved onto the device clock, the device's idle inside spans with
overlapping activities, the innermost-span attribution, and None where
the program records nothing."""

from types import SimpleNamespace

import pytest

from benchmark import manifest as manifest_mod
from benchmark import spans
from benchmark.run import run_cell

MAN = manifest_mod.Manifest()

# Host-clock records of one request: a set-up span (index 0, before the
# stretch), then the request and three children; the device clock runs
# 10 ns ahead.
HOST = [("serve.build.factor", 0, 30, -1, None, None),
        ("serve.request", 40, 840, -1, 0, 128),
        ("serve.sweeps", 90, 240, 1, 0, None),
        ("refine.readback", 240, 290, 1, 0, None),
        ("serve.residual", 290, 490, 1, 0, None)]
ACTS = [("sweep", 100, 200), ("cast", 150, 250), ("gather", 400, 500),
        ("next", 700, 800)]
BOUNDS = (50, 900)


def _stretch():
    return spans.stretch_spans(HOST, 1, 10)


def test_stretch_spans_move_the_clock_and_reindex():
    recs = _stretch()
    assert [r[:4] for r in recs] == [("serve.request", 50, 850, -1),
                                     ("serve.sweeps", 100, 250, 0),
                                     ("refine.readback", 250, 300, 0),
                                     ("serve.residual", 300, 500, 0)]
    assert recs[0][4:] == (0, 128)
    assert spans.stretch_spans([None, HOST[1]], 0, 5)[0] is None


def test_idle_inside_spans_with_overlaps():
    # serve.request on the device clock 50..850: covered by the union of
    # [100, 250] (two overlapping activities), [400, 500] and [700, 800]
    assert spans.span_idle_ms(_stretch(), ACTS, "serve.request") == \
        (800 - 150 - 100 - 100) / 1e6
    # a span that one activity straddles at each end
    assert spans.span_idle_ms([("x", 180, 420, -1, None, None)], ACTS, "x") \
        == (240 - 70 - 20) / 1e6
    assert spans.span_idle_ms(_stretch(), ACTS, "absent") is None
    # the clock offset moves the span against an activity at its end
    rec, tail = [("r", 0, 100, -1, None, None)], [("k", 95, 120)]
    assert spans.span_idle_ms(spans.stretch_spans(rec, 0, 0), tail, "r") == \
        95 / 1e6
    assert spans.span_idle_ms(spans.stretch_spans(rec, 0, 10), tail, "r") == \
        85 / 1e6


def test_idle_named_by_innermost_span():
    got = spans.idle_by_span(_stretch(), ACTS, BOUNDS, 1)
    assert got == {"serve.request": 300 / 1e6, "serve.residual": 100 / 1e6,
                   "refine.readback": 50 / 1e6, spans.OUTSIDE: 50 / 1e6}
    assert list(got)[0] == "serve.request"  # largest first
    # the parts add up to the idle between the markers, per item
    idle = sum(b - a for a, b in [(50, 100), (250, 400), (500, 700), (800, 900)])
    assert sum(spans.idle_by_span(_stretch(), ACTS, BOUNDS, 2).values()) == \
        pytest.approx(idle / 1e6 / 2)
    # a parent and a child starting at one instant: the child is innermost
    same = [("p", 0, 100, -1, None, None), ("c", 0, 60, 0, None, None)]
    assert spans.idle_by_span(same, [], (0, 100), 1) == {"c": 60 / 1e6,
                                                         "p": 40 / 1e6}


def _reading(**kw):
    base = dict(items=1, wall_s=1e-6, acts=ACTS, busy_s=0.0, counters={},
                spans=_stretch(), spans_dropped=0)
    return SimpleNamespace(**(base | kw))


def test_idle_reader_refuses_missing_or_dropped_records():
    read = MAN.metric("solve.idle_ms_per_request.short").read
    assert read(_reading()) == (800 - 350) / 1e6
    assert read(_reading(spans=None)) is None  # no recorder in the program
    assert read(_reading(spans_dropped=3)) is None  # the buffer was full
    assert read(_reading(acts=None)) is None  # the profiler lost activity
    # the run's reading today has no span records
    assert read(SimpleNamespace(items=1, acts=ACTS, counters={})) is None


def test_registry_readers_none_without_the_program_spans(monkeypatch):
    from rsparse_tpu_torch import solve, utils

    utils.reset_metrics()
    for name in ("factor.plan_s", "factor.numeric_s",
                 "solve.readbacks_per_request"):
        assert MAN.metric(name).read(_reading()) is None
    monkeypatch.delattr(solve._amax, "readbacks")  # a program without it
    with utils.phase_timer("serve.request"):
        pass
    assert spans.readbacks_per_request() is None


def test_traced_cpu_run_reads_the_program_spans(monkeypatch):
    """A --trace 1 run of a serve cell on the CPU (no device trace) with
    the multifrontal route forced: the planner's and the factorization's
    seconds and the readbacks per request come from the program."""
    import rsparse_tpu_torch as rt
    from rsparse_tpu_torch import utils

    monkeypatch.setattr(rt.config, "mf_min_n", 100)
    utils.reset_metrics()
    res = run_cell("cd2d-128.serve-b128", 2**31 + 77, 0.3, True, "cpu",
                   params={"grid": 24})
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["factor.plan_s"] > 0 and m["factor.numeric_s"] > 0
    assert m["solve.readbacks_per_request.short"] >= 2
    got = utils.get_metrics()
    assert m["factor.plan_s"] + m["factor.numeric_s"] <= \
        got["serve.build.factor"]["seconds"]
    assert res["metrics"]["factor.plan_s"]["unit"] == "s"


def test_clock_skew_from_probes():
    # the device clock 300 ns ahead; launches take 20 ns, returns 10 ns
    probes = [(1000, 1330), (2000, 2340)]
    spins = [("spin_kernel", 1320, 1620), ("spin_kernel", 2320, 2630)]
    got = spans.clock_skew(probes, spins)
    assert got["launch_ns"] == 320 and got["return_ns"] == -290
    assert got["skew_ns"] == 300 + (20 - 10) / 2
    assert got["skew_range_ns"] == [290, 320]
    assert spans.clock_skew([], []) is None


def test_readback_tails_measure_the_return():
    acts = [("copy", 100, 200), ("copy", 500, 560), ("kernel", 600, 700)]
    recs = [("refine.readback", 50, 230, -1, 0, None),
            ("serve.sweeps", 230, 600, -1, 0, None),
            ("refine.readback", 520, 580, -1, 0, None)]
    assert spans.readback_tails(recs, acts) == (30 + 20) / 2
    assert spans.readback_tails(recs[1:2], acts) is None
