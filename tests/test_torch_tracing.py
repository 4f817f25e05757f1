"""The port's span recorder (`utils.recording`, `utils.spans`) and the spans
and counter inside its serve handles and factorizations, on the CPU: what
is recorded and when, parents and request ids, a full buffer, the clock
shared with `torch.profiler`, a serve handle's request spans, the
refinement's readback counter and the build seconds taken from the spans.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rsparse_tpu_torch as rt  # noqa: E402
from rsparse_tpu_torch import solve, utils  # noqa: E402
from rsparse_tpu_torch.utils import phase_timer, recording, spans  # noqa: E402
import torch_cases as C  # noqa: E402


def _names(recs):
    return [r.name for r in recs]


def test_nothing_recorded_outside_recording():
    with recording():
        with phase_timer("unit.in"):
            pass
    with phase_timer("unit.out"):
        pass
    assert _names(spans()) == ["unit.in"]
    calls = []
    with phase_timer("unit.barrier", barrier=lambda: calls.append(1)):
        pass
    assert calls == []  # the barrier runs only while recording
    with recording():
        with phase_timer("unit.barrier", barrier=lambda: calls.append(1)):
            pass
    assert calls == [1] and _names(spans()) == ["unit.barrier"]


def test_parents_and_request_ids_across_nested_spans():
    with recording():
        with phase_timer("outer"):
            for nrhs in (3, 5):
                with phase_timer("serve.request", request=True, attr=nrhs):
                    with phase_timer("child"):
                        with phase_timer("grandchild", attr=7):
                            pass
                    with phase_timer("child"):
                        pass
        with phase_timer("after"):
            pass
    recs = spans()
    assert _names(recs) == ["outer", "serve.request", "child", "grandchild",
                            "child", "serve.request", "child", "grandchild",
                            "child", "after"]
    assert [r.parent for r in recs] == [-1, 0, 1, 2, 1, 0, 5, 6, 5, -1]
    assert [r.request for r in recs] == [None, 0, 0, 0, 0, 1, 1, 1, 1, None]
    assert [r.attr for r in recs] == [None, 3, None, 7, None, 5, None, 7,
                                      None, None]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    # a new recording starts a fresh buffer, request ids from 0
    with recording():
        with phase_timer("serve.request", request=True):
            pass
    assert [(r.name, r.request) for r in spans()] == [("serve.request", 0)]


def test_full_buffer_drops_and_counts():
    with recording(capacity=3):
        for k in range(5):
            with phase_timer(f"s{k}"):
                pass
        with recording():  # entered while on: changes nothing
            with phase_timer("s5"):
                pass
    assert _names(spans()) == ["s0", "s1", "s2"]
    assert spans.dropped == 3
    with recording():
        pass
    assert spans() == [] and spans.dropped == 0


def test_span_brackets_a_profiler_event_on_one_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording():
            with phase_timer("clock.check"):
                torch.add(x, x)
    (rec,) = spans()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::add"]
    assert evs
    for e in evs:
        assert rec.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec.end_ns


def _request_tree(recs):
    """{request id: names of the spans carrying it}, after checking that
    each carrier's parents lead to its serve.request span."""
    out = {}
    for r in recs:
        if r.request is None:
            continue
        out.setdefault(r.request, []).append(r.name)
        top = r
        while top.name != "serve.request":
            assert top.parent >= 0
            top = recs[top.parent]
        assert top.request == r.request
    return out


@pytest.mark.parametrize("family", ["cholsol", "lusol"])
@pytest.mark.parametrize("route", ["device_mf", "device_level"])
def test_serve_handle_spans_and_readbacks(monkeypatch, family, route):
    if route == "device_mf":
        monkeypatch.setattr(rt.config, "mf_min_n", 100)
    if family == "cholsol":
        a = C.port("lap12")
        build = lambda: rt.cholsol_serve(a, 1, device="cpu")  # noqa: E731
        keys = ["analysis", "factor", "handle"]
    else:
        a = C.port("unsym12")
        order = 1 if route == "device_mf" else -1  # the level LU's order
        build = lambda: rt.lusol_serve(a, order, 1e-6, device="cpu")  # noqa: E731
        keys = ["analysis", "factor", "probe", "handle"]
    rng = np.random.default_rng(3)
    with recording():
        h = build()
        built = len(spans())
        counts = []
        for nrhs in (1, 4, 2):
            r0 = solve._amax.readbacks
            X = h(torch.as_tensor(rng.standard_normal((a.n, nrhs))))
            counts.append(solve._amax.readbacks - r0)
    assert X.shape == (a.n, 2)
    recs = spans()
    assert h.factor_route == route
    # set-up: the build spans, their seconds h.build_seconds's
    builds = [r for r in recs[:built] if r.parent == -1]
    assert _names(builds) == [f"serve.build.{k}" for k in keys]
    assert list(h.build_seconds) == keys
    for k, r in zip(keys, builds):
        assert h.build_seconds[k] == (r.end_ns - r.start_ns) / 1e9
    inner = {r.name for r in recs[:built] if r.parent >= 0}
    if route == "device_mf":  # the planner and the numeric factorization
        assert {"factor.plan", "factor.numeric"} <= inner
        fac = builds[keys.index("factor")]
        for r in recs[:built]:
            if r.name in ("factor.plan", "factor.numeric"):
                assert recs[r.parent] == fac
    else:
        assert not inner & {"factor.plan", "factor.numeric"}
    # requests: one serve.request per call, its children under its id
    reqs = [r for r in recs[built:] if r.name == "serve.request"]
    assert [r.request for r in reqs] == [0, 1, 2]
    assert [r.attr for r in reqs] == [1, 4, 2]
    tree = _request_tree(recs)
    assert sorted(tree) == [0, 1, 2]
    for k, names in tree.items():
        sweeps = names.count("serve.sweeps")
        assert sweeps >= 1 and names.count("serve.residual") == sweeps
        # 2 readbacks before the loop, one per refinement step
        assert names.count("refine.readback") == counts[k] == 2 + sweeps - 1
        assert set(names) == {"serve.request", "serve.sweeps",
                              "serve.residual", "refine.readback"}


def test_build_seconds_without_the_recorder():
    a = C.port("lap8")
    h = rt.cholsol_serve(a, 1, device="cpu")
    assert list(h.build_seconds) == ["analysis", "factor", "handle"]
    assert all(v >= 0 for v in h.build_seconds.values())
    r0 = solve._amax.readbacks
    h(np.ones((a.n, 1)))
    assert solve._amax.readbacks - r0 >= 2


def test_registry_keeps_every_span():
    utils.reset_metrics()
    a = C.port("lap8")
    h = rt.cholsol_serve(a, 1, device="cpu")
    h(np.ones((a.n, 2)))
    got = utils.get_metrics()
    assert got["serve.request"]["calls"] == 1
    assert got["refine.readback"]["calls"] >= 2
    assert {"serve.build.analysis", "serve.build.factor",
            "serve.build.handle"} <= set(got)
