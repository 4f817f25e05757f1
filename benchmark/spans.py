"""The program's own spans and counters, as the benchmark reads them.

- Per-layer readers' arithmetic over the program's always-on phase
  registry (`rsparse_tpu_torch.utils.get_metrics`) and its readback
  counter: `phase_seconds`, `readbacks_per_request`. A run is one process,
  so the registry holds that run's set-up and requests. A program
  without the phase or the counter reads None.
- The span recorder's arithmetic (`rsparse_tpu_torch.utils.recording`,
  `spans`): `stretch_spans` moves a stretch's records onto the device's
  clock, `span_idle_ms` is the device's idle inside spans of one name,
  `idle_by_span` names each idle gap by the innermost span open across it.
  Records are (name, start ns, end ns, parent, request, attr), parents
  indexed among the records given.
- The span attribution of one serve cell on the card, until
  `benchmark/run.py` turns the recorder on itself (PERF.md, Open questions):

      python3 -m benchmark.spans --workload <cell> --seed <n> [--blocks 6]

  builds the cell as a run does with the recorder on, profiles one
  stretch of the traffic's `stretch` requests between marker kernels as
  `trace.profile_stretch` does, then probes the two clocks (`clock_skew`),
  and prints a `spans:` line (the idle milliseconds per request in all,
  and, with the spans moved onto the device clock by the opening marker's
  offset and by the probes' skew, the idle inside `serve.request`, by
  innermost span, and `readback_tails`), a `setup_spans:` line (set-up's
  seconds by span name) and a `recorder:` line (the host's cost of one
  span, and seconds per request in alternating blocks of `--block-seconds`
  with the recorder off and on, unprofiled). Exits 2 without a card or
  without a recorder in the program.
"""

import argparse
import bisect
import collections
import contextlib
import json
import statistics
import sys
import time
from types import SimpleNamespace

from benchmark import trace

OUTSIDE = "outside"  # idle that no span of the program covers
ATTEMPTS = 4  # profiled stretches before the attribution gives up
PROBES = 16  # clock probes after each stretch
SPIN_CYCLES = 200000  # a probe's kernel, torch.cuda._sleep (~0.1 ms)
SPIN = "spin_kernel"  # that kernel's name in the trace


def _phases():
    from rsparse_tpu_torch.utils import get_metrics

    return get_metrics()


def phase_seconds(name):
    """Seconds of the program's `name` phase over the process, or None."""
    p = _phases().get(name)
    return p["seconds"] if p and p["calls"] else None


def readbacks_per_request():
    """The refinement's readbacks (`solve._amax.readbacks`) over the
    process's serve requests (the registry's `serve.request` calls)."""
    from rsparse_tpu_torch import solve

    count = getattr(solve._amax, "readbacks", None)
    req = _phases().get("serve.request")
    if count is None or not req or not req["calls"]:
        return None
    return count / req["calls"]


def stretch_spans(records, first, offset_ns):
    """The records from index `first` on (the spans that started in the
    stretch), their times moved onto the device clock by `offset_ns`
    (device time less host time), their parents re-indexed among them (-1:
    none, or one that started before). A span still open (None) stays
    None."""
    out = []
    for rec in records[first:]:
        if rec is None:
            out.append(None)
            continue
        name, s, e, parent, request, attr = rec
        out.append((name, s + offset_ns, e + offset_ns,
                    parent - first if parent >= first else -1, request, attr))
    return out


def _merged(acts):
    """The union of the activities' intervals: sorted disjoint [start, end]."""
    out = []
    for _, s, e in sorted(acts, key=lambda a: a[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered_ns(merged, starts, lo, hi):
    """Nanoseconds of [lo, hi] that the merged intervals cover."""
    total = 0
    for s, e in merged[max(bisect.bisect_right(starts, lo) - 1, 0):]:
        if s >= hi:
            break
        total += max(0, min(e, hi) - max(s, lo))
    return total


def span_idle_ms(records, acts, name):
    """Milliseconds per `name` span in which the device ran nothing: each
    span's length less its union with the activities, averaged over the
    `name` spans; None without such a span."""
    sel = [(r[1], r[2]) for r in records if r is not None and r[0] == name]
    if not sel:
        return None
    merged = _merged(acts)
    starts = [s for s, _ in merged]
    idle = sum(e - s - _covered_ns(merged, starts, s, e) for s, e in sel)
    return idle / 1e6 / len(sel)


def idle_by_span(records, acts, bounds, items):
    """{span name: idle milliseconds per item}: each idle gap of the
    device in `bounds` split among the innermost spans open across it;
    OUTSIDE takes what no span covers."""
    depth, events = {}, []
    for i, rec in enumerate(records):
        if rec is None:
            continue
        depth[i] = depth.get(rec[3], -1) + 1
        # at one instant, ends before starts, the inner end and the outer
        # start first
        events.append((rec[1], 1, depth[i], i))
        events.append((rec[2], 0, -depth[i], i))
    events.sort()
    stack, out, k = [], collections.defaultdict(int), 0

    def step(ev):
        if ev[1]:
            stack.append(ev[3])
        else:
            stack.remove(ev[3])

    for a, b in trace.idle_gaps(acts, *bounds):
        while k < len(events) and events[k][0] <= a:
            step(events[k])
            k += 1
        cur = a
        while k < len(events) and events[k][0] < b:
            out[records[stack[-1]][0] if stack else OUTSIDE] += events[k][0] - cur
            cur = events[k][0]
            step(events[k])
            k += 1
        out[records[stack[-1]][0] if stack else OUTSIDE] += b - cur
    return {n: ns / 1e6 / items for n, ns in
            sorted(out.items(), key=lambda kv: -kv[1]) if ns > 0}


def clock_skew(probes, spins):
    """The device clock less the host's, from probes: each (host time
    before a launch, host time after the synchronize that waited for it)
    beside its kernel's (name, device start, device end). A launch reads
    lat1 + skew and a return lat2 - skew, both latencies positive, so the
    skew lies in [-least return, least launch]; the estimate is the median
    of (launch - return) / 2, which takes the two latencies as equal."""
    launch = [s - a for (a, _), (_, s, _) in zip(probes, spins)]
    ret = [b - e for (_, b), (_, _, e) in zip(probes, spins)]
    if not launch:
        return None
    return {"launch_ns": statistics.median(launch),
            "return_ns": statistics.median(ret),
            "skew_ns": statistics.median((x - y) / 2 for x, y in zip(launch, ret)),
            "skew_range_ns": [-min(ret), min(launch)]}


def readback_tails(records, acts):
    """Median nanoseconds from the end of the device's last activity
    before each `refine.readback` span's end (the copy it waited for) to
    that end: the host's return from the synchronize, which is short and
    positive when host and device clocks are aligned."""
    ends = sorted(e for _, _, e in acts)
    tails = []
    for r in records:
        if r is not None and r[0] == "refine.readback":
            k = bisect.bisect_right(ends, r[2]) - 1
            if k >= 0:
                tails.append(r[2] - ends[k])
    return statistics.median(tails) if tails else None


def profile_with_spans(run_items, device, prof):
    """One stretch as `trace.profile_stretch` runs it (fillers, opening
    markers, run_items(), closing markers, fillers) with the program's
    recorder `prof` on, then PROBES clock probes; the stretch's device
    activities, the markers' bounds and offset, the probes' `clock_skew`
    and the stretch's span records on the host's clock. None when the
    profiler lost a marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tag = torch.zeros(256, dtype=torch.int32, device=device)

    def launch(op, k):
        for _ in range(k):
            op(tag, tag, out=tag)

    torch.cuda.synchronize(device)
    first, dropped = len(prof.spans()), prof.spans.dropped
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        launch(torch.bitwise_and, trace.FILLERS)
        torch.cuda.synchronize(device)
        time.sleep(trace.FLUSH_S)
        t_host = time.time_ns()
        t0 = time.perf_counter()
        launch(torch.bitwise_xor, trace.MARKERS)
        items = run_items()
        launch(torch.bitwise_or, trace.MARKERS)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launch(torch.bitwise_and, trace.FILLERS)
        torch.cuda.synchronize(device)
        probes = []
        for _ in range(PROBES):
            t_a = time.time_ns()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize(device)
            probes.append((t_a, time.time_ns()))
        time.sleep(trace.FLUSH_S)
    every = trace._device_activities(p)
    opens = sorted(a for a in every if trace.OPEN.search(a[0]))
    closes = sorted(a for a in every if trace.CLOSE.search(a[0]))
    if len(opens) != trace.MARKERS or len(closes) != trace.MARKERS:
        return None
    lo, hi = opens[-1][2], closes[0][1]
    acts = [a for a in every if a[1] >= lo and a[2] <= hi]
    spins = sorted(a for a in every if SPIN in a[0] and a[1] > hi)
    return SimpleNamespace(
        items=items, wall_s=wall, acts=acts, bounds=(lo, hi),
        busy_s=trace.union_ns(acts) / 1e9, offset_ns=opens[0][1] - t_host,
        clock=clock_skew(probes, spins) if len(spins) == PROBES else None,
        spans=stretch_spans(prof.spans(), first, 0),
        spans_dropped=prof.spans.dropped - dropped)


def span_cost_us(prof, n=100000):
    """Host microseconds of one empty span, with the recorder off and on."""
    out = {}
    for state in ("off", "on"):
        with prof.recording(n + 1) if state == "on" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(n):
                with prof.phase_timer("cost.probe"):
                    pass
            out[state] = (time.perf_counter() - t0) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=6,
                    help="blocks of requests with the recorder off, and on")
    ap.add_argument("--block-seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import program
    from benchmark.manifest import Manifest
    from rsparse_tpu_torch.utils import profiling as prof

    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    if not hasattr(prof, "recording"):
        log("the program has no span recorder")
        return 2
    man = Manifest()
    cell = man.workload(args.workload)
    cfg, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    drv = man.driver(traffic["driver"]).Driver(cfg, traffic, args.seed, "cuda",
                                               man, program)
    n, i = int(traffic["stretch"]), 0

    def items(k):
        def run():
            nonlocal i
            for _ in range(k):
                drv.item(i)
                i += 1
            return k
        return run

    with prof.recording():
        drv.setup()
        setup = collections.defaultdict(float)
        for rec in filter(None, prof.spans()):
            setup[rec.name] += (rec.end_ns - rec.start_ns) / 1e9
        st = None
        for _ in range(ATTEMPTS):
            st = profile_with_spans(items(n), "cuda", prof)
            if st is not None:
                break
    log("setup_spans: " + json.dumps(dict(setup)) + " build_seconds="
        + json.dumps(drv.info["build_seconds"]) + f" route={drv.info['route']}")
    if st is None:
        log("spans: the profiler lost a marker in every stretch")
        return 1
    whole = (st.wall_s - st.busy_s) * 1e3 / st.items
    reqs = {r[4] for r in st.spans if r is not None and r[4] is not None}
    # the spans on the device clock by the opening marker's offset, and by
    # the probes' skew
    aligned = {}
    for how, off in (("marker", st.offset_ns),
                     ("probe", st.clock and st.clock["skew_ns"])):
        if off is None or st.spans_dropped:
            continue
        recs = stretch_spans(st.spans, 0, int(off))
        aligned[how] = {
            "offset_ns": off,
            "in_requests": span_idle_ms(recs, st.acts, "serve.request"),
            "readback_tail_ns": readback_tails(recs, st.acts),
            "by_span": idle_by_span(recs, st.acts, st.bounds, st.items)}
    log(f"spans: workload={args.workload} seed={args.seed} items={st.items}"
        f" requests={len(reqs)} records={len(st.spans)}"
        f" dropped={st.spans_dropped} wall_ms_per_request={st.wall_s * 1e3 / st.items!r}"
        f" idle_ms_per_request={whole!r} clock={json.dumps(st.clock)}"
        f" aligned={json.dumps(aligned)}")
    blocks = {"off": [], "on": []}
    for _ in range(args.blocks):
        for state in ("off", "on"):
            with prof.recording() if state == "on" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0, k = time.perf_counter(), 0
                while time.perf_counter() - t0 < args.block_seconds:
                    items(1)()
                    k += 1
                torch.cuda.synchronize()
                blocks[state].append((time.perf_counter() - t0) / k)
    cost = span_cost_us(prof)
    log("recorder: span_us_off={off!r} span_us_on={on!r}".format(**cost)
        + f" s_per_item_off={statistics.median(blocks['off'])!r}"
        f" s_per_item_on={statistics.median(blocks['on'])!r}"
        f" blocks={json.dumps(blocks)}")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "idle_ms_per_request": whole, "clock": st.clock,
                      "aligned": aligned, "setup": dict(setup), "span_us": cost,
                      "s_per_item": {k: statistics.median(v)
                                     for k, v in blocks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
