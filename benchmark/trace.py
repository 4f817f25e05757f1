"""Device traces of a stretch of requests or steps, read without the
program's help.

A stretch runs under `torch.profiler` with device activity only (host
operator events would multiply the profiler's own processing at tens of
thousands of launches a step). Marker kernels on a small int32 tensor,
which the program never launches, open (`bitwise_xor`) and close
(`bitwise_or`) the stretch: they align the device's clock with the host's,
bound the program's activities, and show whether the profiler dropped
activity. It can: on the H100 it has dropped up to the first eight and
the last tens of records of a profile, so filler kernels (`bitwise_and`)
and a short wait come before the opening markers and after the closing
ones. A host sampler records which function of the program the
main thread is in, so that each idle gap of the device is named by what
the host was doing.
"""

import collections
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

MARKERS = 8  # marker kernels at each end of a stretch
OPEN = re.compile(r"bitwise_xor|BitwiseXor", re.IGNORECASE)
CLOSE = re.compile(r"bitwise_or|BitwiseOr", re.IGNORECASE)
FILL = re.compile(r"bitwise_and|BitwiseAnd", re.IGNORECASE)
FILLERS = 512  # kernels at each end, outside the markers, for the profiler to drop
FLUSH_S = 0.05  # wait before the profiler stops
SAMPLE_S = 0.005  # host sampling interval (the interpreter's switch interval)
NAME_CHARS = 120  # activity names are cut to this length in the breakdown

Activity = Tuple[str, int, int]  # (name, start ns, end ns) on the device


def union_ns(acts: Sequence[Activity]) -> int:
    """Nanoseconds in which at least one activity ran: the union of the
    intervals, overlaps across streams counted once."""
    total, end = 0, None
    for _, s, e in sorted(acts, key=lambda a: a[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(acts: Sequence[Activity], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The intervals of [lo, hi] in which no activity ran."""
    gaps, cur = [], lo
    for _, s, e in sorted(acts, key=lambda a: a[1]):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def frame_label(frame) -> str:
    """The innermost function of the program on a stack
    ("factor/frontal_lu.py:_lu_mf_values"), else of the benchmark, else
    "other"."""
    bench = None
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if "/rsparse_tpu_torch/" in path:
            return (path.rsplit("/rsparse_tpu_torch/", 1)[1] + ":"
                    + frame.f_code.co_name)
        if bench is None and "/benchmark/" in path:
            bench = ("benchmark/" + path.rsplit("/benchmark/", 1)[1] + ":"
                     + frame.f_code.co_name)
        frame = frame.f_back
    return bench or "other"


class HostSampler:
    """Samples the calling thread's stack every SAMPLE_S seconds, on the
    clock of `time.time_ns`, while started."""

    def __init__(self):
        self.samples: List[Tuple[int, str]] = []
        self._target = threading.get_ident()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self):
        while not self._stop.wait(SAMPLE_S):
            frame = sys._current_frames().get(self._target)
            self.samples.append((time.time_ns(), frame_label(frame)))

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def name_gaps(gaps, samples, offset_ns: int) -> Dict[str, float]:
    """Seconds of idle gaps by the host's label: each gap goes to the
    label sampled most often inside it, or to the last one sampled before
    it. Host times are moved onto the device clock by offset_ns."""
    times = [t + offset_ns for t, _ in samples]
    out: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b in gaps:
        while j < len(times) and times[j] < a:
            j += 1
        k = j
        while k < len(times) and times[k] <= b:
            k += 1
        if k > j:
            label = collections.Counter(l for _, l in samples[j:k]).most_common(1)[0][0]
        elif j > 0:
            label = samples[j - 1][1]
        else:
            label = "unsampled"
        out[label] += (b - a) / 1e9
    return dict(out)


@dataclass
class Stretch:
    """What one profiled stretch recorded: `acts` the program's device
    activities between the markers (None when the profiler lost some),
    `wall_s` the host's wall from the first marker to the end of the last
    item, `counters` the launch counters' rise."""

    items: int
    wall_s: float
    counters: Dict[str, int]
    acts: Optional[List[Activity]]
    busy_s: float
    gaps: Dict[str, float] = field(default_factory=dict)
    lost: str = ""

    def top_ops(self, k: int = 10):
        by = collections.defaultdict(float)
        for name, s, e in self.acts or ():
            by[name[:NAME_CHARS]] += (e - s) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10):
        return [[n, v] for n, v in
                sorted(self.gaps.items(), key=lambda kv: -kv[1])[:k]]


def _device_activities(prof) -> List[Activity]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile_stretch(run_items: Callable[[], int], read_counters, expected,
                    device) -> Stretch:
    """Profile one stretch: fillers, opening markers, run_items() (returns
    the items run), closing markers, fillers. `read_counters()` gives the launch
    counters; `expected` is a list of (counter, name pattern): the
    activities matching the pattern must number the counter's rise, and
    every marker must be there, else the stretch lost activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tag = torch.zeros(256, dtype=torch.int32, device=device)

    def launch(op, k):
        for _ in range(k):
            op(tag, tag, out=tag)

    torch.cuda.synchronize(device)
    c0 = read_counters()
    with HostSampler() as sampler:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            launch(torch.bitwise_and, FILLERS)
            torch.cuda.synchronize(device)
            time.sleep(FLUSH_S)
            t_host = time.time_ns()
            t0 = time.perf_counter()
            launch(torch.bitwise_xor, MARKERS)
            items = run_items()
            launch(torch.bitwise_or, MARKERS)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            launch(torch.bitwise_and, FILLERS)
            torch.cuda.synchronize(device)
            time.sleep(FLUSH_S)
    c1 = read_counters()
    counters = {k: c1[k] - c0[k] for k in c0}
    every = _device_activities(prof)
    opens = sorted(a for a in every if OPEN.search(a[0]))
    closes = sorted(a for a in every if CLOSE.search(a[0]))
    lost = []
    if len(opens) != MARKERS or len(closes) != MARKERS:
        lost.append(f"markers {len(opens)} + {len(closes)} of {MARKERS} + {MARKERS}")
        acts = [a for a in every if not (OPEN.search(a[0]) or CLOSE.search(a[0])
                                         or FILL.search(a[0]))]
    else:
        lo, hi = opens[-1][2], closes[0][1]
        acts = [a for a in every if a[1] >= lo and a[2] <= hi]
    for counter, pattern in expected:
        seen = sum(1 for a in acts if re.search(pattern, a[0]))
        if seen != counters.get(counter, 0):
            lost.append(f"{counter} {seen} of {counters.get(counter, 0)}")
    busy = union_ns(acts) / 1e9
    st = Stretch(items=items, wall_s=wall, counters=counters,
                 acts=None if lost else acts, busy_s=busy, lost="; ".join(lost))
    if not lost:
        st.gaps = name_gaps(idle_gaps(acts, opens[-1][2], closes[0][1]),
                            sampler.samples, opens[0][1] - t_host)
    return st
