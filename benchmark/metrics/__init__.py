"""Per-layer metric readers, one file per measured quantity, named as the
metric. A metric named `<quantity>.<qualifier>` without a file of its own
is read by its quantity's file (`Manifest.metric`), so a quantity split by
cell, as `sptrsv_roofline` and `sptrsv_roofline.short`, shares one reader.

Each has `read(r) -> float or None`, most of them one call into
`benchmark/readers.py`. `r` holds the profiled stretch: `items` (requests
or steps), `wall_s` (its host wall), `acts` (the program's device
activities as (name, start ns, end ns), None when the profiler lost
activity), `busy_s` (their union), `counters` (the launch counters'
rise), and what the driver's `context()` adds (`build_seconds`,
`chain_work`). A reader that finds nothing to read returns None and the
metric is left out of the line. A reader file that declares COUNTER and
PATTERNS makes a stretch whose matching activities do not number the
counter's rise count as lost. `device.ops_per_step` and
`device.busy_ms_per_step` belong to the refactor cells, which
`BENCHMARK.json` does not list yet (PERF.md, Open questions).
"""
