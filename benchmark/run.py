"""Run one cell of `BENCHMARK.json` once and print one JSON result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for; without them it prints no result and exits 2. Set-up (imports, the
card, kernel builds, the matrix from the seed, analysis, factorization or
handle build, warm-up) is timed from the start of this module to the first
timed item. The window then runs items for `--seconds`. With `--trace 1` a
stretch of items at the start of the window runs under the profiler (again
when the profiler lost activity, up to ATTEMPTS times) and the per-layer
metrics are reported instead of the end-to-end ones. After the window the
program's state is dropped and a sample of the answers is compared with
the plain reference; each number compared is printed beside its limit as
the last lines of standard error and under "checks", the last key of the
result line. A run that finds `jax`, `jaxlib`, `flax` or the JAX package
`rsparse_tpu` loaded, by whole top-level name, prints no result and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rsparse_tpu")
ATTEMPTS = 4  # profiled stretches before a run gives up on device metrics


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module names, compared by the
    whole name before the first dot (`rsparse_tpu_torch` is not
    `rsparse_tpu`)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest=None, solver=None,
             params=None, t_start: float = None) -> dict:
    """One run of a cell; returns the result line's object. `solver`
    replaces the program (the control and the tests); `params` overrides
    the configuration's sizes (the tests' small grids)."""
    import torch

    from benchmark import compare, manifest as manifest_mod, trace as tr

    if solver is None:
        from benchmark import program as solver
    man = manifest or manifest_mod.Manifest()
    t_start = T_START if t_start is None else t_start
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    if params:
        cfg["params"] = {**cfg["params"], **params}
    traffic = man.traffic(cell["traffic"])
    limits = man.limits(workload)
    layer_metrics = man.per_layer(workload)
    readers = {m["name"]: man.metric(m["name"]) for m in layer_metrics}
    expected = [(r.COUNTER, p) for r in readers.values()
                if hasattr(r, "COUNTER") for p in r.PATTERNS]
    on_card = torch.device(device).type == "cuda"
    counters = getattr(solver, "read_counters", dict)

    t_init = time.perf_counter()
    drv = man.driver(traffic["driver"]).Driver(cfg, traffic, seed, device,
                                               man, solver)
    if trace and on_card:  # the profiler's first start, paid in set-up
        probe = tr.profile_stretch(lambda: 0, counters, [], device)
        log(f"profiler probe: lost={probe.lost or 'nothing'}")
    t_build = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t_start
    log(f"setup: imports={t_init - t_start!r} inputs={t_build - t_init!r} "
        f"build_and_warmup={setup_s - (t_build - t_start)!r}")

    attempted = failed = 0
    i = 0

    def one():
        nonlocal attempted, failed, i
        attempted += 1
        try:
            drv.item(i)
        except Exception:  # a failed item counts; the window goes on
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
        i += 1

    def items(n):
        def run():
            for _ in range(n):
                one()
            return n
        return run

    t_window = time.perf_counter()
    stretch, losses = None, []
    if trace and on_card:
        for _ in range(ATTEMPTS):
            stretch = tr.profile_stretch(items(int(traffic["stretch"])),
                                         counters, expected, device)
            if stretch.acts is not None:
                break
            losses.append(stretch.lost)
    t_rest, i_rest = time.perf_counter(), i
    while time.perf_counter() - t_window < seconds:
        one()
    window_s = time.perf_counter() - t_window
    rest_s = (time.perf_counter() - t_rest) / max(i - i_rest, 1)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if on_card else 0)}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = {}
    if trace:
        reading = SimpleNamespace(items=0, wall_s=0.0, acts=None, busy_s=0.0,
                                  counters={}, **drv.context())
        if stretch is not None:
            reading.__dict__.update(items=stretch.items, wall_s=stretch.wall_s,
                                    acts=stretch.acts, busy_s=stretch.busy_s,
                                    counters=stretch.counters)
            dev["busy_s"], dev["window_s"] = stretch.busy_s, stretch.wall_s
        for m in layer_metrics:
            value = readers[m["name"]].read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        log(f"trace: stretches={len(losses) + (stretch is not None and stretch.acts is not None)}"
            f" lost={len(losses)} ({' | '.join(losses) or 'none'})"
            f" items={reading.items} counters={reading.counters}"
            f" s_per_item traced={reading.wall_s / max(reading.items, 1)!r}"
            f" untraced={rest_s!r}")
    else:
        e2e = drv.end_to_end(window_s)
        e2e["setup_s"] = setup_s
        for m in man.end_to_end(workload):
            # "<quantity>.<qualifier>" reports the driver's <quantity>
            value = e2e[m["name"].split(".", 1)[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"run: workload={workload} seed={seed} window_s={window_s!r} "
        f"setup_s={setup_s!r} threads={torch.get_num_threads()} "
        f"card={power_limit() if on_card else 'cpu'}")
    log("program: " + json.dumps(drv.describe(), default=str))

    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.numbers()
    ok, rows = compare.judge(numbers, limits)
    log(f"check: {len(rows)} numbers in {time.perf_counter() - t_check:.3f} s")
    result.update(correct=bool(ok and failed == 0 and attempted > 0),
                  metrics=metrics, device=dev)
    if trace and stretch is not None and stretch.acts is not None:
        result["breakdown"] = {"device_ops": stretch.top_ops(),
                               "idle_gaps": stretch.top_gaps()}
    result["checks"] = {name: {"value": _finite(v), "limit": l}
                        for name, v, l in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.manifest import Manifest

    man = Manifest()
    chips = int(man.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", man)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    log(f"correct {result['correct']}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
