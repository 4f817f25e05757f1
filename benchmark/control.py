"""Readings that the limits of `correct` are set from, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 5

For each of `--seeds` a run of the cell with the program, and for each of
`--control-seeds` a run with the control in the program's place: the plain
reference computed one precision lower than the configuration states
(float32 for float64, TF32 off). Each run is the cell's own traffic at its
own sizes with a short window; one JSON line per run gives its numbers,
and a last line the largest program reading and the smallest control
reading of each number. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys

import numpy as np
import torch


class Control:
    """The reference in float32 in the program's place."""

    def __init__(self, manifest):
        self.manifest = manifest

    def _ref(self, cfg, arrays, device):
        mod = self.manifest.reference(cfg["reference"])
        return mod.build(cfg, *arrays, dtype=torch.float32, device=device)

    def server(self, cfg, arrays, device):
        ref = self._ref(cfg, arrays, device)
        ref.factor()
        info = {"route": "control-float32", "build_seconds": {},
                "factor_nnz": [], "sweep_dtype": "float32"}
        return (lambda B: ref.solve(B).to(torch.float64)), info

    def refactor(self, cfg, arrays, device):
        n, p, i, _ = arrays

        def solve(values, b):
            ref = self._ref(cfg, (n, p, i, values), device)
            x = ref.solve(torch.as_tensor(b, dtype=torch.float32, device=device))
            return x.double().cpu().numpy()

        return solve, {"route": "control-float32"}


def main(argv=None) -> int:
    from benchmark.manifest import Manifest
    from benchmark.run import run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = Manifest()
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    worst, least = {}, {}
    for side, solver, seed_list in (("program", None, seeds(args.seeds)),
                                    ("control", Control(man),
                                     seeds(args.control_seeds))):
        for seed in seed_list:
            res = run_cell(args.workload, seed, args.seconds, False,
                           args.device, man, solver)
            nums = {k: c["value"] for k, c in res["checks"].items()}
            print(json.dumps({"side": side, "seed": seed,
                              "correct": res["correct"],
                              "attempted": res["attempted"],
                              "failed": res["failed"], "numbers": nums}),
                  flush=True)
            for k, v in nums.items():
                v = np.inf if v is None else v
                if side == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    least[k] = min(least.get(k, np.inf), v)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
