"""Refactorization: one analysis of the pattern in set-up, then a closed
loop of steps, each with new values on the same pattern and a new b.

Step i's values are A + c I, with c = 1/dt drawn from (seed, i)
log-uniform in [shift_lo, shift_hi] (backward Euler with an adaptive
step), so no value set repeats in a run; b is N(0, 1). The values, b and
the solve are all inside the step. A sample of `sample` steps, drawn from
the seed, is compared with the reference once the window has closed.

Traffic parameters: shift_lo, shift_hi, warmup (steps before the window),
sample, stretch (steps in a profiled stretch).
"""

import time

import numpy as np
import torch

from benchmark import compare, seeds


class Driver:
    items = "steps"

    def __init__(self, cfg, traffic, seed, device, manifest, solver):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.manifest, self.solver = manifest, solver
        gen = manifest.generator(cfg["generator"])
        self.arrays = gen.make(cfg["params"], seeds.rng(seed, seeds.MATRIX))
        n, p, i, _ = self.arrays
        self.n = n
        cols = np.repeat(np.arange(n), np.diff(p))
        self.diag = np.flatnonzero(np.asarray(i[: p[-1]]) == cols)
        self.xs = {}  # step -> x
        self.steps = 0
        self.step_times = []
        self.solve = self.info = None

    def values(self, phase, k):
        rng = seeds.rng(self.seed, seeds.VALUES, phase, k)
        lo, hi = np.log10(self.traffic["shift_lo"]), np.log10(self.traffic["shift_hi"])
        x = np.array(self.arrays[3], np.float64)
        x[self.diag] += 10.0 ** rng.uniform(lo, hi)
        return x

    def rhs(self, phase, k):
        return seeds.rng(self.seed, seeds.RHS, phase, k).standard_normal(self.n)

    def setup(self):
        self.solve, self.info = self.solver.refactor(self.cfg, self.arrays,
                                                     self.device)
        for w in range(int(self.traffic["warmup"])):
            self.solve(self.values(seeds.WARM, w), self.rhs(seeds.WARM, w))

    def item(self, i):
        t0 = time.perf_counter()
        self.xs[i] = self.solve(self.values(seeds.WINDOW, i),
                                self.rhs(seeds.WINDOW, i))
        self.steps += 1
        self.step_times.append(time.perf_counter() - t0)

    def end_to_end(self, window_s):
        return {"step_s": window_s / self.steps}

    def context(self):
        return {}

    def describe(self):
        t = self.step_times
        return dict(self.info) | {"steps": self.steps, "step_s_first_last_median": (
            [t[0], t[-1], float(np.median(t))] if t else None)}

    def release(self):
        self.solve = None

    def numbers(self):
        done = sorted(self.xs)
        if not done:
            return {}
        k = min(int(self.traffic["sample"]), len(done))
        pick = seeds.rng(self.seed, seeds.SAMPLE).choice(len(done), k, replace=False)
        ref_mod = self.manifest.reference(self.cfg["reference"])
        n, p, i, _ = self.arrays
        out = []
        for j in sorted(pick):
            step = done[j]
            ref = ref_mod.build(self.cfg, n, p, i, self.values(seeds.WINDOW, step),
                                dtype=torch.float64, device=self.device)
            b = torch.as_tensor(self.rhs(seeds.WINDOW, step), device=self.device)
            x = torch.as_tensor(np.asarray(self.xs[step], np.float64),
                                device=self.device)
            out.append(compare.answer_numbers(ref, x, b, ref.solve(b),
                                              ref.norm_inf()))
        return compare.worst(out)
