"""Serving: one handle built in set-up, then a closed loop of one client.

Request i is B[n, nrhs] of N(0, 1) in float64, made on the device from
(seed, i) outside the timed call; its latency runs from the handle's call
to its return with X on the device, after a synchronize. A reservoir of
`sample` answers, drawn from the seed, is kept (copied outside the timed
call) and compared with the reference once the window has closed.

Traffic parameters: nrhs, warmup (requests before the window), sample,
stretch (requests in a profiled stretch).
"""

import time

import numpy as np
import torch

from benchmark import compare, peaks, seeds


class Driver:
    items = "requests"

    def __init__(self, cfg, traffic, seed, device, manifest, solver):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.manifest, self.solver = manifest, solver
        self.nrhs = int(traffic["nrhs"])
        gen = manifest.generator(cfg["generator"])
        self.arrays = gen.make(cfg["params"], seeds.rng(seed, seeds.MATRIX))
        self.n = self.arrays[0]
        self.lat = []
        self.kept = []  # [(request index, X copy)]
        self._pick = seeds.rng(seed, seeds.SAMPLE)
        self.handle = self.info = None

    def rhs(self, phase, k):
        g = torch.Generator(device=self.device)
        g.manual_seed(seeds.torch_seed(self.seed, seeds.RHS, phase, k))
        return torch.randn((self.n, self.nrhs), generator=g,
                           dtype=torch.float64, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.handle, self.info = self.solver.server(self.cfg, self.arrays,
                                                    self.device)
        for w in range(int(self.traffic["warmup"])):
            self.handle(self.rhs(seeds.WARM, w))
        self._sync()

    def item(self, i):
        B = self.rhs(seeds.WINDOW, i)
        self._sync()
        t0 = time.perf_counter()
        X = self.handle(B)
        self._sync()
        self.lat.append(time.perf_counter() - t0)
        # reservoir sampling (Vitter's R) of the answers to compare
        k, t = int(self.traffic["sample"]), len(self.lat) - 1
        if t < k:
            self.kept.append((i, X.clone()))
        else:
            j = int(self._pick.integers(0, t + 1))
            if j < k:
                self.kept[j] = (i, X.clone())

    def end_to_end(self, window_s):
        lat = np.asarray(self.lat)
        return {"solve_ms_p95": float(np.percentile(lat, 95)) * 1e3,
                "rhs_per_s": self.nrhs * len(lat) / window_s}

    def context(self):
        info = self.info
        work = [peaks.sweep_work(self.n, nnz, self.nrhs, info["sweep_dtype"])
                for nnz in info["factor_nnz"]]
        return {"build_seconds": info["build_seconds"],
                "chain_work": [(b, f, info["sweep_dtype"]) for b, f in work]}

    def describe(self):
        return dict(self.info) | {"requests": len(self.lat)}

    def release(self):
        self.handle = None

    def numbers(self):
        if not self.kept:
            return {}
        ref = self.manifest.reference(self.cfg["reference"]).build(
            self.cfg, *self.arrays, dtype=torch.float64, device=self.device)
        Bs = [self.rhs(seeds.WINDOW, i) for i, _ in self.kept]
        X_ref = ref.solve(torch.cat(Bs, 1)).split(self.nrhs, 1)
        norm_a = ref.norm_inf()
        return compare.worst(
            compare.answer_numbers(ref, X, B, Xr, norm_a)
            for (_, X), B, Xr in zip(self.kept, Bs, X_ref))
