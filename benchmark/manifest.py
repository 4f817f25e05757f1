"""Finds a cell's parts by the names in `BENCHMARK.json`.

Every part is a file of its own under `benchmark/` (see the package's
docstring), loaded by its path, so that a new configuration, traffic mix,
metric or cell is added with files and manifest entries alone.
"""

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    """`BENCHMARK.json` of the checkout at `root`, and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._modules: Dict[str, ModuleType] = {}

    def _path(self, *parts: str) -> str:
        return os.path.join(self.root, "benchmark", *parts)

    def _json(self, path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self._path(kind, f"{name}.py")
        if path not in self._modules:
            if not NAME.match(name) or not os.path.exists(path):
                raise KeyError(f"no {kind} {name!r} ({path})")
            mod_name = f"benchmark_{kind}_" + re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                cfg = self._json(os.path.join(self.root, c["file"]))
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(self._path("traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return self._json(self._path("limits", f"{workload}.json"))

    def driver(self, name: str) -> ModuleType:
        return self._module("drivers", name)

    def generator(self, name: str) -> ModuleType:
        return self._module("generators", name)

    def reference(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def metric(self, name: str) -> ModuleType:
        """The reader of metric `name`: `metrics/<name>.py`, or else that of
        the quantity it qualifies (`sptrsv_roofline.short` is read by
        `sptrsv_roofline.py`, `device.idle_share.serve` by
        `device.idle_share.py`), the qualifiers dropped one at a time."""
        base = name
        while "." in base and not os.path.exists(self._path("metrics", f"{base}.py")):
            base = base.rsplit(".", 1)[0]
        return self._module("metrics", base)

    def _reports(self, metric: dict, workload: str) -> bool:
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics that `workload` reports."""
        return [m for m in self.spec["end_to_end"] if self._reports(m, workload)]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics that `workload` reports: those that list
        it, and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]
