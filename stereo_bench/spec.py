"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell
names a configuration (``configs[].file``), a traffic mix
(``traffic/<name>.json``) and has its limits of the output check
(``limits/<workload>.json``); a per-layer metric is a reader
(``layer_metrics/<name>.py``, a function ``read(ctx)``), and the kernel
names that attribute device time to an op are the ``patterns`` of every
``kernel_names/*.json`` whose ``op`` is that op. A later cell, mix, metric
or kernel is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class SpecError(ValueError):
    """The benchmark's data do not name what was asked for."""


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Optional[Path] = None):
        self.here = (root or HERE.parent) / HERE.name
        bench = _json(self.here.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = _json(self.here.parent / entry["file"])
        self.traffic = _json(self.here / "traffic" / f"{self.workload['traffic']}.json")
        if (self.traffic["loop"], self.traffic["pipeline_depth"]) != ("closed", 1):
            raise SpecError(f"traffic {self.workload['traffic']!r}: the harness drives a closed loop of depth 1")
        self.limits: Dict[str, float] = _json(self.here / "limits" / f"{name}.json")
        self.peaks = _json(self.here / "rooflines" / "peaks.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str) -> Callable:
        path = self.here / "layer_metrics" / f"{metric}.py"
        if not path.is_file():
            raise SpecError(f"per-layer metric {metric!r} has no reader {path}")
        spec = importlib.util.spec_from_file_location(f"stereo_bench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def kernel_patterns(self, op: str) -> List[str]:
        out = []
        for path in sorted((self.here / "kernel_names").glob("*.json")):
            data = _json(path)
            if data["op"] == op:
                out += data["patterns"]
        return out
