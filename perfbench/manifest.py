"""Find a cell's pieces by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each is a file of its own: configs/<config>.json, mixes/<traffic>.json.
The cell's limits are limits/<cell>.json, and each per-layer metric is the
reader metrics/<metric>.py. Adding a cell, a configuration, a mix or a
metric is adding its files and its entry; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.here = here
        self.bench = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for entry in self.bench["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _data(self, kind: str, name: str) -> dict:
        return json.loads((self.here / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._data("configs", name)

    def mix(self, name: str) -> dict:
        return self._data("mixes", name)

    def limits(self, cell: str) -> dict:
        return self._data("limits", cell)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports."""
        return [m for m in self.bench["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read(record)` function of metrics/<metric>.py."""
        path = self.here / "metrics" / f"{metric}.py"
        tag = re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{tag}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
