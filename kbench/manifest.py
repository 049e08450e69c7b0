"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file its entry names; a traffic mix is
``kbench/traffic/<name>.json``, whose ``kind`` names the loop module
``kbench.loops.<kind>`` that runs it; a per-layer metric is read by
``kbench/layers/<name>.py``. Adding a configuration, a mix of an existing
kind or a metric is a new file and a new entry, with no edit to a file
that is there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


class Bench:
    """The manifest under ``root`` and the files of the cells it names."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as fh:
            self.data = json.load(fh)

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as fh:
                    return json.load(fh)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic_path(self, name: str) -> Path:
        return self.root / "kbench" / "traffic" / f"{name}.json"

    def traffic(self, name: str) -> Dict:
        with open(self.traffic_path(name)) as fh:
            return json.load(fh)

    def layer_path(self, metric: str) -> Path:
        return self.root / "kbench" / "layers" / f"{metric}.py"

    def reader(self, metric: str) -> Callable:
        """The ``read(ctx)`` function of the metric's reader file."""
        path = self.layer_path(metric)
        spec = importlib.util.spec_from_file_location(
            "kbench.layers." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, cell: str) -> List[Dict]:
        """The cell's end-to-end metrics: those that list it, or list no
        cells."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The cell's per-layer metrics: those that list it, or, without a
        list, those whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
