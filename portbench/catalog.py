"""Everything the harness runs is found by name: BENCHMARK.json at the
root of the checkout names the cells, configurations and metrics, and
each lives in a file of its own under portbench/:

    configs/<config>.json     a configuration (BENCHMARK.json's `file`)
    traffic/<traffic>.json    a traffic mix
    metrics/<metric>.py       a per-layer metric's reader
    kernels/<kernel>.json     a kernel's profiler names
    peaks/<device kind>.json  a card's published peaks

A later change adds a cell, a configuration, a mix, a metric, a kernel
or a card by adding such files and BENCHMARK.json entries."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent


class Catalog:
    """The benchmark as found under root (the checkout)."""

    def __init__(self, root: Path = HERE.parent):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The end_to_end or per_layer entries that cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def metric_module(self, name: str) -> ModuleType:
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kernel_names(self, kernel: str) -> List[str]:
        with open(self.dir / "kernels" / f"{kernel}.json") as f:
            return json.load(f)["names"]

    def peaks(self, kind: str) -> Optional[dict]:
        """The published peaks of a card, by its name, or None for a card
        the benchmark has no table of."""
        path = self.dir / "peaks" / (re.sub(r"[^A-Za-z0-9]+", "_", kind)
                                     + ".json")
        if not path.exists():
            return None
        with open(path) as f:
            return json.load(f)
