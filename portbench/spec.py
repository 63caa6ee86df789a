"""Where the benchmark's parts live, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the configurations, the
cells and the metrics. Each cell has a file ``cells/<cell>.json``; its
traffic mix is ``traffic/<traffic>.json``; its configuration is the file
that ``BENCHMARK.json`` names; each metric is read by
``metrics/<metric>.py``. A later change adds a part by adding its file and
its entry, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """The benchmark's files under ``root`` (the checkout): ``BENCHMARK.json``
    and the folder ``bench_dir`` beside it."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.bench = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """The cell's entry in ``BENCHMARK.json`` merged with its own file."""
        entry = self.workload(name)
        own = load_json(self.dir / "cells" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if own.get(key, entry[key]) != entry[key]:
                raise ValueError(f"cells/{name}.json says {key}={own[key]!r}; "
                                 f"BENCHMARK.json says {entry[key]!r}")
        return {**own, **entry}

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return {**load_json(self.root / c["file"]), "name": name}
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return {**load_json(self.dir / "traffic" / f"{name}.json"), "name": name}

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: the end-to-end ones
        untraced, the per-layer ones traced; a metric with a ``workloads``
        key only in those cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def peaks(self, device_name: str) -> dict | None:
        return load_json(self.dir / "peaks.json").get(device_name)
