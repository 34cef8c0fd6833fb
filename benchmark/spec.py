"""`BENCHMARK.json` and the files it names, found by name: a configuration
is `configs/<name>.json` (its reference constants beside it), a traffic
mix `traffic/<name>.json`, a metric the reader `metrics/<name>.py`, all
under this folder.  A later cell, mix or metric is added as new files and
entries; nothing here needs an edit for it."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(Exception):
    """BENCHMARK.json or a file it names is missing or inconsistent."""


class Spec:
    def __init__(self, benchmark: dict, configs_dir: str = None,
                 traffic_dir: str = None, metrics_dir: str = None):
        self.benchmark = benchmark
        self.configs_dir = configs_dir or os.path.join(HERE, "configs")
        self.traffic_dir = traffic_dir or os.path.join(HERE, "traffic")
        self.metrics_dir = metrics_dir or os.path.join(HERE, "metrics")

    @classmethod
    def load(cls, path: str = os.path.join(ROOT, "BENCHMARK.json")) -> "Spec":
        try:
            with open(path) as f:
                return cls(json.load(f))
        except (OSError, ValueError) as e:
            raise SpecError(f"cannot read {path}: {e}") from e

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> str:
        return os.path.join(self.configs_dir, f"{name}.json")

    def config(self, name: str) -> dict:
        return _read_json(self.config_file(name))

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(self.traffic_dir, f"{name}.json"))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics, or
        with `trace` its per-layer ones."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read(run)` function of `metrics/<metric>.py`."""
        path = os.path.join(self.metrics_dir, f"{metric}.py")
        if not os.path.exists(path):
            raise SpecError(f"no reader {path} for metric {metric!r}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SpecError(f"cannot read {path}: {e}") from e
