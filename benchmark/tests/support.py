"""Shared pieces of the benchmark's tests: a cell at W = 8 (k = 6) whose
proofs the port makes on the CPU in minutes, with its reference
constants worked out once per session."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.reference import constants
from benchmark.spec import HERE, Spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "w8-prove"


def benchmark_dict() -> dict:
    """BENCHMARK.json with the W = 8 cell in place of the real ones."""
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "w8", "source": "test", "reduced": [],
                         "file": "benchmark/tests/data/w8.json", "why": "test"}]
    bench["workloads"] = [{"name": CELL, "config": "w8", "traffic": "prove",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    return bench


def w8_spec(tmp_dir: str) -> Spec:
    """A Spec of the W = 8 cell: its config and constants in `tmp_dir`,
    the real traffic mixes and metric readers."""
    configs = os.path.join(tmp_dir, "configs")
    os.makedirs(configs, exist_ok=True)
    src = os.path.join(DATA, "w8.json")
    dst = os.path.join(configs, "w8.json")
    shutil.copy(src, dst)
    with open(src) as f:
        cfg = json.load(f)
    with open(constants.path_for(dst), "w") as f:
        json.dump(constants.compute(cfg["word_bits"], cfg["reg_count"],
                                    cfg["k"], log=lambda *a: None), f)
    return Spec(benchmark_dict(), configs_dir=configs)
