"""Finds a cell's pieces by name: BENCHMARK.json's entries and the files
under ``benchmark/`` that hold each configuration, traffic mix, per-layer
metric reader and set of limits, and the work count and plain reference
that a configuration file names.

A new configuration, mix or metric is new files and new entries in
BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: Dict  # benchmark/configs/<config>.json
    mix: Dict  # benchmark/traffic/<traffic>.json
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports
    limits: Dict  # benchmark/limits/<cell>.json
    bench_dir: str


def read_json(path: str) -> Dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_module(path: str, name: Optional[str] = None) -> ModuleType:
    """Import a file of the benchmark as a module of its own."""
    name = name or "bench_" + os.path.relpath(path, BENCH_DIR).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: Dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of a parsed BENCHMARK.json, its files read from ``bench_dir``."""
    work = [w for w in bench["workloads"] if w["name"] == name]
    if len(work) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    config = read_json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    mix = read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name, int(w["chips"]), config, mix, [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], limits, bench_dir)


def metric_file(bench_dir: str, metric: str) -> str:
    """benchmark/metrics/<metric>.py; for ``<quantity>.<cells>`` without a
    file of its own (the quantity read apart for some cells), <quantity>.py."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(bench_dir, "metrics", f"{metric.split('.')[0]}.py")
    return path


def metric_reader(cell: Cell, metric: str):
    """``read(records)`` of the metric's file."""
    return load_module(metric_file(cell.bench_dir, metric)).read


def work_count(cell: Cell):
    """``point_work(config, symbols)`` of benchmark/work/<work>.py, the
    module the configuration file names."""
    return load_module(os.path.join(cell.bench_dir, "work", f"{cell.config['work']}.py")).point_work


def reference_link(cell: Cell, device, precision: str):
    """``Link(config, device, precision)`` of benchmark/reference/<reference>.py,
    the module the configuration file names; it answers
    ``point(key, snr_db, symbols)``."""
    module = load_module(os.path.join(cell.bench_dir, "reference", f"{cell.config['reference']}.py"))
    return module.Link(cell.config, device, precision)
