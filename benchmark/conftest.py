"""pytest settings of the benchmark's own tests (benchmark/tests/).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which decides inside the test whether there is a
card and skips with a reason where there is none.  Run them on a card
with ``python3 -m pytest benchmark/tests -m card``.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false here")
    return torch.device("cuda:0")


def make_tiny_bench(tmp_path, config="headline_64sc", symbols=4096, chunk=2048, mix="campaign", name="tiny"):
    """A copy of the benchmark's tree in ``tmp_path`` with one more
    configuration ``name`` (``config`` at ``symbols`` OFDM symbols a point
    and ``chunk`` a launch: a size the CPU runs in seconds), added as files
    and BENCHMARK.json entries alone.  Returns (BENCHMARK.json, tree, cell)."""
    import json
    import shutil

    tree = os.path.join(str(tmp_path), "benchmark")
    shutil.copytree(BENCH_DIR, tree, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(tree, "configs", f"{config}.json")) as fh:
        c = json.load(fh)
    c.update(name=name, point_ofdm_symbols=symbols)
    c["link"]["symbols_per_chunk"] = chunk
    with open(os.path.join(tree, "configs", f"{name}.json"), "w") as fh:
        json.dump(c, fh)
    cell = f"{name}.{mix}"
    shutil.copy(os.path.join(tree, "limits", f"{config}.campaign.json"), os.path.join(tree, "limits", f"{cell}.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": name, "source": "a test", "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": mix, "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # the metrics of the cell it copies
        if f"{config}.{mix}" in m.get("workloads", ()):
            m["workloads"].append(cell)
    bench_file = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(bench_file, "w") as fh:
        json.dump(bench, fh)
    return bench_file, tree, cell


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)


def run_harness(capsys, bench_file, tree, cell, seed=4294967999, seconds=0.5, trace=0):
    """One run of benchmark/run.py's main on the CPU (the look for a card
    skipped): (exit code, the parsed last line of standard output or None,
    standard error)."""
    import json

    import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu", bench_file=bench_file, bench_dir=tree)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None), err
