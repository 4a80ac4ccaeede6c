"""The control, the plain reference in bfloat16 in the program's place,
comes out not correct: on the CPU at a size a test run holds, and on a
card at each cell's own size on three seeds."""

import json
import os

import pytest

from conftest import BENCH_DIR, ROOT, run_harness


def _with_control(monkeypatch, tree):
    from harness import control, program, spec

    def build(config, symbols, device, spans):
        cell = spec.Cell("", 1, config, {}, [], [], {}, tree)
        return control.control_runner(cell, symbols, device)

    monkeypatch.setattr(program, "build_runner", build)


def test_control_is_not_correct_on_the_cpu(capsys, tiny_bench, monkeypatch):
    _with_control(monkeypatch, tiny_bench[1])
    rc, out, _ = run_harness(capsys, *tiny_bench)
    assert rc == 0 and out["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["headline_64sc.campaign", "pod_1024sc.campaign", "headline_64sc.short_points"])
def test_control_is_not_correct_at_the_cells_size(cuda_card, cell):
    """Each cell's readings on a card: every control seed fails a limit."""
    import readings

    from harness import check, spec

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        limits = spec.find_cell(json.load(fh), cell, BENCH_DIR).limits
    lines = readings.main(["--workload", cell, "--seeds", "0", "--control-seeds", "3", "--window-points", "64"])
    control = [ln for ln in lines if ln.get("side") == "control"]
    assert len(control) == 3
    assert all(not check.verdict(ln, limits) for ln in control)
