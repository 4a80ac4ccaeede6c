"""The last line of a run, its keys and the check that ends it; and the
exits without a result."""

import json
import os
import subprocess
import sys

from conftest import ROOT, make_tiny_bench, run_harness

import run


def test_last_line_keys(capsys, tiny_bench):
    rc, out, err = run_harness(capsys, *tiny_bench)
    assert rc == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"ofdm_syms_per_s", "point_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["check"]) == {"bit_gap", "symbol_gap", "papr_gap_db", "power_gap"}
    tail = err.strip().splitlines()[-4:]
    assert [ln.split()[1] for ln in tail] == list(out["check"])
    assert all(" limit " in ln for ln in tail)


def test_traced_line_keys(capsys, tiny_bench):
    rc, out, _ = run_harness(capsys, *tiny_bench, trace=1)
    assert rc == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the profiler records no device op: only the host readers report
    assert set(out["metrics"]) == {"host_setup_s", "runner_host_ms"}


def test_short_points_keys(capsys, tmp_path):
    """The short-point cell's rate is ofdm_syms_per_s.short, under a bound of its own, and its
    tail a per-layer metric, not point_ms_p95; its per-layer metrics carry the same suffix."""
    bench_file, tree, cell = make_tiny_bench(tmp_path, mix="short_points")
    with open(os.path.join(tree, "traffic", "short_points.json")) as fh:
        mix = json.load(fh)
    with open(os.path.join(tree, "traffic", "short_points.json"), "w") as fh:
        json.dump(dict(mix, point_ofdm_symbols=2048), fh)
    rc, out, _ = run_harness(capsys, bench_file, tree, cell)
    assert rc == 0 and out["correct"] is True
    assert set(out["metrics"]) == {"ofdm_syms_per_s.short", "setup_s"}
    assert out["metrics"]["ofdm_syms_per_s.short"]["unit"] == "syms/s"
    rc, out, _ = run_harness(capsys, bench_file, tree, cell, trace=1)
    assert rc == 0 and set(out["metrics"]) == {"host_setup_s", "runner_host_ms.short", "point_ms_p95.short"}


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "headline_64sc.campaign", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_no_result_without_the_program(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "headline_64sc.campaign", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_a_metric_that_loads_the_jax_package_stops_the_result(capsys, tmp_path, monkeypatch):
    """A per-layer metric read after the window closed imports a module named
    ofdm_tpu (a stand-in for the JAX package): no result line, exit code 3."""
    fake = tmp_path / "fake"
    (fake / "ofdm_tpu").mkdir(parents=True)
    (fake / "ofdm_tpu" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    bench_file, tree, cell = make_tiny_bench(tmp_path)
    with open(os.path.join(tree, "metrics", "loads_jax_package.py"), "w") as fh:
        fh.write("import ofdm_tpu  # noqa: F401\n\n\ndef read(records):\n    return 1.0\n")
    with open(bench_file) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({"name": "loads_jax_package", "unit": "1", "better": "lower", "source": "host_clock",
                               "layer": "campaign loop", "moves": "setup_s", "workloads": [cell]})
    with open(bench_file, "w") as fh:
        json.dump(bench, fh)
    try:
        rc, out, err = run_harness(capsys, bench_file, tree, cell, trace=1)
    finally:
        sys.modules.pop("ofdm_tpu", None)
    assert rc == 3 and out is None
    assert "before the result" in err and "ofdm_tpu" in err


def test_a_run_that_loaded_jax_prints_nothing(capsys, tiny_bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", json)
    rc = run.main(["--workload", tiny_bench[2], "--seed", "5", "--seconds", "0.2", "--trace", "0"], device="cpu",
                  bench_file=tiny_bench[0], bench_dir=tiny_bench[1])
    out, err = capsys.readouterr()
    assert rc != 0 and not out.strip() and "jaxlib" in err
