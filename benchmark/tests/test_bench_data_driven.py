"""A configuration, a traffic mix and a per-layer metric added as files
and BENCHMARK.json entries alone: the harness finds them by name."""

import json
import os

from conftest import make_tiny_bench, run_harness


def test_new_configuration_mix_and_metric_from_files(capsys, tmp_path):
    bench_file, tree, _ = make_tiny_bench(tmp_path, config="pod_1024sc", symbols=256, chunk=128, name="wide_tiny")
    with open(os.path.join(tree, "traffic", "two_points.json"), "w") as fh:
        json.dump({"name": "two_points", "point_ofdm_symbols": 128, "why": "a test"}, fh)
    with open(os.path.join(tree, "metrics", "points_done.py"), "w") as fh:
        fh.write("def read(records):\n    return float(len(records['points']))\n")
    with open(os.path.join(tree, "limits", "wide_tiny.two_points.json"), "w") as fh:
        json.dump({"bit_gap": 1.0, "symbol_gap": 1.0, "papr_gap_db": 0.001, "power_gap": 0.0}, fh)
    with open(bench_file) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "wide_tiny.two_points", "config": "wide_tiny", "traffic": "two_points",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "points_done", "unit": "points", "better": "higher",
                               "source": "host_clock", "layer": "campaign loop", "moves": "ofdm_syms_per_s",
                               "workloads": ["wide_tiny.two_points"]})
    with open(bench_file, "w") as fh:
        json.dump(bench, fh)
    rc, out, _ = run_harness(capsys, bench_file, tree, "wide_tiny.two_points", trace=1, seconds=0.3)
    assert rc == 0 and out["correct"] is True
    assert out["metrics"]["points_done"]["value"] == out["attempted"] >= 1
    rc, out, _ = run_harness(capsys, bench_file, tree, "wide_tiny.two_points", trace=0, seconds=0.3)
    assert rc == 0 and out["correct"] is True and "points_done" not in out["metrics"]
