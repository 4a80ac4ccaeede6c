"""BENCHMARK.json against the benchmark's contract, and every name it
uses found under benchmark/."""

import json
import os
import re

from conftest import BENCH_DIR, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for part, keys in KEYS.items():
        names = [e["name"] for e in b[part]]
        assert len(names) == len(set(names))
        for e in b[part]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert _line(w["why"]) and w["chips"] == 1 and NAME.match(w["traffic"])
    assert sum(m["name"] == "setup_s" for m in b["end_to_end"]) == 1
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_name_has_its_files():
    b = _bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            config = json.load(fh)
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert all(k in config for k in c["reduced"])
        for sub in ("work", "reference"):
            assert os.path.exists(os.path.join(BENCH_DIR, sub, f"{config[sub]}.py"))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(BENCH_DIR, "limits", f"{w['name']}.json"))
    for m in b["per_layer"]:
        assert os.path.exists(spec.metric_file(BENCH_DIR, m["name"]))


def test_every_cell_reports_what_its_metrics_move():
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    metric, and the cells a per-layer metric lists report what it moves."""
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {c: {m["name"] for m in b["end_to_end"] if c in m.get("workloads", cells)} for c in cells}
    per_layer = {c: [m for m in b["per_layer"] if c in m.get("workloads", cells)] for c in cells}
    for c in cells:
        assert "setup_s" in e2e[c] and len(e2e[c]) >= 2 and per_layer[c], c
        assert all(m["moves"] in e2e[c] for m in per_layer[c]), c
    for m in b["end_to_end"]:  # <quantity>.<cells>: a quantity run.py computes
        assert m["name"].split(".")[0] in ("ofdm_syms_per_s", "point_ms_p95", "setup_s"), m["name"]


def test_a_full_check_with_24_cells_fits():
    b = _bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
