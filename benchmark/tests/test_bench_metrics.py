"""Each per-layer metric's arithmetic on a small recorded profile, and the
trace's union, labels and breakdown."""

import math
import os

import pytest

from conftest import BENCH_DIR
from harness import spec, trace

# A window of 10 ms (profiler microseconds 1000-11000) with two points of
# two chunks each: four device ops of 2 ms, two of which overlap a fill.
RECORDS = {
    "config": None,
    "host_spans": {"import": 3.0, "cuda_init": 0.5, "prepare": 0.25, "runner": 1.5, "papr_sample": 0.125,
                   "warm_point": 0.4},
    "points": [
        {"wall_s": 0.0050, "transmission_ms": 4.5, "symbols": 8, "chunks": 2, "snr_db": 0.0},
        {"wall_s": 0.0046, "transmission_ms": 4.4, "symbols": 8, "chunks": 2, "snr_db": 5.0},
    ],
    "device_ops": [
        ("diag_main", 1000.0, 3000.0),
        ("fill", 2500.0, 3500.0),
        ("diag_main", 3500.0, 5500.0),
        ("diag_main", 6000.0, 8000.0),
        ("diag_main", 8000.0, 10000.0),
    ],
    "window_us": (1000.0, 11000.0),
    "work": {"operations": 2.68e9, "bytes": 1.0e6},
    "peaks": {"operations_per_s": 33.5e12, "bytes_per_s": 3.35e12},
}


def _read(name, records=RECORDS):
    return spec.load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py")).read(records)


def test_host_setup_s():
    assert _read("host_setup_s") == pytest.approx(0.25 + 1.5 + 0.125)


def test_runner_host_ms():
    assert _read("runner_host_ms") == pytest.approx(((5.0 - 4.5) + (4.6 - 4.4)) / 2)


def test_chunk_device_ms():
    # 2 + 1 + 2 + 2 + 2 ms of device ops over 4 chunks
    assert _read("chunk_device_ms") == pytest.approx(9.0 / 4)


def test_chain_roofline():
    # 2.68e9 operations at 33.5e12/s = 0.08 ms (the bytes take 0.0003 ms) over 9 ms of device time
    assert _read("chain_roofline") == pytest.approx(100 * 0.08 / 9.0)


def test_device_idle():
    # busy: 1000-3500, 3500-5500, 6000-10000 = 8.5 ms of the 10 ms window
    assert _read("device_idle") == pytest.approx(15.0)


def test_point_ms_p95_short():
    # numpy's linear 95th percentile of 5.0 and 4.6 ms
    assert _read("point_ms_p95.short") == pytest.approx(4.6 + 0.95 * 0.4)


def test_readers_return_nothing_without_data():
    empty = dict(RECORDS, device_ops=[], points=[], host_spans={})
    for name in ("host_setup_s", "runner_host_ms", "chunk_device_ms", "chain_roofline", "device_idle",
                 "point_ms_p95.short"):
        assert _read(name, empty) is None


def test_breakdown_names_gaps_by_the_host_span():
    host = [("window", 1000.0, 11000.0), ("point", 1000.0, 5600.0), ("results", 5600.0, 5700.0),
            ("point", 5700.0, 10500.0), ("results", 10500.0, 11000.0)]
    b = trace.breakdown(RECORDS["device_ops"], host, 1000.0, 11000.0)
    assert b["device_ops"][0] == ["diag_main", pytest.approx(0.008)]
    assert b["device_ops"][1] == ["fill", pytest.approx(0.001)]
    gaps = b["idle_gaps"]
    assert [g[0] for g in gaps] == ["results", "point"]  # 10000-11000 mid 10500: the innermost span is results
    assert gaps[0][1] == pytest.approx(0.001) and gaps[1][1] == pytest.approx(0.0005)
    assert math.isclose(sum(g[1] for g in gaps), 0.0015)


def test_kernel_names_lose_their_signature():
    assert trace.kernel_name("void diag_main<2, 0>(float const*, int)") == "diag_main"
    assert trace.kernel_name("Memset (Device)") == "Memset"
