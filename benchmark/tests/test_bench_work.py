"""The frozen work count against a hand count at 64 subcarriers."""

import json
import os

from conftest import BENCH_DIR
from harness import spec


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _work(config):
    """The configuration's own work count (the module its file names)."""
    return spec.load_module(os.path.join(BENCH_DIR, "work", f"{config['work']}.py")).point_work


def test_headline_count_by_hand():
    config = _config("headline_64sc")
    point_work = _work(config)
    chunk = 1 << 17
    # a bin: Philox 100 + encode 21 + channel 6 + Box-Muller 72 + MMSE 24 + demap 26 + count 5 = 254
    per_chunk = chunk * 64 * 254
    # 16 tiles of 8192 symbols a chunk; the first 1024 symbols of each, 64 bins, 4 operations a sample
    per_chunk += 16 * 1024 * 64 * 4
    # every 32nd tile: tile 0, 8192 symbols; a 64-point IDFT (32 x 6 butterflies x 10 + 2 x 64)
    # and the statistic of 67 samples (5 each)
    per_chunk += 8192 * (32 * 6 * 10 + 128 + 67 * 5)
    ops, nbytes = point_work(config, 2 * chunk)
    assert ops == 2 * per_chunk
    assert nbytes == 2 * (5 * 4 * 64 + 24)


def test_pod_count_has_no_tail_product_and_no_in_run_papr():
    config = _config("pod_1024sc")
    point_work = _work(config)
    chunk = 1 << 17
    # the guard (7 samples) covers the 8-tap channel; the PAPR comes from the sampled batch in set-up
    per_chunk = chunk * 1024 * 254 + (chunk // 1024) * 64 * 1024 * 4
    assert point_work(config, 8 * chunk)[0] == 8 * per_chunk


def test_a_short_guard_adds_the_tail_product():
    config = _config("headline_64sc")
    point_work = _work(config)
    config["link"]["prefix_length_ratio"] = 0.34  # L = 1 of the 3 the channel needs: E = 3 tail lanes
    base = _config("headline_64sc")
    diff = point_work(config, 1 << 17)[0] - point_work(base, 1 << 17)[0]
    papr = 8192 * 5 * (65 - 67)  # the statistic sees T = 65 samples, not 67
    assert diff == (1 << 17) * (3 * 3 * 64 * 8 + 2 * 64) + papr
