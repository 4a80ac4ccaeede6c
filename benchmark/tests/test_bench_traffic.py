"""The traffic generator: points made from --seed repeat, and walk the grid."""

import itertools
import json
import os

from conftest import BENCH_DIR
from harness import traffic


def _load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as fh:
        return json.load(fh)


def _first(config, mix, seed, k=20):
    return list(itertools.islice(traffic.points(config, mix, seed), k))


def test_same_seed_same_points():
    config, mix = _load("configs", "headline_64sc"), _load("traffic", "campaign")
    seed = 3_000_000_017  # more than 32 signed bits hold
    assert _first(config, mix, seed) == _first(config, mix, seed)
    assert [p.key for p in _first(config, mix, seed)] != [p.key for p in _first(config, mix, seed + 1)]


def test_points_walk_the_grid_and_wrap():
    config, mix = _load("configs", "pod_1024sc"), _load("traffic", "campaign")
    pts = _first(config, mix, 7, 15)
    grid = config["snr_grid_db"]
    assert [p.snr_db for p in pts] == [float(grid[i % len(grid)]) for i in range(15)]
    assert [p.index for p in pts] == list(range(15))
    assert len({p.key for p in pts}) == 15 and all(0 <= p.key < 1 << 64 for p in pts)
    assert traffic.point(config, mix, 7, -1).key not in {p.key for p in pts}


def test_point_size_from_the_mix_or_the_configuration():
    headline = _load("configs", "headline_64sc")
    assert traffic.point_symbols(headline, _load("traffic", "campaign")) == 1 << 25
    assert traffic.point_symbols(headline, _load("traffic", "short_points")) == 1 << 21
    assert traffic.point_symbols(_load("configs", "pod_1024sc"), _load("traffic", "campaign")) == 1 << 20


def test_splitmix_is_the_published_sequence():
    # SplitMix64 from state 0: the first output is 0xe220a8397b1dcdaf
    assert traffic.splitmix64(0) == 0xE220A8397B1DCDAF
