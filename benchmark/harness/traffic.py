"""The one traffic generator: a closed loop of campaign points.

A mix file (benchmark/traffic/<name>.json) sets ``point_ofdm_symbols``
(null: the configuration's own ``point_ofdm_symbols``).  Points walk the
configuration's SNR grid in order and wrap around.  The key of point p is
a 64-bit mix of (seed, p), so one seed gives the same points, in the same
order, on every run.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple

M64 = (1 << 64) - 1


class Point(NamedTuple):
    index: int  # p; the warm-up point is -1
    snr_db: float
    key: int  # 64-bit key of every random draw of the point
    symbols: int  # OFDM symbols of the point


def splitmix64(x: int) -> int:
    """Steele, Lea and Flood's SplitMix64 finalizer: a bijection of 64-bit words."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def point_key(seed: int, p: int) -> int:
    """The key of point p (p = -1: the warm-up point) of a run seeded ``seed``."""
    return splitmix64(splitmix64(seed & M64) ^ ((p + 1) & M64))


def point_symbols(config: Dict, mix: Dict) -> int:
    sym = mix.get("point_ofdm_symbols")
    return int(config["point_ofdm_symbols"] if sym is None else sym)


def point(config: Dict, mix: Dict, seed: int, p: int) -> Point:
    """Point p of the run: p walks the grid in order and wraps around."""
    grid = config["snr_grid_db"]
    snr = float(grid[p % len(grid)]) if p >= 0 else float(grid[-1])
    return Point(p, snr, point_key(seed, p), point_symbols(config, mix))


def points(config: Dict, mix: Dict, seed: int) -> Iterator[Point]:
    """Points 0, 1, 2, ... of the run, as a closed loop with one client asks for them."""
    p = 0
    while True:
        yield point(config, mix, seed, p)
        p += 1
