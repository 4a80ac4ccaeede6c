"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (the module its configuration names under benchmark/reference/)
works out again a sample of the points the window finished, from the
configuration file and each point's key, and the program's answers are
held against it:

* ``bit_gap``, ``symbol_gap``: the largest |program - reference| of a
  point's bit (symbol) errors over sqrt(reference + 1), the count's own
  Poisson scale; a float32 program differs from the float64 reference
  only where a point lies within rounding of a decision boundary;
* ``papr_gap_db``: the largest |program - reference| of a point's PAPR;
* ``power_gap``: the largest |program - reference| of an allocated power.

The sample always holds the first finished point at the grid's lowest
SNR, where the counts are largest, and, drawn from the seed, further
finished points up to ``CHECK_BINS`` bins of work (at least
``MIN_POINTS``, at most ``MAX_POINTS``).  Each number has its limit in
benchmark/limits/<cell>.json.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

CHECK_BINS = 1 << 32
MIN_POINTS, MAX_POINTS = 2, 12
NUMBERS = ("bit_gap", "symbol_gap", "papr_gap_db", "power_gap")


def sample(finished: Sequence, config: Dict, seed: int) -> List[int]:
    """Indices into ``finished`` (the window's points, in order) to check."""
    if not finished:
        return []
    lowest = min(config["snr_grid_db"])
    first = next((i for i, p in enumerate(finished) if p.snr_db == lowest), 0)
    bins = finished[0].symbols * int(config["link"]["num_subcarriers"])
    k = min(MAX_POINTS, max(MIN_POINTS, CHECK_BINS // bins))
    rest = [i for i in range(len(finished)) if i != first]
    rng = random.Random(seed ^ 0x5EED)
    return [first] + sorted(rng.sample(rest, min(k - 1, len(rest))))


def gaps(program: Tuple, reference: Dict) -> Dict[str, float]:
    """One point's numbers: program (bit errors, symbol errors, PAPR dB,
    allocated power) against the reference's answer."""
    be, se, papr, power = program[:4]
    rb, rs = reference["bit_errors"], reference["symbol_errors"]
    return {
        "bit_gap": abs(be - rb) / math.sqrt(rb + 1),
        "symbol_gap": abs(se - rs) / math.sqrt(rs + 1),
        "papr_gap_db": abs(papr - reference["papr_db"]),
        "power_gap": max((abs(a - b) for a, b in zip(power, reference["allocated_power"])), default=math.inf)
        if len(power) == len(reference["allocated_power"]) else math.inf,
    }


def compare(points: Sequence, answers: Sequence, picks: Sequence[int], link) -> Dict[str, float]:
    """The largest of each number over the picked points; ``link`` answers
    ``point(key, snr_db, symbols)``."""
    worst = {k: 0.0 for k in NUMBERS}
    for i in picks:
        p = points[i]
        g = gaps(answers[i], link.point(p.key, p.snr_db, p.symbols))
        worst = {k: max(worst[k], g[k]) for k in NUMBERS}
    return worst


def verdict(numbers: Dict[str, float], limits: Dict) -> bool:
    return all(numbers[k] <= float(limits[k]) for k in NUMBERS)
