"""The control: the plain reference computed in bfloat16 and put in the
program's place, a runner whose ``run`` answers as ``LinkRunner.run``
does.  The configurations state float32; bfloat16 is the precision below
it that a faster chain would be tempted by.  The check has to find it not
correct (benchmark/tests/test_bench_control.py, benchmark/readings.py)."""

from __future__ import annotations

import time
from typing import Dict


class ControlRunner:
    def __init__(self, link, symbols: int):
        self.link = link
        self.symbols = symbols

    def run(self, seed: int, snr_db: float) -> Dict:
        t0 = time.perf_counter()
        r = self.link.point(seed, snr_db, self.symbols)
        return dict(r, transmission_time_ms=(time.perf_counter() - t0) * 1e3)


def control_runner(cell, symbols: int, device) -> ControlRunner:
    from harness import spec

    return ControlRunner(spec.reference_link(cell, device, "bfloat16"), symbols)
