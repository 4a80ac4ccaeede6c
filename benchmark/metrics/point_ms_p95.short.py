"""point_ms_p95.short: the 95th percentile of the traced window's point
times (the benchmark's call of ``run()`` to the point's counts on the
host), in ms.  In a cell of short points the per-point host path sets
this tail, and it spreads too widely from run to run to share
point_ms_p95's bound; it stands here without one."""

import numpy as np


def read(records):
    walls = [p["wall_s"] for p in records["points"]]
    if not walls:
        return None
    return float(np.percentile(np.asarray(walls, np.float64), 95)) * 1e3
