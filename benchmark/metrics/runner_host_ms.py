"""runner_host_ms: the mean over the window's points of the benchmark's
wall time of ``run()`` less the runner's own ``transmission_time_ms`` (its
synchronized chunk loop): the runner's per-point host path outside the
chunk loop, in ms."""


def read(records):
    pts = records["points"]
    if not pts:
        return None
    return sum(p["wall_s"] * 1e3 - p["transmission_ms"] for p in pts) / len(pts)
