"""The traced run's records, from ``torch.profiler``'s trace of the window.

The device ops are the events the profiler put on the card (kernels,
copies, fills), without the user annotations it mirrors there.  The host
spans are the benchmark's own ``record_function`` ranges.  Times are
microseconds on the profiler's one clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SPANS = ("window", "point", "results")

Interval = Tuple[str, float, float]


def kernel_name(name: str) -> str:
    """A device op's short name: without its template arguments and signature."""
    return name.split("(")[0].split("<")[0].replace("void ", "").strip() or "(unnamed)"


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device ops, host spans) of a finished profile, each (name, start us, end us)."""
    import torch

    device, host = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in SPANS:
                device.append((e.name, start, end))
        elif e.name in SPANS:
            host.append((e.name, start, end))
    return sorted(device, key=lambda d: d[1]), sorted(host, key=lambda h: h[1])


def within(ops: List[Interval], t0: float, t1: float) -> List[Interval]:
    """The ops of [t0, t1], clipped to it."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in ops if b > t0 and a < t1]


def union(ops: List[Interval]) -> List[Tuple[float, float]]:
    """The merged busy intervals of ops sorted by start."""
    out: List[List[float]] = []
    for _, a, b in ops:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def label(host: List[Interval], t: float) -> str:
    """The innermost host span open at time t, or "other"."""
    best: Optional[Interval] = None
    for s in host:
        if s[1] <= t <= s[2] and (best is None or s[2] - s[1] < best[2] - best[1]):
            best = s
    return best[0] if best else "other"


def breakdown(ops: List[Interval], host: List[Interval], t0: float, t1: float, top: int = 10) -> Dict:
    """The device ops that took most time and the longest idle gaps of the
    window [t0, t1], each gap named by the host span open at its middle."""
    by_name: Dict[str, float] = {}
    for n, a, b in ops:
        k = kernel_name(n)
        by_name[k] = by_name.get(k, 0.0) + (b - a) / 1e6
    busy = union(ops)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[label(host, (a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]],
    }
