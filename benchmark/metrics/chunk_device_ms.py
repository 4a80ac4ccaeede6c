"""chunk_device_ms: the device ops' time in the traced window (the
profiler's kernels, copies and fills, summed) over the chunks the window
ran, in ms."""


def read(records):
    chunks = sum(p["chunks"] for p in records["points"])
    ops = records["device_ops"]
    if not chunks or not ops:
        return None
    return sum(b - a for _, a, b in ops) / 1e3 / chunks
