"""device_idle: the share of the traced window in which no device op ran,
in %: 1 - (the union of the device ops' intervals) / (the window's length)."""

from harness.trace import union


def read(records):
    w0, w1 = records["window_us"]
    ops = records["device_ops"]
    if w1 <= w0 or not ops:
        return None
    busy = sum(b - a for a, b in union(ops))
    return 100.0 * (1.0 - busy / (w1 - w0))
