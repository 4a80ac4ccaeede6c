"""chain_roofline: the least time the card could take for the window's
work over the time its device ops took, in %.  The work is the
configuration's count (benchmark/work/<work>.py: the operations and
bytes the link's mathematics needs, from the configuration's sizes); the
least time is the larger of operations over the peak operation rate and
bytes over the peak bandwidth (harness/peaks.py)."""


def read(records):
    ops = records["device_ops"]
    busy = sum(b - a for _, a, b in ops) / 1e6
    work, peaks = records["work"], records["peaks"]
    if busy <= 0 or work["operations"] <= 0:
        return None
    least = max(work["operations"] / peaks["operations_per_s"], work["bytes"] / peaks["bytes_per_s"])
    return 100.0 * least / busy
