"""host_setup_s: the host clock's seconds of the set-up steps the program
does on the host before the warm-up point: ``prepare``, ``LinkRunner(...)``
and, where the configuration takes its PAPR from the sampled TX batch, the
first draw of that batch (the benchmark's own spans around each call)."""

STEPS = ("prepare", "runner", "papr_sample")


def read(records):
    spans = records["host_spans"]
    found = [spans[s] for s in STEPS if s in spans]
    return sum(found) if found else None
