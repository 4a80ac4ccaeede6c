"""The readings the check's limits are set from, on a card.

    python3 benchmark/readings.py --workload <cell> --seeds 12 --control-seeds 3 --window-points N \
        [--fault unchanged --fault half --fault altered --fault-seeds 3]

For each of ``--seeds`` seeds (counted from ``--first-seed``), the points
a run of the cell would check, had its window finished ``N`` points, run
through the program (one runner, as the window drives it) and the plain
reference; then, for each ``--fault``, the same points of
``--fault-seeds`` further seeds through the program with that fault
planted in its runner (``FAULTS``); then those of ``--control-seeds``
seeds with the control (the reference in bfloat16) in the program's
place.  Prints one JSON line a seed with each number of the check, and
the largest of each over the program's seeds (the lower reading), the
least over the control's (the upper reading) and the least over each
fault's.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _unchanged(chunks):
    """Every chunk leaves the point's counters as they started."""
    def run(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect):
        done = chunks(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect)
        acc[:2] = 0
        return done
    return run


def _half(chunks):
    """Half of the point's chunks left out, the counts of the rest doubled."""
    def run(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect):
        done = chunks(self, key, chunk, max(1, num_chunks // 2), snr_db, snr_lin, rows, acc, psum, collect)
        acc[:2] *= 2
        return done
    return run


def _altered(chunks):
    """One decision of every OFDM symbol altered where the counts are made:
    a bit error and a symbol error more a symbol."""
    def run(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect):
        done = chunks(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect)
        acc[:2] += self.setup.num_ofdm_symbols
        return done
    return run


# Faults a cell of this benchmark can have, planted in LinkRunner's chunk loop.
FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@contextlib.contextmanager
def planted(fault):
    from ofdm_tpu_torch.pipeline import LinkRunner

    chunks = LinkRunner._chunks
    LinkRunner._chunks = FAULTS[fault](chunks)
    try:
        yield
    finally:
        LinkRunner._chunks = chunks


def main(argv=None, device=None):
    """Prints the readings and returns their lines, parsed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[], choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--window-points", type=int, required=True)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    args = ap.parse_args(argv)
    for path in (ROOT, BENCH_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import check, control, program, spec, traffic

    bench = spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = spec.find_cell(bench, args.workload, BENCH_DIR)
    device = torch.device(device or "cuda:0")
    symbols = traffic.point_symbols(cell.config, cell.mix)
    sides = ["program"] * args.seeds + [f"fault:{f}" for f in args.fault for _ in range(args.fault_seeds)]
    sides += ["control"] * args.control_seeds
    seeds = [args.first_seed + 7919 * i for i in range(len(sides))]
    plan = {}
    for s in seeds:
        pts = [traffic.point(cell.config, cell.mix, s, p) for p in range(args.window_points)]
        plan[s] = (pts, check.sample(pts, cell.config, s))
    answers = {}
    runner = program.build_runner(cell.config, symbols, device, {})
    for s, side in zip(seeds, sides):
        if side == "control":
            continue
        pts, picks = plan[s]
        with planted(side[6:]) if side.startswith("fault:") else contextlib.nullcontext():
            answers[s] = {i: program.answer(program.run_point(runner, pts[i].key, pts[i].snr_db)) for i in picks}
    del runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctrl = control.control_runner(cell, symbols, device) if "control" in sides else None
    for s, side in zip(seeds, sides):
        if side == "control":
            pts, picks = plan[s]
            answers[s] = {i: program.answer(ctrl.run(pts[i].key, pts[i].snr_db)) for i in picks}
    link = spec.reference_link(cell, device, "float64")
    lower = {k: 0.0 for k in check.NUMBERS}
    least = {side: {k: float("inf") for k in check.NUMBERS} for side in sides if side != "program"}
    lines = []
    for s, side in zip(seeds, sides):
        pts, picks = plan[s]
        t0 = time.perf_counter()
        got = check.compare(pts, [answers[s].get(i) for i in range(len(pts))], picks, link)
        for k in check.NUMBERS:
            if side == "program":
                lower[k] = max(lower[k], got[k])
            else:
                least[side][k] = min(least[side][k], got[k])
        lines.append({"side": side, "seed": s, "points": [(pts[i].index, pts[i].snr_db) for i in picks],
                      "reference_s": round(time.perf_counter() - t0, 3), **got})
        print(json.dumps(lines[-1]), flush=True)
    summary = {"workload": args.workload, "lower": lower, "upper": least.pop("control", None), "faults": least}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    return lines


if __name__ == "__main__":
    main()
