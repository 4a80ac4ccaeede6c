"""Runs one cell of the benchmark of ``ofdm_tpu_torch`` once and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Set-up builds the runner of the cell's configuration (``prepare`` ->
``LinkRunner``) and runs one warm-up point; the window then drives
``LinkRunner.run`` point after point (a closed loop with one client, the
points of the cell's traffic mix) until ``--seconds`` have passed, and
the plain reference checks a sample of the points it finished.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of the
window), ``device`` and, traced, ``breakdown``; then ``check``, each
compared number beside its limit, which also end standard error.

Everything a cell needs is found by name under ``benchmark/``: its
configuration (configs/), traffic mix (traffic/), per-layer metric
readers (metrics/), the work count and plain reference its configuration
names (work/, reference/) and limits (limits/).  An end-to-end metric
``<quantity>.<cells>`` is the quantity's number, for the cells that list
it apart, under a bound of their own.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names a run may not hold once its window has closed:
# JAX and the JAX package, compared whole (ofdm_tpu_torch is the program).
FORBIDDEN = ("jax", "jaxlib", "flax", "ofdm_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """FORBIDDEN names that ``sys.modules`` holds, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def loaded_forbidden(when):
    """Whether ``sys.modules`` holds a FORBIDDEN name, said on standard error."""
    bad = forbidden_modules()
    if bad:
        print(f"{when}, the run held {', '.join(bad)}; nothing of JAX or the JAX package may load", file=sys.stderr)
    return bool(bad)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def main(argv=None, device=None, bench_file=None, bench_dir=BENCH_DIR):
    """One run; returns the exit code.  ``device`` skips the look for CUDA
    cards and runs there ("cpu": the program's plain versions, for tests);
    ``bench_file`` and ``bench_dir`` name another BENCHMARK.json and tree."""
    args = parse(argv)
    # The program builds into ofdm_tpu_torch/_build/ inside the checkout;
    # any other kernel cache goes to fixed paths inside it too.
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    for path in (ROOT, bench_dir):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import check, program, spec, trace, traffic
    from harness.peaks import PEAK_BYTES, PEAK_OPS

    bench = spec.read_json(bench_file or os.path.join(ROOT, "BENCHMARK.json"))
    cell = spec.find_cell(bench, args.workload, bench_dir)
    t = time.perf_counter()
    import torch

    torch_import = time.perf_counter() - t

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, mix = cell.config, cell.mix
    symbols = traffic.point_symbols(config, mix)
    chunk = int(config["link"]["symbols_per_chunk"]) or symbols

    # --- set-up: everything up to the first timed point ----------------------
    spans = {"torch_import": torch_import}
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    spans["cuda_init"] = time.perf_counter() - t
    runner = program.build_runner(config, symbols, device, spans)
    warm = traffic.point(config, mix, args.seed, -1)
    t = time.perf_counter()
    program.run_point(runner, warm.key, warm.snr_db)
    spans["warm_point"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START

    # --- the window -----------------------------------------------------------
    prof = None
    span = contextlib.nullcontext
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        span = record_function
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    points, answers, walls = [], [], []
    gen = traffic.points(config, mix, args.seed)
    t0 = time.perf_counter()
    with span("window"):
        while True:
            p = next(gen)
            with span("point"):
                ts = time.perf_counter()
                result = program.run_point(runner, p.key, p.snr_db)
                te = time.perf_counter()
            with span("results"):
                points.append(p)
                answers.append(program.answer(result))
                walls.append(te - ts)
            if te - t0 >= args.seconds:
                break
    window_s = te - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if loaded_forbidden("once the window had closed"):
        return 3
    del runner, result
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # --- metrics ------------------------------------------------------------
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    values = {}
    breakdown = None
    if args.trace:
        ops, host = trace.events(prof)
        w = next((h for h in host if h[0] == "window"), None)
        w0, w1 = (w[1], w[2]) if w else (0.0, 0.0)
        ops = trace.within(ops, w0, w1)
        point_work = spec.work_count(cell)
        work = [point_work(config, p.symbols) for p in points]
        records = {
            "config": config,
            "host_spans": spans,
            "points": [{"wall_s": wall, "transmission_ms": a[4], "symbols": p.symbols,
                        "chunks": -(-p.symbols // chunk), "snr_db": p.snr_db}
                       for p, a, wall in zip(points, answers, walls)],
            "device_ops": ops,
            "window_us": (w0, w1),
            "work": {"operations": sum(o for o, _ in work), "bytes": sum(b for _, b in work)},
            "peaks": {"operations_per_s": PEAK_OPS, "bytes_per_s": PEAK_BYTES},
        }
        for m in cell.per_layer:
            v = spec.metric_reader(cell, m["name"])(records)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
        busy = sum(b - a for a, b in trace.union(ops)) / 1e6
        device_info.update(busy_s=busy, window_s=(w1 - w0) / 1e6)
        breakdown = trace.breakdown(ops, host, w0, w1)
    else:
        e2e = {"ofdm_syms_per_s": sum(p.symbols for p in points) / window_s,
               "point_ms_p95": percentile(walls, 95) * 1e3,
               "setup_s": setup_s}
        for m in cell.end_to_end:  # <quantity>.<cells>: the quantity, for the cells that name it
            quantity = m["name"].split(".")[0]
            if quantity in e2e:
                values[m["name"]] = (e2e[quantity], m["unit"])
    card = power_limit() if cuda else None
    if card:
        device_info["power_limit"] = card

    # --- correct: the plain reference on a sample of the finished points ----------
    picks = check.sample(points, config, args.seed)
    link = spec.reference_link(cell, device, "float64")
    numbers = check.compare(points, answers, picks, link)
    correct = check.verdict(numbers, cell.limits) and len(answers) == len(points) > 0
    compared = {k: {"value": numbers[k], "limit": float(cell.limits[k])} for k in check.NUMBERS}

    out = {"correct": correct, "attempted": len(points), "failed": 0,
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = compared
    print(f"{args.workload} seed {args.seed}: {len(points)} points in {window_s:.3f} s, setup {setup_s:.3f} s "
          f"({json.dumps({k: round(v, 4) for k, v in spans.items()})}), checked points {picks}"
          + (f", card {card}" if card else ""), file=sys.stderr)
    for k, c in compared.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    # The work count, the metric readers and the reference loaded since the
    # window closed come from files a later PR adds: look again.
    if loaded_forbidden("before the result"):
        return 3
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
