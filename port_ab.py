"""A/B of two trees of the port on one CUDA card: registers and qam chunk times.

    python3 port_ab.py OTHER_TREE [--reps 3]

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The script builds both trees' kernel libraries, each in a process
of its own with its tree first on ``sys.path`` (the other tree first), and
compares the registers ptxas reports for every qam entry point of the
plain chunk libraries.  Then it times the five qam cells' chunk kernels at
a 2^17-symbol chunk (the headline link on diag, scfde_default on fold,
wide_1024sc and lr_1024sc_zp on lr, zp_64sc on mm) in four processes, in
the order other, this, this, other; each time is the median of ``reps``
timings of 20 launches by CUDA events.  Prints one JSON object as its last
line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK = 1 << 17
HEADLINE = dict(num_subcarriers=64, constellation_order=64, channel_type="CUSTOM", channel_model="Lin-Phoong_P2",
                prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="MMSE", snr_db=30.0)
WIDE = dict(HEADLINE, num_subcarriers=1024, channel_model="severe_multipath")
CELLS = {
    "headline_64sc": HEADLINE,
    "scfde_default": dict(HEADLINE, constellation_order=4, channel_model="Lin-Phoong_P1", modulation_type="SC-OFDM",
                          equalization_method="ZF", snr_db=10.0),
    "wide_1024sc": WIDE,
    "lr_1024sc_zp": dict(WIDE, prefix_type="ZERO"),
    "zp_64sc": dict(HEADLINE, prefix_type="ZERO"),
}


def worker(what, reps):
    """In a tree's own process: build its libraries, or time its cells."""
    import torch

    from ofdm_tpu_torch import build

    if what == "build":
        t0 = time.perf_counter()
        build.build(build.SOURCES)
        return {"build_s": time.perf_counter() - t0, "build_dir": build.BUILD_DIR, "libraries": list(build.SOURCES)}
    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    dev = torch.device("cuda")
    out = {}
    for name, kw in CELLS.items():
        runner = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=kw["num_subcarriers"] * 4 * CHUNK,
                                                     symbols_per_chunk=CHUNK)), dev)
        link, chunk_fn = runner.link, runner.kernel.chunk
        work = runner.kernel.workspace(link, CHUNK, dev)
        acc, psum = lk.new_accumulators(dev)
        snr_lin = lk.snr_linear(kw["snr_db"])

        def launch():
            chunk_fn(link, (3, 4), CHUNK, CHUNK, snr_lin, acc, psum, work)

        launch()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / 20)
        out[name] = statistics.median(times)
    return out


def run_worker(tree, what, reps):
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2]); "
            "import port_ab; print(json.dumps(port_ab.worker(sys.argv[3], int(sys.argv[4]))))")
    done = subprocess.run([sys.executable, "-c", code, tree, HERE, what, str(reps)], capture_output=True, text=True,
                          cwd=tree, timeout=1200)
    if done.returncode != 0:
        raise RuntimeError(f"{what} in {tree} failed:\n{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def qam_registers(build_dir, libraries):
    from chip_smoke import qam_registers as parse

    out = {}
    for lib in libraries:
        if lib.endswith("_staged") or lib == "boxmuller":
            continue
        with open(os.path.join(build_dir, f"{lib}.log")) as fh:
            out.update({f"{lib}:{k}": v for k, v in parse(fh.read()).items()})
    return out


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 3
    import torch

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 1
    builds = {label: run_worker(tree, "build", reps) for label, tree in (("other", other), ("this", HERE))}
    regs = {label: qam_registers(b["build_dir"], b["libraries"]) for label, b in builds.items()}
    common = sorted(set(regs["other"]) & set(regs["this"]))
    moved = {k: (regs["other"][k], regs["this"][k]) for k in common if regs["other"][k] != regs["this"][k]}
    print(f"qam entry points: {len(common)} in both trees, {len(moved)} with other registers: {json.dumps(moved)}")
    print(f"build s: other {builds['other']['build_s']:.1f} ({len(builds['other']['libraries'])} libraries), "
          f"this {builds['this']['build_s']:.1f} ({len(builds['this']['libraries'])} libraries)")
    timings = []
    for label in ("other", "this", "this", "other"):
        t = run_worker(other if label == "other" else HERE, "time", reps)
        print(f"{label}: {json.dumps(t)}", flush=True)
        timings.append({"tree": label, "ms": t})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "qam_entry_points": len(common), "registers_moved": moved,
              "build_s": {k: v["build_s"] for k, v in builds.items()}, "timings": timings}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
