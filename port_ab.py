"""A/B of two trees of the port on one CUDA card: registers and chunk times.

    python3 port_ab.py OTHER_TREE [--reps 3] [--lr-study]

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The script builds both trees' kernel libraries, each in a process
of its own with its tree first on ``sys.path`` (this script's cells and
worker for both), and
compares the registers ptxas reports for every qam entry point that both
trees have, in the plain chunk libraries and apart in the staged ones.
Then it times, at a 2^17-symbol chunk, the five qam cells' chunk kernels
(the headline link on diag, scfde_default on fold, wide_1024sc and
lr_1024sc_zp on lr, zp_64sc on mm; the lr zero-prefix chunk at 512 and
2048 subcarriers, lr_main's other group sizes; an SC-FDE link at each
other width the fold and mm kernels compile for, 32-256 subcarriers, with
a cyclic and a zero prefix) and the staged cells (a
waterfilling link with both power switches on each chain, and the
noise-bump study's chunk with all four stages on diag at 64, 512 and 1024
subcarriers, fold and mm; a cell a tree does not take reads "skip") in
four processes, in the order other, this, this, other; each time is the
median of ``reps`` timings of 20 launches by CUDA events (10 for the
staged cells).  With ``--lr-study`` it times the lr study's cells instead:
the lr chunk over the repo's channel models of E = 1, 3 and 5 at 1024
subcarriers (cyclic and zero prefix) and a short-CP link at 128, and the
staged 1024-sc lr chunks with the PAPR statistic on one tile in 128 (its
share of them).  Prints one JSON object as its last line.
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
SCFDE = dict(HEADLINE, constellation_order=4, channel_model="Lin-Phoong_P1", modulation_type="SC-OFDM",
             equalization_method="ZF", snr_db=10.0)
CELLS = {
    "headline_64sc": HEADLINE,
    "scfde_default": SCFDE,
    "wide_1024sc": WIDE,
    "lr_1024sc_zp": dict(WIDE, prefix_type="ZERO"),
    "zp_64sc": dict(HEADLINE, prefix_type="ZERO"),
    # lr_main's groups of 4 (four blocks an SM) and of 2 symbols
    "lr_512sc_zp": dict(WIDE, num_subcarriers=512, prefix_type="ZERO"),
    "lr_2048sc_zp": dict(WIDE, num_subcarriers=2048, prefix_type="ZERO"),
    # fold's other compiled widths (bins a lane 1, 3-8; scfde_default has 2)
    **{f"scfde_{n}sc": dict(SCFDE, num_subcarriers=n) for n in (32, 96, 128, 160, 192, 224, 256)},
    # mm's other compiled widths (bins a lane 3, 4, 6, 8; zp_64sc has 2)
    **{f"scfde_zp_{n}sc": dict(SCFDE, num_subcarriers=n, prefix_type="ZERO") for n in (96, 128, 192, 256)},
}
_WF = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True, normalize_before_demap=True)
_NB = dict(noise_type="NONE", apply_power_allocation=True, normalize_before_demap=True)
# (config, with the noise-bump stages): the staged builds' chunks
STAGED_CELLS = {
    "wf_headline_64sc": (dict(HEADLINE, **_WF), False),
    "wf_scfde_default": (dict(SCFDE, **_WF), False),
    "wf_wide_1024sc": (dict(WIDE, **_WF), False),
    "wf_cp034_128sc": (dict(HEADLINE, **_WF, num_subcarriers=128, constellation_order=16, prefix_length_ratio=0.34,
                            channel_model="severe_multipath", snr_db=20.0), False),
    "wf_zp_64sc": (dict(HEADLINE, **_WF, prefix_type="ZERO"), False),
    "bump_study_64sc": (dict(HEADLINE, **_NB), True),
    "bump_study_512sc": (dict(HEADLINE, **_NB, num_subcarriers=512), True),
    "bump_study_1024sc": (dict(HEADLINE, **_NB, num_subcarriers=1024), True),
    "bump_scfde_default": (dict(SCFDE, **_NB), True),
    "bump_zp_64sc": (dict(HEADLINE, **_NB, prefix_type="ZERO"), True),
}
# --lr-study: the lr chunk against the tail rank E, and the in-run PAPR's
# share of the staged 1024-sc lr chunks (1 tile in 128 sampled, not 4)
LR_STUDY_CELLS = {
    "lr_two_ray_1024sc": dict(WIDE, channel_model="two_ray"),
    "lr_two_ray_1024sc_zp": dict(WIDE, channel_model="two_ray", prefix_type="ZERO"),
    "lr_p2_1024sc": dict(WIDE, channel_model="Lin-Phoong_P2"),
    "lr_p2_1024sc_zp": dict(WIDE, channel_model="Lin-Phoong_P2", prefix_type="ZERO"),
    "lr_rayleigh_1024sc": dict(WIDE, channel_model="rayleigh_fading"),
    "lr_rayleigh_1024sc_zp": dict(WIDE, channel_model="rayleigh_fading", prefix_type="ZERO"),
    "lr_cp034_128sc": dict(WIDE, num_subcarriers=128, constellation_order=16, prefix_length_ratio=0.34,
                           snr_db=20.0),
}
LR_STUDY_STAGED = {
    "wf_wide_1024sc_papr1": (dict(WIDE, **_WF, papr_stride=128), False),
    "bump_study_1024sc_papr1": (dict(HEADLINE, **_NB, num_subcarriers=1024, papr_stride=128), True),
}


def median_ms(launch, reps, launches):
    """Median over ``reps`` of the mean ms of ``launches`` launches, by CUDA events."""
    import torch

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            launch()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def staged_cell(kw, bump, dev):
    """A launch of one staged cell's chunk (its rows: sqrt(P), or the
    noise-bump study's three rows of its wf_plus3 scenario at 15 dB), or
    None when the tree routes it to the eager chain."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    runner = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=kw["num_subcarriers"] * 4 * CHUNK,
                                                 symbols_per_chunk=CHUNK)), dev)
    if runner.mode == "eager":
        return None
    link = runner.link
    if bump:
        link = lk.noise_bump_link(link)
        profile = nb.create_noise_profile(kw["num_subcarriers"], nb.SCENARIOS[1].noise_bump_db)
        rows = nb.point_rows(np.abs(runner.setup.h_freq) ** 2, nb.SCENARIOS[1], profile, 15.0)
    else:
        rows = np.sqrt(runner.point_params(kw["snr_db"])[0])[None]
    rows = torch.tensor(rows, dtype=torch.float32, device=dev)
    work = runner.kernel.workspace(link, CHUNK, dev)
    acc, psum = lk.new_accumulators(dev)
    snr_lin = lk.snr_linear(15.0)
    return lambda: runner.kernel.chunk(link, (3, 4), CHUNK, CHUNK, snr_lin, acc, psum, work, rows)


def worker(what, reps):
    """In a tree's own process: build its libraries, or time its cells
    (``what`` "time") or the lr study's ("lr_study")."""
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
    cells, staged = (LR_STUDY_CELLS, LR_STUDY_STAGED) if what == "lr_study" else (CELLS, STAGED_CELLS)
    out = {}
    for name, kw in cells.items():
        runner = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=kw["num_subcarriers"] * 4 * CHUNK,
                                                     symbols_per_chunk=CHUNK)), dev)
        link, chunk_fn = runner.link, runner.kernel.chunk
        work = runner.kernel.workspace(link, CHUNK, dev)
        acc, psum = lk.new_accumulators(dev)
        snr_lin = lk.snr_linear(kw["snr_db"])

        def launch():
            chunk_fn(link, (3, 4), CHUNK, CHUNK, snr_lin, acc, psum, work)

        out[name] = median_ms(launch, reps, 20)
    for name, (kw, bump) in staged.items():
        try:
            launch = staged_cell(kw, bump, dev)
        except (TypeError, ValueError) as e:  # a stage the tree's chain does not have
            out[name] = f"skip: {type(e).__name__}"
            continue
        out[name] = "skip: eager" if launch is None else median_ms(launch, reps, 10)
    return out


def run_worker(tree, what, reps):
    # the tree's package first on sys.path, this script's cells and worker for both trees
    code = ("import importlib.util, json, sys; sys.path.insert(0, sys.argv[1]); "
            "spec = importlib.util.spec_from_file_location('port_ab', sys.argv[2] + '/port_ab.py'); "
            "ab = importlib.util.module_from_spec(spec); spec.loader.exec_module(ab); "
            "print(json.dumps(ab.worker(sys.argv[3], int(sys.argv[4]))))")
    done = subprocess.run([sys.executable, "-c", code, tree, HERE, what, str(reps)], capture_output=True, text=True,
                          cwd=tree, timeout=1200)
    if done.returncode != 0:
        raise RuntimeError(f"{what} in {tree} failed:\n{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def qam_registers(build_dir, libraries, staged):
    """{library:kernel key: registers} of the qam entry points of the plain
    chunk libraries, or with ``staged`` of the staged and noise-bump ones."""
    from chip_smoke import qam_registers as parse

    out = {}
    for lib in libraries:
        if lib.endswith(("_staged", "_bump")) != staged or lib == "boxmuller":
            continue
        with open(os.path.join(build_dir, f"{lib}.log")) as fh:
            out.update({f"{lib}:{k}": v for k, v in parse(fh.read()).items()})
    return out


def compare(builds, staged):
    """(qam entry points in both trees, {key: (other's registers, this one's)} where they differ)."""
    regs = {label: qam_registers(b["build_dir"], b["libraries"], staged) for label, b in builds.items()}
    common = sorted(set(regs["other"]) & set(regs["this"]))
    return len(common), {k: (regs["other"][k], regs["this"][k]) for k in common if regs["other"][k] != regs["this"][k]}


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
    common, moved = compare(builds, False)
    staged_common, staged_moved = compare(builds, True)
    print(f"qam entry points: {common} in both trees, {len(moved)} with other registers: {json.dumps(moved)}")
    print(f"staged qam entry points: {staged_common} in both trees, {len(staged_moved)} with other registers: "
          f"{json.dumps(staged_moved)}")
    print(f"build s: other {builds['other']['build_s']:.1f} ({len(builds['other']['libraries'])} libraries), "
          f"this {builds['this']['build_s']:.1f} ({len(builds['this']['libraries'])} libraries)")
    timings = []
    for label in ("other", "this", "this", "other"):
        t = run_worker(other if label == "other" else HERE, "lr_study" if "--lr-study" in argv else "time", reps)
        print(f"{label}: {json.dumps(t)}", flush=True)
        timings.append({"tree": label, "ms": t})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "qam_entry_points": common, "registers_moved": moved,
              "staged_qam_entry_points": staged_common, "staged_registers_moved": staged_moved,
              "build_s": {k: v["build_s"] for k, v in builds.items()}, "timings": timings}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
