"""A/B of two trees of the port on one CUDA card: registers and chunk times.

    python3 port_ab.py OTHER_TREE [--reps 3] [--lr-study | --slab-study | --bounds-study | --sampler-study |
                                   --lr-rows-study]

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The script builds both trees' kernel libraries, each in a process
of its own with its tree first on ``sys.path`` (this script's cells and
worker for both), and
compares the registers ptxas reports for every qam entry point that both
trees have, in the plain chunk libraries and apart in the staged ones,
and the counts each tree's diag chain gives (the noise-bump campaigns at
64 and 512 sc point by point, a waterfilling 512-sc run's BER and in-run
papr_db) and each WIDE_COUNT_CELLS run gives on fold_wide and mm_wide
(route, BER, papr_db), with the static block and warp barriers of both
trees' wide dense kernels, and the samplers' outputs in both trees: a hash
of K2's planes (ofdm_boxmuller at the moment gate's shape) and of K3's four
outputs (fold_probe / mm_probe on each PROBE_CELLS link at two symbols),
which must be equal, with the registers of K2's library and of the probes.
Then it times, at a 2^17-symbol chunk, the five qam cells'
chunk kernels (the headline link on diag, scfde_default on fold,
wide_1024sc and lr_1024sc_zp on lr, zp_64sc on mm; the diag chain's
adaptive_64sc (aqam), OFDM-CY1.0-512 and flat single-tap links at 1024,
2048 and 4096 sc (diag_wide, txext), a 300-sc link over the reference's
custom-channel demo IR and a 160-sc one; the lr zero-prefix chunk at 512 and
2048 subcarriers, lr_main's other group sizes; an SC-FDE link at each
other width the fold and mm kernels compile for, 32-256 subcarriers, with
a cyclic and a zero prefix; WIDE_DENSE_CELLS on fold_wide and mm_wide) and
the staged cells (a waterfilling link with both power switches on each
chain and on the two wide dense chains, and the
noise-bump study's chunk with all four stages on diag at 64, 512 and 1024
subcarriers, fold and mm; a cell a tree does not take reads "skip") in
four processes, in the order other, this, this, other; each time is the
median of ``reps`` timings of 20 launches by CUDA events (10 for the
staged cells).  With ``--lr-study`` it times the lr study's cells instead:
the lr chunk over the repo's channel models of E = 1, 3 and 5 at 1024
subcarriers (cyclic and zero prefix) and a short-CP link at 128, and the
staged 1024-sc lr chunks with the PAPR statistic on one tile in 128 (its
share of them).  With ``--slab-study`` it times instead the noise-bump
chunks of the diag chains at 64 and 512 sc with the one-pass scratch
capped at 2^22, 2^23, 2^24 and 2^26 bins a slab (a tree without the
one-pass scratch reads "skip").  With ``--bounds-study`` it times
BOUNDS_CELLS with fold_wide and mm_wide built at each BOUNDS minimum of
resident blocks (``OFDM_WIDE_MIN_BLOCKS``), this tree only.  With
``--sampler-study`` it builds and compares both trees' registers and
sampler hashes as above, then times only the samplers in the four
processes: K2's device time by CUDA events over back-to-back launches of
its entry point on fixed planes, and through ``boxmuller_sample``; K3's
device time by the profiler and its time through the wrapper by CUDA
events, on scfde_default (fold) and zp_64sc (mm).  With
``--lr-rows-study`` it builds only the lr library (``lr_kernel``) in both
trees, side by side, and times LR_ROWS_CELLS' lr chunks in the four
processes: the cost of how the kernel lists its factor rows (a 64-bit
mask in one tree, a row table in the other) on the 512-2048-sc lr cells.
Prints one JSON object as its last line.
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
# The reference's custom-channel demo IR (examples/custom_channel_demo.py, energy 1.22)
DEMO_IR = (1.0, 0.4 - 0.2j, 0.1 + 0.1j)
# A cell's config is SimulationConfig keywords; "adaptive_json" takes the
# reference's adaptive config at the cell's snr_db instead, "channel_ir" an IR.
# The fold and mm chains past 256 subcarriers (fold_wide, mm_wide): the audit's
# SC-FDE cells at 1024 and 512 sc (64-QAM, severe_multipath, 30 dB), a
# 300-sc single-tap link (the split DFT), single-tap zero-prefix OFDM at
# 1024 sc (OFDM's TX transform) and the reference's adaptive config on
# SC-FDE at 1024 sc (aqam, 20 dB).
AUDIT_SC = dict(HEADLINE, channel_model="severe_multipath", modulation_type="SC-OFDM")
_ASC = dict(adaptive_json="config/simulation_settings_adaptive.json", num_subcarriers=1024, snr_db=20.0,
            channel_model="severe_multipath", modulation_type="SC-OFDM")
WIDE_DENSE_CELLS = {
    "SC-CY1.0-1024": dict(AUDIT_SC, num_subcarriers=1024),
    "SC-ZE1.0-1024": dict(AUDIT_SC, num_subcarriers=1024, prefix_type="ZERO"),
    "SC-CY1.0-512": dict(AUDIT_SC, num_subcarriers=512),
    "SC-ZE1.0-512": dict(AUDIT_SC, num_subcarriers=512, prefix_type="ZERO"),
    "sc_flat_cp_300": dict(AUDIT_SC, num_subcarriers=300, channel_model="flat_fading", snr_db=20.0),
    "flat_zp_ofdm_1024": dict(HEADLINE, num_subcarriers=1024, prefix_type="ZERO", channel_model="flat_fading",
                              snr_db=20.0),
    "adaptive_scfde_1024sc": _ASC,
    "adaptive_scfde_1024sc_zp": dict(_ASC, prefix_type="ZERO"),
}
CELLS = {
    "headline_64sc": HEADLINE,
    "adaptive_64sc": dict(adaptive_json="config/simulation_settings_adaptive.json", num_subcarriers=64,
                          snr_db=20.0),
    "OFDM-CY1.0-512": dict(HEADLINE, num_subcarriers=512, channel_model="severe_multipath"),
    "custom_demo_300sc": dict(HEADLINE, num_subcarriers=300, snr_db=20.0, channel_ir=DEMO_IR),
    # diag_main at 5 bins a lane; diag_wide at 4, 8 and 16 bins a thread under txext
    "severe_160sc": dict(HEADLINE, num_subcarriers=160, channel_model="severe_multipath"),
    **{f"flat_fading_cp_{n}sc": dict(HEADLINE, num_subcarriers=n, channel_model="flat_fading", snr_db=20.0)
       for n in (1024, 2048, 4096)},
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
    **WIDE_DENSE_CELLS,
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
    # the wide dense chains with apply_power + normalize
    "wf_SC-CY1.0-1024": (dict(WIDE_DENSE_CELLS["SC-CY1.0-1024"], **_WF), False),
    "wf_SC-ZE1.0-1024": (dict(WIDE_DENSE_CELLS["SC-ZE1.0-1024"], **_WF), False),
}
# The cells whose runs' counts both trees must give alike (wide_counts).
WIDE_COUNT_CELLS = {**WIDE_DENSE_CELLS, **{k: STAGED_CELLS[k][0] for k in ("wf_SC-CY1.0-1024", "wf_SC-ZE1.0-1024")}}
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
# --lr-rows-study: the plain lr chunks at 512-2048 subcarriers (the lr library alone)
LR_ROWS_CELLS = {k: CELLS[k] for k in ("wide_1024sc", "lr_1024sc_zp", "lr_512sc_zp", "lr_2048sc_zp")}
LR_STUDY_STAGED = {
    "wf_wide_1024sc_papr1": (dict(WIDE, **_WF, papr_stride=128), False),
    "bump_study_1024sc_papr1": (dict(HEADLINE, **_NB, num_subcarriers=1024, papr_stride=128), True),
}


# The samplers: K2 at the moment gate's shape and seeds (chip_smoke.py's
# NOISE_SHAPE / NOISE_SEEDS), K3 on fold and mm links at every width their
# chunk kernels compile for, in qam, aqam and with apply_power, at two
# symbols (run symbol 0's chunk and one past 2^32).
NOISE_SHAPE = (1 << 15, 128)
NOISE_SEEDS = (987654321, 123456789)
PROBE_SYM0 = (0, (1 << 32) + 77)
PROBE_CELLS = {
    **{k: CELLS[k] for k in ("scfde_default", "zp_64sc")},
    **{f"scfde_{n}sc": CELLS[f"scfde_{n}sc"] for n in (32, 96, 128, 160, 192, 224, 256)},
    **{f"scfde_zp_{n}sc": CELLS[f"scfde_zp_{n}sc"] for n in (96, 128, 192, 256)},
    "adaptive_scfde_64sc": dict(_ASC, num_subcarriers=64),
    "wf_scfde_default": STAGED_CELLS["wf_scfde_default"][0],
    "wf_zp_64sc": STAGED_CELLS["wf_zp_64sc"][0],
}
PROBE_TIMED = ("scfde_default", "zp_64sc")


def _probe_of(runner):
    """(K3 wrapper, rows) of a fold or mm runner: rows sqrt(P) under apply_power."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    probe = {"fold": fk.fold_probe, "mm": mmk.mm_probe}[runner.mode]
    rows = None
    if runner.link.apply_power:
        rows = np.sqrt(runner.point_params(runner.setup.cfg.snr_db)[0])[None]
        rows = torch.tensor(rows, dtype=torch.float32, device=runner.link.hr.device)
    return probe, rows


def sampler_hashes(dev):
    """sha256 of K2's planes and of each PROBE_CELLS link's K3 outputs at
    PROBE_SYM0 in this tree, with the route."""
    import hashlib

    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng

    def digest(ts):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:20]

    out = {"boxmuller": digest(lk.boxmuller_sample(*NOISE_SEEDS, NOISE_SHAPE, dev))}
    key = prng.key_words(0)
    for name, kw in PROBE_CELLS.items():
        runner = runner_for(kw, dev)
        probe, rows = _probe_of(runner)
        out[name] = [runner.mode, runner.link.q.mode] + [digest(probe(runner.link, key, s, CHUNK, rows))
                                                        for s in PROBE_SYM0]
    return out


def device_ms(fn, name, launches):
    """Mean device ms a launch of the kernel ``name`` over ``launches`` calls
    of fn, from the profiler's kernel events (None when it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return None if len(spans) != launches else sum(spans) / launches / 1e3


def sampler_times(dev, reps):
    """K2's device time (CUDA events over 50 back-to-back launches of
    ofdm_boxmuller on fixed planes: its host call is a few microseconds) and
    its time through boxmuller_sample; K3's device time (profiler, 200
    launches) and time through the wrapper (CUDA events, 1000 calls) on
    PROBE_TIMED."""
    import torch

    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng

    lib = build.load("boxmuller")
    count = NOISE_SHAPE[0] * NOISE_SHAPE[1]
    z0 = torch.empty(count, dtype=torch.float32, device=dev)
    z1 = torch.empty(count, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw():
        build.check(lib, lib.ofdm_boxmuller(z0.data_ptr(), z1.data_ptr(), count, *NOISE_SEEDS, stream),
                    "ofdm_boxmuller")

    out = {"boxmuller_device": median_ms(raw, reps, 50),
           "boxmuller_profiler": device_ms(raw, "boxmuller_kernel", 50),
           "boxmuller_wrapper": median_ms(lambda: lk.boxmuller_sample(*NOISE_SEEDS, NOISE_SHAPE, dev), reps, 50)}
    key = prng.key_words(0)
    for name in PROBE_TIMED:
        runner = runner_for(PROBE_CELLS[name], dev)
        probe, rows = _probe_of(runner)
        link = runner.link

        def call():
            probe(link, key, CHUNK, CHUNK, rows)

        out[f"{runner.mode}_probe_device"] = device_ms(call, f"{runner.mode}_probe", 200)
        out[f"{runner.mode}_probe_wrapper"] = median_ms(call, reps, 1000)
    return out


def ptxas_registers(build_dir, lib, match):
    """{kernel key: registers} of library ``lib``'s kernels whose key holds ``match``."""
    from chip_smoke import ptxas_kernels

    with open(os.path.join(build_dir, f"{lib}.log")) as fh:
        return {k: v[0] for k, v in ptxas_kernels(fh.read()).items() if match in k}


# --slab-study: the one-pass scratch's slab cap (bins) on the diag noise-bump chunks
SLAB_BINS = (1 << 22, 1 << 23, 1 << 24, 1 << 26)
SLAB_CELLS = {n: STAGED_CELLS[f"bump_study_{n}sc"][0] for n in (64, 512)}


def runner_for(kw, dev, chunks=4):
    """A LinkRunner of a cell at ``chunks`` chunks of CHUNK OFDM symbols (``CELLS``' keys)."""
    import numpy as np

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    kw = dict(kw)
    ir = kw.pop("channel_ir", None)
    path = kw.pop("adaptive_json", None)
    if path is not None:
        cfg = {c.snr_db: c for c in SimulationConfig.from_json(os.path.join(HERE, path))}[kw.pop("snr_db")]
        cfg = cfg.replace(num_symbols=chunks * CHUNK, symbols_per_chunk=CHUNK, **kw)
    else:
        cfg = SimulationConfig(**kw, num_symbols=kw["num_subcarriers"] * chunks * CHUNK, symbols_per_chunk=CHUNK)
    return LinkRunner(prepare(cfg, channel_ir=None if ir is None else np.asarray(ir)), dev)


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

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk

    runner = runner_for(kw, dev)
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


def diag_counts(dev):
    """The diag chain's counts in this tree: the noise-bump study's fused
    campaign at 64 sc (21 points x 2^24 OFDM symbols) and 512 sc (2^20), BER
    by point, and a 512-sc waterfilling link's run (2^20; apply_power, so
    the PAPR statistic is in the run): BER and papr_db."""
    import tempfile

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    out = {}
    snrs = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
    with tempfile.TemporaryDirectory() as tmp:
        for n, symbols in ((64, 1 << 24), (512, 1 << 20)):
            res = nb.run_noise_bump_experiment(snrs, num_subcarriers=n, fused_symbols_per_point=symbols,
                                               results_dir=tmp, seed=42, chunk=CHUNK)
            out[f"noise_bump_{n}sc"] = res
    kw = dict(STAGED_CELLS["wf_headline_64sc"][0], num_subcarriers=512)
    r = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=512 << 20, symbols_per_chunk=CHUNK)), dev).run(0)
    out["wf_512sc"] = {"bit_error_rate": r["bit_error_rate"], "papr_db": r["papr_db"],
                       "papr_estimator": r["papr_estimator"]}
    return out


def wide_counts(dev):
    """Each WIDE_COUNT_CELLS cell's run through LinkRunner in this tree (8
    chunks of CHUNK OFDM symbols, seed 0): the route, BER and papr_db."""
    out = {}
    for name, kw in WIDE_COUNT_CELLS.items():
        runner = runner_for(kw, dev, chunks=8)
        r = runner.run(0)
        out[name] = {"mode": runner.mode, "bit_error_rate": r["bit_error_rate"], "papr_db": r["papr_db"]}
    return out


def sass_barriers(build):
    """{library: {kernel key: static BAR, WARPSYNC}} of a tree's wide dense
    libraries' qam kernels (``chip_smoke.sass_barriers``)."""
    from chip_smoke import sass_barriers as count

    out = {}
    for lib, path in build["wide_libraries"].items():
        out[lib] = {k: v for k, v in count(path).items() if k.split("+")[0].endswith(",0>")}
    return out


def slab_study(dev, reps):
    """The diag noise-bump chunks at 64 and 512 sc at each SLAB_BINS cap."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    out = {}
    for n, kw in SLAB_CELLS.items():
        for bins in SLAB_BINS:
            if not hasattr(lk, "ONEPASS_SLAB_BINS"):
                out[f"bump_study_{n}sc_slab{bins}"] = "skip: no one-pass scratch"
                continue
            lk.ONEPASS_SLAB_BINS = bins
            out[f"bump_study_{n}sc_slab{bins}"] = median_ms(staged_cell(kw, True, dev), reps, 10)
    return out


# --bounds-study: the wide dense mains' __launch_bounds__ minimum blocks an SM
BOUNDS = (4, 3, 5, 4)
BOUNDS_CELLS = ("SC-CY1.0-1024", "SC-ZE1.0-1024", "SC-CY1.0-512", "SC-ZE1.0-512", "adaptive_scfde_1024sc",
                "adaptive_scfde_1024sc_zp")


def bounds_study(dev, reps):
    """BOUNDS_CELLS' chunks with fold_wide and mm_wide built at each BOUNDS
    value of OFDM_WIDE_MIN_BLOCKS (the plain builds, all compiled at once),
    in BOUNDS' order, with each variant's mains' registers, local bytes and
    blocks an SM at the cell's width."""
    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.ops import link_kernel as lk

    names = {}
    for mb in sorted(set(BOUNDS)):
        for chain in ("fold_wide", "mm_wide"):
            names[chain, mb] = f"{chain}_minblocks{mb}"
            build.LIBRARIES[names[chain, mb]] = (f"{chain}_kernel", (f"-DOFDM_WIDE_MIN_BLOCKS={mb}",))
    build.build(list(names.values()))
    load = build.load
    out = {}
    for i, mb in enumerate(BOUNDS):
        build.load = lambda name, mb=mb: load(names.get((name, mb), name))
        try:
            for name in BOUNDS_CELLS:
                runner = runner_for(CELLS[name], dev)
                link = runner.link
                work = runner.kernel.workspace(link, CHUNK, dev)
                acc, psum = lk.new_accumulators(dev)
                snr_lin = lk.snr_linear(runner.setup.cfg.snr_db)
                ms = median_ms(lambda: runner.kernel.chunk(link, (3, 4), CHUNK, CHUNK, snr_lin, acc, psum, work),
                               reps, 20)
                geo = lk.wide_geometry(runner.mode, link.n, link.T, link.E, link.plan.log2n)
                out[f"{name}_minblocks{mb}_{i}"] = {"ms": ms, "main": geo["main"]}
        finally:
            build.load = load
    return out


def worker(what, reps):
    """In a tree's own process: build its libraries, read its diag counts
    (``what`` "counts"), or time its cells ("time"), the lr study's
    ("lr_study") or the slab study's ("slab_study")."""
    import torch

    from ofdm_tpu_torch import build

    if what == "build_lr":
        t0 = time.perf_counter()
        build.build(["lr_kernel"])
        return {"build_s": time.perf_counter() - t0}
    if what == "build":
        t0 = time.perf_counter()
        build.build(build.SOURCES)
        wide = [n for n in build.SOURCES if n.startswith(("fold_wide", "mm_wide"))]
        return {"build_s": time.perf_counter() - t0, "build_dir": build.BUILD_DIR, "libraries": list(build.SOURCES),
                "wide_libraries": {n: build.library_path(n) for n in wide}}
    from ofdm_tpu_torch.ops import link_kernel as lk

    dev = torch.device("cuda")
    if what == "counts":
        return {**diag_counts(dev), "wide": wide_counts(dev)}
    if what == "sampler_hashes":
        return sampler_hashes(dev)
    if what == "sampler_times":
        return sampler_times(dev, reps)
    if what == "slab_study":
        return slab_study(dev, reps)
    if what == "bounds_study":
        return bounds_study(dev, reps)
    cells, staged = {"lr_study": (LR_STUDY_CELLS, LR_STUDY_STAGED),
                     "lr_rows": (LR_ROWS_CELLS, {})}.get(what, (CELLS, STAGED_CELLS))
    out = {}
    for name, kw in cells.items():
        runner = runner_for(kw, dev)
        link, chunk_fn = runner.link, runner.kernel.chunk
        work = runner.kernel.workspace(link, CHUNK, dev)
        acc, psum = lk.new_accumulators(dev)
        snr_lin = lk.snr_linear(runner.setup.cfg.snr_db)

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
    if "--bounds-study" in argv:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        result = {"card": card, "bounds_study": run_worker(HERE, "bounds_study", reps)}
        for k, v in result["bounds_study"].items():
            print(f"{k}: {json.dumps(v)}")
        print(json.dumps(result))
        return 0
    if "--lr-rows-study" in argv:
        return lr_rows_study(other, reps)
    builds = {label: run_worker(tree, "build", reps) for label, tree in (("other", other), ("this", HERE))}
    common, moved = compare(builds, False)
    staged_common, staged_moved = compare(builds, True)
    print(f"qam entry points: {common} in both trees, {len(moved)} with other registers: {json.dumps(moved)}")
    print(f"staged qam entry points: {staged_common} in both trees, {len(staged_moved)} with other registers: "
          f"{json.dumps(staged_moved)}")
    outside = {k: v for k, v in {**moved, **staged_moved}.items() if "_probe<" not in k}
    print(f"qam entry points outside the probes with other registers: {json.dumps(outside)}")
    # K3's narrow probes and K2's library (K4 and K5 beside it) in both trees, by kernel key
    sampler_regs = {label: {**{f"{lib}:{k}": r for lib in ("fold_kernel", "fold_staged", "mm_kernel", "mm_staged")
                               for k, r in ptxas_registers(b["build_dir"], lib, "_probe<").items()},
                            **{f"boxmuller:{k}": r for k, r in ptxas_registers(b["build_dir"], "boxmuller", "").items()}}
                    for label, b in builds.items()}
    for label, regs in sampler_regs.items():
        print(f"sampler registers {label}: {json.dumps(regs)}")
    hashes = {label: run_worker(tree, "sampler_hashes", reps) for label, tree in (("other", other), ("this", HERE))}
    for label, h in hashes.items():
        print(f"sampler hashes {label}: {json.dumps(h)}")
    hashes_equal = {k: hashes["other"].get(k) == v for k, v in hashes["this"].items()}
    print(f"sampler hashes equal in both trees: {json.dumps(hashes_equal)}")
    print(f"build s: other {builds['other']['build_s']:.1f} ({len(builds['other']['libraries'])} libraries), "
          f"this {builds['this']['build_s']:.1f} ({len(builds['this']['libraries'])} libraries)")
    sampler_timings = []
    for label in ("other", "this", "this", "other"):
        t = run_worker(other if label == "other" else HERE, "sampler_times", reps)
        print(f"samplers {label}: {json.dumps(t)}", flush=True)
        sampler_timings.append({"tree": label, "ms": t})
    result = {"qam_entry_points": common, "registers_moved": moved, "staged_qam_entry_points": staged_common,
              "staged_registers_moved": staged_moved, "registers_moved_outside_the_probes": outside,
              "sampler_registers": sampler_regs, "sampler_hashes": hashes, "sampler_hashes_equal": hashes_equal,
              "sampler_timings": sampler_timings, "build_s": {k: v["build_s"] for k, v in builds.items()}}
    if "--sampler-study" not in argv:
        result.update(chunk_study(argv, other, builds, reps))
    result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


def lr_rows_study(other, reps):
    """``--lr-rows-study``: both trees' lr library built side by side, then
    LR_ROWS_CELLS timed in the order other, this, this, other."""
    from concurrent.futures import ThreadPoolExecutor

    trees = (("other", other), ("this", HERE))
    with ThreadPoolExecutor(2) as pool:
        builds = dict(zip((t[0] for t in trees), pool.map(lambda t: run_worker(t[1], "build_lr", reps), trees)))
    print(f"lr build s: {json.dumps({k: v['build_s'] for k, v in builds.items()})}")
    timings = []
    for label in ("other", "this", "this", "other"):
        t = run_worker(other if label == "other" else HERE, "lr_rows", reps)
        print(f"{label}: {json.dumps(t)}", flush=True)
        timings.append({"tree": label, "ms": t})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "build_s": {k: v["build_s"] for k, v in builds.items()}, "timings": timings}))
    return 0


def chunk_study(argv, other, builds, reps):
    """The wide dense kernels' static barriers, both trees' counts and the
    chunk timings (or the lr / slab study's), in turns."""
    barriers = {label: sass_barriers(b) for label, b in builds.items()}
    for label, b in barriers.items():
        print(f"wide static barriers {label}: {json.dumps(b)}")
    counts = {label: run_worker(tree, "counts", reps) for label, tree in (("other", other), ("this", HERE))}
    for label, c in counts.items():
        print(f"diag counts {label}: {json.dumps(c)}")
    same = {k: counts["other"][k] == counts["this"][k] for k in counts["this"] if k.startswith("noise_bump")}
    papr_gap = abs(counts["other"]["wf_512sc"]["papr_db"] - counts["this"]["wf_512sc"]["papr_db"])
    # the route and BER exactly; papr_db's PAPR sum is a double atomicAdd whose
    # last digits follow the blocks' order, so within 1e-9 dB
    wide_same = {k: counts["other"]["wide"][k]["mode"] == v["mode"]
                 and counts["other"]["wide"][k]["bit_error_rate"] == v["bit_error_rate"]
                 and abs(counts["other"]["wide"][k]["papr_db"] - v["papr_db"]) < 1e-9
                 for k, v in counts["this"]["wide"].items()}
    print(f"wide dense counts equal in both trees (route, BER; papr_db within 1e-9 dB): {json.dumps(wide_same)}")
    print(f"diag counts: noise-bump points equal {json.dumps(same)}; wf_512sc BER equal "
          f"{counts['other']['wf_512sc']['bit_error_rate'] == counts['this']['wf_512sc']['bit_error_rate']}, "
          f"papr_db gap {papr_gap:.6f} dB")
    mode = "lr_study" if "--lr-study" in argv else "slab_study" if "--slab-study" in argv else "time"
    timings = []
    for label in ("other", "this", "this", "other"):
        t = run_worker(other if label == "other" else HERE, mode, reps)
        print(f"{label}: {json.dumps(t)}", flush=True)
        timings.append({"tree": label, "ms": t})
    return {"diag_counts": counts, "noise_bump_points_equal": same, "wf_512sc_papr_db_gap": papr_gap,
            "wide_counts_equal": wide_same, "wide_static_barriers": barriers, "timings": timings}


if __name__ == "__main__":
    sys.exit(main(sys.argv))
