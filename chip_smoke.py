"""Smoke test of the PyTorch port on one CUDA card: build, check, run, measure.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; imports nothing of JAX or of the JAX package.
It builds the port's kernels from ``ofdm_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, and drives five paths
through ``prepare()`` -> ``LinkRunner.run()``: the headline link (64
subcarriers, 64-QAM, CP ratio 1.0, MMSE, Lin-Phoong P2, AWGN 30 dB; the
diag kernel) and the reference's default SC-FDE link (64 subcarriers,
QPSK, CP ratio 1.0, ZF, Lin-Phoong P1, AWGN 10 dB; the fold kernel) with
2^27 OFDM symbols each, cut from bench.py's 2^31 and 2^29; then bench.py's
two 1024-subcarrier cells through the lr kernel (64-QAM, severe_multipath,
MMSE, AWGN 30 dB): ``wide_1024sc`` (CP ratio 1.0) on 2^26 symbols, cut
from bench.py's 2^27, and ``lr_1024sc_zp`` (zero prefix, ratio 1.0) on
bench.py's own 2^26; then ``zp_64sc``, the headline link with a zero
prefix (the published campaign's ZP-OFDM MMSE link at guard 1.0; the mm
kernel) on 2^27 symbols, and the campaign's 16 CP/ZP x ZF/MMSE x guard
cells on 2^20 symbols each; then the new constellation modes (8-PSK,
adaptive QAM and adaptive PSK) on all four chunk kernels, and
``adaptive_64sc``, the reference's adaptive-modulation link
(config/simulation_settings_adaptive.json at 20 dB: 64 subcarriers,
Lin-Phoong P1, CP ratio 1.0, MMSE, waterfilling, CAPACITY_BASED QAM 4-256;
the diag kernel in aqam mode) on 2^26 OFDM symbols, its 15 / 25 dB points
and the JAX package's audit links' BER bands on 2^20 symbols each; then
the power stages: each staged kernel (``apply_power`` and ``normalize``
on a waterfilling link of every chain and on the adaptive link, the
noise-bump chunk, and two IRs without unit energy on the plain diag
kernel) against its plain version, the noise-bump study's fused campaign
(``run_noise_bump_experiment``: the JAX package's ``_FusedLink``
configuration, 3 scenarios x 7 SNR points at 2^24 OFDM symbols a point,
through the diag kernel with all four stages) and one waterfilling link
a chain with both switches through ``LinkRunner``; then K5 (the
normal-pair kernel) and K4's plane form against their plain versions and
the moment gate, symbol capture (``run(collect_symbols=4096)``) through
each chain's dump stage on seven links and once over a whole 2^17-symbol
chunk, the eager chain (the links no kernel takes: three of
tools/shape_audit.py's shapes, a 1024-sc flat channel, the headline with
hotpath "xla") at 2^20 OFDM symbols each, and the noise-bump study's
eager-only campaign (``_Link``, 21 points x 2048 OFDM symbols); then the
noise-bump stages on the fold, lr and mm kernels (each staged chunk with
all four stages against its plain version on five links) and the diag
chain past 256 subcarriers (``diag_wide`` against its plain version on
three links in qam, aqam and 8-PSK, an IR without unit energy, the
study's 512-sc link, two captures; the audit's two cells it takes from
the eager chain through ``LinkRunner``), and the study's fused campaign
at 512 sc (``diag_wide``) and 1024 sc (lr), 3 scenarios x 7 SNR points
at 2^20 OFDM symbols a point, each point at z = 5 against the JAX
package's ``_Link`` at that width; then the fold and zero-prefix mm
chains past 256 subcarriers (``fold_wide`` and ``mm_wide`` against their
plain versions on ten links at sym0 = 0 and 2^32 + 77, with apply_power +
normalize, with the noise-bump stages, a capture a chain, K3 on three
links) and the audit's ``SC-CY1.0-1024`` and ``SC-ZE1.0-1024`` at 30 and
20 dB through ``LinkRunner`` (2^20 OFDM symbols each, z = 5 against the
JAX package's XLA readings), which ran on the eager chain; then adaptive
SC-FDE on those chains (``adaptive_scfde``: the reference's adaptive
config with "modulation_type": "SC-OFDM", each kernel in aqam or apsk
against its plain version on eight links at 64-1024 sc with its staged,
bump, dump and K3 checks, the router over the adaptive SC-FDE grid, and
the cells ``adaptive_scfde_64sc`` through ``run_sweep`` at 15 / 20 / 25 dB
(2^24 OFDM symbols a point), ``adaptive_scfde_64sc_zp`` (mm, 2^22) and
``adaptive_scfde_1024sc`` / ``_zp`` (fold_wide, mm_wide; 2^20), each at
z = 5 against the JAX package's XLA reading (on fold with the fold
kernel's measured power), beside the eager chain's rate on the same
link); then two chains built by hand from the bit-level ops
(``bitlevel_path``: ``bitlevel_headline``, the headline link's parameters
through bits.random_bits -> mapping.encode -> linops.modulate / convolve ->
channel.awgn -> linops.demodulate -> equalize -> decode_bits, and
``bitlevel_adaptive``, examples/overview.py's adaptive chain; 2^20 OFDM
symbols x 64 sc each in blocks of 2^16, K4 under random_bits and K5 for the
AWGN, random_bits on the card bit-equal to its CPU version at 2^24 and
1,000,003 bits and at each chain's block, each BER at z = 5 against the
JAX package's own chain) and the shape audit
(``ofdm_tpu_torch.shape_audit``: tools/shape_audit.py's 30 shapes and two
more through ``LinkRunner``, each on the chain the JAX package's plan
picks, in its z = 5 band).  For each path it checks the BER gate or band,
the SNR sweep and the launch counters, reads the profiler's busy share,
and times the kernel beside its plain version and its bound; for the fold
and mm kernels it also reads their layout off the loaded kernels (symbols
a group, warps, registers, shared memory, blocks an SM) and checks it at
every width they take; for the diag kernels (``diag_layout``) it prints
their layout, the static SASS of diag_main, power_partials, the one-pass
front and diag_demap by pipe (``cuobjdump -sass``) and the headline
chunk's pipe-aware bound, and it times diag_demap, the one-pass
normalize's counting kernel, on the noise-bump links at 64 and 512 sc.
Any failed check raises.

Then K3, the carry probe, against its plain version and the chunk
kernels' carry row on 14 links, and the chunks' carry-in; the sharded runs
(``ShardedLinkRunner`` on a one-rank NCCL mesh in both stream modes, the
wide fold and mm links among them, two ranks on the card under gloo
against the shards' single-process runs and a chained emulation) and the
CLI (``python -m ofdm_tpu_torch``) on the reference's default, adaptive
and pod-scale configs and on the adaptive one on SC-FDE.  Last, the
examples and tools (``examples_path``): every module of
``ofdm_tpu_torch.examples`` through its ``main()`` at the JAX script's
size in a temporary directory, each link on the card and inside z = 5
of the JAX script's reading, the parity report with its guard grid free
of MISMATCH, the noise-bump example inside its gates with its PNGs drawn
(PIL without matplotlib), then the live watcher, the channel plot,
``trace()`` around a headline run and ``ThroughputMeter``.  Before K3,
the giant path (``giant_path``): the lr and diag chains past 4096
subcarriers (thread-block clusters), past 63 tail lanes and noise rank
128, and ``mm_wide`` on the JAX plan's "taps" link, against their plain
versions and end to end through ``LinkRunner``.

    python3 chip_smoke.py --nccl-ranks 4

runs only the sharded runs, on four cards under NCCL (one rank a card);
``--examples-only`` the build and the examples and tools;
``--giant-only`` the build of the giant path's libraries and the giant
path; ``--factor-seconds N`` times the host factorization of the giant
path's severe_multipath CP 0.5 link at N subcarriers.

Output: findings on earlier lines; then the kernels JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

T_SCRIPT = time.perf_counter()  # the script's start: main's clock misses the torch import and CUDA start
from ofdm_tpu_torch.shape_audit import AUDIT_BASE  # the audit's base link (64 sc, severe_multipath, 30 dB)

REFERENCE_BER_30DB = 0.01901  # the reference's published BER (bench.py gate)
# The reference's SC-FDE default at 0/10/20 dB (docs/RESULTS.md) and the JAX
# package's reading of it on a TPU v5e (BENCH_r05.json, 2^29 symbols).
REFERENCE_SCFDE_BER = {0.0: 0.246083, 10.0: 0.0145, 20.0: 0.0}
TPU_V5E_SCFDE_BER_10DB = 0.0143092158541549
MAIN_SYMBOLS = 1 << 27
MAIN_CHUNK = 1 << 17
MAIN_SEED = 0
CHECK_SYMBOLS = 1 << 14
NOISE_SHAPE = (1 << 15, 128)
NOISE_SEEDS = (987654321, 123456789)  # bench.py's moment-gate seeds
BOXMULLER_COUNTS = ((4194301,), (5,))  # K2's scalar tail: 1 element past the quads; 1 quad and 1 element
# One operation per lane per clock: 132 SMs x 128 fp32 lanes x 1.98 GHz,
# half the 67 TFLOP/s float32 rate, which counts an FMA as two (H100 SXM
# data sheet).  bytes: 3.35 TB/s HBM3.
PEAK_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6  # the H100's 50 MB L2 (the same data sheet)
# Operations per bin of the diag chunk, counted from csrc/link_kernel.cu:
# Philox4x32-10 = 10 rounds x (2 mulhi + 2 mul + 4 xor + 2 key adds);
# QAM encode (zig-zag, Gray, int->float, affine); y = s*h; Box-Muller
# (uniform, logf ~20, sqrtf ~8, two degree-5 Horner chains and the
# quadrant select); MMSE (|y|^2, the per-symbol butterfly share, the IEEE
# divide ~10, the equalizer); slicer (round, clip, convert, inverse Gray,
# zig-zag); popcount and counters.
OPS_PER_BIN = {
    "philox": 100, "encode": 21, "channel": 6, "noise": 72, "mmse": 24,
    "demap": 26, "count": 5,
}
# The measured power needs |y|^2 and its sum on each tile's slice (per bin);
# the PAPR statistic |x|^2, its max and its sum (per time sample).
POWER_SUM_OPS = 4
PAPR_OPS = 5
# bench.py's lr cells: the BER gate and the JAX package's readings of it on a
# TPU v5e (BENCH_r05.json; docs/RESULTS.md:99-112, the pod-scale sweep).
LR_SYMBOLS = 1 << 26
LR_BER_30DB = 3.73e-6
LR_BER_TOL = 2e-7
TPU_V5E_WIDE_BER = {"BENCH_r05": 3.7284e-06, "docs/RESULTS.md:112": 3.72e-06}
TPU_V5E_ZP_BER = 3.7304e-06
TPU_V5E_WIDE_SWEEP = {0.0: 0.402, 10.0: 0.187, 20.0: 0.0212, 30.0: 3.72e-6}
SWEEP_SYMBOLS = 1 << 20
U32_CHECK_WORDS = 1 << 22
U32_TIMED_LAUNCHES = 100
# The published campaign (docs/OFDM-Based Systems.tex:199-264; docs/RESULTS.md:42-59):
# 64 sc, 64-QAM, Lin-Phoong P2, 30 dB, CP/ZP x ZF/MMSE x guard ratio, as
# (the JAX package's reading on a TPU v5e, the seeded reference value).
CAMPAIGN = {
    ("CYCLIC", "ZF", 0.34): (0.041078, 0.041035), ("CYCLIC", "ZF", 0.68): (0.026662, 0.026598),
    ("CYCLIC", "ZF", 1.0): (0.018672, 0.018704), ("CYCLIC", "ZF", 1.34): (0.018672, 0.018632),
    ("CYCLIC", "MMSE", 0.34): (0.041089, 0.041083), ("CYCLIC", "MMSE", 0.68): (0.026841, 0.026817),
    ("CYCLIC", "MMSE", 1.0): (0.019000, 0.019054), ("CYCLIC", "MMSE", 1.34): (0.019000, 0.019021),
    ("ZERO", "ZF", 0.34): (0.041211, 0.040943), ("ZERO", "ZF", 0.68): (0.026800, 0.026517),
    ("ZERO", "ZF", 1.0): (0.018818, 0.018671), ("ZERO", "ZF", 1.34): (0.018822, 0.018709),
    ("ZERO", "MMSE", 0.34): (0.041219, 0.040941), ("ZERO", "MMSE", 0.68): (0.026954, 0.026777),
    ("ZERO", "MMSE", 1.0): (0.019113, 0.019049), ("ZERO", "MMSE", 1.34): (0.019109, 0.019078),
}
CAMPAIGN_SYMBOLS = 1 << 20
CAMPAIGN_TOL = 1.5e-3


def kernel_key(mangled):
    """'diag_main<2,0>' for the mangled name of a kernel template of this
    repo (namespace::kernel<int and bool arguments>), the bool arguments
    dropped while all are false (kStaged, kDump in the plain builds), so the
    plain build's keys match across sources that add one; a variant with a
    true bool gets them as a suffix without its trailing false ones
    ('fold_main<2,0>+001': the carry-in; 'lr_main<4,0>+1': the staged
    build's), so a key stays when a source adds a defaulted bool after them."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    pos, names = 3, []
    while pos < len(mangled) and mangled[pos].isdigit():
        num = re.match(r"\d+", mangled[pos:]).group(0)
        pos += len(num)
        names.append(mangled[pos : pos + int(num)])
        pos += int(num)
    args = re.match(r"I((?:L[ib]\d+E)+)", mangled[pos:])  # the int and bool arguments, before any type
    ints = re.findall(r"Li(\d+)E", args.group(1)) if args else []
    bools = re.findall(r"Lb(\d)E", args.group(1)) if args else []
    suffix = "+" + "".join(bools).rstrip("0") if "1" in bools else ""
    return f"{names[-1]}<{','.join(ints)}>{suffix}"


def qam_registers(log_text):
    """{kernel key: registers} of the qam instantiations in a ptxas -v log
    (the mode is the last int argument: 0 is qam)."""
    return {k: regs for k, (regs, _) in sorted(ptxas_kernels(log_text).items())
            if k.split("+")[0].endswith((",0>", "<0>"))}


# Lane operations a clock of one H100 SM on each pipe of the SASS the
# kernels compile to (the CUDA C++ Programming Guide's arithmetic throughput
# table, compute capability 9.0): fp32 add / multiply; the integer ALU
# (add, logic, shift, compare, select, min / max, IMAD, moves); int <->
# float and f32 rounding conversions; the special-function unit (MUFU: lg2,
# sqrt, rcp); popcount and bit scans; warp shuffles; loads and stores.
# Control and uniform-datapath instructions count only toward issue (four
# schedulers of 32 lanes a clock).  1.98 GHz x 132 SMs, as PEAK_OPS.
PIPE_RATE = {"fp32": 128, "int": 64, "conv": 16, "mufu": 16, "popc": 16, "shfl": 32, "mem": 32, "other": 128}
SM_CLOCKS = 132 * 1.98e9
_PIPE_OPS = {
    "fp32": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"),
    "int": ("IMAD", "IADD3", "IADD32I", "LOP3", "LOP32I", "SHF", "SHL", "SHR", "ISETP", "IMNMX", "VIMNMX", "LEA",
            "SEL", "FSEL", "FSETP", "FMNMX", "PLOP3", "MOV", "MOV32I", "PRMT", "IABS", "BMSK", "SGXT", "P2R", "R2P",
            "IMUL", "ISCADD", "FCHK", "IDP", "HADD2", "HMUL2", "HFMA2"),
    "conv": ("F2I", "I2F", "F2F", "I2FP", "F2FP", "FRND", "I2I"),
    "mufu": ("MUFU",),
    "popc": ("POPC", "FLO", "BREV"),
    "shfl": ("SHFL",),
    "mem": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMG", "ATOMS", "RED", "LDL", "STL", "LDSM"),
}
_PIPE_OF = {op: pipe for pipe, ops in _PIPE_OPS.items() for op in ops}
# Philox4x32-10's second multiplier, as SASS may print it (unsigned or as
# a negative immediate): each round multiplies by it once.
PHILOX_MARKS = ("0xcd9e8d57", "-0x326172a9")


def sass_counts(library_path, bins_per_pass):
    """{kernel key: counts} of the static SASS (``cuobjdump -sass``) of the
    kernels of a built library named in ``bins_per_pass`` ({kernel key: bins
    one pass of its outermost loop handles}): instructions by pipe
    (PIPE_RATE's classes) over the whole function (``function``), over the
    body of its outermost loop without the loops nested in it (``loop``:
    one pass, the tile-sigma and PAPR loops left out) and that per bin
    (``per_bin``), with ``philox``, the Philox4x32-10 calls of the pass (the
    body's instructions that name PHILOX_MARKS, over the ten rounds a call).
    A static count: every branch of the body counts, taken or not."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        key = kernel_key(block.split()[0])
        if key not in bins_per_pass:
            continue
        ins = [(int(m.group(1), 16), m.group(2), m.group(0)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)[^;]*;", block)]
        back = []  # backward branches: (target, address)
        for addr, op, txt in ins:
            hit = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", txt) if op == "BRA" else None
            if hit and int(hit.group(1), 16) < addr:
                back.append((int(hit.group(1), 16), addr))
        lo, hi = min(back, key=lambda b: b[0] - b[1]) if back else (0, -1)
        nested = [(t, a) for t, a in back if lo <= t and a <= hi and (t, a) != (lo, hi)]

        def count(sel):
            pipes = dict.fromkeys(PIPE_RATE, 0)
            for addr, op, _ in sel:
                pipes[_PIPE_OF.get(op, "other")] += 1
            return pipes

        body = [i for i in ins if lo <= i[0] <= hi and not any(t <= i[0] <= a for t, a in nested)]
        loop = count(body)
        bins = bins_per_pass[key]
        out[key] = {"function": count(ins), "loop": loop, "per_bin": {k: v / bins for k, v in loop.items()},
                    "philox": sum(any(mark in txt for mark in PHILOX_MARKS) for _, _, txt in body) / 10}
    return out


def pipe_bound_ms(per_bin, bins):
    """The least ms ``bins`` bins of ``per_bin`` instructions by pipe (lane
    instructions a bin) could take on the card: each pipe's lane
    instructions over its rate, and all of them over the issue rate, the
    largest of these; with the pipe that sets it."""
    times = {pipe: bins * count / (PIPE_RATE[pipe] * SM_CLOCKS) for pipe, count in per_bin.items()}
    times["issue"] = bins * sum(per_bin.values()) / (4 * 32 * SM_CLOCKS)
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, pipe


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# The headline link (bench.py's headline cell) and the reference's default
# SC-FDE link (bench.py's scfde_default), without their sizes.
HEADLINE_KW = dict(num_subcarriers=64, constellation_order=64, constellation_type="QAM", channel_type="CUSTOM",
                   channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                   equalization_method="MMSE", noise_type="AWGN", snr_db=30.0)
SCFDE_KW = dict(num_subcarriers=64, constellation_order=4, constellation_type="QAM", channel_type="CUSTOM",
                channel_model="Lin-Phoong_P1", modulation_type="SC-OFDM", prefix_type="CYCLIC",
                prefix_length_ratio=1.0, equalization_method="ZF", noise_type="AWGN", snr_db=10.0)


def headline_cfg(num_ofdm, chunk=0, **kw):
    from ofdm_tpu_torch.config import SimulationConfig

    base = dict(HEADLINE_KW, num_symbols=64 * num_ofdm, symbols_per_chunk=chunk)
    base.update(kw)
    return SimulationConfig(**base)


def scfde_cfg(num_ofdm, chunk=0, **kw):
    from ofdm_tpu_torch.config import SimulationConfig

    base = dict(SCFDE_KW, num_symbols=kw.get("num_subcarriers", 64) * num_ofdm, symbols_per_chunk=chunk)
    base.update(kw)
    return SimulationConfig(**base)


# The fold links held against the plain version: the SC-FDE default, SC-FDE
# MMSE 16-QAM, OFDM with a short CP (E = 7), OFDM with no prefix, and the
# short-CP link without noise; then one link at each other width the kernel
# compiles for (bins a lane J = ceil(n / 32): 1, 3, ..., 8), up to 256-sc
# SC-FDE (tile 4096).
_SHORT_CP = dict(modulation_type="OFDM", prefix_length_ratio=0.5, channel_model="severe_multipath",
                 constellation_order=16, equalization_method="MMSE", snr_db=20.0)
FOLD_LINKS = {
    "scfde_default": {},
    "scfde_mmse_16qam_severe": dict(equalization_method="MMSE", constellation_order=16,
                                    channel_model="severe_multipath", snr_db=15.0),
    "ofdm_short_cp": _SHORT_CP,
    "ofdm_no_prefix_p2": dict(modulation_type="OFDM", prefix_type="NONE", channel_model="Lin-Phoong_P2",
                              constellation_order=16, snr_db=20.0),
    "ofdm_short_cp_noiseless": dict(_SHORT_CP, noise_type="NONE"),
    "scfde_32sc": dict(num_subcarriers=32),
    "ofdm_short_cp_96sc": dict(_SHORT_CP, num_subcarriers=96),
    "scfde_mmse_128sc": dict(num_subcarriers=128, equalization_method="MMSE", constellation_order=16,
                             snr_db=15.0),
    "scfde_160sc": dict(num_subcarriers=160),
    "scfde_192sc": dict(num_subcarriers=192),
    "scfde_224sc": dict(num_subcarriers=224),
    "scfde_256sc": dict(num_subcarriers=256),
}


def wide_cfg(num_ofdm, chunk=0, **kw):
    """bench.py's wide_1024sc link; ``prefix_type="ZERO"`` gives lr_1024sc_zp."""
    from ofdm_tpu_torch.config import SimulationConfig

    base = dict(
        num_symbols=1024 * num_ofdm, num_subcarriers=1024, constellation_order=64,
        constellation_type="QAM", channel_type="CUSTOM", channel_model="severe_multipath",
        prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="MMSE",
        noise_type="AWGN", snr_db=30.0, symbols_per_chunk=chunk,
    )
    base.update(kw)
    base["num_symbols"] = base["num_subcarriers"] * num_ofdm
    return SimulationConfig(**base)


def custom_64_taps():
    """A unit-energy 64-tap channel from a seed (E = 63 tail lanes)."""
    import numpy as np

    rng = np.random.default_rng(11)
    ir = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    return ir / np.linalg.norm(ir)


# The lr links held against the plain version, with their chunk sizes: the
# two bench cells; 128-sc short-CP and ZP 0.5 links (real corrections, the
# strided in-kernel PAPR); a 64-tap channel at 256 sc with ZP (E = 63,
# noise rank 63); and 4096-sc ZP (16 bins a thread, tile 512), at 2^15
# symbols so its plain version keeps to the same number of bins.
_LR_128 = dict(num_subcarriers=128, constellation_order=16, snr_db=20.0)
LR_LINKS = {
    "wide_1024sc": ({}, 1 << 17),
    "lr_1024sc_zp": (dict(prefix_type="ZERO"), 1 << 17),
    "cp034_128sc": (dict(_LR_128, prefix_length_ratio=0.34), 1 << 17),
    "zp05_128sc": (dict(_LR_128, prefix_type="ZERO", prefix_length_ratio=0.5), 1 << 17),
    "custom64_256sc_zp": (dict(num_subcarriers=256, prefix_type="ZERO"), 1 << 17),
    "zp_4096sc": (dict(num_subcarriers=4096, prefix_type="ZERO"), 1 << 15),
}


# The mm links held against the plain version: zp_64sc (the published
# campaign's ZP-OFDM MMSE link at guard 1.0, the main path of the slice), ZP
# 0.34 ZF and 0.68 MMSE (real ISI: E = 3 > L), severe_multipath (E = 7), the
# reference's default SC-FDE link with a zero prefix; then one link at each
# other width the kernel compiles for (time samples a lane J = 2, 4, 6, 8,
# 10: T = 35, 99, 163, 256, 259), up to 256-sc SC-FDE (tile 4096) and a
# single-tap 256-sc link (E = 0).
_SCFDE_ZP = dict(modulation_type="SC-OFDM", constellation_order=4, channel_model="Lin-Phoong_P1",
                 equalization_method="ZF", snr_db=10.0)
MM_LINKS = {
    "zp_64sc": {},
    "zp034_zf": dict(prefix_length_ratio=0.34, equalization_method="ZF"),
    "zp068_mmse": dict(prefix_length_ratio=0.68),
    "zp_severe_64sc": dict(channel_model="severe_multipath", snr_db=20.0),
    "scfde_zp": _SCFDE_ZP,
    "zp_32sc": dict(num_subcarriers=32),
    "zp_96sc": dict(num_subcarriers=96),
    "scfde_zp_160sc": dict(_SCFDE_ZP, num_subcarriers=160),
    "flat_zp_256sc": dict(num_subcarriers=256, channel_model="flat_fading", snr_db=20.0),
    "scfde_zp_256sc": dict(_SCFDE_ZP, num_subcarriers=256),
}
ZP_BER_REF = CAMPAIGN[("ZERO", "MMSE", 1.0)][1]  # the seeded reference, docs/RESULTS.md:58
TPU_V5E_ZP_64SC_BER = CAMPAIGN[("ZERO", "MMSE", 1.0)][0]


def zp_cfg(num_ofdm, chunk=0, **kw):
    """zp_64sc: the headline link with a zero prefix (64 sc, 64-QAM, ZP ratio
    1.0, MMSE, Lin-Phoong P2, AWGN 30 dB)."""
    kw = {"prefix_type": "ZERO", **kw}
    return headline_cfg(num_ofdm, chunk, **kw, num_symbols=kw.get("num_subcarriers", 64) * num_ofdm)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_chunk(link_kw, chunk, sym0, device):
    """diag_chunk kernel vs plain on the card on the same draw
    (``compare_chunk``: counts, PAPR peak and carry row exactly): run
    symbols [sym0, sym0 + chunk) of the main path's seed."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import prepare

    setup = prepare(headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **link_kw))
    link = lk.diag_link(setup, device)
    return compare_chunk(f"chunk {link_kw or 'headline'}", lk.diag_chunk, lk.diag_chunk_plain, link, sym0, chunk,
                         setup.cfg.snr_db, device)


def compare_chunk(label, kernel, plain, link, sym0, chunk, snr_db, device, no_papr=False, rows=None):
    """A chunk kernel vs its plain version on the card on the same draw: run
    symbols [sym0, sym0 + chunk) of the main path's seed (``rows``: the
    stages' per-lane rows).  Counts, PAPR peak and carry row must be equal,
    the PAPR sum within 1e-12 (both zero when ``no_papr``).  Returns the
    largest difference."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng

    snr_lin = lk.snr_linear(snr_db)
    key = prng.key_words(MAIN_SEED)
    got = []
    for fn in (kernel, plain):
        acc, psum = lk.new_accumulators(device)
        cr, ci = fn(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows)
        torch.cuda.synchronize()
        be, se, pk = acc.tolist()
        got.append((be, se, lk.bits_f32(pk), float(psum), cr.cpu().clone(), ci.cpu().clone()))
    (kb, ks, kp, kps, kcr, kci), (pb, ps, pp, pps, pcr, pci) = got
    carry_err = max(float((kcr - pcr).abs().max()), float((kci - pci).abs().max()))
    print(f"{label} symbols [{sym0}, {sym0 + chunk}): kernel be={kb} se={ks} peak={kp} sum={kps}; "
          f"plain be={pb} se={ps} peak={pp} sum={pps}; carry max diff {carry_err}")
    if (kb, ks) != (pb, ps):
        raise AssertionError(f"{label}: counts disagree: kernel {kb}/{ks}, plain {pb}/{ps}")
    if kp != pp or abs(kps - pps) > 1e-12 * pps or (no_papr and (kp, kps) != (0.0, 0.0)):
        raise AssertionError(f"{label}: PAPR statistics disagree")
    if not (torch.equal(kcr, pcr) and torch.equal(kci, pci)):
        raise AssertionError(f"{label}: carry rows disagree")
    return max(abs(kp - pp), carry_err)


def check_fold(name, sym0, device):
    """fold_chunk kernel vs plain (``compare_chunk``) on symbols [sym0, sym0 +
    MAIN_CHUNK)."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import prepare

    setup = prepare(scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **FOLD_LINKS[name]))
    link = fk.fold_link(setup, device)
    tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
    return compare_chunk(f"fold_chunk {name} (n={link.n}, tile {tile})", fk.fold_chunk, fk.fold_chunk_plain,
                         link, sym0, MAIN_CHUNK, setup.cfg.snr_db, device)


def check_lr(name, device):
    """lr_chunk kernel vs plain (``compare_chunk``) on the last chunk of a
    2^26-symbol run; no PAPR statistic under txext."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.pipeline import prepare

    kw, chunk = LR_LINKS[name]
    ir = custom_64_taps() if name.startswith("custom64") else None
    setup = prepare(wide_cfg(LR_SYMBOLS, chunk, **kw), channel_ir=ir)
    link = lrk.lr_link(setup, device)
    tile = lk.tile_for(chunk, link.tile_cap)
    return compare_chunk(f"lr_chunk {name} (n={link.n}, E={link.E}, rank={link.rank}, tile {tile}, "
                         f"txext={link.txext})", lrk.lr_chunk, lrk.lr_chunk_plain, link, LR_SYMBOLS - chunk,
                         chunk, setup.cfg.snr_db, device, no_papr=link.txext)


def lr_operations(link, chunk):
    """(needed, power pass, tails): the operations one lr chunk needs, and
    two kinds of work the kernel's design adds.  Needed, per bin: the chain
    shared with the diag count (Philox, encode, s * D, Box-Muller, equalizer,
    slicer, counters), the two skinny products and, on a zero prefix, g2 @
    B^H as ``product_ops`` counts them on the link's own matrices (an input
    that is identically zero — ZP 1.0's TailM, so t and both corrections —
    costs nothing), 2 to add the corrections and 2 the colored part; per
    symbol the rank's g2 draws (Philox and Box-Muller); per bin of each
    tile's slice, |y|^2 and its sum; per sampled symbol the TX product and
    the PAPR statistic.  lr_power recomputes Philox, encode, t and y on the
    slices and one previous t a block; lr_main recomputes one previous t a
    block of RUN symbols (both over the link's listed rows: none without a
    tail)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk

    n, E, r = link.n, link.E, link.rank if link.add_noise else 0
    tail_zero = not (bool(link.tail_r.any()) or bool(link.tail_i.any()))
    t_ops = 0 if tail_zero else product_ops(link.tail_r.T, link.tail_i.T)
    corr_ops = 0 if tail_zero else product_ops(link.cc_r, link.cc_i) + 2 * n
    eq = OPS_PER_BIN["mmse"] if link.method == 1 else 6
    noise = OPS_PER_BIN["noise"] if link.add_noise else 0
    colored = (r * (OPS_PER_BIN["philox"] + OPS_PER_BIN["noise"]) + product_ops(link.bh_r, link.bh_i)
               + 2 * n) if r else 0
    encode = n * (OPS_PER_BIN["philox"] + OPS_PER_BIN["encode"])
    per_symbol = (encode + n * (OPS_PER_BIN["channel"] + eq + noise + OPS_PER_BIN["demap"] + OPS_PER_BIN["count"])
                  + t_ops + corr_ops + colored)
    tile, tiles, groups = lrk._chunk_geometry(link, chunk)
    slice_syms = sum(min(link.slice, min(tile, chunk - t * tile)) for t in range(tiles)) if link.add_noise else 0
    sampled = 0 if link.txext else lk.sampled_symbols(chunk, tile, link.pstride)
    papr = sampled * (product_ops(link.fr, link.fi) + PAPR_OPS * link.T) if sampled else 0
    t_rows, c_rows = len(link.tail_rows), len(link.cc_rows)
    prev_t = encode + 8 * n * t_rows if t_rows else 0
    y_ops = encode + 8 * n * t_rows + 8 * n * c_rows + 6 * n
    power = slice_syms * y_ops + (tiles * groups if link.add_noise else 0) * prev_t
    tails = -(-chunk // lrk.RUN) * prev_t
    return chunk * per_symbol + slice_syms * n * POWER_SUM_OPS + papr, power, tails


def lr_cell(card, device, name, kw, sweep):
    """One bench lr cell through prepare() -> LinkRunner.run() on 2^26
    symbols: launch counters, BER gate, the sampled-TX PAPR and its time,
    optionally the SNR sweep, the profile and the kernel's times.  Returns
    (launches of lr_main, of lr_power, of random_u32, chunk ms, plain ms,
    bound ms, sample ms)."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    LinkRunner(prepare(wide_cfg(MAIN_CHUNK, MAIN_CHUNK, **kw))).run(1, snr_db=25.0)  # warm-up
    runner = LinkRunner(prepare(wide_cfg(LR_SYMBOLS, MAIN_CHUNK, **kw)))
    if runner.mode != "lr":
        raise AssertionError(f"{name} routed to {runner.mode}")
    torch.cuda.synchronize()
    lrk.lr_chunk.launches = lrk.lr_chunk.power_launches = prng.random_u32.launches = 0
    r = runner.run(MAIN_SEED, snr_db=30.0)
    launches = (lrk.lr_chunk.launches, lrk.lr_chunk.power_launches, prng.random_u32.launches)
    num_chunks = LR_SYMBOLS // MAIN_CHUNK
    ber = r["bit_error_rate"]
    tpu = TPU_V5E_WIDE_BER if name == "wide_1024sc" else {"BENCH_r05": TPU_V5E_ZP_BER}
    print(f"{name} run [{card}]: {LR_SYMBOLS} OFDM symbols ({r['total_bits']} bits; bench.py runs "
          f"{'2^27' if name == 'wide_1024sc' else '2^26'}), ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} "
          f"run_s={r['transmission_time_ms'] / 1e3:.4f} BER={ber} (gate {LR_BER_30DB} +- {LR_BER_TOL}; "
          f"the JAX package on a TPU v5e read {json.dumps(tpu)}) papr_db={r['papr_db']:.4f} "
          f"papr_estimator={r['papr_estimator']} papr_sample_fraction={r['papr_sample_fraction']:.6f} "
          f"hotpath={r['hotpath_used']} launches: lr_main {launches[0]}, lr_power {launches[1]}, "
          f"random_u32 {launches[2]}")
    if launches != (num_chunks, num_chunks, 1) or r["hotpath_used"] != "cuda":
        raise AssertionError(f"{name} launched lr_main/lr_power/random_u32 {launches}, not "
                             f"({num_chunks}, {num_chunks}, 1)")
    if r["papr_estimator"] != "sampled_tx" or not 9.0 < r["papr_db"] < 14.0:
        raise AssertionError(f"{name} PAPR: {r['papr_estimator']} {r['papr_db']}")
    if not abs(ber - LR_BER_30DB) < LR_BER_TOL:
        raise AssertionError(f"{name} BER gate: {ber} vs {LR_BER_30DB}")
    runner._papr_cache = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner._papr_sample()
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    print(f"{name} sampled TX PAPR [{card}]: {sample_ms:.2f} ms host clock for "
          f"{runner._papr_cache[2] // runner.setup.block_length} symbols")
    if sweep:
        srun = LinkRunner(prepare(wide_cfg(SWEEP_SYMBOLS, MAIN_CHUNK, **kw)))
        bers = [srun.run(2, snr_db=snr)["bit_error_rate"] for snr in TPU_V5E_WIDE_SWEEP]
        print(f"{name} sweep 0/10/20/30 dB BER at {SWEEP_SYMBOLS} symbols a point: {bers} (the JAX "
              f"package on a TPU v5e, docs/RESULTS.md: {list(TPU_V5E_WIDE_SWEEP.values())})")
        if not all(a > b for a, b in zip(bers, bers[1:])):
            raise AssertionError(f"{name} BER does not fall with SNR")
    print_profile(card, name, profile_run(runner, 30.0))

    link = runner.link
    snr_lin = lk.snr_linear(30.0)
    acc, psum = lk.new_accumulators(device)
    work = lrk.chunk_workspace(link, MAIN_CHUNK, device)
    k_ms = cuda_ms(lambda: lrk.lr_chunk(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    p_ms = cuda_ms(lambda: lrk.lr_chunk_plain(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum), 2)
    ops, power_ops, tail_ops = lr_operations(link, MAIN_CHUNK)
    mats = 2 * (3 * link.E * link.n + link.rank * link.n) + 7 * link.n
    bound = max(ops / PEAK_OPS, (4 * mats + 3 * 8 + 8 * link.T) / PEAK_BYTES) * 1e3
    print(f"lr_chunk {name} at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({ops} operations needed; the design adds {power_ops} in the power pass "
          f"and {tail_ops} in lr_main's tail recomputes, {(power_ops + tail_ops) / PEAK_OPS * 1e3:.4f} ms "
          f"at the same rate)")
    lr_geometry(card, name, link)
    return launches, k_ms, p_ms, bound, sample_ms


def lr_geometry(card, name, link):
    """Print lr_main's layout on a link, as the loaded kernel reports it
    (``lr_kernel.geometry``: the symbols a group M, registers, local bytes,
    shared memory a block, resident blocks an SM), and the factor bytes a
    bin and symbol it reads (the listed rows, D and the equalizer rows once
    a group) beside those a layout that reads every row once a symbol
    would."""
    from ofdm_tpu_torch.ops import lr_kernel as lrk

    g = lrk.geometry(link)
    M = g["group_symbols"]
    rank = link.rank if link.add_noise else 0
    eq = {0: 8, 1: 12}.get(link.method, 0)
    bh = len(link.bh_rows) if rank else 0
    per_group = 8 * (len(link.tail_rows) + len(link.cc_rows) + bh) + 8 + eq
    every_row = 8 * (3 * link.E + rank) + 8 + eq
    print(f"lr_main on {name} (n={link.n}) [{card}]: J={g['bins_a_thread']} bins a thread, M={M} symbols a group "
          f"(lr_power {g['power_group_symbols']}); {g['registers']} registers, {g['local_bytes']} local bytes a "
          f"thread; shared memory a block {g['dynamic_smem_bytes']} bytes dynamic + {g['static_smem_bytes']} "
          f"static; {g['blocks_an_sm']} blocks an SM; factor bytes a bin and symbol {per_group / M:.2f} (rows "
          f"read: TailM {list(link.tail_rows)}, [Cr; Cp] {list(link.cc_rows)}, B^H {list(link.bh_rows)[:bh]}, "
          f"D and the equalizer rows, once a group) against {every_row} read once a symbol over all rows")


LR_LAYOUT_ROWS = ((63, 128), (159, 159))  # (listed tail lanes, listed noise rows) lr_layouts_fit checks


def lr_layouts_fit(card):
    """lr_main's layout at every width it takes (1-4096, and 8192, 16384,
    32768 as clusters under txext) at LR_LAYOUT_ROWS' tail and noise rows
    (its shared memory grows with both), with and without the in-kernel
    PAPR, in the plain, staged and noise-bump builds: the card gives each a
    block's shared memory and keeps a block resident, and the groups divide
    the run, which divides every tile."""
    import ctypes

    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk

    out = (ctypes.c_int * len(lrk.GEOMETRY_KEYS))()
    most = {}
    widths = [(n, txext) for n in range(1, lk.CLUSTER_BINS + 1) for txext in (0, 1)]
    widths += [(n, 1) for n in (8192, 16384, lrk.MAX_N)]
    for library in ("lr_kernel", "lr_staged", "lr_bump"):
        lib = build.load(library)
        for n, txext in widths:
            for nt, nbh in LR_LAYOUT_ROWS:
                build.check(lib, lib.ofdm_lr_geometry(n, nt, nbh, txext, out),
                            f"{library} ofdm_lr_geometry n={n} nt={nt} nbh={nbh} txext={txext}")
                g = dict(zip(lrk.GEOMETRY_KEYS, out))
                if g["blocks_an_sm"] < 1 or lrk.RUN % g["group_symbols"] or lrk.RUN % g["power_group_symbols"]:
                    raise AssertionError(f"lr_main's layout at n={n}, nt={nt}, nbh={nbh}, txext={txext} in "
                                         f"{library}: {g}")
                most[library] = max(most.get(library, (0, 0)), (g["dynamic_smem_bytes"] + g["static_smem_bytes"], n))
    bad = [t for t in lk.TILE_LADDER if t % lrk.RUN]
    if bad:
        raise AssertionError(f"tiles {bad} do not hold whole runs of {lrk.RUN}")
    print(f"lr_main's layout fits at every width 1-{lk.CLUSTER_BINS} and 8192 / 16384 / {lrk.MAX_N}, (tail, noise) "
          f"rows {LR_LAYOUT_ROWS} [{card}]: most shared memory a block (bytes, at n) {most}")


def lr_path(card, device):
    """K4 (random_u32) against its plain version, the lr kernel against its
    plain version on six links, then bench.py's two lr cells.  Returns the
    kernels-line entries of lr_chunk and random_u32."""
    import torch

    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import PAPR_SAMPLE_SEED

    # K4 against its plain version on 2^22 words and at the main path's
    # shape: the wide cell's sampled batch (S, 1024), S = 2^25 // T, T = 1031
    key = prng.key_words(PAPR_SAMPLE_SEED)
    S = min(max(1024, (1 << 25) // 1031), LR_SYMBOLS)
    shape = (S, 1024)
    u_err = 0.0
    for sh in ((U32_CHECK_WORDS,), shape):
        wk = prng.random_u32(key, sh, device)
        wp = prng.random_u32_plain(key, sh, device)
        if not torch.equal(wk, wp):
            raise AssertionError(f"random_u32 kernel and plain words differ at {sh}")
        u_err = max(u_err, float((wk.to(torch.int64) - wp.to(torch.int64)).abs().max()))
        del wk, wp
        print(f"random_u32: {sh} words bit-equal")

    err = max(check_lr(name, device) for name in LR_LINKS)
    lr_layouts_fit(card)
    wide = lr_cell(card, device, "wide_1024sc", {}, sweep=True)
    zp = lr_cell(card, device, "lr_1024sc_zp", dict(prefix_type="ZERO"), sweep=False)

    u_ms = cuda_ms(lambda: prng.random_u32(key, shape, device), U32_TIMED_LAUNCHES)
    up_ms = cuda_ms(lambda: prng.random_u32_plain(key, shape, device), 3)
    ri_ms = cuda_ms(lambda: torch.randint(0, 1 << 32, shape, dtype=torch.int64, device=device), 20)
    words = S * 1024
    u_ops = -(-words // 4) * OPS_PER_BIN["philox"]
    u_bytes = words * 4  # the function's uint32 words
    u_bound = max(u_ops / PEAK_OPS, u_bytes / PEAK_BYTES) * 1e3
    print(f"random_u32 at {shape} [{card}]: kernel {u_ms:.4f} ms a launch over {U32_TIMED_LAUNCHES} "
          f"(one ofdm_philox launch writing the "
          f"words, no other pass), plain {up_ms:.3f} ms, bound {u_bound:.4f} ms; torch.randint of the "
          f"same count {ri_ms:.4f} ms (other numbers: for scale only)")
    (wl, wk_ms, wp_ms, wb, _), (zl, zk_ms, zp_ms, zb, _) = wide, zp
    return [
        {"name": "lr_chunk", "route": "cuda", "source": "ofdm_tpu_torch/csrc/lr_kernel.cu",
         "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": wl[0], "power_launches": wl[1],
         "max_abs_err": err, "ms": wk_ms, "plain_ms": wp_ms, "bound_ms": wb, "bound_by": "operations",
         "library_ms": None, "zp_cell": {"launches": zl[0], "power_launches": zl[1], "ms": zk_ms,
                                         "plain_ms": zp_ms, "bound_ms": zb}},
        {"name": "random_u32", "route": "cuda", "source": "ofdm_tpu_torch/csrc/boxmuller.cu",
         "replaces": "ofdm_tpu/ops/prng.py:64", "launches": wl[2], "max_abs_err": u_err, "ms": u_ms,
         "plain_ms": up_ms, "bound_ms": u_bound,
         "bound_by": "operations" if u_ops / PEAK_OPS >= u_bytes / PEAK_BYTES else "bytes",
         "library_ms": None, "randint_ms": ri_ms},
    ]


def moment_gate(z0, z1):
    """bench.py's noise-moment gate on (z0, z1)."""
    a, b = z0.reshape(-1).double(), z1.reshape(-1).double()
    m = {
        "mean": float(a.mean()),
        "var": float(a.var(unbiased=False)),
        "tail3": float((a.abs() > 3.0).double().mean()),
        "amax": max(float(a.abs().max()), float(b.abs().max())),
        "corr": float((a * b).mean()),
    }
    ok = (abs(m["mean"]) < 3e-3 and abs(m["var"] - 1.0) < 5e-3 and 0.0025 <= m["tail3"] <= 0.0029
          and 4.0 < m["amax"] <= 5.78 and abs(m["corr"]) < 3e-3)
    return ok, m


def profile_run(runner, snr_db):
    """``profile_call`` of one run of ``runner`` at ``snr_db``."""
    return profile_call(lambda: runner.run(4, snr_db=snr_db))


def profile_call(fn):
    """Device time by kernel and the device's busy share over one profiled
    call of fn(), from torch.profiler's kernel events; None when the
    profiler recorded no kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    by_name = {}
    for name, t0, t1 in spans:
        key = name.split("(")[0].split("<")[0].replace("void ", "") or "(unnamed)"
        by_name[key] = by_name.get(key, 0.0) + (t1 - t0) / 1e3
    busy, end = 0.0, None
    for _, t0, t1 in sorted(spans, key=lambda s: s[1]):
        t0 = t0 if end is None else max(t0, end)
        if t1 > t0:
            busy += t1 - t0
            end = t1
    window = max(t1 for _, _, t1 in spans) - min(t0 for _, t0, _ in spans)
    return by_name, busy / window, window / 1e3


def device_ms(fn, kernel, reps=20):
    """Device milliseconds a launch of ``kernel`` over ``reps`` calls of fn()
    (the profiler's kernel events); None when the profiler recorded no
    launch of it."""
    prof = profile_call(lambda: [fn() for _ in range(reps)])
    return None if prof is None or kernel not in prof[0] else prof[0][kernel] / reps


def print_profile(card, what, prof):
    if prof is None:
        print(f"profile {what}: the profiler recorded no device kernels; idle share not measured")
    else:
        by_name, busy, window_ms = prof
        print(f"profile {what} [{card}]: device busy {busy:.4f} of a {window_ms:.2f} ms kernel window; "
              f"device ms by kernel {json.dumps(by_name)}")


def product_ops(mr, mi):
    """Operations the complex product v @ M needs, read off this link's
    matrix: 8 a nonzero term (four multiplies, four adds: no FMA under
    -fmad=false) in each distinct output column, and none for a column that
    repeats another or copies one input (its one nonzero is 1)."""
    import numpy as np

    cols = np.unique(np.concatenate([mr.cpu().numpy().T, mi.cpu().numpy().T], axis=1), axis=0)
    re, im = np.split(cols, 2, axis=1)
    nnz = ((re != 0) | (im != 0)).sum(axis=1)
    copy = (nnz == 1) & (re.sum(axis=1) == 1) & (im == 0).all(axis=1)
    return int(8 * nnz[~copy].sum())


def fold_operations(link, chunk, ops=OPS_PER_BIN):
    """(needed, power pass, tails): the operations one fold chunk needs, and
    two kinds of work the kernel's design adds.  Needed, per symbol: the
    products as ``product_ops`` counts them (the SC-FDE TX stage is a copy),
    the per-bin chain as in the diag count (Philox, encode, noise,
    equalizer, slicer, counters) and the PAPR statistic per time sample;
    per bin of each tile's slice, |y|^2 and its sum.  fold_power recomputes
    Philox, encode and both products' listed terms on the slices; fold_main's
    warps recompute their first symbol's predecessor tail (Philox, encode,
    the tail columns' listed terms; fold_power's one tail a warp is not
    counted)."""
    from ofdm_tpu_torch.ops import fold_kernel as fk

    n, T = link.n, link.T
    eq = ops["mmse"] if link.method == 1 else 6
    per_symbol = (product_ops(link.txr, link.txi) + product_ops(link.cmr, link.cmi)
                  + (product_ops(link.idr, link.idi) if link.is_sc else 0)
                  + n * (ops["philox"] + ops["encode"] + eq + ops["demap"]
                         + ops["count"] + (ops["noise"] if link.add_noise else 0))
                  + PAPR_OPS * T)
    tile, tiles, _ = fk._chunk_geometry(link, chunk)
    slice_syms = sum(min(link.slice, min(tile, chunk - t * tile)) for t in range(tiles)) if link.add_noise else 0
    encode = n * (ops["philox"] + ops["encode"])
    power = slice_syms * (encode + 8 * (link.tx_terms.nonzero + link.cm_terms.nonzero))
    tails = -(-chunk // fk.RUN) * (encode + tail_ops(link))
    return chunk * per_symbol + slice_syms * n * POWER_SUM_OPS, power, tails


def group_geometry(card, chain, name, link):
    """Print the fold or mm kernels' layout on a link as the loaded kernels
    report it (``{fold,mm}_kernel.geometry``: bins a lane, symbols a group,
    each kernel's warps a block, registers, local bytes a thread, shared
    memory a block and resident blocks an SM), and the products' listed
    terms a symbol (the nonzero elements; and the terms the lanes run)
    against the dense products'.  Returns the layout."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.ops import terms

    mod, second = (fk, "power") if chain == "fold" else (mmk, "front")
    g = mod.geometry(link.n, link.T, link.E, lk.staged_library(link, None, chain))
    mats = [t for t in (getattr(link, f"{m}_terms", None) for m in ("tx", "cm", "cv", "rx", "id")) if t is not None]
    listed = sum(t.nonzero for t in mats)
    ran = sum(terms.lane_terms(t) for t in mats)
    full = sum(t.rows * t.cols for t in mats)
    print(f"{chain} layout on {name} (n={link.n}, T={link.T}, E={link.E}) [{card}]: J={g['bins_a_lane']} bins a "
          f"lane, S={g['group_symbols']} symbols a group; {chain}_main {g['warps']} warps a block, "
          f"{g['registers']} registers, {g['local_bytes']} local bytes a thread, shared memory a block "
          f"{g['dynamic_smem_bytes']} bytes dynamic + {g['static_smem_bytes']} static, {g['blocks_an_sm']} blocks "
          f"an SM; {chain}_{second} {g[second + '_warps']} warps, {g[second + '_registers']} registers, "
          f"{g[second + '_local_bytes']} local bytes, {g[second + '_dynamic_smem_bytes']} bytes dynamic, "
          f"{g[second + '_blocks_an_sm']} blocks an SM; listed terms a symbol {listed} (lanes run {ran}) against "
          f"{full} dense")
    return g


def group_layouts_fit(card):
    """The fold and mm kernels' layouts at every width they take (n = 1 ...
    256 at the widest time samples and tail a link of that width can have:
    T = 2n, mm at most 320, and E = T), in the plain, staged and noise-bump
    builds: the card gives each kernel's block its shared memory and keeps
    one resident."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    most = {}
    for chain, mod, second in (("fold", fk, "power"), ("mm", mmk, "front")):
        for library in (f"{chain}_kernel", f"{chain}_staged", f"{chain}_bump"):
            for n in range(1, mod.MAX_N + 1):
                T = min(2 * n, mmk.MAX_T) if chain == "mm" else 2 * n
                g = mod.geometry(n, T, T, library)
                if min(g["warps"], g["blocks_an_sm"], g[second + "_warps"], g[second + "_blocks_an_sm"]) < 1:
                    raise AssertionError(f"{library}'s layout at n={n}, T={T}, E={T}: {g}")
                most[library] = max(most.get(library, (0, 0)), (g["dynamic_smem_bytes"] + g["static_smem_bytes"], n))
    print(f"fold and mm layouts fit at every width 1-256, T = 2n (mm <= 320), E = T [{card}]: most shared memory a "
          f"block (bytes, at n) {most}")


def fold_path(card, device):
    """The SC-FDE default through the fold kernel: the kernel against its
    plain version on five links, the main run, the sweep, the profile and
    the kernel's times.  Returns the kernels-line entry."""
    import torch

    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    last = MAIN_SYMBOLS - MAIN_CHUNK
    err = max(check_fold(name, last, device) for name in FOLD_LINKS)
    group_layouts_fit(card)

    runner = LinkRunner(prepare(scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK)))
    if runner.mode != "fold":
        raise AssertionError(f"the SC-FDE default routed to {runner.mode}")
    runner.run(1, snr_db=5.0)  # warm-up
    fk.fold_chunk.launches = fk.fold_chunk.power_launches = 0
    r = runner.run(MAIN_SEED, snr_db=10.0)
    main_launches, power_launches = fk.fold_chunk.launches, fk.fold_chunk.power_launches
    num_chunks = MAIN_SYMBOLS // MAIN_CHUNK
    ber = r["bit_error_rate"]
    print(f"scfde_default run [{card}]: {MAIN_SYMBOLS} OFDM symbols ({r['total_bits']} bits; bench.py runs "
          f"2^29), ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} "
          f"run_s={r['transmission_time_ms'] / 1e3:.4f} BER={ber} (reference 0.0145; the JAX package "
          f"on a TPU v5e read {TPU_V5E_SCFDE_BER_10DB}, BENCH_r05) papr_db={r['papr_db']:.4f} "
          f"hotpath={r['hotpath_used']} launches: fold_main {main_launches}, fold_power {power_launches}")
    if main_launches != num_chunks or power_launches != num_chunks or r["hotpath_used"] != "cuda":
        raise AssertionError(f"the SC-FDE run launched fold_main {main_launches} and fold_power "
                             f"{power_launches} times, not {num_chunks} each")
    if not abs(ber - REFERENCE_SCFDE_BER[10.0]) < 1.5e-3:
        raise AssertionError(f"SC-FDE BER gate: {ber} vs {REFERENCE_SCFDE_BER[10.0]}")
    sweep = []
    for snr in REFERENCE_SCFDE_BER:
        fk.fold_chunk.launches = fk.fold_chunk.power_launches = 0
        sweep.append(runner.run(2, snr_db=snr)["bit_error_rate"])
        if fk.fold_chunk.launches != num_chunks or fk.fold_chunk.power_launches != num_chunks:
            raise AssertionError(f"sweep at {snr} dB: {fk.fold_chunk.launches} launches, not {num_chunks}")
    print(f"scfde sweep 0/10/20 dB BER: {sweep} (reference {list(REFERENCE_SCFDE_BER.values())})")
    if not all(a > b for a, b in zip(sweep, sweep[1:])):
        raise AssertionError("SC-FDE BER does not fall with SNR")
    print_profile(card, "scfde_default", profile_run(runner, 10.0))

    link = runner.link
    snr_lin = lk.snr_linear(10.0)
    acc, psum = lk.new_accumulators(device)
    work = fk.chunk_workspace(link, MAIN_CHUNK, device)
    layout = group_geometry(card, "fold", "scfde_default", link)
    k_ms = cuda_ms(lambda: fk.fold_chunk(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    p_ms = cuda_ms(lambda: fk.fold_chunk_plain(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum), 3)
    ops, power_ops, tail_ops = fold_operations(link, MAIN_CHUNK)
    mats = 2 * (2 * link.n * (link.T + link.E) + (link.n * link.n if link.is_sc else 0)) + 5 * link.n
    bound = max(ops / PEAK_OPS, (4 * mats + 3 * 8 + 8 * link.T) / PEAK_BYTES) * 1e3
    print(f"fold_chunk at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({ops} operations needed; the design adds {power_ops} in the power "
          f"pass and {tail_ops} in fold_main's tail recomputes, {(power_ops + tail_ops) / PEAK_OPS * 1e3:.4f} ms "
          f"at the same rate)")
    return {"name": "fold_chunk", "route": "cuda", "source": "ofdm_tpu_torch/csrc/fold_kernel.cu",
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": main_launches,
            "power_launches": power_launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None, "layout": layout}


def check_mm(name, device):
    """mm_chunk kernel vs plain (``compare_chunk``) on the last chunk of a
    2^27-symbol run (sym0 > 0)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    setup = prepare(zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **MM_LINKS[name]))
    if kernel_mode(setup) != "mm":
        raise AssertionError(f"{name} routes to {kernel_mode(setup)}, not mm")
    link = mmk.mm_link(setup, device)
    tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
    return compare_chunk(f"mm_chunk {name} (n={link.n}, T={link.T}, E={link.E}, tile {tile})", mmk.mm_chunk,
                         mmk.mm_chunk_plain, link, MAIN_SYMBOLS - MAIN_CHUNK, MAIN_CHUNK, setup.cfg.snr_db,
                         device)


def mm_operations(link, chunk, ops=OPS_PER_BIN):
    """(needed, added): the operations one mm chunk needs, and the work the
    kernels' design adds.  Needed, per symbol: the products as
    ``product_ops`` counts them, the conv without the rows that meet an
    input that is identically zero (F_tx,ext's zero-guard columns and their
    repeats); Philox for every time sample (the bins' words are the first
    n), encode, equalizer, slicer and counters per bin, Box-Muller, |y|^2
    and its sum per time sample when the noise is on, and the PAPR
    statistic per time sample.  Added: mm_main draws the bins' Philox words
    again; mm_front recomputes one predecessor tail a run of RUN symbols
    (encode and the tail columns' listed terms, ``tail_ops``)."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.ops import mm_kernel as mmk

    n, T, E = link.n, link.T, link.E
    live = np.flatnonzero((link.txr.cpu().numpy() != 0).any(axis=0) | (link.txi.cpu().numpy() != 0).any(axis=0))
    rows = torch.as_tensor(live)
    conv = product_ops(link.cvr[rows], link.cvi[rows])
    products = (product_ops(link.txr, link.txi) + conv + product_ops(link.rxr, link.rxi)
                + (product_ops(link.idr, link.idi) if link.is_sc else 0))
    eq = ops["mmse"] if link.method == 1 else 6
    noisy = link.add_noise
    per_symbol = (products + (T if noisy else n) * ops["philox"]
                  + n * (ops["encode"] + eq + ops["demap"] + ops["count"])
                  + T * (PAPR_OPS + ((ops["noise"] + POWER_SUM_OPS) if noisy else 0)))
    encode = n * (ops["philox"] + ops["encode"])
    added = chunk * n * ops["philox"] + -(-chunk // mmk.RUN) * (encode + tail_ops(link))
    return chunk * per_symbol, added


def tail_ops(link):
    """Operations of a predecessor tail's product: 8 a listed term of
    F_tx,ext's columns T ... T+E-1."""
    return sum(8 * int((el[:, lane] != 0).sum()) for j, _, _, el in link.tx_terms.segments()
               for lane in range(32) if link.T <= 32 * j + lane < link.T + link.E)


def mm_path(card, device):
    """The zero-prefix mm chain: the kernel against its plain version on ten
    links, zp_64sc on 2^27 symbols (launch counters, BER gate, the sweep,
    the profile, the kernel's times), then the 16 cells of the published
    campaign through whichever kernel each routes to.  Returns the
    kernels-line entry."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    err = max(check_mm(name, device) for name in MM_LINKS)

    runner = LinkRunner(prepare(zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK)))
    if runner.mode != "mm":
        raise AssertionError(f"zp_64sc routed to {runner.mode}")
    runner.run(1, snr_db=25.0)  # warm-up
    mmk.mm_chunk.launches = mmk.mm_chunk.front_launches = mmk.mm_chunk.power_launches = 0
    r = runner.run(MAIN_SEED, snr_db=30.0)
    main_launches, front_launches = mmk.mm_chunk.launches, mmk.mm_chunk.front_launches
    power_launches = mmk.mm_chunk.power_launches
    num_chunks = MAIN_SYMBOLS // MAIN_CHUNK
    ber = r["bit_error_rate"]
    print(f"zp_64sc run [{card}]: {MAIN_SYMBOLS} OFDM symbols ({r['total_bits']} bits), "
          f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} run_s={r['transmission_time_ms'] / 1e3:.4f} "
          f"BER={ber} (gate {ZP_BER_REF} +- {CAMPAIGN_TOL}, the seeded reference, docs/RESULTS.md:58; "
          f"the JAX package on a TPU v5e read {TPU_V5E_ZP_64SC_BER} on 2^18 symbols) "
          f"papr_db={r['papr_db']:.4f} papr_estimator={r['papr_estimator']} hotpath={r['hotpath_used']} "
          f"launches: mm_front {front_launches}, mm_power {power_launches}, mm_main {main_launches}")
    if (main_launches, front_launches, power_launches) != (num_chunks,) * 3 or r["hotpath_used"] != "cuda":
        raise AssertionError(f"the zp_64sc run launched mm_front {front_launches}, mm_power {power_launches} "
                             f"and mm_main {main_launches} times, not {num_chunks} each")
    if r["papr_estimator"] != "in_run" or r["papr_sample_fraction"] != 1.0:
        raise AssertionError(f"zp_64sc PAPR: {r['papr_estimator']} {r['papr_sample_fraction']}")
    if not abs(ber - ZP_BER_REF) < CAMPAIGN_TOL:
        raise AssertionError(f"zp_64sc BER gate: {ber} vs {ZP_BER_REF}")
    srun = LinkRunner(prepare(zp_cfg(SWEEP_SYMBOLS, MAIN_CHUNK)))
    sweep = [srun.run(2, snr_db=snr)["bit_error_rate"] for snr in (0.0, 10.0, 20.0, 30.0)]
    print(f"zp_64sc sweep 0/10/20/30 dB BER at {SWEEP_SYMBOLS} symbols a point: {sweep}")
    if not all(a > b for a, b in zip(sweep, sweep[1:])):
        raise AssertionError("zp_64sc BER does not fall with SNR")
    print_profile(card, "zp_64sc", profile_run(runner, 30.0))

    link = runner.link
    snr_lin = lk.snr_linear(30.0)
    acc, psum = lk.new_accumulators(device)
    work = mmk.chunk_workspace(link, MAIN_CHUNK, device)
    layout = group_geometry(card, "mm", "zp_64sc", link)
    k_ms = cuda_ms(lambda: mmk.mm_chunk(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    p_ms = cuda_ms(lambda: mmk.mm_chunk_plain(link, (3, 4), MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum), 3)
    ops, added = mm_operations(link, MAIN_CHUNK)
    mats = 2 * (link.n * (link.T + link.E) + (link.T + link.E) * link.T + link.T * link.n) + 5 * link.n
    bound = max(ops / PEAK_OPS, (4 * mats + 3 * 8 + 8 * link.T) / PEAK_BYTES) * 1e3
    print(f"mm_chunk at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({ops} operations needed; the design adds {added}, "
          f"{added / PEAK_OPS * 1e3:.4f} ms at the same rate, and moves y before noise through device "
          f"memory, written once and read by mm_power and mm_main: {3 * 8 * MAIN_CHUNK * link.T} bytes, "
          f"{3 * 8 * MAIN_CHUNK * link.T / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s)")

    # the published campaign, each cell through the kernel it routes to
    for (prefix, eq, ratio), (tpu, ref) in CAMPAIGN.items():
        cell = LinkRunner(prepare(headline_cfg(CAMPAIGN_SYMBOLS, MAIN_CHUNK, prefix_type=prefix,
                                               prefix_length_ratio=ratio, equalization_method=eq)))
        b = cell.run(MAIN_SEED)["bit_error_rate"]
        print(f"campaign {prefix} {eq} {ratio} ({cell.mode}) [{card}]: BER {b} at {CAMPAIGN_SYMBOLS} symbols; "
              f"seeded reference {ref}; the JAX package on a TPU v5e {tpu}")
        if not abs(b - ref) < CAMPAIGN_TOL:
            raise AssertionError(f"campaign cell {prefix} {eq} {ratio}: BER {b} vs reference {ref}")
    return {"name": "mm_chunk", "route": "cuda", "source": "ofdm_tpu_torch/csrc/mm_kernel.cu",
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": main_launches,
            "front_launches": front_launches, "power_launches": power_launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": "operations", "library_ms": None, "layout": layout}


# --- the constellation modes: psk, aqam, apsk ------------------------------------

ADAPTIVE_CONFIG = "config/simulation_settings_adaptive.json"  # the reference's adaptive link
ADAPTIVE_SYMBOLS = 1 << 26  # OFDM symbols (under adaptive loading num_symbols counts them)
# docs/RESULTS.md:61-67: the reference's adaptive setup at 20 dB.
RESULTS_WATER_LEVEL = 1.020873477957
RESULTS_BITS_PER_OFDM = 230
RESULTS_ORDERS = [16] * 19 + [4] * 13 + [16] * 32
BAND_SYMBOLS = 1 << 20
BAND_Z = 5.0
# The aqam codec's terms per bin, counted from csrc/link_common.cuh as
# OPS_PER_BIN is: encode = four lane-row loads, the masked draw, zig-zag,
# Gray, three int -> float conversions and the per-lane affine map (27);
# demap = two lane-row loads, the per-lane centre, round / clip / convert
# on both axes, the 8-bit inverse Gray and the zig-zag (31); MMSE reads the
# lane's slicer gain (+1).
OPS_PER_BIN_AQAM = dict(OPS_PER_BIN, encode=27, demap=31, mmse=25)

# The JAX package's audit links (tools/shape_audit.py:38-120): 64 sc,
# severe_multipath, CP 1.0, MMSE, AWGN 30 dB, with these changes.
_PSK8 = dict(constellation_type="PSK", constellation_order=8)
_ADAPT = dict(power_allocation_type="WATERFILLING", adaptive_modulation_mode="CAPACITY_BASED", snr_db=20.0)
_APSK = dict(_ADAPT, constellation_type="PSK")
_ZP05_256 = dict(num_subcarriers=256, prefix_type="ZERO", prefix_length_ratio=0.5)
# The codec checks: each chunk kernel in each new mode, (chain, mode, link).
# adapt_flat_36db loads 1024-QAM, above the config's 256 (the static width
# must cover it; tests/test_pallas_link.py:456); the two Lin-Phoong P1
# links leave 8 subcarriers inactive (order 0).
CODEC_LINKS = {
    "psk8_cp1.0_64": ("diag", "psk", _PSK8),
    "adapt_flat_36db": ("diag", "aqam", dict(_ADAPT, channel_model="flat_fading", snr_db=36.0)),
    "adapt_psk_wf_cp1.0_64": ("diag", "apsk", _APSK),
    "psk8_cp0.34_64": ("fold", "psk", dict(_PSK8, prefix_length_ratio=0.34)),
    "adapt_wf_cp0.34_64": ("fold", "aqam", dict(_ADAPT, prefix_length_ratio=0.34)),
    "adapt_psk_p1_10db_cp0.34_64": ("fold", "apsk", dict(_APSK, channel_model="Lin-Phoong_P1", snr_db=10.0,
                                                          prefix_length_ratio=0.34)),
    "psk8_zp0.5_256": ("lr", "psk", dict(_PSK8, **_ZP05_256)),
    "adapt_wf_zp0.5_256": ("lr", "aqam", dict(_ADAPT, **_ZP05_256)),
    "adapt_psk_wf_zp0.5_256": ("lr", "apsk", dict(_APSK, **_ZP05_256)),
    "psk8_zp1.0_64": ("mm", "psk", dict(_PSK8, prefix_type="ZERO")),
    "adapt_p1_15db_zp1.0_64": ("mm", "aqam", dict(_ADAPT, channel_model="Lin-Phoong_P1", snr_db=15.0,
                                                   prefix_type="ZERO")),
    "adapt_psk_wf_zp1.0_64": ("mm", "apsk", dict(_APSK, prefix_type="ZERO")),
}
# The eager chain at full width (2^20 OFDM symbols each, chunks of 2^17),
# each asked for by hotpath "xla" where a kernel takes the link:
# tools/shape_audit.py's three shapes the wide kernels took from it
# (OFDM-CY1.0-512 on diag_wide; SC-CY1.0-1024 on fold_wide, SC-ZE1.0-1024
# on mm_wide), on the audit's base; the two 1024-sc SC-FDE shapes again at
# 20 dB (at 30 dB the JAX readings hold 0 and 3 errors, so those two bands
# cannot fail; at 20 dB 64-QAM errs and the band holds the SC-FDE eager
# chain to the reference); a 1024-sc single-tap CP link (at 20 dB, where
# 64-QAM over a flat channel makes errors; diag_wide takes it); the
# headline.  Each BER is held at z = 5 against the JAX package's XLA
# reading on a CPU (jax_band_readings.py, 2^24 / n OFDM symbols).
EAGER_SYMBOLS = 1 << 20
EAGER_LINKS = {
    "OFDM-CY1.0-512": dict(AUDIT_BASE, num_subcarriers=512, hotpath="xla"),
    "SC-CY1.0-1024": dict(AUDIT_BASE, num_subcarriers=1024, modulation_type="SC-OFDM", hotpath="xla"),
    "SC-ZE1.0-1024": dict(AUDIT_BASE, num_subcarriers=1024, modulation_type="SC-OFDM", prefix_type="ZERO",
                          hotpath="xla"),
    "SC-CY1.0-1024_20db": dict(AUDIT_BASE, num_subcarriers=1024, modulation_type="SC-OFDM", snr_db=20.0,
                               hotpath="xla"),
    "SC-ZE1.0-1024_20db": dict(AUDIT_BASE, num_subcarriers=1024, modulation_type="SC-OFDM", prefix_type="ZERO",
                               snr_db=20.0, hotpath="xla"),
    "flat_fading_cp_1024sc": dict(AUDIT_BASE, num_subcarriers=1024, channel_model="flat_fading", snr_db=20.0,
                                  hotpath="xla"),
    "headline_xla": dict(HEADLINE_KW, hotpath="xla"),
}
# The BER bands: the audit's PSK and adaptive links (the JAX package routes
# them diag, fold, diag, lr, diag) and the reference's adaptive config at 15
# and 25 dB, each held at z = 5 against the JAX package's reading of the same
# config: (bit errors, bits), XLA path, on a CPU, seed jax.random.PRNGKey(0),
# 2^18 OFDM symbols (jax_band_readings.py).  JAX_CPU_READINGS also holds the
# readings of STAGED_BAND_LINKS and of ASC_CELLS (the same way), of
# EAGER_LINKS (the same way at 2^24 / n OFDM symbols) and of each
# noise-bump point (the JAX package's _Link on a CPU at 2^16 OFDM symbols
# at 64 sc, 2^22 / n at the widths of NOISE_BUMP_WIDE).
BAND_LINKS = {
    "psk8_cp1.0_64": ("diag", _PSK8),
    "psk8_cp0.34_64": ("fold", dict(_PSK8, prefix_length_ratio=0.34)),
    "adapt_wf_cp1.0_64": ("diag", _ADAPT),
    "adapt_wf_zp0.5_256": ("lr", dict(_ADAPT, **_ZP05_256)),
    "adapt_psk_wf_cp1.0_64": ("diag", _APSK),
}
# --- the power stages and the noise-bump study -------------------------------------

# A waterfilling link a chain with both power switches: TX sqrt(P) and the
# per-tile unit power before the demap.
_WF = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True, normalize_before_demap=True)
STAGED_BAND_LINKS = {
    "wf_headline_64sc": ("diag", dict(HEADLINE_KW, **_WF)),
    "wf_scfde_default": ("fold", dict(SCFDE_KW, **_WF)),
    "wf_cp034_128sc": ("lr", dict(HEADLINE_KW, **_WF, num_subcarriers=128, constellation_order=16,
                                  prefix_length_ratio=0.34, snr_db=20.0)),
    "wf_zp_64sc": ("mm", dict(HEADLINE_KW, **_WF, prefix_type="ZERO")),
}
# The noise-bump study's fused campaign (the JAX package's _FusedLink: 64
# sc, 64-QAM, Lin-Phoong P2, CP 1.0, MMSE, no channel noise, both
# switches, post-EQ colored noise and 1/sqrt(P)), at its TPU default of
# 2^24 OFDM symbols a point.
NOISE_BUMP_SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
NOISE_BUMP_SYMBOLS = 1 << 24
NOISE_BUMP_SEED = 42
# The reference experiment's curves at 0 / 15 / 30 dB (tests/test_experiments.py:40-48), gate +- 0.02.
NOISE_BUMP_REFERENCE = {
    "uniform": (0.4868, 0.4078, 0.1495),
    "wf_plus3": (0.4907, 0.4367, 0.1578),
    "wf_plus6": (0.4913, 0.4404, 0.1727),
}
NOISE_BUMP_TOL = 0.02


# The study at the two wider widths the JAX package's fused kernel takes
# (pallas_link.plan_for; the chain each routes to): 512 sc on diag (the
# block-per-symbol diag_wide), 1024 sc on lr; 2^20 OFDM symbols a point.
NOISE_BUMP_WIDE = {512: "diag", 1024: "lr"}
NOISE_BUMP_WIDE_SYMBOLS = 1 << 20


def noise_bump_name(scenario_key, snr_db, n=64):
    """The JAX_CPU_READINGS key of one noise-bump point at ``n`` subcarriers."""
    width = "" if n == 64 else f"{n}sc_"
    return f"noise_bump_{width}{scenario_key}_{int(snr_db)}db"


JAX_CPU_READINGS = {
    "psk8_cp1.0_64": (0, 50331648),
    "psk8_cp0.34_64": (12161, 50331648),
    "adapt_wf_cp1.0_64": (17787, 68157440),
    "adapt_wf_zp0.5_256": (100194, 271581184),
    "adapt_psk_wf_cp1.0_64": (1580, 52166656),
    "reference_adaptive_15db": (18970, 41418752),
    "reference_adaptive_20db": (5378, 60293120),
    "reference_adaptive_25db": (9687, 90701824),
    "wf_headline_64sc": (2707163, 100663296),
    "wf_scfde_default": (1136318, 33554432),
    "wf_cp034_128sc": (6499262, 134217728),
    "wf_zp_64sc": (2705667, 100663296),
    "noise_bump_uniform_0db": (12255376, 25165824),
    "noise_bump_uniform_5db": (11958759, 25165824),
    "noise_bump_uniform_10db": (11374755, 25165824),
    "noise_bump_uniform_15db": (10276953, 25165824),
    "noise_bump_uniform_20db": (8472936, 25165824),
    "noise_bump_uniform_25db": (6205414, 25165824),
    "noise_bump_uniform_30db": (3757426, 25165824),
    "noise_bump_wf_plus3_0db": (12322920, 25165824),
    "noise_bump_wf_plus3_5db": (12097055, 25165824),
    "noise_bump_wf_plus3_10db": (11656810, 25165824),
    "noise_bump_wf_plus3_15db": (10960770, 25165824),
    "noise_bump_wf_plus3_20db": (9825236, 25165824),
    "noise_bump_wf_plus3_25db": (6637112, 25165824),
    "noise_bump_wf_plus3_30db": (3965468, 25165824),
    "noise_bump_wf_plus6_0db": (12337855, 25165824),
    "noise_bump_wf_plus6_5db": (12121416, 25165824),
    "noise_bump_wf_plus6_10db": (11702108, 25165824),
    "noise_bump_wf_plus6_15db": (11053685, 25165824),
    "noise_bump_wf_plus6_20db": (10013329, 25165824),
    "noise_bump_wf_plus6_25db": (7027480, 25165824),
    "noise_bump_wf_plus6_30db": (4356699, 25165824),
    "noise_bump_512sc_uniform_0db": (12460498, 25165824),
    "noise_bump_512sc_uniform_5db": (12367784, 25165824),
    "noise_bump_512sc_uniform_10db": (12184023, 25165824),
    "noise_bump_512sc_uniform_15db": (11837933, 25165824),
    "noise_bump_512sc_uniform_20db": (11170039, 25165824),
    "noise_bump_512sc_uniform_25db": (9933709, 25165824),
    "noise_bump_512sc_uniform_30db": (7987501, 25165824),
    "noise_bump_512sc_wf_plus3_0db": (12481392, 25165824),
    "noise_bump_512sc_wf_plus3_5db": (12399937, 25165824),
    "noise_bump_512sc_wf_plus3_10db": (12214408, 25165824),
    "noise_bump_512sc_wf_plus3_15db": (11868038, 25165824),
    "noise_bump_512sc_wf_plus3_20db": (11207554, 25165824),
    "noise_bump_512sc_wf_plus3_25db": (9983277, 25165824),
    "noise_bump_512sc_wf_plus3_30db": (8050045, 25165824),
    "noise_bump_512sc_wf_plus6_0db": (12482764, 25165824),
    "noise_bump_512sc_wf_plus6_5db": (12403328, 25165824),
    "noise_bump_512sc_wf_plus6_10db": (12234589, 25165824),
    "noise_bump_512sc_wf_plus6_15db": (11917571, 25165824),
    "noise_bump_512sc_wf_plus6_20db": (11313779, 25165824),
    "noise_bump_512sc_wf_plus6_25db": (10187867, 25165824),
    "noise_bump_512sc_wf_plus6_30db": (8407230, 25165824),
    "noise_bump_1024sc_uniform_0db": (12495160, 25165824),
    "noise_bump_1024sc_uniform_5db": (12432697, 25165824),
    "noise_bump_1024sc_uniform_10db": (12305263, 25165824),
    "noise_bump_1024sc_uniform_15db": (12070732, 25165824),
    "noise_bump_1024sc_uniform_20db": (11620556, 25165824),
    "noise_bump_1024sc_uniform_25db": (10760759, 25165824),
    "noise_bump_1024sc_uniform_30db": (9229438, 25165824),
    "noise_bump_1024sc_wf_plus3_0db": (12507746, 25165824),
    "noise_bump_1024sc_wf_plus3_5db": (12444065, 25165824),
    "noise_bump_1024sc_wf_plus3_10db": (12321100, 25165824),
    "noise_bump_1024sc_wf_plus3_15db": (12083572, 25165824),
    "noise_bump_1024sc_wf_plus3_20db": (11636596, 25165824),
    "noise_bump_1024sc_wf_plus3_25db": (10782773, 25165824),
    "noise_bump_1024sc_wf_plus3_30db": (9259428, 25165824),
    "noise_bump_1024sc_wf_plus6_0db": (12509285, 25165824),
    "noise_bump_1024sc_wf_plus6_5db": (12453951, 25165824),
    "noise_bump_1024sc_wf_plus6_10db": (12335494, 25165824),
    "noise_bump_1024sc_wf_plus6_15db": (12113402, 25165824),
    "noise_bump_1024sc_wf_plus6_20db": (11701403, 25165824),
    "noise_bump_1024sc_wf_plus6_25db": (10912526, 25165824),
    "noise_bump_1024sc_wf_plus6_30db": (9517541, 25165824),
    "OFDM-CY1.0-512": (419, 100663296),
    "SC-CY1.0-1024": (0, 100663296),
    "SC-ZE1.0-1024": (3, 100663296),
    "flat_fading_cp_1024sc": (994741, 100663296),
    "headline_xla": (1915505, 100663296),
    "SC-CY1.0-1024_20db": (1969562, 100663296),
    "SC-ZE1.0-1024_20db": (1971122, 100663296),
    "adaptive_scfde_64sc_15db": (509055, 41418752),
    "adaptive_scfde_64sc_15db_fold_power": (502808, 41418752),
    "adaptive_scfde_64sc_20db": (34288, 60293120),
    "adaptive_scfde_64sc_20db_fold_power": (34290, 60293120),
    "adaptive_scfde_64sc_25db": (180615, 90701824),
    "adaptive_scfde_64sc_25db_fold_power": (180599, 90701824),
    "adaptive_scfde_64sc_zp_20db": (45915, 60293120),
    "adaptive_scfde_1024sc_20db": (3448270, 1085800448),
    "adaptive_scfde_1024sc_20db_fold_power": (3448274, 1085800448),
    "adaptive_scfde_1024sc_zp_20db": (3847430, 1085800448),
    "bitlevel_headline": (478897, 25165824),
    "bitlevel_adaptive": (1316, 15073280),
    # the giant path's 1024-sc links (jax_band_readings.py giant: 2^14 OFDM symbols)
    "long_ir_1024_zp": (403062, 67108864),
    "taps_1024_zp": (759195, 167772160),
}


def audit_cfg(num_ofdm, chunk=0, **kw):
    """An audit link of ``num_ofdm`` OFDM symbols."""
    from ofdm_tpu_torch.config import SimulationConfig

    base = dict(AUDIT_BASE, symbols_per_chunk=chunk, **kw)
    adaptive = base.get("adaptive_modulation_mode") == "CAPACITY_BASED"
    base["num_symbols"] = num_ofdm if adaptive else num_ofdm * base["num_subcarriers"]
    return SimulationConfig(**base)


def adaptive_cfg(snr_db, num_ofdm, chunk=MAIN_CHUNK):
    """The reference's adaptive config at ``snr_db`` on ``num_ofdm`` OFDM symbols."""
    from ofdm_tpu_torch.config import SimulationConfig

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ADAPTIVE_CONFIG)
    cfg = {c.snr_db: c for c in SimulationConfig.from_json(path)}[snr_db]
    return cfg.replace(num_symbols=num_ofdm, symbols_per_chunk=chunk)


def chains():
    """{chain: (link builder, kernel wrapper, plain version, launch counters)}."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    return {
        "diag": (lk.diag_link, lk.diag_chunk, lk.diag_chunk_plain, ("launches", "power_launches")),
        "fold": (fk.fold_link, fk.fold_chunk, fk.fold_chunk_plain, ("launches", "power_launches")),
        "lr": (lrk.lr_link, lrk.lr_chunk, lrk.lr_chunk_plain, ("launches", "power_launches")),
        "mm": (mmk.mm_link, mmk.mm_chunk, mmk.mm_chunk_plain, ("launches", "front_launches", "power_launches")),
    }


def band(name, r, reading="XLA path, CPU, 2^18 symbols"):
    """Hold a run's BER at z = BAND_Z against the JAX package's reading."""
    from ofdm_tpu_torch.ops import metrics as mt

    je, jb = JAX_CPU_READINGS[name]
    ok = mt.ber_equivalent(r["bit_errors"], r["total_bits"], je, jb, z=BAND_Z)
    print(f"band {name}: BER {r['bit_error_rate']} ({r['bit_errors']} / {r['total_bits']}) vs the JAX "
          f"package's {je / jb} ({je} / {jb}; {reading}) z={BAND_Z}: {'inside' if ok else 'OUTSIDE'}")
    if not ok:
        raise AssertionError(f"{name}: BER {r['bit_error_rate']} outside its band around {je / jb}")


def check_codec(name, device):
    """A chunk kernel in a new mode vs its plain version (``compare_chunk``)
    on the last 2^17-symbol chunk of a 2^27-symbol run, then the link
    through LinkRunner on one chunk: routed to the chain, on the kernel."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, kernel_mode, prepare

    chain, mode, kw = CODEC_LINKS[name]
    setup = prepare(audit_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **kw))
    link_fn, kernel, plain, counters = chains()[chain]
    link = link_fn(setup, device)
    if kernel_mode(setup) != chain or link.q.mode != mode:
        raise AssertionError(f"{name} routes to {kernel_mode(setup)} / {link.q.mode}, not {chain} / {mode}")
    orders = sorted({int(o) for o in setup.constellation_orders})
    if name == "adapt_flat_36db" and not (orders[-1] > setup.cfg.max_constellation_order
                                          and 1 << link.q.bits >= orders[-1]):
        raise AssertionError(f"{name}: orders {orders}, static width {link.q.bits}")
    tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
    err = compare_chunk(f"{chain}_chunk {mode} {name} (n={link.n}, bits={link.q.bits}, orders {orders}, tile {tile})",
                        kernel, plain, link, MAIN_SYMBOLS - MAIN_CHUNK, MAIN_CHUNK, setup.cfg.snr_db, device,
                        no_papr=getattr(link, "txext", False))
    for c in counters:
        setattr(kernel, c, 0)
    r = LinkRunner(prepare(audit_cfg(MAIN_CHUNK, MAIN_CHUNK, **kw))).run(MAIN_SEED)
    launches = tuple(getattr(kernel, c) for c in counters)
    if r["hotpath_used"] != "cuda" or launches != (1,) * len(counters):
        raise AssertionError(f"{name} through LinkRunner: {r['hotpath_used']}, launches {launches}")
    print(f"{name} through LinkRunner ({chain}, {mode}) on {MAIN_CHUNK} symbols: BER {r['bit_error_rate']}, "
          f"hotpath {r['hotpath_used']}, launches {launches}")
    return err


def diag_operations(link, chunk, ops_per_bin):
    """Operations one diag chunk needs: the per-bin chain as ``ops_per_bin``
    counts it, |y|^2 and its sum on each tile's measured-power slice, the
    PAPR product and statistic on the sampled tiles."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    tile = lk.tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    slice_bins = sum(min(link.slice, min(tile, chunk - t * tile)) for t in range(tiles)) * link.n * link.add_noise
    ops = chunk * link.n * sum(ops_per_bin.values()) + slice_bins * POWER_SUM_OPS
    if link.txext:  # no time plane in the chunk
        return ops
    sampled = lk.sampled_symbols(chunk, tile, link.pstride)
    return ops + sampled * (papr_product_ops(link) + PAPR_OPS * link.T)


def idft_ops(plan):
    """Operations of one n-point block (I)DFT (csrc/block_dft.cuh): radix-2
    10 a butterfly, n / 2 log2 n of them; the split 8 a term over n (N1 +
    N2) and 6 n twiddles; 2 n for the scale."""
    n = plan.n
    return ((n // 2) * plan.log2n * 10 if plan.log2n >= 0 else n * (plan.n1 + plan.n2) * 8 + 6 * n) + 2 * n


def papr_matrix_bytes(link):
    """Bytes a diag chunk reads for its in-run time block: the IDFT's
    twiddle rows, or F_tx (none under txext)."""
    if link.txext:
        return 0
    return 8 * link.n if link.plan is not None else 8 * link.n * link.T


def papr_product_ops(link):
    """Operations of a diag link's in-run time block a sampled symbol: its
    n-point IDFT (``idft_ops``) where the link has a plan, else the product
    with F_tx (``product_ops``: its distinct columns)."""
    return product_ops(link.fr, link.fi) if link.plan is None else idft_ops(link.plan)


def adaptive_path(card, device, headline_ms):
    """The twelve codec checks, then the reference's adaptive link on 2^26 OFDM
    symbols through the diag kernel in aqam mode (setup against
    docs/RESULTS.md, launch counters, BER band, the profile, the kernel's
    times), its 15 / 25 dB points and the audit links' BER bands.  Returns
    the kernels-line entry of diag_chunk in aqam mode."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    err = max(check_codec(name, device) for name in CODEC_LINKS)

    setup = prepare(adaptive_cfg(20.0, ADAPTIVE_SYMBOLS))
    wl_gap = abs(setup.water_level - RESULTS_WATER_LEVEL)
    print(f"adaptive_64sc setup: water level {setup.water_level!r} (docs/RESULTS.md {RESULTS_WATER_LEVEL}, "
          f"gap {wl_gap:.3e}), {setup.bits_per_ofdm_symbol} bits per OFDM symbol, orders "
          f"{setup.constellation_orders.tolist()}")
    if (wl_gap > 1e-12 or setup.bits_per_ofdm_symbol != RESULTS_BITS_PER_OFDM
            or setup.constellation_orders.tolist() != RESULTS_ORDERS):
        raise AssertionError("adaptive_64sc setup differs from docs/RESULTS.md:61-67")
    runner = LinkRunner(setup)
    if runner.mode != "diag" or runner.link.q.mode != "aqam":
        raise AssertionError(f"adaptive_64sc routed to {runner.mode} / {runner.link.q.mode}")
    runner.run(1)  # warm-up
    lk.diag_chunk.launches = lk.diag_chunk.power_launches = 0
    r = runner.run(MAIN_SEED)
    launches = (lk.diag_chunk.launches, lk.diag_chunk.power_launches)
    num_chunks = ADAPTIVE_SYMBOLS // MAIN_CHUNK
    print(f"adaptive_64sc run [{card}]: {ADAPTIVE_SYMBOLS} OFDM symbols ({r['total_bits']} bits), "
          f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} run_s={r['transmission_time_ms'] / 1e3:.4f} "
          f"BER={r['bit_error_rate']} SER={r['symbol_error_rate']} papr_db={r['papr_db']:.4f} "
          f"hotpath={r['hotpath_used']} launches: diag_main {launches[0]}, power_partials {launches[1]}")
    if launches != (num_chunks, num_chunks) or r["hotpath_used"] != "cuda":
        raise AssertionError(f"adaptive_64sc launched diag_main / power_partials {launches}, not {num_chunks} each")
    band("reference_adaptive_20db", r)
    print_profile(card, "adaptive_64sc", profile_run(runner, 20.0))

    sweep = {20.0: r["bit_error_rate"]}
    for snr in (15.0, 25.0):
        rs = LinkRunner(prepare(adaptive_cfg(snr, BAND_SYMBOLS))).run(2)
        band(f"reference_adaptive_{int(snr)}db", rs)
        sweep[snr] = rs["bit_error_rate"]
    print(f"adaptive_64sc sweep 15/20/25 dB BER: {[sweep[k] for k in (15.0, 20.0, 25.0)]}")
    for name, (chain, kw) in BAND_LINKS.items():
        cell = LinkRunner(prepare(audit_cfg(BAND_SYMBOLS, MAIN_CHUNK, **kw)))
        if cell.mode != chain:
            raise AssertionError(f"{name} routed to {cell.mode}, not {chain}")
        band(name, cell.run(MAIN_SEED))

    link = runner.link
    snr_lin = lk.snr_linear(20.0)
    acc, psum = lk.new_accumulators(device)
    work = lk.chunk_workspace(link, MAIN_CHUNK, device)
    k_ms = cuda_ms(lambda: lk.diag_chunk(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    p_ms = cuda_ms(lambda: lk.diag_chunk_plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum), 3)
    ops = diag_operations(link, MAIN_CHUNK, OPS_PER_BIN_AQAM)
    rows = 4 * (7 * link.n + 5 * link.n) + papr_matrix_bytes(link)
    bound = max(ops / PEAK_OPS, (rows + 3 * 8) / PEAK_BYTES) * 1e3
    print(f"diag_chunk aqam at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms (the headline's qam "
          f"{headline_ms:.4f} ms, ratio {k_ms / headline_ms:.4f}), plain {p_ms:.3f} ms, bound {bound:.4f} ms "
          f"({ops} operations; orders {sorted(set(np.asarray(setup.constellation_orders).tolist()))})")
    torch.cuda.synchronize()
    return {"name": "diag_chunk (aqam)", "route": "cuda", "source": "ofdm_tpu_torch/csrc/link_kernel.cu",
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[0],
            "power_partials_launches": launches[1], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None}


# --- the power stages and the noise-bump campaign ------------------------------------

# Operations a bin of each stage, counted from csrc/link_common.cuh as
# OPS_PER_BIN is: sqrt(P) (two multiplies, and the row's load); the
# normalization (|e|^2, its share of the sums, f x slicer and the two
# multiplies; the tile reduction is negligible); the post-EQ noise (Philox,
# the Box-Muller chain, sigma x radius and the two multiply-adds);
# 1/sqrt(P) (two multiplies).
STAGE_OPS = {"power": 2, "normalize": 7, "post_noise": OPS_PER_BIN["philox"] + OPS_PER_BIN["noise"] + 5,
             "compensate": 2}
# The reference's custom-channel demo IR (examples/custom_channel_demo.py,
# energy 1.22) and the 4-tap IR of energy 1.3225: ISI-free diag links over
# taps without unit energy, on 64 sc, 16-QAM, MMSE, 20 dB, CP 1.0.
CUSTOM_IRS = {"custom_channel_demo": (1.0, 0.4 - 0.2j, 0.1 + 0.1j), "ir_4tap_1.3225": (1.0, 0.5, 0.25j, 0.1)}


def sqrt_power_row(runner, snr_db):
    """The apply_power stage's (1, n) row of a runner's SNR point: f32(sqrt(P))."""
    import numpy as np
    import torch

    return torch.tensor(np.sqrt(runner.point_params(snr_db)[0])[None], dtype=torch.float32, device=runner.device)


def stage_checks(device):
    """Each staged chunk kernel vs its plain version (``compare_chunk``) on
    the last 2^17-symbol chunk of a 2^27-symbol run (2^26 for lr): both
    switches on diag, fold, lr (wide_1024sc: the in-run PAPR from the scaled
    symbols) and mm (zp_64sc's shape) waterfilling links and on the
    reference's adaptive link (aqam); the noise-bump chunk; and the two
    custom IRs without unit energy on the plain diag kernel.  Returns the
    largest difference."""
    import numpy as np

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    last = MAIN_SYMBOLS - MAIN_CHUNK
    cases = [
        ("wf_headline_64sc", headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last, None),
        ("wf_scfde_default", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last, None),
        ("wf_wide_1024sc", wide_cfg(LR_SYMBOLS, MAIN_CHUNK, **_WF), LR_SYMBOLS - MAIN_CHUNK, None),
        ("wf_zp_64sc", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last, None),
        ("wf_adaptive_64sc", adaptive_cfg(20.0, MAIN_SYMBOLS).replace(apply_power_allocation=True,
                                                                      normalize_before_demap=True), last, None),
    ] + [(name, headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK, constellation_order=16, snr_db=20.0), last, np.asarray(ir))
         for name, ir in CUSTOM_IRS.items()]
    chains_ = chains()
    err = 0.0
    for name, cfg, sym0, ir in cases:
        runner = LinkRunner(prepare(cfg, channel_ir=ir), device)
        _, kernel, plain, _ = chains_[runner.mode]
        link = runner.link
        rows = sqrt_power_row(runner, cfg.snr_db) if cfg.apply_power_allocation else None
        if ir is not None:
            d = link.cr.cpu().numpy() + 1j * link.ci.cpu().numpy()
            h = link.hr.cpu().numpy() + 1j * link.hi.cpu().numpy()
            print(f"{name}: IR energy {float(np.sum(np.abs(ir) ** 2))}, channel rows / equalizer rows "
                  f"{float(np.mean(np.abs(d) / np.abs(h)))} (1/||ir|| {1.0 / float(np.linalg.norm(ir))})")
        tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
        err = max(err, compare_chunk(
            f"{runner.mode}_chunk {name} (n={link.n}, stages={lk.link_stages(link)}, mode {link.q.mode}, tile {tile}, "
            f"txext={getattr(link, 'txext', False)})", kernel, plain, link, sym0, MAIN_CHUNK, cfg.snr_db, device,
            rows=rows))
    # the noise-bump chunk: all four stages, wf_plus3 at 15 dB
    fused = nb.FusedLink(MAIN_SYMBOLS, 64, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    scen = nb.SCENARIOS[1]
    rows = fused.rows(scen, nb.create_noise_profile(64, scen.noise_bump_db), 15.0)
    err = max(err, compare_chunk(f"diag_chunk noise_bump {scen.key} 15 dB (stages={lk.link_stages(fused.link)})",
                                 lk.diag_chunk, lk.diag_chunk_plain, fused.link, last, MAIN_CHUNK, 15.0, device,
                                 rows=rows))
    return err


def staged_operations(chain, link, chunk):
    """(needed, added): the operations one staged chunk needs, the chain's
    count plus its stages a bin, and the work the design adds (the chain's
    own, plus, but on the diag chains, which run the chain once and keep e
    in a scratch plane, the normalization pass: the chain again up to e)."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    stages = lk.link_stages(link)
    per_bin = sum(ops for bit, ops in zip((lk.STAGE_POWER, lk.STAGE_NORMALIZE, lk.STAGE_POST_NOISE,
                                           lk.STAGE_COMPENSATE), STAGE_OPS.values()) if stages & bit)
    if chain == "diag":
        ops_per_bin = dict(OPS_PER_BIN_AQAM if link.q.mode == "aqam" else OPS_PER_BIN)
        if not link.add_noise:
            ops_per_bin["noise"] = 0
        base = diag_operations(link, chunk, ops_per_bin)
        added = 0
    else:
        base, *extra = {"fold": fold_operations, "lr": lr_operations, "mm": mm_operations}[chain](link, chunk)
        added = sum(extra)
    needed = base + chunk * link.n * per_bin
    if link.normalize and chain != "diag":
        added += needed
    return needed, added


def noise_bump_path(card, device, headline_ms, err):
    """The slice's main path: the noise-bump study's fused campaign through
    ``run_noise_bump_experiment`` at 2^24 OFDM symbols a point (3 scenarios x
    7 SNR points, one link), its launch counters, the reference curves'
    gate, the z = 5 band of every point, the profile and the staged
    diag_chunk's times.  Returns the kernels-line entry."""
    import torch

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import metrics as mt

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tmp", "noise_bump")  # gitignored
    nb.run_noise_bump_experiment((15.0,), fused_symbols_per_point=MAIN_CHUNK, results_dir=out_dir, seed=1,
                                 chunk=MAIN_CHUNK)  # warm-up
    torch.cuda.synchronize()
    lk.diag_chunk.launches = lk.diag_chunk.norm_launches = lk.diag_chunk.power_launches = 0
    lk.diag_chunk.demap_launches = 0
    t0 = time.perf_counter()
    res = nb.run_noise_bump_experiment(NOISE_BUMP_SNRS, fused_symbols_per_point=NOISE_BUMP_SYMBOLS,
                                       results_dir=out_dir, seed=NOISE_BUMP_SEED, chunk=MAIN_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (lk.diag_chunk.launches, lk.diag_chunk.norm_launches, lk.diag_chunk.demap_launches,
                lk.diag_chunk.power_launches)
    points = len(nb.SCENARIOS) * len(NOISE_BUMP_SNRS)
    want = points * (NOISE_BUMP_SYMBOLS // MAIN_CHUNK)
    print(f"noise_bump campaign [{card}]: {points} points x {NOISE_BUMP_SYMBOLS} OFDM symbols in {wall:.4f} s: "
          f"{wall / points * 1e3:.3f} ms and {NOISE_BUMP_SYMBOLS * points / wall:.1f} OFDM syms/s a point on "
          f"average; launches: diag_staged (the chain, once a chunk) {launches[0]}, norm_factors {launches[1]}, "
          f"diag_demap {launches[2]}, power_partials {launches[3]}")
    if launches != (want, want, want, 0):
        raise AssertionError(f"noise_bump campaign launched {launches}, not ({want}, {want}, {want}, 0)")
    bits = NOISE_BUMP_SYMBOLS * 64 * 6
    for scenario in nb.SCENARIOS:
        bers = res[scenario.name]
        print(f"noise_bump {scenario.key} BER at {list(NOISE_BUMP_SNRS)} dB: {bers}")
        for snr, ber in zip(NOISE_BUMP_SNRS, bers):
            je, jb = JAX_CPU_READINGS[noise_bump_name(scenario.key, snr)]
            errors = int(round(ber * bits))
            if not mt.ber_equivalent(errors, bits, je, jb, z=BAND_Z):
                raise AssertionError(f"noise_bump {scenario.key} {snr} dB: BER {ber} outside z={BAND_Z} of the JAX "
                                     f"package's _Link reading {je / jb}")
        for snr, ref in zip((0.0, 15.0, 30.0), NOISE_BUMP_REFERENCE[scenario.key]):
            got = bers[NOISE_BUMP_SNRS.index(snr)]
            if not abs(got - ref) < NOISE_BUMP_TOL:
                raise AssertionError(f"noise_bump {scenario.key} {snr} dB: BER {got} vs reference {ref}")
    print(f"noise_bump: every point inside z={BAND_Z} of the JAX package's _Link reading (CPU, 2^16 symbols); "
          f"0 / 15 / 30 dB within {NOISE_BUMP_TOL} of the reference curves {json.dumps(NOISE_BUMP_REFERENCE)}")

    fused = nb.FusedLink(NOISE_BUMP_SYMBOLS, 64, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    scen = nb.SCENARIOS[1]
    profile = nb.create_noise_profile(64, scen.noise_bump_db)
    rows = fused.rows(scen, profile, 15.0)
    print_profile(card, "noise_bump point (wf_plus3, 15 dB)",
                  profile_call(lambda: fused.run_point(7, scen, profile, 15.0)))
    link = fused.link
    snr_lin = lk.snr_linear(15.0)
    acc, psum = lk.new_accumulators(device)
    work = lk.chunk_workspace(link, MAIN_CHUNK, device)
    k_ms = cuda_ms(lambda: lk.diag_chunk(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work, rows), 20)
    p_ms = cuda_ms(lambda: lk.diag_chunk_plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, rows=rows), 3)
    ops, added = staged_operations("diag", link, MAIN_CHUNK)
    rows_bytes = 4 * (7 * link.n + 3 * link.n) + papr_matrix_bytes(link)
    bound = max(ops / PEAK_OPS, (rows_bytes + 3 * 8) / PEAK_BYTES) * 1e3
    print(f"diag_chunk with the noise-bump stages at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms (the "
          f"headline's qam {headline_ms:.4f} ms, ratio {k_ms / headline_ms:.4f}), plain {p_ms:.3f} ms, bound "
          f"{bound:.4f} ms ({ops} operations needed; the design adds {added}, {added / PEAK_OPS * 1e3:.4f} ms at "
          f"the same rate, and a scratch plane of {lk.ONEPASS_BYTES_PER_BIN} bytes a bin written and read once)")
    return {"name": "diag_chunk (noise-bump stages)", "route": "cuda", "source": "ofdm_tpu_torch/csrc/link_kernel.cu",
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[0],
            "norm_launches": launches[1], "demap_launches": launches[2], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": "operations", "library_ms": None}


def staged_path(card, device, err):
    """Both switches through LinkRunner, one waterfilling link a chain at
    2^20 OFDM symbols (launch counters, the z = 5 band against the JAX
    package's CPU reading), then each chain's staged kernel timed at its
    check link beside its plain version and bound.  Returns the
    kernels-line entries."""
    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    chains_ = chains()
    launches = {}
    for name, (chain, kw) in STAGED_BAND_LINKS.items():
        _, kernel, _, counters = chains_[chain]
        runner = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=BAND_SYMBOLS * kw["num_subcarriers"],
                                                     symbols_per_chunk=MAIN_CHUNK)))
        if runner.mode != chain:
            raise AssertionError(f"{name} routed to {runner.mode}, not {chain}")
        # the diag chain: the chain once, norm_factors and diag_demap a chunk
        counters = counters + ("norm_launches",) + (("demap_launches",) if chain == "diag" else ())
        for c in counters:
            setattr(kernel, c, 0)
        r = runner.run(MAIN_SEED)
        got = tuple(getattr(kernel, c) for c in counters)
        want = BAND_SYMBOLS // MAIN_CHUNK
        print(f"{name} through LinkRunner ({chain}): launches {dict(zip(counters, got))}, "
              f"papr_estimator {r['papr_estimator']}")
        if got != (want,) * len(got) or r["hotpath_used"] != "cuda":
            raise AssertionError(f"{name}: launches {got}, not {want} each")
        band(name, r)
        launches[chain] = got[0]

    entries = []
    last = MAIN_SYMBOLS - MAIN_CHUNK
    timed = {"diag": (headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last),
             "fold": (scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last),
             "lr": (wide_cfg(LR_SYMBOLS, MAIN_CHUNK, **_WF), LR_SYMBOLS - MAIN_CHUNK),
             "mm": (zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF), last)}
    for chain, (cfg, sym0) in timed.items():
        runner = LinkRunner(prepare(cfg))
        _, kernel, plain, _ = chains_[chain]
        link = runner.link
        rows = sqrt_power_row(runner, cfg.snr_db)
        snr_lin = lk.snr_linear(cfg.snr_db)
        acc, psum = lk.new_accumulators(device)
        work = runner.kernel.workspace(link, MAIN_CHUNK, device)
        k_ms = cuda_ms(lambda: kernel(link, (3, 4), sym0, MAIN_CHUNK, snr_lin, acc, psum, work, rows), 20)
        p_ms = cuda_ms(lambda: plain(link, (3, 4), sym0, MAIN_CHUNK, snr_lin, acc, psum, rows=rows), 2)
        ops, added = staged_operations(chain, link, MAIN_CHUNK)
        bound = ops / PEAK_OPS * 1e3
        print(f"{chain}_chunk with apply_power + normalize at {MAIN_CHUNK} symbols ({cfg.num_subcarriers} sc) "
              f"[{card}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound:.4f} ms ({ops} operations needed; "
              f"the design adds {added}, {added / PEAK_OPS * 1e3:.4f} ms at the same rate)")
        entries.append({"name": f"{chain}_chunk (apply_power + normalize)", "route": "cuda",
                        "source": f"ofdm_tpu_torch/csrc/{'link' if chain == 'diag' else chain}_kernel.cu",
                        "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[chain],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                        "bound_by": "operations", "library_ms": None})
    return entries


# --- symbol capture, the eager chain and its two Philox kernels ----------------------

# K5's math per element beyond Philox: two 24-bit conversions, logf (~20),
# sqrtf (~8), sincosf's reduction and two polynomials (~16) and four
# multiplies (an estimate, as OPS_PER_BIN).
NORMAL_OPS = 50
CAPTURE_COLLECT = 4096
EAGER_READING = "XLA path, CPU, 2^24 / n OFDM symbols"
NOISE_BUMP_EAGER_SYMBOLS = 2048  # _Link's batch, the JAX package's default


def normal_entries(card, device):
    """K5 (``prng.normal_planes``) against its plain version on a (2^15, 128)
    plane and at every shape the main path draws (each eager link's
    (2^17, T) AWGN planes, ``_Link``'s (2048, 64) post-EQ noise), the moment
    gate on its planes, K4's plane form (``prng.philox_plane``) bit-equal to
    its plain version and to ``link_words``' word 0 at sym0 > 2^32 at every
    shape the main path draws (each eager link's (2^17, n) TX words,
    ``_Link``'s (2048, 64)), and both timed at the eager chain's shapes
    beside their plain versions, bounds and torch.randn.  Returns the two
    kernels-line entries (launches filled in later)."""
    import torch

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import prepare

    key = NOISE_SEEDS
    blocks = {name: prepare(SimulationConfig(**kw, num_symbols=kw["num_subcarriers"])).block_length
              for name, kw in EAGER_LINKS.items()}
    widths = sorted({kw["num_subcarriers"] for kw in EAGER_LINKS.values()})
    T = blocks["SC-CY1.0-1024"]
    bump = (NOISE_BUMP_EAGER_SYMBOLS, 64)
    normal_shapes = ([(NOISE_SHAPE, prng.AWGN_STREAM)] + [((MAIN_CHUNK, t), prng.AWGN_STREAM)
                                                         for t in sorted(set(blocks.values()))]
                     + [(bump, prng.BUMP_STREAM)])
    err = 0.0
    for (rows, cols), c3 in normal_shapes:
        zk = prng.normal_planes(key, 7, rows, cols, c3, device)
        zp = prng.normal_planes_plain(key, 7, rows, cols, c3, device)
        e = max(float((zk[0] - zp[0]).abs().max()), float((zk[1] - zp[1]).abs().max()))
        print(f"normal_pair ({rows}, {cols}), c3 = {c3}: kernel vs plain max abs diff {e:.3e} (tolerance 1e-5: the "
              f"library's logf / sincosf against PyTorch's, a few ulps)")
        if e > 1e-5:
            raise AssertionError(f"normal_pair ({rows}, {cols}) kernel vs plain {e}")
        err = max(err, e)
        del zk, zp
    ok, m = moment_gate(*prng.normal_planes(key, 0, *NOISE_SHAPE, prng.AWGN_STREAM, device))
    print(f"normal_pair moment gate: {json.dumps(m)} ok={ok}")
    if not ok:
        raise AssertionError("normal_pair moment gate failed")
    sym0 = (1 << 32) + 12345
    plane_err = 0
    for rows, cols in [(4096, 1024)] + [(MAIN_CHUNK, n) for n in widths] + [bump]:
        wk = prng.philox_plane(key, sym0, rows, cols, 0, device)
        wp = prng.philox_plane_plain(key, sym0, rows, cols, 0, device)
        raw = prng.link_words(key, sym0, rows, cols, device)[0]
        e = int((wk.to(torch.int64) - wp.to(torch.int64)).abs().max())
        plane_err = max(plane_err, e)
        if e != 0 or not torch.equal(wk.to(torch.int64) & prng.M32, raw):
            raise AssertionError(f"philox_plane ({rows}, {cols}) differs from its plain version (max abs diff {e}) "
                                 f"or from link_words' word 0")
        print(f"philox_plane: ({rows}, {cols}) at sym0 {sym0} bit-equal to its plain version and to link_words' "
              f"word 0")
        del wk, wp, raw
    torch.cuda.empty_cache()

    elems = MAIN_CHUNK * T
    nk = cuda_ms(lambda: prng.normal_planes(key, 0, MAIN_CHUNK, T, prng.AWGN_STREAM, device), 20)
    npl = cuda_ms(lambda: prng.normal_planes_plain(key, 0, MAIN_CHUNK, T, prng.AWGN_STREAM, device), 2)
    rn = cuda_ms(lambda: torch.randn((2, MAIN_CHUNK, T), device=device), 20)
    n_ops, n_bytes = elems * (OPS_PER_BIN["philox"] + NORMAL_OPS), elems * 8
    n_bound = max(n_ops / PEAK_OPS, n_bytes / PEAK_BYTES) * 1e3
    words = MAIN_CHUNK * 1024
    pk = cuda_ms(lambda: prng.philox_plane(key, 0, MAIN_CHUNK, 1024, 0, device), 20)
    ppl = cuda_ms(lambda: prng.philox_plane_plain(key, 0, MAIN_CHUNK, 1024, 0, device), 2)
    p_ops, p_bytes = words * OPS_PER_BIN["philox"], words * 4
    p_bound = max(p_ops / PEAK_OPS, p_bytes / PEAK_BYTES) * 1e3
    print(f"normal_pair at ({MAIN_CHUNK}, {T}) [{card}]: kernel {nk:.4f} ms, plain {npl:.3f} ms, bound "
          f"{n_bound:.4f} ms ({n_ops} operations, {n_bytes} bytes); torch.randn of both planes {rn:.4f} ms "
          f"(other numbers: for scale only)")
    print(f"philox_plane at ({MAIN_CHUNK}, 1024) [{card}]: kernel {pk:.4f} ms, plain {ppl:.3f} ms, bound "
          f"{p_bound:.4f} ms ({p_ops} operations, {p_bytes} bytes)")
    torch.cuda.synchronize()
    return [
        {"name": "normal_pair", "route": "cuda", "source": "ofdm_tpu_torch/csrc/boxmuller.cu",
         "replaces": "ofdm_tpu/ops/prng.py:120", "launches": None, "max_abs_err": err, "ms": nk, "plain_ms": npl,
         "bound_ms": n_bound, "bound_by": "operations" if n_ops / PEAK_OPS >= n_bytes / PEAK_BYTES else "bytes",
         "library_ms": None, "randn_ms": rn},
        {"name": "philox_plane", "route": "cuda", "source": "ofdm_tpu_torch/csrc/boxmuller.cu",
         "replaces": "ofdm_tpu/ops/prng.py:64", "launches": None, "max_abs_err": float(plane_err), "ms": pk, "plain_ms": ppl,
         "bound_ms": p_bound, "bound_by": "operations" if p_ops / PEAK_OPS >= p_bytes / PEAK_BYTES else "bytes",
         "library_ms": None},
    ]


def capture_links():
    """(name, chain, config) of the capture checks: one link a chain at its
    usual size (qam, and aqam on diag), a waterfilling link under both
    switches, and the audit's 8-PSK link on fold and adaptive-PSK link on
    mm (whose dumps write raw points)."""
    return [
        ("headline", "diag", headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK)),
        ("adaptive_64sc", "diag", adaptive_cfg(20.0, ADAPTIVE_SYMBOLS)),
        ("scfde_default", "fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK)),
        ("wide_1024sc", "lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK)),
        ("lr_1024sc_zp", "lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK, prefix_type="ZERO")),
        ("zp_64sc", "mm", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK)),
        ("wf_zp_64sc", "mm", zp_cfg(BAND_SYMBOLS, MAIN_CHUNK, **_WF)),
        ("psk8_cp0.34_64", "fold", audit_cfg(BAND_SYMBOLS, MAIN_CHUNK, **BAND_LINKS["psk8_cp0.34_64"][1])),
        ("adapt_psk_wf_zp1.0_64", "mm", audit_cfg(BAND_SYMBOLS, MAIN_CHUNK,
                                                  **CODEC_LINKS["adapt_psk_wf_zp1.0_64"][2])),
    ]


def capture_check(card, device, name, chain, cfg, collect):
    """``LinkRunner.run(seed, collect_symbols=collect)`` on one link: the run's
    BER equals the same run's without capture to the last digit, one dump
    launch, ``received_symbols_exact``; the points equal the plain
    version's chunk-0 points on the card within 1e-5 and the kernel's own
    replay bitwise; the replay counts what the plain build (and the plain
    version) count on chunk 0.  Returns (max abs error, the runner, the
    dump launches of the capture run)."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    _, kernel, plain, _ = chains()[chain]
    runner = LinkRunner(prepare(cfg))
    if runner.mode != chain:
        raise AssertionError(f"{name} routed to {runner.mode}, not {chain}")
    r0 = runner.run(MAIN_SEED)
    kernel.dump_launches = 0
    r1 = runner.run(MAIN_SEED, collect_symbols=collect)
    dumps = kernel.dump_launches
    got = torch.from_numpy(r1["received_symbols"]).to(device)
    if (r1["bit_error_rate"] != r0["bit_error_rate"] or r1["received_symbols_exact"] is not True or dumps != 1
            or got.shape != (collect,)):
        raise AssertionError(f"{name}: capture run BER {r1['bit_error_rate']} vs {r0['bit_error_rate']}, exact "
                             f"{r1['received_symbols_exact']}, dump launches {dumps}, {tuple(got.shape)} points")
    link = runner.link
    n = cfg.num_subcarriers
    chunk = runner._chunk_plan()[0]
    key = prng.key_words(MAIN_SEED)
    snr_lin = lk.snr_linear(cfg.snr_db)
    rows = sqrt_power_row(runner, cfg.snr_db) if cfg.apply_power_allocation else None
    D = lk.dump_rows(collect, n, chunk)
    counts = {}
    points = {}
    for what, fn, dump in (("replay", kernel, lk.new_dump(D, n, device)), ("plain build", kernel, None),
                           ("plain version", plain, lk.new_dump(D, n, device))):
        acc, psum = lk.new_accumulators(device)
        fn(link, key, 0, chunk, snr_lin, acc, psum, rows=rows, dump=dump)
        torch.cuda.synchronize()
        counts[what] = tuple(acc.tolist()[:2])
        if dump is not None:
            points[what] = torch.complex(dump[0], dump[1]).reshape(-1)[:collect]
    err = float((got - points["plain version"]).abs().max())
    print(f"capture {name} ({chain}, {link.q.mode}, stages {lk.link_stages(link)}) [{card}]: {collect} points, "
          f"BER {r1['bit_error_rate']} with and without capture; max abs diff to the plain version's chunk-0 "
          f"points {err:.3e}; chunk-0 counts replay {counts['replay']}, plain build {counts['plain build']}, "
          f"plain version {counts['plain version']}")
    if not torch.equal(got, points["replay"]):
        raise AssertionError(f"{name}: run()'s capture differs from the kernel's replay")
    if err > 1e-5:
        raise AssertionError(f"{name}: dump vs plain {err}")
    if not counts["replay"] == counts["plain build"] == counts["plain version"]:
        raise AssertionError(f"{name}: chunk-0 counts {counts}")
    return err, runner, dumps


def capture_path(card, device):
    """Capture on every chain (``capture_check``), once more over a whole
    headline chunk, then each chain's chunk with the dump stage timed on
    its first link.  Returns the four dump entries of the kernels line."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk

    chains_ = chains()
    errs, firsts, launches = {}, {}, {}
    links = [(name, chain, cfg, CAPTURE_COLLECT) for name, chain, cfg in capture_links()]
    links.append(("headline (a whole chunk)", "diag", headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK), MAIN_CHUNK * 64))
    for name, chain, cfg, collect in links:
        err, runner, dumps = capture_check(card, device, name, chain, cfg, collect)
        errs[chain] = max(errs.get(chain, 0.0), err)
        launches[chain] = launches.get(chain, 0) + dumps
        firsts.setdefault(chain, (runner, cfg))
    entries = []
    for chain, (runner, cfg) in firsts.items():
        _, kernel, plain, _ = chains_[chain]
        link = runner.link
        n = cfg.num_subcarriers
        snr_lin = lk.snr_linear(cfg.snr_db)
        acc, psum = lk.new_accumulators(device)
        work = runner.kernel.workspace(link, MAIN_CHUNK, device)
        D = lk.dump_rows(CAPTURE_COLLECT, n, MAIN_CHUNK)
        dump = lk.new_dump(D, n, device)
        k_ms = cuda_ms(lambda: kernel(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work, dump=dump), 20)
        p_ms = cuda_ms(lambda: plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, dump=dump), 2)
        base_ms = cuda_ms(lambda: kernel(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
        ops = staged_operations(chain, link, MAIN_CHUNK)[0] + 2 * D * n
        dump_bytes = 8 * D * n
        bound = max(ops / PEAK_OPS, dump_bytes / PEAK_BYTES) * 1e3
        print(f"{chain}_chunk with the dump stage ({D} rows) at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms "
              f"(the plain build {base_ms:.4f} ms), plain {p_ms:.3f} ms, bound {bound:.4f} ms ({ops} operations)")
        entries.append({"name": f"{chain}_chunk (dump)", "route": "cuda",
                        "source": f"ofdm_tpu_torch/csrc/{'link' if chain == 'diag' else chain}_kernel.cu",
                        "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[chain],
                        "max_abs_err": errs[chain], "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                        "bound_by": "operations", "library_ms": None, "plain_build_ms": base_ms})
    torch.cuda.synchronize()
    return entries


def eager_path(card, device, prng_entries):
    """The eager chain at full width: each of EAGER_LINKS at 2^20 OFDM
    symbols in chunks of 2^17 through LinkRunner (hotpath "eager", one K4
    plane and one K5 pair a chunk, the z = 5 band, run time and the
    profiler's busy share, the peak device memory); fills the launches of
    ``prng_entries``."""
    import torch

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    total = {"normal_pair": 0, "philox_plane": 0}
    for name, kw in EAGER_LINKS.items():
        n = kw["num_subcarriers"]
        runner = LinkRunner(prepare(SimulationConfig(**kw, num_symbols=n * EAGER_SYMBOLS,
                                                     symbols_per_chunk=MAIN_CHUNK)))
        if runner.mode != "eager":
            raise AssertionError(f"{name} routed to {runner.mode}")
        runner.run(1)  # warm-up
        prng.normal_planes.launches = prng.philox_plane.launches = 0
        torch.cuda.reset_peak_memory_stats()
        r = runner.run(MAIN_SEED)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = (prng.normal_planes.launches, prng.philox_plane.launches)
        chunks = EAGER_SYMBOLS // MAIN_CHUNK
        run_s = r["transmission_time_ms"] / 1e3
        print(f"eager {name} [{card}]: {EAGER_SYMBOLS} OFDM symbols x {n} sc, run_s={run_s:.4f} "
              f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} BER={r['bit_error_rate']} "
              f"papr_db={r['papr_db']:.4f} hotpath={r['hotpath_used']} launches: normal_pair {launches[0]}, "
              f"philox_plane {launches[1]}; peak device memory {peak_gb:.2f} GB")
        if r["hotpath_used"] != "eager" or launches != (chunks, chunks):
            raise AssertionError(f"eager {name}: {r['hotpath_used']}, launches {launches}, not {chunks} each")
        band(name, r, EAGER_READING)
        total["normal_pair"] += launches[0]
        total["philox_plane"] += launches[1]
        print_profile(card, f"eager {name}", profile_run(runner, kw["snr_db"]))
    for e in prng_entries:
        e["launches"] = total[e["name"]]


def eager_noise_bump_path(card, device):
    """The noise-bump study's eager-only campaign (``_Link``, 2048 OFDM symbols
    a point, 21 points): the reference curves' gate, z = 5 against the JAX
    package's ``_Link`` readings, one K4 plane and one K5 pair a point."""
    import torch

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import metrics as mt
    from ofdm_tpu_torch.ops import prng

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tmp", "noise_bump_eager")  # gitignored
    nb.run_noise_bump_experiment((15.0,), NOISE_BUMP_EAGER_SYMBOLS, results_dir=out_dir, seed=1,
                                 fused_symbols_per_point=0)  # warm-up
    torch.cuda.synchronize()
    prng.normal_planes.launches = prng.philox_plane.launches = 0
    t0 = time.perf_counter()
    res = nb.run_noise_bump_experiment(NOISE_BUMP_SNRS, NOISE_BUMP_EAGER_SYMBOLS, results_dir=out_dir,
                                       seed=NOISE_BUMP_SEED, fused_symbols_per_point=0)
    wall = time.perf_counter() - t0
    points = len(nb.SCENARIOS) * len(NOISE_BUMP_SNRS)
    launches = (prng.normal_planes.launches, prng.philox_plane.launches)
    print(f"noise_bump eager campaign [{card}]: {points} points x {NOISE_BUMP_EAGER_SYMBOLS} OFDM symbols in "
          f"{wall:.4f} s; launches normal_pair {launches[0]}, philox_plane {launches[1]}")
    if launches != (points, points):
        raise AssertionError(f"noise_bump eager campaign launched {launches}, not {points} each")
    bits = NOISE_BUMP_EAGER_SYMBOLS * 64 * 6
    for scenario in nb.SCENARIOS:
        bers = res[scenario.name]
        print(f"noise_bump eager {scenario.key} BER at {list(NOISE_BUMP_SNRS)} dB: {bers}")
        for snr, ber in zip(NOISE_BUMP_SNRS, bers):
            je, jb = JAX_CPU_READINGS[noise_bump_name(scenario.key, snr)]
            if not mt.ber_equivalent(int(round(ber * bits)), bits, je, jb, z=BAND_Z):
                raise AssertionError(f"noise_bump eager {scenario.key} {snr} dB: BER {ber} outside z={BAND_Z} of "
                                     f"the JAX package's _Link reading {je / jb}")
        for snr, ref in zip((0.0, 15.0, 30.0), NOISE_BUMP_REFERENCE[scenario.key]):
            got = bers[NOISE_BUMP_SNRS.index(snr)]
            if not abs(got - ref) < NOISE_BUMP_TOL:
                raise AssertionError(f"noise_bump eager {scenario.key} {snr} dB: BER {got} vs reference {ref}")
    print(f"noise_bump eager: every point inside z={BAND_Z} of the JAX package's _Link reading; 0 / 15 / 30 dB "
          f"within {NOISE_BUMP_TOL} of the reference curves")


# --- the noise-bump stages on every chain; diag past 256 subcarriers -----------------

# A noiseless link with both power switches: the noise-bump study's stages
# ride it (link_kernel.noise_bump_link).
_NB = dict(noise_type="NONE", apply_power_allocation=True, normalize_before_demap=True)
# The diag links past the warp layout, held against the plain version in
# three codec modes: the audit's two shapes that the kernel takes from the
# eager chain (both txext) and a 300-sc ISI-free link (the in-run PAPR).
WIDE_DIAG_LINKS = {
    "OFDM-CY1.0-512": dict(num_subcarriers=512),
    "flat_fading_cp_1024sc": dict(num_subcarriers=1024, channel_model="flat_fading", snr_db=20.0),
    "isi_free_300sc": dict(num_subcarriers=300, channel_model="Lin-Phoong_P2", snr_db=20.0),
}
WIDE_DIAG_MODES = {"qam": {}, "aqam": _ADAPT, "psk8": _PSK8}
WIDE_BAND_SYMBOLS = 1 << 20


def bump_rows(runner, device, snr_db=15.0):
    """The study's (3, n) rows of its wf_plus3 scenario at ``snr_db`` for a runner's link."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.experiments import noise_bump as nb

    n = runner.setup.cfg.num_subcarriers
    scen = nb.SCENARIOS[1]
    rows = nb.point_rows(np.abs(runner.setup.h_freq) ** 2, scen, nb.create_noise_profile(n, scen.noise_bump_db),
                         snr_db)
    return torch.tensor(rows, device=device)


def bump_links(device):
    """{name: (chain, noise-bump link, its rows, sym0)}: the staged chunks
    with all four stages held against their plain version: fold (OFDM short
    CP, scfde_default), lr (cp034_128sc, the study's 1024-sc link), mm
    (zp_64sc); each at the last 2^17-symbol chunk of its usual run."""
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    last = MAIN_SYMBOLS - MAIN_CHUNK
    cfgs = {
        "ofdm_short_cp": ("fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **dict(FOLD_LINKS["ofdm_short_cp"], **_NB)),
                          last),
        "scfde_default": ("fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_NB), last),
        "cp034_128sc": ("lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK, **dict(LR_LINKS["cp034_128sc"][0], **_NB)),
                        LR_SYMBOLS - MAIN_CHUNK),
        "zp_64sc": ("mm", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_NB), last),
    }
    out = {}
    for name, (chain, cfg, sym0) in cfgs.items():
        runner = LinkRunner(prepare(cfg), device)
        if runner.mode != chain:
            raise AssertionError(f"{name} routed to {runner.mode}, not {chain}")
        out[name] = (chain, lk.noise_bump_link(runner.link), bump_rows(runner, device), sym0)
    fused = nb.FusedLink(LR_SYMBOLS, 1024, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    if fused.runner.mode != "lr":
        raise AssertionError(f"the 1024-sc study link routed to {fused.runner.mode}")
    out["study_1024sc"] = ("lr", fused.link, bump_rows(fused.runner, device), LR_SYMBOLS - MAIN_CHUNK)
    return out


def chunk_loop(chain, link, rows, chunks, device, snr_db=15.0):
    """``chunks`` consecutive 2^17-symbol chunks of one link through its
    chain's wrapper, one stream as ``FusedLink.run_point`` drives it;
    returns the launches of the wrapper's counting pass."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import _KERNELS

    kernel = _KERNELS[chain].chunk
    work = _KERNELS[chain].workspace(link, MAIN_CHUNK, device)
    counter = "wide_launches" if chain == "diag" and link.n > lk.WARP_MAX_N else "launches"
    setattr(kernel, counter, 0)
    acc, psum = lk.new_accumulators(device)
    for c in range(chunks):
        kernel(link, (9, 1), c * MAIN_CHUNK, MAIN_CHUNK, lk.snr_linear(snr_db), acc, psum, work, rows)
    torch.cuda.synchronize()
    return getattr(kernel, counter)


def bump_checks(device):
    """Each chain's staged chunk with all four stages against its plain
    version (``compare_chunk``: counts, PAPR and carry exactly), then each
    link driven over 8 chunks through its chain's wrapper.  Returns
    ({chain: (max difference, launches)}, the links)."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    links = bump_links(device)
    chains_ = chains()
    out = {}
    for name, (chain, link, rows, sym0) in links.items():
        _, kernel, plain, _ = chains_[chain]
        err = compare_chunk(f"{chain}_chunk noise-bump stages {name} (n={link.n}, E={link.E}, "
                            f"sc={getattr(link, 'is_sc', False)}, stages={lk.link_stages(link)})", kernel, plain, link,
                            sym0, MAIN_CHUNK, 15.0, device, rows=rows)
        launches = chunk_loop(chain, link, rows, 8, device)
        e, count = out.get(chain, (0.0, 0))
        out[chain] = (max(e, err), count + launches)
    return out, links


def wide_diag_checks(card, device):
    """diag_wide against its plain version on the card (counts, PAPR and
    carry exactly; no PAPR under txext) on WIDE_DIAG_LINKS in qam, aqam and
    8-PSK at 2^17 symbols, on an IR without unit energy and on the study's
    512-sc link with all four stages; a capture replay on two of them.
    Returns the largest difference."""
    import numpy as np

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    sym0 = WIDE_BAND_SYMBOLS - MAIN_CHUNK
    err = 0.0
    for name, kw in WIDE_DIAG_LINKS.items():
        for mode, extra in WIDE_DIAG_MODES.items():
            runner = LinkRunner(prepare(audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **{**kw, **extra})), device)
            link = runner.link
            if runner.mode != "diag" or link.q.mode != ("psk" if mode == "psk8" else mode):
                raise AssertionError(f"{name} {mode} routed to {runner.mode} in {link.q.mode}")
            tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
            err = max(err, compare_chunk(
                f"diag_chunk {name} {mode} (n={link.n}, diag_wide, tile {tile}, txext={link.txext})",
                lk.diag_chunk, lk.diag_chunk_plain, link, sym0, MAIN_CHUNK, runner.setup.cfg.snr_db, device,
                no_papr=link.txext))
    # an IR without unit energy: the channel multiply's own rows
    ir = np.asarray(CUSTOM_IRS["custom_channel_demo"])
    runner = LinkRunner(prepare(audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **WIDE_DIAG_LINKS["isi_free_300sc"]),
                                channel_ir=ir), device)
    if runner.mode != "diag" or not lk.own_channel_rows(runner.link):
        raise AssertionError(f"custom_channel_demo at 300 sc: {runner.mode}, own rows "
                             f"{lk.own_channel_rows(runner.link)}")
    err = max(err, compare_chunk("diag_chunk custom_channel_demo 300 sc (diag_wide, channel rows of its own)",
                                 lk.diag_chunk, lk.diag_chunk_plain, runner.link, sym0, MAIN_CHUNK,
                                 runner.setup.cfg.snr_db, device))
    fused = nb.FusedLink(WIDE_BAND_SYMBOLS, 512, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    err = max(err, compare_chunk(f"diag_chunk noise-bump study 512 sc (diag_wide, stages="
                                 f"{lk.link_stages(fused.link)})", lk.diag_chunk, lk.diag_chunk_plain, fused.link,
                                 sym0, MAIN_CHUNK, 15.0, device, rows=bump_rows(fused.runner, device)))
    for name, mode in (("OFDM-CY1.0-512", "qam"), ("isi_free_300sc", "aqam")):
        cfg = audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **{**WIDE_DIAG_LINKS[name], **WIDE_DIAG_MODES[mode]})
        err = max(err, capture_check(card, device, f"{name} {mode} (diag_wide)", "diag", cfg, CAPTURE_COLLECT)[0])
    return err


def wide_cells(card, device):
    """The two audit cells the wide diag kernel took from the eager chain,
    through LinkRunner at 2^20 OFDM symbols: diag_wide's launches, the
    sampled-TX PAPR, the z = 5 band against the JAX package's XLA reading
    (their eager twins run in eager_path), the profile.  Returns (launches,
    the OFDM-CY1.0-512 runner)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    launches, first = 0, None
    for name in ("OFDM-CY1.0-512", "flat_fading_cp_1024sc"):
        runner = LinkRunner(prepare(audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **WIDE_DIAG_LINKS[name])), device)
        runner.run(1)  # warm-up (and the cached PAPR sample)
        lk.diag_chunk.wide_launches = lk.diag_chunk.launches = lk.diag_chunk.power_launches = 0
        r = runner.run(MAIN_SEED)
        got = (lk.diag_chunk.wide_launches, lk.diag_chunk.launches, lk.diag_chunk.power_launches)
        want = WIDE_BAND_SYMBOLS // MAIN_CHUNK
        print(f"{name} through LinkRunner (diag_wide) [{card}]: {WIDE_BAND_SYMBOLS} OFDM symbols, "
              f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} BER={r['bit_error_rate']} "
              f"papr_db={r['papr_db']:.4f} ({r['papr_estimator']}) hotpath={r['hotpath_used']}; launches "
              f"diag_wide {got[0]}, diag_main {got[1]}, wide_power {got[2]}")
        if got != (want, 0, want) or r["hotpath_used"] != "cuda" or r["papr_estimator"] != "sampled_tx":
            raise AssertionError(f"{name}: launches {got}, {r['hotpath_used']}, {r['papr_estimator']}")
        band(name, r, EAGER_READING)
        launches += got[0]
        first = first or runner
        print_profile(card, f"{name} (diag_wide)", profile_run(runner, runner.setup.cfg.snr_db))
    return launches, first


def wide_noise_bump_campaigns(card, device):
    """The study's fused campaign at 512 sc (diag_wide) and 1024 sc (lr):
    ``run_noise_bump_experiment``, 3 scenarios x 7 SNR points at 2^20 OFDM
    symbols a point, its launch counters, every point at z = 5 against the
    JAX package's ``_Link`` reading at that width, the profile of one
    point.  Returns {n: counting-pass launches}."""
    import torch

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import metrics as mt

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tmp", "noise_bump_wide")  # gitignored
    points = len(nb.SCENARIOS) * len(NOISE_BUMP_SNRS)
    want = points * (NOISE_BUMP_WIDE_SYMBOLS // MAIN_CHUNK)
    out = {}
    for n, chain in NOISE_BUMP_WIDE.items():
        kernel, counter = (lk.diag_chunk, "wide_launches") if chain == "diag" else (lrk.lr_chunk, "launches")
        nb.run_noise_bump_experiment((15.0,), num_subcarriers=n, fused_symbols_per_point=MAIN_CHUNK,
                                     results_dir=out_dir, seed=1, chunk=MAIN_CHUNK)  # warm-up
        torch.cuda.synchronize()
        setattr(kernel, counter, 0)
        kernel.norm_launches = lk.diag_chunk.demap_launches = 0
        t0 = time.perf_counter()
        res = nb.run_noise_bump_experiment(NOISE_BUMP_SNRS, num_subcarriers=n,
                                           fused_symbols_per_point=NOISE_BUMP_WIDE_SYMBOLS, results_dir=out_dir,
                                           seed=NOISE_BUMP_SEED, chunk=MAIN_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # diag_wide runs the chain once, then norm_factors and diag_demap; lr its
        # normalization pass and norm_factors, then its counting pass
        got = (getattr(kernel, counter), kernel.norm_launches) + ((lk.diag_chunk.demap_launches,)
                                                                  if chain == "diag" else ())
        what = ("diag_wide (the chain) {}, norm_factors {}, diag_demap {}" if chain == "diag" else
                "lr_main (counting pass) {}, normalization pass + norm_factors {} each").format(*got)
        print(f"noise_bump campaign {n} sc [{card}]: {points} points x {NOISE_BUMP_WIDE_SYMBOLS} OFDM symbols in "
              f"{wall:.4f} s: {wall / points * 1e3:.3f} ms and {NOISE_BUMP_WIDE_SYMBOLS * points / wall:.1f} OFDM "
              f"syms/s a point on average; launches: {what}")
        if got != (want,) * len(got):
            raise AssertionError(f"noise_bump {n} sc campaign launched {got}, not {want} each")
        bits = NOISE_BUMP_WIDE_SYMBOLS * n * 6
        for scenario in nb.SCENARIOS:
            bers = res[scenario.name]
            print(f"noise_bump {n} sc {scenario.key} BER at {list(NOISE_BUMP_SNRS)} dB: {bers}")
            for snr, ber in zip(NOISE_BUMP_SNRS, bers):
                je, jb = JAX_CPU_READINGS[noise_bump_name(scenario.key, snr, n)]
                if not mt.ber_equivalent(int(round(ber * bits)), bits, je, jb, z=BAND_Z):
                    raise AssertionError(f"noise_bump {n} sc {scenario.key} {snr} dB: BER {ber} outside z={BAND_Z} "
                                         f"of the JAX package's _Link reading {je / jb}")
        print(f"noise_bump {n} sc: every point inside z={BAND_Z} of the JAX package's _Link reading (CPU, "
              f"2^22 / n OFDM symbols)")
        fused = nb.FusedLink(NOISE_BUMP_WIDE_SYMBOLS, n, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
        scen = nb.SCENARIOS[1]
        profile = nb.create_noise_profile(n, scen.noise_bump_db)
        print_profile(card, f"noise_bump {n} sc point (wf_plus3, 15 dB)",
                      profile_call(lambda: fused.run_point(7, scen, profile, 15.0)))
        out[n] = got[0]
    return out


def bump_entry(card, device, name, chain, link, rows, sym0, launches, err):
    """One chain's staged chunk with all four stages timed at 2^17 symbols
    beside its plain version and bound; returns its kernels-line entry."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import _KERNELS

    _, kernel, plain, _ = chains()[chain]
    snr_lin = lk.snr_linear(15.0)
    acc, psum = lk.new_accumulators(device)
    work = _KERNELS[chain].workspace(link, MAIN_CHUNK, device)
    k_ms = cuda_ms(lambda: kernel(link, (3, 4), sym0, MAIN_CHUNK, snr_lin, acc, psum, work, rows), 10)
    p_ms = cuda_ms(lambda: plain(link, (3, 4), sym0, MAIN_CHUNK, snr_lin, acc, psum, rows=rows), 1)
    ops, added = staged_operations(chain, link, MAIN_CHUNK)
    bound = ops / PEAK_OPS * 1e3
    kname = "diag_wide" if chain == "diag" else f"{chain}_chunk"
    print(f"{kname} with the noise-bump stages, {name} (n={link.n}) at {MAIN_CHUNK} symbols [{card}]: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound:.4f} ms ({ops} operations needed; the design adds "
          f"{added}, {added / PEAK_OPS * 1e3:.4f} ms at the same rate)")
    source = {"diag": "diag_wide_kernel", "fold": "fold_kernel", "lr": "lr_kernel", "mm": "mm_kernel"}[chain]
    return {"name": f"{kname} (noise-bump stages, {name})", "route": "cuda",
            "source": f"ofdm_tpu_torch/csrc/{source}.cu", "replaces": "ofdm_tpu/ops/pallas_link.py:1986",
            "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None}


# --- the diag kernels' layout and pipes; the one-pass demap ---------------------------

# The diag libraries and widths whose layout diag_layout prints: (library,
# n, log2 n of the in-run IDFT or -1 for the split).
DIAG_LAYOUTS = (("link_kernel", 64, 6), ("link_staged", 64, 6), ("diag_wide", 512, 9),
                ("diag_wide_staged", 300, -1), ("diag_wide_bump", 512, 9))
# The kernels whose SASS diag_layout counts by pipe: (library, kernel key,
# bins one pass of its outermost loop handles): the headline's, the
# one-pass normalize's at 64 sc (front, demap, the staged power pass) and
# the 512-sc noise-bump chunk's.
DIAG_SASS = (("link_kernel", "diag_main<2,0>", 2), ("link_kernel", "power_partials<0>", 1),
             ("link_staged", "diag_staged<2,0>+01", 2), ("link_staged", "diag_demap<0>", 4),
             ("link_staged", "power_partials<0>+1", 1), ("diag_wide_bump", "diag_wide<2,0>+1011", 2),
             ("diag_wide_bump", "diag_demap<0>", 4))


def diag_layout(card, device, headline_ms):
    """Print each diag library's kernels' layout as the loaded kernels report
    it (``link_kernel.geometry``: registers, local bytes, static shared
    memory, blocks an SM) and the static SASS of DIAG_SASS's kernels by
    pipe (``sass_counts``), then the pipe-aware bounds (``pipe_bound_ms``:
    each kernel's bins x its loop body's instructions a bin by pipe over the
    pipe's rate, the kernels of a chunk in turn, the in-run IDFT's
    operations at the fp32 rate) of the headline chunk, the noise-bump
    chunks at 64 and 512 sc and the 64-sc waterfilling chunk with both
    switches.  Returns {chunk: (bound ms, the pipe that sets its chain
    kernel's bound)}."""
    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    for lib, n, log2n in DIAG_LAYOUTS:
        print(f"diag layout {lib} at {n} sc [{card}]: {json.dumps(lk.geometry(n, lib, log2n))}")
    counts = {}
    for lib in dict.fromkeys(lib for lib, _, _ in DIAG_SASS):
        keys = {key: bins for l_, key, bins in DIAG_SASS if l_ == lib}
        for key, c in sass_counts(build.library_path(lib), keys).items():
            counts[lib, key] = c
            print(f"diag SASS {lib} {key}: whole function {json.dumps(c['function'])}; outermost loop's body "
                  f"{json.dumps(c['loop'])} ({c['philox']:.1f} Philox calls), a bin {json.dumps(c['per_bin'])}")

    def bound(name, link, kernels, ms):
        tile = lk.tile_for(MAIN_CHUNK, link.tile_cap)
        tiles = -(-MAIN_CHUNK // tile)
        slice_bins = sum(min(link.slice, min(tile, MAIN_CHUNK - t * tile)) for t in range(tiles)) * link.n
        parts = []
        for lib, key, per in kernels:
            t, pipe = pipe_bound_ms(counts[lib, key]["per_bin"], slice_bins if per == "slice" else MAIN_CHUNK * link.n)
            parts.append((key, t, pipe))
        papr = lk.sampled_symbols(MAIN_CHUNK, tile, link.pstride) * (papr_product_ops(link) + PAPR_OPS * link.T)
        total = sum(t for _, t, _ in parts) + papr / PEAK_OPS * 1e3
        print(f"{name} pipe-aware bound at {MAIN_CHUNK} symbols [{card}]: {total:.4f} ms ("
              + ", ".join(f"{key} {t:.4f} by {pipe}" for key, t, pipe in parts)
              + f", the in-run IDFT {papr / PEAK_OPS * 1e3:.4f}; static SASS, every branch counted); the chunk "
              f"{ms}")
        return total, parts[0][2]

    link = lk.diag_link(prepare(headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK)), device)
    out = {"headline": bound("diag_chunk", link, (("link_kernel", "diag_main<2,0>", "bins"),
                                                   ("link_kernel", "power_partials<0>", "slice")),
                             f"{headline_ms:.4f} ms, uniform bound "
                             f"{diag_operations(link, MAIN_CHUNK, OPS_PER_BIN) / PEAK_OPS * 1e3:.4f} ms")}
    one_pass = (("link_staged", "diag_staged<2,0>+01", "bins"), ("link_staged", "diag_demap<0>", "bins"))
    fused = nb.FusedLink(WIDE_BAND_SYMBOLS, 64, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    out["noise_bump_64"] = bound("diag_chunk with the noise-bump stages", fused.link, one_pass, "timed below")
    wf = LinkRunner(prepare(headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF)), device).link
    out["wf_64"] = bound("diag_chunk with apply_power + normalize", wf,
                         one_pass + (("link_staged", "power_partials<0>+1", "slice"),), "timed below")
    fused = nb.FusedLink(WIDE_BAND_SYMBOLS, 512, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    out["noise_bump_512"] = bound("diag_wide with the noise-bump stages, 512 sc", fused.link,
                                  (("diag_wide_bump", "diag_wide<2,0>+1011", "bins"),
                                   ("diag_wide_bump", "diag_demap<0>", "bins")), "timed below")
    return out


def demap_entry(card, device, name, link, rows, launches, err):
    """diag_demap on a normalized link: its device time a launch from the
    profiler over 10 chunks, beside its plain version (the plain chunk's
    normalize_points and count_errors on e planes of the chunk's shape) and
    its bound (the scratch's bytes read once; norm_gain, the slicer and the
    count a bin).  Returns its kernels-line entry."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk

    work = lk.chunk_workspace(link, MAIN_CHUNK, device)
    acc, psum = lk.new_accumulators(device)
    snr_lin = lk.snr_linear(15.0)
    lk.diag_chunk.demap_launches = 0
    prof = profile_call(lambda: [lk.diag_chunk(link, (3, 4), c * MAIN_CHUNK, MAIN_CHUNK, snr_lin, acc, psum, work,
                                               rows) for c in range(10)])
    count = lk.diag_chunk.demap_launches
    ms = None if prof is None else sum(v for k, v in prof[0].items() if "diag_demap" in k) / count
    bins = MAIN_CHUNK * link.n
    g = torch.Generator(device=device).manual_seed(5)
    er = torch.randn((MAIN_CHUNK, link.n), generator=g, device=device)
    ei = torch.randn((MAIN_CHUNK, link.n), generator=g, device=device)
    tx = torch.randint(0, 64, (MAIN_CHUNK, link.n), generator=g, device=device)
    f = torch.rand((MAIN_CHUNK, 1), generator=g, device=device) + 0.5
    p_ms = cuda_ms(lambda: lk.count_errors(link, tx, *lk.normalize_points(link, er, ei, f), acc), 3)
    ops = bins * (2 + OPS_PER_BIN["demap"] + OPS_PER_BIN["count"])
    nbytes = bins * lk.ONEPASS_BYTES_PER_BIN
    bound = max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
    print(f"diag_demap {name} at {MAIN_CHUNK} symbols [{card}]: {ms} ms a launch (profiler, {count} launches), plain "
          f"{p_ms:.3f} ms, bound {bound:.4f} ms ({nbytes} bytes, {ops} operations)")
    return {"name": f"diag_demap ({name})", "route": "cuda", "source": "ofdm_tpu_torch/csrc/diag_common.cuh",
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes", "library_ms": None}


def demap_entries(card, device, launches_64, launches_512, err):
    """``demap_entry`` on the noise-bump study's links at 64 sc (diag_staged)
    and 512 sc (diag_wide)."""
    from ofdm_tpu_torch.experiments import noise_bump as nb

    out = []
    for n, launches in ((64, launches_64), (512, launches_512)):
        fused = nb.FusedLink(WIDE_BAND_SYMBOLS, n, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
        out.append(demap_entry(card, device, f"noise-bump stages, {n} sc", fused.link, bump_rows(fused.runner, device),
                               launches, err))
    return out


def wide_path(card, device):
    """This slice's phase: the noise-bump stages on fold, lr and mm and the
    diag chain past 256 subcarriers against their plain versions; the two
    audit cells diag_wide takes through LinkRunner; the study's campaign at
    512 and 1024 sc; the new kernels timed.  Returns the kernels-line
    entries."""
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.ops import link_kernel as lk

    t0 = time.perf_counter()
    bump, links = bump_checks(device)
    wide_err = wide_diag_checks(card, device)
    cell_launches, cell_runner = wide_cells(card, device)
    campaign = wide_noise_bump_campaigns(card, device)

    # diag_wide in qam on OFDM-CY1.0-512 (txext: no time plane), the plain build
    link = cell_runner.link
    snr_lin = lk.snr_linear(cell_runner.setup.cfg.snr_db)
    acc, psum = lk.new_accumulators(device)
    work = lk.chunk_workspace(link, MAIN_CHUNK, device)
    k_ms = cuda_ms(lambda: lk.diag_chunk(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    p_ms = cuda_ms(lambda: lk.diag_chunk_plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum), 2)
    ops = diag_operations(link, MAIN_CHUNK, OPS_PER_BIN)
    bound = max(ops / PEAK_OPS, (4 * 7 * link.n + 3 * 8) / PEAK_BYTES) * 1e3
    print(f"diag_wide (qam) OFDM-CY1.0-512 at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.3f} ms, bound {bound:.4f} ms ({ops} operations)")
    entries = [{"name": "diag_wide (qam, OFDM-CY1.0-512)", "route": "cuda",
                "source": "ofdm_tpu_torch/csrc/diag_wide_kernel.cu", "replaces": "ofdm_tpu/ops/pallas_link.py:1986",
                "launches": cell_launches, "max_abs_err": wide_err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound, "bound_by": "operations", "library_ms": None}]
    fused = nb.FusedLink(WIDE_BAND_SYMBOLS, 512, 64, "Lin-Phoong_P2", chunk=MAIN_CHUNK, device=device)
    entries.append(bump_entry(card, device, "study 512 sc", "diag", fused.link, bump_rows(fused.runner, device), 0,
                              campaign[512], wide_err))
    for name in ("ofdm_short_cp", "scfde_default", "study_1024sc", "zp_64sc"):
        chain, link, rows, sym0 = links[name]
        launches = campaign[1024] if name == "study_1024sc" else bump[chain][1]
        entries.append(bump_entry(card, device, name, chain, link, rows, sym0, launches, bump[chain][0]))
    print(f"noise-bump stages and diag_wide phase: {time.perf_counter() - t0:.1f} s")
    return entries


# --- the fold and zero-prefix mm chains past 256 subcarriers (dense_wide) ------------

_SC = dict(modulation_type="SC-OFDM")
# The wide dense links held against their plain versions at a 2^17-symbol
# chunk, (chain, changes to the audit's base): tools/shape_audit.py's SC-FDE
# shapes at 512 and 1024 sc (CP and zero prefix), SC-FDE without a prefix,
# a 300-sc single-tap CP link (the two-factor DFT, 15 x 20), single-tap
# zero-prefix OFDM at 512 and 1024 sc, 8-PSK on one SC-FDE link and aqam on
# single-tap ZP OFDM; at 20 dB, where 64-QAM errs.
DENSE_WIDE_SNR = 20.0
DENSE_WIDE_LINKS = {
    "SC-CY1.0-512": ("fold", dict(_SC, num_subcarriers=512)),
    "SC-CY1.0-1024": ("fold", dict(_SC, num_subcarriers=1024)),
    "SC-NO-512": ("fold", dict(_SC, num_subcarriers=512, prefix_type="NONE")),
    "sc_flat_cp_300": ("fold", dict(_SC, num_subcarriers=300, channel_model="flat_fading")),
    "SC-ZE1.0-512": ("mm", dict(_SC, num_subcarriers=512, prefix_type="ZERO")),
    "SC-ZE1.0-1024": ("mm", dict(_SC, num_subcarriers=1024, prefix_type="ZERO")),
    "flat_zp_ofdm_512": ("mm", dict(num_subcarriers=512, prefix_type="ZERO", channel_model="flat_fading")),
    "flat_zp_ofdm_1024": ("mm", dict(num_subcarriers=1024, prefix_type="ZERO", channel_model="flat_fading")),
    "SC-CY1.0-512_psk8": ("fold", dict(_SC, num_subcarriers=512, **_PSK8)),
    "flat_zp_ofdm_512_aqam": ("mm", dict(num_subcarriers=512, prefix_type="ZERO", channel_model="flat_fading",
                                         **_ADAPT)),
}
# The two audit cells the wide kernels take from the eager chain, through
# LinkRunner at 30 and 20 dB (their JAX readings' names).
DENSE_WIDE_CELLS = {
    "SC-CY1.0-1024": ("fold", dict(_SC, num_subcarriers=1024)),
    "SC-ZE1.0-1024": ("mm", dict(_SC, num_subcarriers=1024, prefix_type="ZERO")),
    "SC-CY1.0-1024_20db": ("fold", dict(_SC, num_subcarriers=1024, snr_db=20.0)),
    "SC-ZE1.0-1024_20db": ("mm", dict(_SC, num_subcarriers=1024, prefix_type="ZERO", snr_db=20.0)),
}


# The wide cells' BER as this script read them on the wide kernels before
# their staged transform (commit 5a7d89f; NVIDIA H100 80GB HBM3, 700.00 W):
# the staged kernels must give the same counts.
WIDE_BASELINE_BER = {
    "SC-CY1.0-1024": 1.3969838619232178e-09,
    "SC-ZE1.0-1024": 2.3283064365386963e-08,
    "SC-CY1.0-1024_20db": 0.019552769139409065,
    "SC-ZE1.0-1024_20db": 0.019556751164297264,
    "adaptive_scfde_1024sc_20db": 0.003175132692522153,
    "adaptive_scfde_1024sc_zp_20db": 0.0035425263979997914,
}


def check_baseline_ber(name, r):
    """A wide cell's BER against the baseline reading (WIDE_BASELINE_BER), exactly."""
    want = WIDE_BASELINE_BER[name]
    print(f"{name}: BER {r['bit_error_rate']} vs the baseline's {want}: "
          f"{'equal' if r['bit_error_rate'] == want else 'DIFFERENT'}")
    if r["bit_error_rate"] != want:
        raise AssertionError(f"{name}: BER {r['bit_error_rate']} is not the baseline's {want}")


# The wide dense links whose kernels' layout dense_wide_layout prints: the
# four cells' widths (radix-2, staged) and the split 300-sc link.
DENSE_WIDE_LAYOUT_LINKS = ("SC-CY1.0-1024", "SC-ZE1.0-1024", "SC-CY1.0-512", "SC-ZE1.0-512", "sc_flat_cp_300")


def sass_barriers(library_path):
    """{kernel key: {"bar": block barriers, "warpsync": warp barriers}}: the
    static BAR and WARPSYNC instructions of each kernel of a built library
    (``cuobjdump -sass``); a barrier inside a loop counts once."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", block)
        out[kernel_key(block.split()[0])] = {"bar": ops.count("BAR"), "warpsync": ops.count("WARPSYNC")}
    return out


def ptxas_kernels(log_text):
    """{kernel key: (registers, spill store bytes)} of every kernel in a ptxas -v log."""
    out = {}
    for name, spill, regs in re.findall(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?Used (\d+) registers", log_text, re.S):
        out[kernel_key(name)] = (int(regs), int(spill))
    return out


def dense_wide_layout(card, device):
    """The wide dense kernels' layout: for each DENSE_WIDE_LAYOUT_LINKS link
    and build, the slots a thread and each kernel's registers, local bytes,
    shared bytes a block and resident blocks an SM as the loaded kernels
    report them (link_kernel.wide_geometry); for each library the qam
    kernels' registers, spill stores (ptxas) and static block barriers (BAR)
    and warp barriers (WARPSYNC) in the SASS.  mm_wide_main must hold 4
    slots a thread at 1024 sc with no local memory."""
    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.ops import link_kernel as lk

    for name in DENSE_WIDE_LAYOUT_LINKS:
        chain, kw = DENSE_WIDE_LINKS[name]
        link = dense_wide_runner(name, chain, dense_wide_cfg(kw), device).link
        for suffix in ("", "_staged", "_bump"):
            lib = f"{chain}_wide{suffix}"
            geo = lk.wide_geometry(chain, link.n, link.T, link.E, link.plan.log2n, lib)
            print(f"wide layout {lib} {name} (n={link.n}, T={link.T}, E={link.E}, log2n {link.plan.log2n}) "
                  f"[{card}]: {json.dumps(geo)}")
            if suffix == "" and name == "SC-ZE1.0-1024" and (geo["J"] != 4 or geo["main"]["local_bytes"] != 0):
                raise AssertionError(f"mm_wide_main at 1024 sc: {geo}")
    for lib in ("fold_wide", "fold_wide_staged", "fold_wide_bump", "mm_wide", "mm_wide_staged", "mm_wide_bump"):
        with open(os.path.join(build.BUILD_DIR, f"{lib}.log")) as fh:
            regs = ptxas_kernels(fh.read())
        bars = sass_barriers(build.library_path(lib))
        rows = {k: {"registers": regs[k][0], "spill_bytes": regs[k][1], **bars.get(k, {})}
                for k in sorted(regs) if k.split("+")[0].endswith(",0>")}
        print(f"wide SASS {lib} qam kernels: {json.dumps(rows)}")


def dense_wide_cfg(kw, num_ofdm=WIDE_BAND_SYMBOLS, **extra):
    """An audit config of a dense wide link at DENSE_WIDE_SNR unless it says otherwise."""
    return audit_cfg(num_ofdm, MAIN_CHUNK, **{"snr_db": DENSE_WIDE_SNR, **kw, **extra})


def dense_wide_runner(name, chain, cfg, device):
    """LinkRunner of a wide dense link, checked to route to ``chain``'s wide kernel."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    runner = LinkRunner(prepare(cfg), device)
    wide = (fk if chain == "fold" else mmk).is_wide(runner.link) if runner.mode == chain else False
    if not wide:
        raise AssertionError(f"{name} routed to {runner.mode} (wide {wide}), not {chain}'s wide kernel")
    return runner


def dense_wide_counters(reset=False):
    """The wide wrappers' launch counters (and the narrow ones beside them)."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    names = ((fk.fold_chunk, ("wide_launches", "wide_power_launches", "launches", "power_launches")),
             (mmk.mm_chunk, ("wide_launches", "wide_front_launches", "launches", "front_launches")),
             (fk.fold_probe, ("wide_launches", "launches")), (mmk.mm_probe, ("wide_launches", "launches")))
    out = {}
    for fn, attrs in names:
        for a in attrs:
            if reset:
                setattr(fn, a, 0)
            out[f"{fn.__name__}.{a}"] = getattr(fn, a)
    return out


def dense_wide_operations(chain, link, chunk, ops=OPS_PER_BIN):
    """(needed, power pass): the operations one wide fold or mm chunk needs,
    counted from csrc/{fold,mm}_wide_kernel.cu, and what the measured-power
    pass recomputes.  Per symbol: Philox on every drawn bin (fold) or time
    sample (mm), encode, the block transforms (radix-2: 10 a butterfly, n / 2
    log2 n of them; the split: 8 a term over n (N1 + N2), 6 n twiddles; 2 n
    for the scale) for OFDM's TX, the receiver and SC-FDE's IDFT, the
    8 K-term convolution per kept sample, Box-Muller on each noisy sample,
    mm's overlap-add, the equalizer, slicer and count per bin, the PAPR per
    time sample; |y|^2 and its sum over each tile's measured slice."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    n, T, K = link.n, link.T, link.E + 1
    p = link.plan
    dft = idft_ops(p)
    drawn = T if chain == "mm" else n
    eq = ops["mmse"] if link.method == 1 else 6
    tx = (0 if link.is_sc else dft) + n * (ops["philox"] + ops["encode"])
    conv = 8 * K * (T if chain == "mm" else n)
    per_symbol = (tx + (drawn - n) * ops["philox"] + PAPR_OPS * T + conv
                  + (drawn * ops["noise"] if link.add_noise else 0) + (2 * (T - n) if chain == "mm" else 0)
                  + dft + (dft if link.is_sc else 0)
                  + n * (eq + ops["demap"] + ops["count"]))
    m = mmk if chain == "mm" else fk
    tile, tiles, _ = m._chunk_geometry(link, chunk)
    slice_ = tile if chain == "mm" else link.slice
    power_syms = sum(min(slice_, min(tile, chunk - t * tile)) for t in range(tiles)) if link.add_noise else 0
    power_pass = power_syms * (tx + conv + (0 if chain == "mm" else dft))
    return chunk * per_symbol + power_syms * drawn * POWER_SUM_OPS, power_pass


def dense_wide_checks(card, device):
    """fold_wide and mm_wide against their plain versions on the card
    (``compare_chunk``: counts, PAPR and carry exactly) on DENSE_WIDE_LINKS
    at sym0 = 0 and 2^32 + 77; K3 (``probe_check``) on three links; one link
    a chain with apply_power + normalize, one with all four noise-bump
    stages; a capture a chain.  Returns ({chain: max difference}, {chain:
    probe max difference})."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    err = {"fold": 0.0, "mm": 0.0}
    for name, (chain, kw) in DENSE_WIDE_LINKS.items():
        runner = dense_wide_runner(name, chain, dense_wide_cfg(kw), device)
        link = runner.link
        _, kernel, plain, _ = chains()[chain]
        for sym0 in PROBE_SYM0:
            err[chain] = max(err[chain], compare_chunk(
                f"{chain}_wide {name} ({link.q.mode}, n={link.n}, T={link.T}, E={link.E}, sc={link.is_sc}, tile "
                f"{lk.tile_for(MAIN_CHUNK, link.tile_cap)}, dft {link.plan.n1}x{link.plan.n2} log2n "
                f"{link.plan.log2n})", kernel, plain, link, sym0, MAIN_CHUNK, runner.setup.cfg.snr_db, device))
    for name, chain, extra in (("SC-CY1.0-1024", "fold", _WF), ("SC-ZE1.0-1024", "mm", _WF)):
        runner = dense_wide_runner(name, chain, dense_wide_cfg(DENSE_WIDE_LINKS[name][1], **extra), device)
        _, kernel, plain, _ = chains()[chain]
        err[chain] = max(err[chain], compare_chunk(
            f"{chain}_wide {name} apply_power + normalize (stages {lk.link_stages(runner.link)})", kernel, plain,
            runner.link, MAIN_CHUNK, MAIN_CHUNK, DENSE_WIDE_SNR, device,
            rows=sqrt_power_row(runner, DENSE_WIDE_SNR)))
    for name, chain in (("SC-CY1.0-512", "fold"), ("flat_zp_ofdm_512", "mm")):
        runner = dense_wide_runner(name, chain, dense_wide_cfg(DENSE_WIDE_LINKS[name][1], **_NB), device)
        link = lk.noise_bump_link(runner.link)
        _, kernel, plain, _ = chains()[chain]
        err[chain] = max(err[chain], compare_chunk(
            f"{chain}_wide {name} noise-bump stages (stages {lk.link_stages(link)})", kernel, plain, link,
            MAIN_CHUNK, MAIN_CHUNK, 15.0, device, rows=bump_rows(runner, device)))
    probe_err = {}
    for name in ("SC-CY1.0-1024", "SC-NO-512", "SC-ZE1.0-1024"):
        chain, kw = DENSE_WIDE_LINKS[name]
        probe_err[chain] = max(probe_err.get(chain, 0.0), probe_check(name, chain, dense_wide_cfg(kw), device))
    for name in ("SC-CY1.0-1024", "SC-ZE1.0-1024"):
        chain, kw = DENSE_WIDE_LINKS[name]
        err[chain] = max(err[chain], capture_check(card, device, f"{name} ({chain}_wide)", chain,
                                                   dense_wide_cfg(kw), CAPTURE_COLLECT)[0])
    return err, probe_err


def dense_wide_cells(card, device):
    """The two audit cells the wide kernels take from the eager chain at 30
    and 20 dB through LinkRunner at 2^20 OFDM symbols: every launch counter
    set to 0 just before the run and read just after (each wide main kernel
    8 times, its power pass 8, no narrow kernel), OFDM syms/s, peak device
    memory, ``hotpath_used``, the z = 5 band against the JAX package's XLA
    reading (their eager twins run in eager_path), the profile.  Returns
    ({chain: main launches}, {chain: power launches}, {name: OFDM syms/s})."""
    import torch

    launches, power, rates = {"fold": 0, "mm": 0}, {"fold": 0, "mm": 0}, {}
    for name, (chain, kw) in DENSE_WIDE_CELLS.items():
        runner = dense_wide_runner(name, chain, audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **kw), device)
        runner.run(1)  # warm-up
        torch.cuda.synchronize()
        dense_wide_counters(reset=True)
        torch.cuda.reset_peak_memory_stats()
        r = runner.run(MAIN_SEED)
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        got = dense_wide_counters()
        fn = "fold_chunk" if chain == "fold" else "mm_chunk"
        pw = "wide_power_launches" if chain == "fold" else "wide_front_launches"
        want = WIDE_BAND_SYMBOLS // MAIN_CHUNK
        others = {k: v for k, v in got.items() if v and k not in (f"{fn}.wide_launches", f"{fn}.{pw}")}
        print(f"{name} through LinkRunner ({chain}_wide) [{card}]: {WIDE_BAND_SYMBOLS} OFDM symbols, "
              f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} run_s={r['transmission_time_ms'] / 1e3:.4f} "
              f"BER={r['bit_error_rate']} papr_db={r['papr_db']:.4f} ({r['papr_estimator']}) "
              f"hotpath={r['hotpath_used']}; peak device memory {peak_mb:.3f} MB; launches {json.dumps(got)}")
        if (got[f"{fn}.wide_launches"], got[f"{fn}.{pw}"]) != (want, want) or others or r["hotpath_used"] != "cuda":
            raise AssertionError(f"{name}: launches {got}, hotpath {r['hotpath_used']}")
        band(name, r, EAGER_READING)
        check_baseline_ber(name, r)
        launches[chain] += want
        power[chain] += want
        rates[name] = r["ofdm_symbols_per_s"]
        print_profile(card, f"{name} ({chain}_wide)", profile_run(runner, runner.setup.cfg.snr_db))
    return launches, power, rates


def dense_wide_entries(card, device, err, probe_err, launches, power):
    """The kernels-line entries: fold_wide on SC-CY1.0-1024 and mm_wide on
    SC-ZE1.0-1024 (30 dB, the cells' links) timed at 2^17 symbols by CUDA
    events beside their plain versions and bounds; their probes (launches
    filled in by the one-rank halo run)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import _KERNELS

    out = []
    key = prng.key_words(MAIN_SEED)
    for chain, name in (("fold", "SC-CY1.0-1024"), ("mm", "SC-ZE1.0-1024")):
        kw = DENSE_WIDE_CELLS[name][1]
        runner = dense_wide_runner(name, chain, audit_cfg(WIDE_BAND_SYMBOLS, MAIN_CHUNK, **kw), device)
        link = runner.link
        _, kernel, plain, _ = chains()[chain]
        snr_lin = lk.snr_linear(runner.setup.cfg.snr_db)
        acc, psum = lk.new_accumulators(device)
        work = _KERNELS[chain].workspace(link, MAIN_CHUNK, device)
        k_ms = cuda_ms(lambda: kernel(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
        p_ms = cuda_ms(lambda: plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum), 1)
        ops, added = dense_wide_operations(chain, link, MAIN_CHUNK)
        bound = ops / PEAK_OPS * 1e3
        kname = f"{chain}_wide"
        print(f"{kname} {name} at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms "
              f"({MAIN_CHUNK / k_ms * 1e3:.1f} OFDM syms/s), plain {p_ms:.3f} ms, bound {bound:.4f} ms ({ops} "
              f"operations needed; the measured-power pass recomputes {added}, {added / PEAK_OPS * 1e3:.4f} ms at "
              f"the same rate)")
        out.append({"name": f"{kname} ({name})", "route": "cuda",
                    "source": f"ofdm_tpu_torch/csrc/{chain}_wide_kernel.cu",
                    "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[chain],
                    "power_launches": power[chain], "max_abs_err": err[chain], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": "operations", "library_ms": None})
        probe, probe_plain = probes()[chain]
        pk_ms = cuda_ms(lambda: probe(link, key, MAIN_CHUNK, MAIN_CHUNK), PROBE_TIMED_LAUNCHES)
        dev_ms = device_ms(lambda: probe(link, key, MAIN_CHUNK, MAIN_CHUNK), "ofdm::wide_probe", 100)
        pp_ms = cuda_ms(lambda: probe_plain(link, key, MAIN_CHUNK, MAIN_CHUNK), 20)
        p = link.plan
        idft = 0 if link.is_sc else ((link.n // 2) * p.log2n * 10 if p.log2n >= 0 else link.n * (p.n1 + p.n2) * 8)
        pops = link.n * (OPS_PER_BIN["philox"] + OPS_PER_BIN["encode"]) + idft
        pbytes = 8 * (link.T + link.E)
        pbound = max(pops / PEAK_OPS, pbytes / PEAK_BYTES) * 1e3
        print(f"K3 {kname}_probe {name} (T={link.T}, E={link.E}) [{card}]: kernel {pk_ms:.4f} ms a launch (mean "
              f"of {PROBE_TIMED_LAUNCHES} by CUDA events: the wrapper's host time bounds it), device time "
              f"{dev_ms if dev_ms is None else f'{dev_ms:.5f}'} ms a launch (profiler), plain {pp_ms:.3f} ms, "
              f"bound {pbound:.6f} ms ({pops} operations, {pbytes} bytes)")
        by_ops = pops / PEAK_OPS >= pbytes / PEAK_BYTES
        out.append({"name": f"{kname}_probe", "route": "cuda",
                    "source": f"ofdm_tpu_torch/csrc/{chain}_wide_kernel.cu",
                    "replaces": "ofdm_tpu/ops/pallas_link.py:2218", "launches": None,
                    "max_abs_err": probe_err[chain], "ms": pk_ms, "device_ms": dev_ms, "plain_ms": pp_ms,
                    "bound_ms": pbound, "bound_by": "operations" if by_ops else "bytes", "library_ms": None})
    return out


def dense_wide_stage_times(card, device):
    """The wide dense chunks with their stages, timed at 2^17 symbols by CUDA
    events (10 launches): apply_power + normalize on SC-CY1.0-1024 (fold)
    and SC-ZE1.0-1024 (mm), the four noise-bump stages on SC-CY1.0-512 and
    flat_zp_ofdm_512, and the dump stage (a capture's rows) on the two
    1024-sc links, each beside its bound (the chain's operations plus its
    stages a bin; the normalization's second pass printed apart)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import _KERNELS

    cases = []
    for name, chain in (("SC-CY1.0-1024", "fold"), ("SC-ZE1.0-1024", "mm")):
        runner = dense_wide_runner(name, chain, dense_wide_cfg(DENSE_WIDE_LINKS[name][1], **_WF), device)
        cases.append((f"{name} apply_power + normalize", chain, runner.link, DENSE_WIDE_SNR,
                      sqrt_power_row(runner, DENSE_WIDE_SNR), None))
    for name, chain in (("SC-CY1.0-512", "fold"), ("flat_zp_ofdm_512", "mm")):
        runner = dense_wide_runner(name, chain, dense_wide_cfg(DENSE_WIDE_LINKS[name][1], **_NB), device)
        cases.append((f"{name} noise-bump stages", chain, lk.noise_bump_link(runner.link), 15.0,
                      bump_rows(runner, device), None))
    for name, chain in (("SC-CY1.0-1024", "fold"), ("SC-ZE1.0-1024", "mm")):
        link = dense_wide_runner(name, chain, dense_wide_cfg(DENSE_WIDE_LINKS[name][1]), device).link
        cases.append((f"{name} dump", chain, link, DENSE_WIDE_SNR, None,
                      lk.new_dump(lk.dump_rows(CAPTURE_COLLECT, link.n, MAIN_CHUNK), link.n, device)))
    for label, chain, link, snr_db, rows, dump in cases:
        _, kernel, _, _ = chains()[chain]
        acc, psum = lk.new_accumulators(device)
        work = _KERNELS[chain].workspace(link, MAIN_CHUNK, device)
        snr_lin = lk.snr_linear(snr_db)
        ms = cuda_ms(lambda: kernel(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work, rows=rows, dump=dump), 10)
        stages = lk.link_stages(link)
        per_bin = sum(ops for bit, ops in zip((lk.STAGE_POWER, lk.STAGE_NORMALIZE, lk.STAGE_POST_NOISE,
                                               lk.STAGE_COMPENSATE), STAGE_OPS.values()) if stages & bit)
        base, _ = dense_wide_operations(chain, link, MAIN_CHUNK)
        needed = base + MAIN_CHUNK * link.n * per_bin
        print(f"{chain}_wide {label} at {MAIN_CHUNK} symbols [{card}]: kernel {ms:.4f} ms, bound "
              f"{needed / PEAK_OPS * 1e3:.4f} ms ({needed} operations"
              + (f"; the normalization's second pass adds {base / PEAK_OPS * 1e3:.4f} ms" if link.normalize else "")
              + ")")


def dense_wide_path(card, device):
    """This slice's phase: fold_wide and mm_wide (with their probes, staged,
    bump and dump builds) against their plain versions, the two audit cells
    they take from the eager chain through LinkRunner, the kernels timed.
    Returns the kernels-line entries (the probes' launches filled in by
    ``one_rank_path``'s halo run on SC-CY1.0-1024)."""
    t0 = time.perf_counter()
    dense_wide_layout(card, device)
    err, probe_err = dense_wide_checks(card, device)
    launches, power, rates = dense_wide_cells(card, device)
    entries = dense_wide_entries(card, device, err, probe_err, launches, power)
    dense_wide_stage_times(card, device)
    print(f"dense_wide phase: {time.perf_counter() - t0:.1f} s; OFDM syms/s {json.dumps(rates)}")
    return entries


# --- adaptive SC-FDE on the fold and mm kernels, narrow and wide -------------------

# The reference's adaptive link (config/simulation_settings_adaptive.json: 64
# sc, Lin-Phoong P1, CP 1.0, MMSE, waterfilling, CAPACITY_BASED QAM 4-256) on
# SC-FDE, where lane t's order demaps time sample t after the SC IDFT
# (link_kernel.sc_slicer).  The chunk checks, (chain, changes): MMSE and ZF,
# normalize_before_demap (the row rides the normalization), adaptive PSK, a
# zero prefix (mm), severe_multipath at 512 and 1024 sc (fold_wide; orders
# {4, 16, 64}) and at 1024 sc with a zero prefix (mm_wide).
_ASC_WIDE = dict(num_subcarriers=1024, channel_model="severe_multipath")
ASC_LINKS = {
    "asc_64_cp_mmse": ("fold", {}),
    "asc_64_cp_zf": ("fold", dict(equalization_method="ZF")),
    "asc_64_cp_normalize": ("fold", dict(normalize_before_demap=True)),
    "asc_64_cp_apsk": ("fold", dict(constellation_type="PSK")),
    "asc_64_zp": ("mm", dict(prefix_type="ZERO")),
    "asc_512_cp": ("fold", dict(_ASC_WIDE, num_subcarriers=512)),
    "asc_1024_cp": ("fold", _ASC_WIDE),
    "asc_1024_zp": ("mm", dict(_ASC_WIDE, prefix_type="ZERO")),
}
# The phase's cells through the normal entry points on the card, (chain,
# changes, SNR points, OFDM symbols a point): the 64-sc link through
# run_sweep (one setup a point) at the config's three SNRs, its zero-prefix
# twin, and both at 1024 sc over severe_multipath.  Each BER at z = BAND_Z
# against the JAX package's XLA reading on a CPU (jax_band_readings.py,
# ASC_READING_SYMBOLS OFDM symbols), key "<cell>_<snr>db"; on the fold
# chain against the same run with the JAX fold kernel's measured power,
# "<cell>_<snr>db_fold_power": the fold kernels (the JAX package's and the
# port's) measure |Y|^2 over the n bins, the XLA path |y|^2 over all T
# samples, and on SC-FDE the cyclic prefix copies the last lanes' power,
# so where lanes are inactive (the 64-sc link at 15 dB: 8 of 64) the two
# noise powers differ (by 0.64% there; BER 0.012140 against 0.012290 at
# 2^18 symbols).  The eager twins are held to the XLA reading.
ASC_CELLS = {
    "adaptive_scfde_64sc": ("fold", {}, (15.0, 20.0, 25.0), 1 << 24),
    "adaptive_scfde_64sc_zp": ("mm", dict(prefix_type="ZERO"), (20.0,), 1 << 22),
    "adaptive_scfde_1024sc": ("fold", _ASC_WIDE, (20.0,), 1 << 20),
    "adaptive_scfde_1024sc_zp": ("mm", dict(_ASC_WIDE, prefix_type="ZERO"), (20.0,), 1 << 20),
}
ASC_READING_SYMBOLS = 1 << 18
ASC_READING = "XLA path, CPU, 2^18 OFDM symbols"
# aqam on SC-FDE multiplies each time sample by its lane's row after the
# IDFT (two multiplies, counted with the per-sample counters); the
# equalizer reads no lane row then (mmse as qam's).
ASC_OPS = dict(OPS_PER_BIN_AQAM, mmse=OPS_PER_BIN["mmse"], count=OPS_PER_BIN["count"] + 2)


def asc_cfg(snr_db, num_ofdm, chunk=MAIN_CHUNK, **kw):
    """The reference's adaptive config at ``snr_db`` on SC-FDE, with ``kw``'s changes."""
    return adaptive_cfg(snr_db, num_ofdm, chunk).replace(modulation_type="SC-OFDM", **kw)


def asc_kernel(chain, link):
    """The kernel that runs an adaptive SC-FDE link: fold, mm, fold_wide or mm_wide."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    return chain + ("_wide" if (fk if chain == "fold" else mmk).is_wide(link) else "")


def asc_runner(name, chain, cfg, device):
    """LinkRunner of an adaptive SC-FDE link, checked to route to ``chain``
    in an adaptive codec mode."""
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    runner = LinkRunner(prepare(cfg), device)
    if runner.mode != chain or runner.link.q.mode not in ("aqam", "apsk") or not runner.link.is_sc:
        raise AssertionError(f"{name} routed to {runner.mode} ({getattr(runner.link, 'q', None)}), not {chain}")
    return runner


def asc_checks(card, device):
    """Each kernel against its plain version (``compare_chunk``) on
    ASC_LINKS at sym0 = 0 and 2^32 + 77; apply_power alone (the staged
    build's row after the IDFT) on a narrow and a wide link; the noise-bump
    stages; a capture; K3 on a narrow and a wide link.  Returns ({kernel:
    max difference}, K3's max difference)."""
    from ofdm_tpu_torch.ops import link_kernel as lk

    err = {"fold": 0.0, "mm": 0.0, "fold_wide": 0.0, "mm_wide": 0.0}

    def check(label, chain, runner, sym0, snr_db, link=None, rows=None):
        link = runner.link if link is None else link
        kname = asc_kernel(chain, link)
        _, kernel, plain, _ = chains()[chain]
        orders = sorted({int(o) for o in runner.setup.constellation_orders})
        err[kname] = max(err[kname], compare_chunk(
            f"{kname} {label} ({link.q.mode} SC-FDE, n={link.n}, T={link.T}, E={link.E}, orders {orders}, tile "
            f"{lk.tile_for(MAIN_CHUNK, link.tile_cap)}, stages {lk.link_stages(link)})", kernel, plain, link, sym0,
            MAIN_CHUNK, snr_db, device, rows=rows))

    for name, (chain, kw) in ASC_LINKS.items():
        runner = asc_runner(name, chain, asc_cfg(20.0, MAIN_SYMBOLS, **kw), device)
        for sym0 in PROBE_SYM0:
            check(name, chain, runner, sym0, 20.0)
    for name in ("asc_64_cp_mmse", "asc_1024_cp"):
        chain, kw = ASC_LINKS[name]
        runner = asc_runner(name, chain, asc_cfg(20.0, MAIN_SYMBOLS, apply_power_allocation=True, **kw), device)
        check(f"{name} apply_power", chain, runner, MAIN_CHUNK, 20.0, rows=sqrt_power_row(runner, 20.0))
    runner = asc_runner("asc_64_cp_mmse", "fold", asc_cfg(20.0, MAIN_SYMBOLS, **_NB), device)
    check("asc_64_cp_mmse noise-bump stages", "fold", runner, MAIN_CHUNK, 15.0, lk.noise_bump_link(runner.link),
          bump_rows(runner, device))
    err["fold"] = max(err["fold"], capture_check(card, device, "asc_64_cp_mmse (fold, aqam SC-FDE)", "fold",
                                                 asc_cfg(20.0, BAND_SYMBOLS), CAPTURE_COLLECT)[0])
    probe_err = 0.0
    for name in ("asc_64_cp_mmse", "asc_1024_zp"):
        chain, kw = ASC_LINKS[name]
        probe_err = max(probe_err, probe_check(name, chain, asc_cfg(20.0, MAIN_SYMBOLS, **kw), device))
    return err, probe_err


def asc_router():
    """kernel_mode on the adaptive SC-FDE grid (CP / ZP / none x three
    channels x 16-2048 sc x QAM and PSK loading): every link the JAX plan
    admits (up to 1024 sc; tests/test_torch_adaptive_scfde.py holds the
    grid against plan_for + supports on the CPU) on fold or mm, none
    eager; at 2048 sc eager, as the JAX package runs it on XLA."""
    import itertools

    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    seen = {}
    for prefix, channel, n, kind in itertools.product(("CYCLIC", "ZERO", "NONE"),
                                                      ("severe_multipath", "flat_fading", "Lin-Phoong_P2"),
                                                      (16, 32, 64, 128, 256, 512, 1024, 2048), ("QAM", "PSK")):
        mode = kernel_mode(prepare(asc_cfg(20.0, 16, 0, num_subcarriers=n, prefix_type=prefix, channel_model=channel,
                                           constellation_type=kind)))
        want = "eager" if n == 2048 else ("mm" if prefix == "ZERO" else "fold")
        if mode != want:
            raise AssertionError(f"adaptive SC-FDE {prefix} {channel} {n} sc {kind}: {mode}, not {want}")
        seen[mode] = seen.get(mode, 0) + 1
    print(f"adaptive SC-FDE router: {sum(seen.values())} configs, {json.dumps(seen)} (none of n <= 1024 eager)")


def asc_cells(card, device):
    """ASC_CELLS through the normal entry points: the 64-sc cell through
    run_sweep (a runner a point), the others through LinkRunner.  Every
    launch counter set to 0 just before a cell and read just after (each
    point's chunk kernel and its power pass once a chunk, nothing else),
    ``hotpath_used``, the z = 5 band, OFDM syms/s beside the eager chain's
    on the same link (hotpath "xla", banded too).  Returns ({kernel:
    launches}, {kernel: power-pass launches}, {cell: OFDM syms/s})."""
    import torch

    from ofdm_tpu_torch.parallel.sweep import run_sweep
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    launches, power, rates = {}, {}, {}
    for cell, (chain, kw, snrs, num_ofdm) in ASC_CELLS.items():
        warm = asc_runner(cell, chain, asc_cfg(snrs[0], MAIN_CHUNK, **kw), device)
        warm.run(1)
        kname = asc_kernel(chain, warm.link)
        torch.cuda.synchronize()
        dense_wide_counters(reset=True)
        if len(snrs) > 1:
            rs = run_sweep(asc_cfg(snrs[0], num_ofdm, **kw), snrs=snrs, key=MAIN_SEED, sharded=False, device=device)
        else:
            rs = [asc_runner(cell, chain, asc_cfg(snrs[0], num_ofdm, **kw), device).run(MAIN_SEED)]
        torch.cuda.synchronize()
        got = dense_wide_counters()
        fn = "fold_chunk" if chain == "fold" else "mm_chunk"
        main = f"{fn}.{'wide_launches' if kname.endswith('_wide') else 'launches'}"
        pw = f"{fn}.{('wide_' if kname.endswith('_wide') else '') + ('power' if chain == 'fold' else 'front')}_launches"
        want = len(snrs) * num_ofdm // MAIN_CHUNK
        others = {k: v for k, v in got.items() if v and k not in (main, pw)}
        if (got[main], got[pw]) != (want, want) or others or any(r["hotpath_used"] != "cuda" for r in rs):
            raise AssertionError(f"{cell}: launches {got}, hotpath {[r['hotpath_used'] for r in rs]}")
        launches[kname], power[kname] = want, want
        for snr, r in zip(snrs, rs):
            name = f"{cell}_{int(snr)}db"
            print(f"{name} through {'run_sweep' if len(snrs) > 1 else 'LinkRunner'} ({kname}, "
                  f"{warm.link.q.mode} SC-FDE) [{card}]: {num_ofdm} OFDM symbols ({r['total_bits']} bits), "
                  f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} run_s={r['transmission_time_ms'] / 1e3:.4f} "
                  f"BER={r['bit_error_rate']} papr_db={r['papr_db']:.4f} hotpath={r['hotpath_used']}; "
                  f"launches of the cell {json.dumps({k: v for k, v in got.items() if v})}")
            band(f"{name}_fold_power" if chain == "fold" else name, r,
                 ASC_READING + (", the fold kernel's measured power" if chain == "fold" else ""))
            if name in WIDE_BASELINE_BER:
                check_baseline_ber(name, r)
            rates[name] = r["ofdm_symbols_per_s"]
        snr = snrs[len(snrs) // 2]
        eager = LinkRunner(prepare(asc_cfg(snr, min(num_ofdm, 1 << 24), hotpath="xla", **kw)), device)
        if eager.mode != "eager":
            raise AssertionError(f"{cell} with hotpath xla routed to {eager.mode}")
        eager.run(1)
        e = eager.run(MAIN_SEED)
        print(f"{cell}_{int(snr)}db on the eager chain (hotpath xla) [{card}]: "
              f"ofdm_symbols_per_s={e['ofdm_symbols_per_s']:.1f} BER={e['bit_error_rate']} "
              f"hotpath={e['hotpath_used']} (the kernel: {rates[f'{cell}_{int(snr)}db']:.1f})")
        band(f"{cell}_{int(snr)}db", e, ASC_READING)
        rates[f"{cell}_{int(snr)}db_eager"] = e["ofdm_symbols_per_s"]
    prof_runner = asc_runner("adaptive_scfde_64sc", "fold", asc_cfg(20.0, 1 << 22), device)
    print_profile(card, "adaptive_scfde_64sc 20 dB (fold)", profile_run(prof_runner, 20.0))
    return launches, power, rates


def asc_entries(card, device, err, launches, power):
    """The kernels-line entries: each kernel in aqam on SC-FDE on its cell's
    20 dB link, timed at 2^17 symbols by CUDA events beside its plain
    version and its bound by operations (ASC_OPS: the aqam codec's per-bin
    counts and the post-IDFT row)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.pipeline import _KERNELS

    out = []
    for cell, (chain, kw, _, _) in ASC_CELLS.items():
        runner = asc_runner(cell, chain, asc_cfg(20.0, MAIN_SYMBOLS, **kw), device)
        link = runner.link
        kname = asc_kernel(chain, link)
        _, kernel, plain, _ = chains()[chain]
        snr_lin = lk.snr_linear(20.0)
        acc, psum = lk.new_accumulators(device)
        work = _KERNELS[chain].workspace(link, MAIN_CHUNK, device)
        k_ms = cuda_ms(lambda: kernel(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
        p_ms = cuda_ms(lambda: plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum), 1)
        if kname.endswith("_wide"):
            ops, added = dense_wide_operations(chain, link, MAIN_CHUNK, ASC_OPS)
        elif chain == "fold":
            ops, power_ops, tail_ops = fold_operations(link, MAIN_CHUNK, ASC_OPS)
            added = power_ops + tail_ops
        else:
            ops, added = mm_operations(link, MAIN_CHUNK, ASC_OPS)
        bound = ops / PEAK_OPS * 1e3
        print(f"{kname} aqam SC-FDE ({cell}, 20 dB) at {MAIN_CHUNK} symbols [{card}]: kernel {k_ms:.4f} ms "
              f"({MAIN_CHUNK / k_ms * 1e3:.1f} OFDM syms/s), plain {p_ms:.3f} ms, bound {bound:.4f} ms ({ops} "
              f"operations needed; the design adds {added}, {added / PEAK_OPS * 1e3:.4f} ms at the same rate)")
        wrapper = {"fold": "fold_chunk", "mm": "mm_chunk"}.get(kname, kname)
        out.append({"name": f"{wrapper} (aqam SC-FDE, {cell})", "route": "cuda",
                    "source": f"ofdm_tpu_torch/csrc/{kname}_kernel.cu",
                    "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches[kname],
                    "power_launches": power[kname], "max_abs_err": err[kname], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": "operations", "library_ms": None})
    return out


def adaptive_scfde_path(card, device):
    """This slice's phase: adaptive SC-FDE (aqam, apsk) on fold, mm,
    fold_wide and mm_wide against their plain versions (with the staged,
    bump and dump builds and K3), the router over the adaptive SC-FDE grid,
    the cells through run_sweep and LinkRunner, the kernels timed.
    Returns the kernels-line entries."""
    t0 = time.perf_counter()
    err, probe_err = asc_checks(card, device)
    asc_router()
    launches, power, rates = asc_cells(card, device)
    entries = asc_entries(card, device, err, launches, power)
    print(f"adaptive_scfde phase [{card}]: {time.perf_counter() - t0:.1f} s; K3 max difference {probe_err}; "
          f"OFDM syms/s {json.dumps(rates)}")
    return entries


# --- the sweep and the shards: K3, the carry-in, the mesh, the CLI ------------------

# The links K3 (the carry probe) is held on: its chunk's carry row, its plain
# version, and the carry-in, at sym0 = 0 and sym0 > 2^32.  Each chain in qam
# and in the codec's other modes, and with apply_power; fold and mm also at
# each other width their chunk kernels compile for (bins a lane 1, 3-8: the
# fold and mm chunk checks' links).
PROBE_SYM0 = (0, (1 << 32) + 77)
PROBE_TIMED_LAUNCHES = 1000
PROBE_FOLD_WIDTHS = ("scfde_32sc", "ofdm_short_cp_96sc", "scfde_mmse_128sc", "scfde_160sc", "scfde_192sc",
                     "scfde_224sc", "scfde_256sc")
PROBE_MM_WIDTHS = ("zp_32sc", "zp_96sc", "scfde_zp_160sc", "flat_zp_256sc", "scfde_zp_256sc")


def probe_links():
    """{name: (chain, config at MAIN_SYMBOLS)} of K3's checks."""
    def codec(name):
        return CODEC_LINKS[name][0], audit_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **CODEC_LINKS[name][2])

    return {
        "scfde_default": ("fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK)),
        "psk8_cp0.34_64": codec("psk8_cp0.34_64"),
        "adapt_wf_cp0.34_64": codec("adapt_wf_cp0.34_64"),
        "adapt_psk_p1_10db_cp0.34_64": codec("adapt_psk_p1_10db_cp0.34_64"),
        "wf_scfde_default": ("fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF)),
        "wide_1024sc": ("lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK)),
        "lr_1024sc_zp": ("lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK, prefix_type="ZERO")),
        "psk8_zp0.5_256": codec("psk8_zp0.5_256"),
        "adapt_wf_zp0.5_256": codec("adapt_wf_zp0.5_256"),
        "wf_wide_1024sc": ("lr", wide_cfg(LR_SYMBOLS, MAIN_CHUNK, **_WF)),
        "zp_64sc": ("mm", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK)),
        "psk8_zp1.0_64": codec("psk8_zp1.0_64"),
        "adapt_psk_wf_zp1.0_64": codec("adapt_psk_wf_zp1.0_64"),
        "wf_zp_64sc": ("mm", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **_WF)),
        **{f"fold_{name}": ("fold", scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **FOLD_LINKS[name]))
           for name in PROBE_FOLD_WIDTHS},
        **{f"mm_{name}": ("mm", zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK, **MM_LINKS[name])) for name in PROBE_MM_WIDTHS},
    }


def probes():
    """{chain: (K3 wrapper, its plain version)}."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    return {"fold": (fk.fold_probe, fk.fold_probe_plain), "lr": (lrk.lr_probe, lrk.lr_probe_plain),
            "mm": (mmk.mm_probe, mmk.mm_probe_plain)}


def chunk_counts(fn, link, key, sym0, chunk, snr_lin, device, rows, prev=None):
    """(bit errors, symbol errors, carry row pair on the host) of one chunk."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk

    acc, psum = lk.new_accumulators(device)
    cr, ci = fn(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows, prev=prev)
    torch.cuda.synchronize()
    be, se, _ = acc.tolist()
    return be, se, cr.cpu().clone(), ci.cpu().clone()


def probe_check(name, chain, cfg, device):
    """K3 on one link, each sym0 of PROBE_SYM0: the kernel bit-equal to its
    plain version and to the chunk kernel's carry row; the chunk given its
    own predecessor's tail (K3 of the one-symbol chunk before it; zeros at
    sym0 = 0) counts exactly what it counts without it; at sym0 > 2^32 the
    chunk given a foreign tail counts what its plain version counts with
    it.  Each call's four outputs are views of one new buffer: a second
    probe leaves the first one's outputs as they were.  Returns the largest
    difference (0 when bit-equal)."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    runner = LinkRunner(prepare(cfg), device)
    if runner.mode != chain:
        raise AssertionError(f"{name} routes to {runner.mode}, not {chain}")
    link = runner.link
    rows = sqrt_power_row(runner, cfg.snr_db) if cfg.apply_power_allocation else None
    _, kernel, plain, _ = chains()[chain]
    probe, probe_plain = probes()[chain]
    snr_lin = lk.snr_linear(cfg.snr_db)
    key = prng.key_words(MAIN_SEED)
    err = 0.0
    for sym0 in PROBE_SYM0:
        be, se, cr, ci = chunk_counts(kernel, link, key, sym0, MAIN_CHUNK, snr_lin, device, rows)
        got = [t.cpu() for t in probe(link, key, sym0, MAIN_CHUNK, rows)]
        ref = [t.cpu() for t in probe_plain(link, key, sym0, MAIN_CHUNK, rows)]
        diff = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, ref))
        err = max(err, diff, float((got[0] - cr).abs().max()), float((got[1] - ci).abs().max()))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} sym0={sym0}: K3 and its plain version differ (max {diff})")
        if not (torch.equal(got[0], cr) and torch.equal(got[1], ci)):
            raise AssertionError(f"{name} sym0={sym0}: K3's row differs from the chunk kernel's carry row")
        first = probe(link, key, sym0, MAIN_CHUNK, rows)
        kept = [t.clone() for t in first]
        second = probe(link, prng.fold_in(key, 7), sym0 + 1, MAIN_CHUNK, rows)
        torch.cuda.synchronize()
        base = first[0].untyped_storage().data_ptr()
        if (any(t.untyped_storage().data_ptr() != base for t in first)
                or second[0].untyped_storage().data_ptr() == base
                or not all(torch.equal(a, b) for a, b in zip(first, kept))):
            raise AssertionError(f"{name} sym0={sym0}: K3's outputs are not views of one new buffer a call")
        if sym0 == 0:
            own = tuple(torch.zeros(link.E, dtype=torch.float32, device=device) for _ in range(2))
        else:
            own = tuple(probe(link, key, sym0 - 1, 1, rows)[2:])
        pb, ps, pcr, pci = chunk_counts(kernel, link, key, sym0, MAIN_CHUNK, snr_lin, device, rows, prev=own)
        if (pb, ps) != (be, se) or not (torch.equal(pcr, cr) and torch.equal(pci, ci)):
            raise AssertionError(f"{name} sym0={sym0}: the chunk given its own predecessor's tail counts "
                                 f"{pb}/{ps}, without it {be}/{se}")
        line = (f"K3 {name} ({chain}, {link.q.mode}, E={link.E}, apply_power={link.apply_power}) sym0={sym0}: "
                f"probe = plain = carry row (bit-equal), one new buffer a call; chunk {be}/{se} with and without its "
                f"own carry-in")
        if sym0 > 0:
            foreign = tuple(probe(link, prng.fold_in(key, 99), 12345, 1, rows)[2:])
            fb, fs, _, _ = chunk_counts(kernel, link, key, sym0, MAIN_CHUNK, snr_lin, device, rows, prev=foreign)
            qb, qs, _, _ = chunk_counts(plain, link, key, sym0, MAIN_CHUNK, snr_lin, device, rows, prev=foreign)
            if (fb, fs) != (qb, qs):
                raise AssertionError(f"{name}: with a foreign tail the kernel counts {fb}/{fs}, the plain "
                                     f"version {qb}/{qs}")
            line += f"; with a foreign tail kernel {fb}/{fs} = plain {qb}/{qs}"
        print(line)
    return err


def probe_entries(card, device, err):
    """K3's kernels-line entries: each chain's probe on its main-path link
    (scfde_default, lr_1024sc_zp, zp_64sc) at the 2^17-symbol chunk, the
    mean of PROBE_TIMED_LAUNCHES launches by CUDA events, beside its plain
    version and its bound (one symbol: Philox and encode a bin, the TX
    product's needed terms; bytes: the matrix read, for fold and mm its
    nonzero elements, which the one-block probes read as listed terms, and
    the rows written)."""
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    links = {"fold": scfde_cfg(MAIN_SYMBOLS, MAIN_CHUNK), "lr": wide_cfg(LR_SYMBOLS, MAIN_CHUNK, prefix_type="ZERO"),
             "mm": zp_cfg(MAIN_SYMBOLS, MAIN_CHUNK)}
    out = []
    key = prng.key_words(MAIN_SEED)
    for chain, cfg in links.items():
        link = LinkRunner(prepare(cfg), device).link
        probe, probe_plain = probes()[chain]
        k_ms = cuda_ms(lambda: probe(link, key, MAIN_CHUNK, MAIN_CHUNK), PROBE_TIMED_LAUNCHES)
        dev_ms = device_ms(lambda: probe(link, key, MAIN_CHUNK, MAIN_CHUNK), f"ofdm_{chain}::{chain}_probe", 100)
        p_ms = cuda_ms(lambda: probe_plain(link, key, MAIN_CHUNK, MAIN_CHUNK), 20)
        mats = (link.tail_r, link.tail_i) if chain == "lr" else (link.txr, link.txi)
        ops = link.n * (OPS_PER_BIN["philox"] + OPS_PER_BIN["encode"]) + product_ops(
            mats[0].T if chain == "lr" else mats[0], mats[1].T if chain == "lr" else mats[1])
        nbytes = 8 * (mats[0].numel() if chain == "lr" else link.tx_terms.nonzero) + 8 * (link.T + link.E)
        bound = max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
        print(f"K3 {chain}_probe at {cfg.num_subcarriers} sc (T={link.T}, E={link.E}) [{card}]: kernel "
              f"{k_ms:.4f} ms a launch (mean of {PROBE_TIMED_LAUNCHES} by CUDA events: the wrapper's host time "
              f"bounds it), device time {dev_ms if dev_ms is None else f'{dev_ms:.5f}'} ms a launch (profiler, 100 "
              f"launches), plain {p_ms:.3f} ms, bound {bound:.6f} ms ({ops} operations, {nbytes} bytes)")
        out.append({"name": f"{chain}_probe", "route": "cuda", "source": f"ofdm_tpu_torch/csrc/{chain}_kernel.cu",
                    "replaces": "ofdm_tpu/ops/pallas_link.py:2218", "launches": None, "max_abs_err": err,
                    "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": bound,
                    "bound_by": "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes",
                    "library_ms": None})
    return out


def probe_path(card, device):
    """K3 on every link of ``probe_links``; returns its kernels-line entries
    (their launches filled in by the sharded runs)."""
    err = max(probe_check(name, chain, cfg, device) for name, (chain, cfg) in probe_links().items())
    return probe_entries(card, device, err)


# The sharded runs (ShardedLinkRunner on a one-rank NCCL mesh, both stream
# modes) on the five cells of the main paths: OFDM symbols, and the gate
# each BER is held to.
SHARD_KEY = 5
SHARD_TIMEOUT_S = 240.0
TWO_RANK_TIMEOUT_S = 300.0


def shard_links():
    """{name: (chain, config)} of the one-rank sharded runs: 2^24 OFDM
    symbols, 2^23 at 1024 subcarriers, 2^20 on the eager link and on the
    wide fold link; chunks of 2^17."""
    from ofdm_tpu_torch.config import SimulationConfig

    eager = EAGER_LINKS["OFDM-CY1.0-512"]
    return {
        "headline": ("diag", headline_cfg(1 << 24, MAIN_CHUNK)),
        "scfde_default": ("fold", scfde_cfg(1 << 24, MAIN_CHUNK)),
        "lr_1024sc_zp": ("lr", wide_cfg(1 << 23, MAIN_CHUNK, prefix_type="ZERO")),
        "zp_64sc": ("mm", zp_cfg(1 << 24, MAIN_CHUNK)),
        "OFDM-CY1.0-512": ("eager", SimulationConfig(**eager, num_symbols=512 * EAGER_SYMBOLS,
                                                     symbols_per_chunk=MAIN_CHUNK)),
        # the wide fold and mm chains, their probes (fold_wide_probe,
        # mm_wide_probe) in halo mode
        "SC-CY1.0-1024": ("fold", audit_cfg(EAGER_SYMBOLS, MAIN_CHUNK, **DENSE_WIDE_CELLS["SC-CY1.0-1024"][1])),
        "SC-ZE1.0-1024": ("mm", audit_cfg(EAGER_SYMBOLS, MAIN_CHUNK, **DENSE_WIDE_CELLS["SC-ZE1.0-1024"][1])),
    }


def shard_gate(name, r):
    """Hold a sharded run's BER to its cell's gate (or the eager link's band)."""
    gates = {"headline": (REFERENCE_BER_30DB, 1.5e-3), "scfde_default": (REFERENCE_SCFDE_BER[10.0], 1.5e-3),
             "lr_1024sc_zp": (LR_BER_30DB, LR_BER_TOL), "zp_64sc": (ZP_BER_REF, 1.5e-3)}
    if name not in gates:
        band(name, r, EAGER_READING)
        return
    ref, tol = gates[name]
    if not abs(r["bit_error_rate"] - ref) < tol:
        raise AssertionError(f"sharded {name}: BER {r['bit_error_rate']} outside {ref} +- {tol}")


def one_rank_path(card, device, probe_entries):
    """ShardedLinkRunner on a one-rank NCCL mesh (init_process_group over
    127.0.0.1, world size 1), both stream modes, on ``shard_links``: counts
    equal to LinkRunner.run(fold_in(key, 0)) exactly, halo equal to
    independent, each BER inside its gate, K3 launched once a chunk in halo
    mode on fold, lr and mm (the launches of ``probe_entries``), and OFDM
    syms/s beside LinkRunner's."""
    import socket

    import torch
    import torch.distributed as dist

    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.parallel import ShardedLinkRunner, distributed_init, make_mesh
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed_init(f"127.0.0.1:{port}", 1, 0, backend="nccl", timeout=SHARD_TIMEOUT_S)
    try:
        mesh = make_mesh()
        if (mesh.backend, mesh.size) != ("nccl", 1):
            raise AssertionError(f"one-rank mesh: {mesh}")
        probes_ = probes()
        for name, (chain, cfg) in shard_links().items():
            setup = prepare(cfg)
            base = LinkRunner(setup)
            if base.mode != chain:
                raise AssertionError(f"{name} routes to {base.mode}")
            base.run(1)  # warm-up
            want = base.run(prng.fold_in(SHARD_KEY, 0))
            got = {}
            for mode in ("independent", "halo"):
                runner = ShardedLinkRunner(setup, mesh=mesh, stream_mode=mode)
                chunks = runner._chunk_plan()[1]
                # the wide links' probes count apart (wide_launches)
                wide = (chain == "fold" and fk.is_wide(runner.link)) or (chain == "mm" and mmk.is_wide(runner.link))
                counter = "wide_launches" if wide else "launches"
                pname = f"{chain}_wide_probe" if wide else f"{chain}_probe"
                if chain in probes_:
                    probes_[chain][0].launches = probes_[chain][0].wide_launches = 0
                r = runner.run(SHARD_KEY)
                torch.cuda.synchronize()
                got[mode] = r
                launches = other = 0
                if chain in probes_:
                    launches = getattr(probes_[chain][0], counter)
                    other = probes_[chain][0].launches + probes_[chain][0].wide_launches - launches
                want_launches = chunks if mode == "halo" and chain in probes_ else 0
                print(f"sharded {name} ({chain}, {mode}, 1 rank, {r['collective_backend']}) [{card}]: "
                      f"{setup.num_ofdm_symbols} OFDM symbols in {chunks} chunks, BER={r['bit_error_rate']} "
                      f"({r['bit_errors']} / {r['symbol_errors']}), ofdm_symbols_per_s="
                      f"{r['ofdm_symbols_per_s']:.1f} (LinkRunner {want['ofdm_symbols_per_s']:.1f}), "
                      f"{pname} launches {launches}")
                if (r["bit_errors"], r["symbol_errors"]) != (want["bit_errors"], want["symbol_errors"]):
                    raise AssertionError(f"sharded {name} {mode}: {r['bit_errors']}/{r['symbol_errors']}, "
                                         f"LinkRunner {want['bit_errors']}/{want['symbol_errors']}")
                if launches != want_launches or other or r["collective_backend"] != "nccl":
                    raise AssertionError(f"sharded {name} {mode}: probe launches {launches} (+{other} of the other "
                                         f"probe), not {want_launches}")
                if mode == "halo" and chain in probes_:
                    for e in probe_entries:
                        if e["name"] == pname:
                            e["launches"] = launches
                shard_gate(name, r)
            if (got["halo"]["bit_errors"], got["halo"]["symbol_errors"]) != (
                    got["independent"]["bit_errors"], got["independent"]["symbol_errors"]):
                raise AssertionError(f"sharded {name}: halo differs from independent on one rank")
    finally:
        dist.destroy_process_group()
    if any(e["launches"] is None for e in probe_entries):
        raise AssertionError("a probe was not launched on the sharded path")


def rank_links():
    """{name: (chain, config)} of the multi-rank runs: 2^22 OFDM symbols (2^21
    at 1024 subcarriers and on the ISI links, 2^18 on the eager link),
    chunks of 2^17.  The main paths' cells have guards that cover the
    channel, where a symbol's predecessor reaches no point; the three ISI
    links (a guard shorter than the channel on each chain) are where the
    halo stream differs from the independent ones."""
    from ofdm_tpu_torch.config import SimulationConfig

    eager = EAGER_LINKS["OFDM-CY1.0-512"]
    return {
        "scfde_default": ("fold", scfde_cfg(1 << 22, MAIN_CHUNK)),
        "lr_1024sc_zp": ("lr", wide_cfg(1 << 21, MAIN_CHUNK, prefix_type="ZERO")),
        "zp_64sc": ("mm", zp_cfg(1 << 22, MAIN_CHUNK)),
        "ofdm_short_cp": ("fold", scfde_cfg(1 << 21, MAIN_CHUNK, **FOLD_LINKS["ofdm_short_cp"])),
        "cp034_128sc": ("lr", wide_cfg(1 << 21, MAIN_CHUNK, **LR_LINKS["cp034_128sc"][0])),
        "zp034_zf": ("mm", zp_cfg(1 << 21, MAIN_CHUNK, **MM_LINKS["zp034_zf"])),
        "OFDM-CY1.0-512": ("eager", SimulationConfig(**eager, num_symbols=512 * (1 << 18),
                                                     symbols_per_chunk=MAIN_CHUNK)),
    }


def rank_worker(rank, ranks, port, backend, queue):
    """One of ``ranks`` ranks: ``rank_links`` in both stream modes, on
    card 0 under gloo, or on card ``rank`` under NCCL; puts (rank,
    {link/mode: [bit errors, symbol errors, backend, probe launches,
    chunks]}) on ``queue``."""
    import torch

    from ofdm_tpu_torch.parallel import ShardedLinkRunner, distributed_init, make_mesh
    from ofdm_tpu_torch.pipeline import prepare

    out = {}
    try:
        distributed_init(f"127.0.0.1:{port}", ranks, rank, backend=backend, timeout=SHARD_TIMEOUT_S)
        mesh = make_mesh(torch.device("cuda", rank if backend == "nccl" else 0))
        probes_ = probes()
        for name, (chain, cfg) in rank_links().items():
            setup = prepare(cfg)
            for mode in ("independent", "halo"):
                runner = ShardedLinkRunner(setup, mesh=mesh, stream_mode=mode)
                if chain in probes_:
                    probes_[chain][0].launches = 0
                r = runner.run(SHARD_KEY)
                out[f"{name}/{mode}"] = [r["bit_errors"], r["symbol_errors"], r["collective_backend"],
                                         probes_[chain][0].launches if chain in probes_ else 0,
                                         runner._chunk_plan()[1]]
        torch.distributed.destroy_process_group()
    except BaseException as exc:  # the parent fails loudly on it
        out = {"error": repr(exc)}
    queue.put((rank, out))


def chained_emulation(chain, cfg, device, ranks):
    """(bit errors, symbol errors) of a halo run on ``ranks`` ranks in one
    process on the card: the shards' chunks in global order, each given the
    previous shard's K3 tail (shard 0 of chunk 0 zeros)."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    runner = LinkRunner(prepare(cfg))
    link, kern = runner.link, runner.kernel
    B, chunk = runner.setup.num_ofdm_symbols, cfg.symbols_per_chunk
    local = chunk // ranks
    keys = [prng.fold_in(SHARD_KEY, d) for d in range(ranks)]
    acc, psum = lk.new_accumulators(device)
    carry = tuple(torch.zeros(link.E, dtype=torch.float32, device=device) for _ in range(2))
    work = kern.workspace(link, local, device)
    for c in range(B // chunk):
        for d in range(ranks):
            kern.chunk(link, keys[d], c * local, local, lk.snr_linear(cfg.snr_db), acc, psum, work, None, prev=carry)
            carry = tuple(t.clone() for t in kern.probe(link, keys[d], c * local, local, None)[2:])
    return tuple(acc[:2].tolist())


def multi_rank_path(card, device, ranks=2, backend="gloo"):
    """``ranks`` ranks spawned with the spawn start method and a wall-clock
    limit: two on the one card under gloo (NCCL refuses two ranks on one
    device), or one a card under NCCL: every rank reports the same global
    counts; independent counts equal the shards' single-process runs under
    fold_in(key, d); halo counts equal the chained emulation, and differ
    from the independent ones on the ISI links; K3 launches once a rank a
    chunk; the eager link inside its band."""
    import multiprocessing as mp
    import queue as queue_mod
    import socket

    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    ctx = mp.get_context("spawn")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=rank_worker, args=(rank, ranks, port, backend, q)) for rank in range(ranks)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, out = q.get(timeout=TWO_RANK_TIMEOUT_S)
            results[rank] = out
    except queue_mod.Empty:
        raise AssertionError(f"{ranks}-rank run: no result within {TWO_RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    if any("error" in out for out in results.values()):
        raise AssertionError(f"{ranks}-rank run failed: {results}")
    if any(results[r] != results[0] for r in range(ranks)):
        raise AssertionError(f"the {ranks} ranks disagree: {results}")
    out = results[0]
    print(f"{ranks} ranks under {backend} [{card}]: every rank reports {json.dumps(out)} ({wall:.1f} s wall, the "
          f"processes' start included)")
    for name, (chain, cfg) in rank_links().items():
        ind, halo_ = out[f"{name}/independent"], out[f"{name}/halo"]
        if ind[2] != backend or halo_[2] != backend:
            raise AssertionError(f"{name}: backend {ind[2]} / {halo_[2]}")
        if chain == "eager":
            bits = prepare(cfg).total_bits
            for mode, v in (("independent", ind), ("halo", halo_)):
                band(name, {"bit_errors": v[0], "total_bits": bits, "bit_error_rate": v[0] / bits}, EAGER_READING)
            continue
        n = cfg.num_subcarriers
        part = cfg.replace(num_symbols=cfg.num_symbols // ranks, symbols_per_chunk=MAIN_CHUNK // ranks)
        shards = [LinkRunner(prepare(part)).run(prng.fold_in(SHARD_KEY, d)) for d in range(ranks)]
        summed = (sum(r["bit_errors"] for r in shards), sum(r["symbol_errors"] for r in shards))
        chained = chained_emulation(chain, cfg, device, ranks)
        print(f"{ranks}-rank {name} ({chain}, {n} sc): independent {tuple(ind[:2])} = shards {summed}; halo "
              f"{tuple(halo_[:2])} = chained emulation {chained}; {chain}_probe launches {halo_[3]} a rank in "
              f"{halo_[4]} chunks")
        if tuple(ind[:2]) != summed or tuple(halo_[:2]) != chained:
            raise AssertionError(f"{ranks}-rank {name}: independent {ind[:2]} vs {summed}, halo {halo_[:2]} vs "
                                 f"{chained}")
        isi = name in ("ofdm_short_cp", "cp034_128sc", "zp034_zf")
        if isi and tuple(halo_[:2]) == tuple(ind[:2]):
            raise AssertionError(f"{ranks}-rank {name}: the halo stream counts what the independent ones count")
        if halo_[3] != halo_[4] or ind[3] != 0:
            raise AssertionError(f"{ranks}-rank {name}: K3 launched {halo_[3]} times in {halo_[4]} chunks")


# The CLI on the reference's configs: the default SC-FDE grid held to the
# reference's BER (docs/RESULTS.md:12-16) at z = 5 on the same bit count;
# the adaptive grid (run_grid_multi) to the z = 5 bands; the pod-scale grid
# (BASELINE configs[4] at its 2^30 QAM symbols a point) to the published
# readings (docs/RESULTS.md:101-112, three digits, so each held at z = 5
# against the interval its rounding leaves) and at 30 dB to the lr gate.
CLI_CONFIGS = {
    "scfde_default": "config/simulation_settings.json",
    "adaptive": "config/simulation_settings_adaptive.json",
    "pod_scale": "config/simulation_settings_pod_scale.json",
}
CLI_TIMEOUT_S = 300.0
POD_SCALE_PUBLISHED = {0.0: (0.402, 5e-4), 10.0: (0.187, 5e-4), 20.0: (0.0212, 5e-5), 30.0: (3.72e-6, 5e-9)}


def cli_path(card):
    """``python -m ofdm_tpu_torch`` on the three configs of CLI_CONFIGS and
    on the adaptive one with "modulation_type": "SC-OFDM" (written under
    tmp/cli_smoke), each in a results directory of its own under
    tmp/cli_smoke: exit 0, the CSV, the BER curve and a constellation PNG a
    point, BERs in their gates.  Returns {config: seconds a point}."""
    import csv

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import metrics as mt
    from ofdm_tpu_torch.pipeline import prepare

    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("OFDM_TPU_")}
    per_point = {}
    # the reference's adaptive settings on SC-FDE (the adaptive_scfde phase's link)
    with open(os.path.join(here, ADAPTIVE_CONFIG)) as fh:
        settings = dict(json.load(fh), modulation_type="SC-OFDM")
    scfde_path = os.path.join(here, "tmp", "cli_smoke", "simulation_settings_adaptive_scfde.json")
    os.makedirs(os.path.dirname(scfde_path), exist_ok=True)
    with open(scfde_path, "w") as fh:
        json.dump(settings, fh, indent=1)
    for name, path in dict(CLI_CONFIGS, adaptive_scfde=scfde_path).items():
        out_dir = os.path.join(here, "tmp", "cli_smoke", name)
        args = [sys.executable, "-m", "ofdm_tpu_torch", "--simulation-settings", path,
                "--results-dir", os.path.join(out_dir, "results"), "--images-dir", os.path.join(out_dir, "images"),
                "--doc-figures-dir", os.path.join(out_dir, "figures"), "--collect-symbols", "4096"]
        t0 = time.perf_counter()
        done = subprocess.run(args, cwd=here, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"CLI {name}: exit {done.returncode}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
        cfgs = {c.snr_db: c for c in SimulationConfig.from_json(os.path.join(here, path))}
        with open(os.path.join(out_dir, "results", "ber_results.csv"), newline="") as fh:
            rows = {float(r["snr_db"]): float(r["bit_error_rate"]) for r in csv.DictReader(fh)}
        if sorted(rows) != sorted(cfgs):
            raise AssertionError(f"CLI {name}: CSV points {sorted(rows)}, config {sorted(cfgs)}")
        pngs = []
        for root, _, files in os.walk(os.path.join(out_dir, "images")):
            pngs += [f for f in files if f.endswith(".png")]
        if sum("BER_vs_SNR" in f for f in pngs) != 1 or sum("SNR" in f and "dB.png" in f for f in pngs) != len(cfgs):
            raise AssertionError(f"CLI {name}: PNGs {sorted(pngs)}")
        device_lines = [ln for ln in done.stdout.splitlines() if ln.startswith("Devices:")]
        rate_lines = [ln.strip() for ln in done.stdout.splitlines() if "Peak throughput" in ln]
        checks = []
        for snr, ber in sorted(rows.items()):
            bits = prepare(cfgs[snr]).total_bits
            errors = round(ber * bits)
            if name == "scfde_default" and snr in REFERENCE_SCFDE_BER:
                ref = REFERENCE_SCFDE_BER[snr]
                ok = mt.ber_equivalent(errors, bits, round(ref * bits), bits, z=BAND_Z)
                checks.append(f"{snr:g} dB {ber} vs reference {ref} z={BAND_Z}: {'inside' if ok else 'OUTSIDE'}")
            elif name in ("adaptive", "adaptive_scfde"):
                key = (f"reference_adaptive_{int(snr)}db" if name == "adaptive"
                       else f"adaptive_scfde_64sc_{int(snr)}db_fold_power")
                je, jb = JAX_CPU_READINGS[key]
                ok = mt.ber_equivalent(errors, bits, je, jb, z=BAND_Z)
                checks.append(f"{snr:g} dB {ber} ({errors} / {bits}) vs JAX {je / jb} z={BAND_Z}: "
                              f"{'inside' if ok else 'OUTSIDE'}")
            elif name == "pod_scale" and snr in POD_SCALE_PUBLISHED:
                ref, half = POD_SCALE_PUBLISHED[snr]
                lo, hi = mt.ber_confidence_interval(errors, bits, BAND_Z)
                ok = hi >= ref - half and lo <= ref + half
                if snr == 30.0:
                    ok = ok and abs(ber - LR_BER_30DB) < LR_BER_TOL
                checks.append(f"{snr:g} dB {ber} ({errors} / {bits}) vs published {ref} (+- {half} rounding) "
                              f"z={BAND_Z}: {'inside' if ok else 'OUTSIDE'}")
            else:
                continue
            if not ok:
                raise AssertionError(f"CLI {name}: {checks[-1]}")
        per_point[name] = wall / len(cfgs)
        print(f"CLI {name} ({path}) [{card}]: exit 0 in {wall:.1f} s for {len(cfgs)} points (process start and "
              f"figures included); {device_lines[0] if device_lines else ''}; {rate_lines[0] if rate_lines else ''}; "
              f"{len(pngs)} PNGs; {'; '.join(checks)}")
    return per_point


def sweep_path(card, device, probe_entries):
    """The sweep and the shards: the one-rank NCCL mesh, two ranks under gloo
    and the CLI (``one_rank_path``, ``multi_rank_path``, ``cli_path``)."""
    one_rank_path(card, device, probe_entries)
    multi_rank_path(card, device)
    return cli_path(card)


# --- the bit-level chains and the shape audit ----------------------------------------

# Two chains built by hand from the port's bit-level ops at 2^20 OFDM
# symbols x 64 subcarriers (2^26 symbols, adaptive_64sc's size), in blocks of
# 2^16 OFDM symbols with the convolution's carry passed from block to block;
# block b draws its bits from prng.fold_in(key, b) through bits.random_bits
# (K4) and its AWGN from prng.normal_planes (K5) at rows b x 2^16 of the
# eager chain's stream (c3 = 4).  Each BER at z = BAND_Z against the JAX
# package's own chain with jax.random on a CPU at 2^16 OFDM symbols
# (jax_band_readings.py).
#   bitlevel_headline: the headline link's parameters from prepare(): 64-QAM
#     Gray, CP ratio 1.0, Lin-Phoong P2, MMSE, 30 dB; bits -> mapping.encode
#     -> linops.modulate -> linops.convolve (banded) -> channel.awgn ->
#     linops.demodulate -> equalize -> mapping.decode_bits -> bit_errors.
#   bitlevel_adaptive: examples/overview.py:31-92: Lin-Phoong P1, 64 sc, 20
#     dB, prefix = the channel order, waterfilling (budget n), QAM gap
#     loading at SER 1e-3, sqrt(P) at TX, ofdm_modulate -> channel.transmit
#     -> MMSE -> unit power a subcarrier -> adaptive.decode; BER and SER.
BITLEVEL_OFDM_SYMBOLS = 1 << 20
BITLEVEL_BLOCK = 1 << 16
BITLEVEL_SEED = 0
BITLEVEL_READING = "the JAX package's bit-level chain, jax.random, CPU, 2^16 OFDM symbols"
BITLEVEL_CHECK_BITS = (1 << 24, 1000003)  # random_bits on the card vs the CPU (and each chain's block); 1000003 is odd
NN_TIE = 1e-5  # decode_nn and decode_hard may part only where two scores lie this close


def bitlevel_headline_link(device):
    """The headline link's constants for the headline chain, from prepare()."""
    import torch

    from ofdm_tpu_torch.ops import linops
    from ofdm_tpu_torch.pipeline import prepare

    s = prepare(headline_cfg(BITLEVEL_BLOCK))
    cfg, T = s.cfg, s.block_length
    E = linops.ext_width(len(s.taps), T)
    t0, t1 = linops.conv_matrices(s.taps, T)
    return dict(setup=s, n=cfg.num_subcarriers, L=s.prefix_length, T=T, E=E, const=s.const,
                t0=torch.tensor(t0, dtype=torch.complex64, device=device),
                band=torch.tensor(t1[T - E:], dtype=torch.complex64, device=device),
                h_freq=torch.tensor(s.h_freq, dtype=torch.complex64, device=device))


def nn_disagreements(eqd, const):
    """(symbol, nn index, hard index, score gap) wherever decode_nn and
    decode_hard part on ``eqd``; the gap (the NN score of its pick minus that
    of the slicer's, from the f32 points in float64) is 0 on a tie."""
    import numpy as np
    import torch

    from ofdm_tpu_torch.ops import mapping

    nn = mapping.decode_nn(eqd, const).reshape(-1)
    hard = mapping.decode_hard(eqd, const).reshape(-1)
    where = torch.nonzero(nn != hard).reshape(-1)
    y = eqd.reshape(-1)[where].cpu().numpy().astype(np.complex128)
    c = const.table
    out = []
    for i, yy, a, b in zip(where.tolist(), y, nn[where].tolist(), hard[where].tolist()):
        score = lambda j: 2.0 * (yy * np.conj(c[j])).real - abs(c[j]) ** 2  # noqa: E731
        out.append((i, a, b, float(score(a) - score(b))))
    return out


def bitlevel_headline(device, num_ofdm=BITLEVEL_OFDM_SYMBOLS, block=BITLEVEL_BLOCK, seed=BITLEVEL_SEED):
    """The headline chain: {errors, bits, ms, nn} (nn: block 0's decode_nn /
    decode_hard disagreements)."""
    import torch

    from ofdm_tpu_torch.config import EqualizationMethod, ModulationType
    from ofdm_tpu_torch.ops import bits as tb
    from ofdm_tpu_torch.ops import channel, linops, mapping, metrics, prng
    from ofdm_tpu_torch.ops import equalize as eq

    link = bitlevel_headline_link(device)
    s, const, n, L, T = link["setup"], link["const"], link["n"], link["L"], link["T"]
    prefix, snr = s.cfg.prefix_type, s.cfg.snr_db
    key = prng.key_words(seed)
    errors = torch.zeros((), dtype=torch.int64, device=device)
    carry, eqd0 = None, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(num_ofdm // block):
        tx = tb.random_bits(prng.fold_in(key, b), (block, n, const.bits_per_symbol), device)
        x = linops.modulate(mapping.encode(tx, const), n, prefix, L, ModulationType.OFDM)
        y, carry = linops.convolve(x, link["t0"], link["band"], carry, ext=link["E"])
        y = channel.awgn(y, snr, prng.normal_planes(key, b * block, block, T, prng.AWGN_STREAM, device))
        eqd = eq.equalize(linops.demodulate(y, n, prefix, L), link["h_freq"], EqualizationMethod.MMSE, snr)
        errors += metrics.bit_errors(tx, mapping.decode_bits(eqd, const))
        eqd0 = eqd if b == 0 else eqd0
    errors = int(errors)
    ms = (time.perf_counter() - t0) * 1e3
    # outside the timed window: block 0's second decode
    return dict(errors=errors, bits=num_ofdm * n * const.bits_per_symbol, ms=ms, nn=nn_disagreements(eqd0, const))


def bitlevel_adaptive_setup():
    """overview.py's host setup (float64): (taps, h_freq, L, power, mapper)."""
    import numpy as np

    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.ops import adaptive as ad
    from ofdm_tpu_torch.ops import allocate as al
    from ofdm_tpu_torch.ops import mapping

    n, snr_db = 64, 20.0
    raw = chm.get_channel("Lin-Phoong_P1")
    h_freq = chm.channel_frequency_response(raw, n)
    gains = np.abs(h_freq) ** 2
    noise_power = 10 ** (-snr_db / 10)
    power = al.waterfilling(float(n), gains, noise_power)
    orders = mapping.qam_bit_loading_orders(1e-3, power * gains / noise_power)
    return dict(n=n, snr_db=snr_db, taps=chm.normalize_impulse_response(raw), h_freq=h_freq,
                L=chm.channel_order(raw), power=power, mapper=ad.make_adaptive_mapper("QAM", orders))


def bitlevel_adaptive(device, num_ofdm=BITLEVEL_OFDM_SYMBOLS, block=BITLEVEL_BLOCK, seed=BITLEVEL_SEED):
    """overview.py's adaptive chain: {errors, bits, symbol_errors, symbols, ms}."""
    import torch

    from ofdm_tpu_torch.config import EqualizationMethod, PrefixType
    from ofdm_tpu_torch.ops import adaptive as ad
    from ofdm_tpu_torch.ops import bits as tb
    from ofdm_tpu_torch.ops import channel, metrics, ofdm, prng
    from ofdm_tpu_torch.ops import equalize as eq

    a = bitlevel_adaptive_setup()
    n, L, snr, m = a["n"], a["L"], a["snr_db"], a["mapper"]
    taps = torch.tensor(a["taps"], dtype=torch.complex64, device=device)
    h_freq = torch.tensor(a["h_freq"], dtype=torch.complex64, device=device)
    sqrt_p = torch.tensor(a["power"], dtype=torch.float32, device=device).sqrt().to(torch.complex64)
    key = prng.key_words(seed)
    errors = torch.zeros((), dtype=torch.int64, device=device)
    sym_errors = torch.zeros((), dtype=torch.int64, device=device)
    carry = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(num_ofdm // block):
        tx = tb.random_bits(prng.fold_in(key, b), (block, m.bits_per_ofdm_symbol), device)
        sym, tx_idx = ad.encode(tx, m)
        blocks = ofdm.ofdm_modulate(sym * sqrt_p, n, PrefixType.CYCLIC, L)
        z = prng.normal_planes(key, b * block, block, n + L, prng.AWGN_STREAM, device)
        rx, carry = channel.transmit(blocks, taps, snr, z=z, carry=carry)
        freq = ofdm.ofdm_demodulate_to_freq(rx, n, PrefixType.CYCLIC, L)
        eqd = eq.equalize(freq, h_freq, EqualizationMethod.MMSE, snr)
        p = (eqd.real * eqd.real + eqd.imag * eqd.imag).mean(dim=0, keepdim=True)
        eqd = torch.where(p > 1e-10, eqd / p.sqrt(), eqd)
        rx_bits, rx_idx = ad.decode(eqd, m)
        errors += metrics.bit_errors(tx, rx_bits)
        sym_errors += metrics.symbol_errors(tx_idx, rx_idx)
    errors, sym_errors = int(errors), int(sym_errors)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(errors=errors, bits=num_ofdm * m.bits_per_ofdm_symbol, symbol_errors=sym_errors,
                symbols=num_ofdm * n, ms=ms)


def l2_bound_ms(ops, nbytes):
    """(bound ms, "operations" or "bytes") of a sampler launch timed back to
    back: the larger of ops / PEAK_OPS and nbytes / PEAK_BYTES, except that an
    output that fits in L2 (rewritten in place launch after launch, it need
    not reach HBM, and L2's own rate has no published figure) is bounded by
    its operations alone."""
    if nbytes <= L2_BYTES or ops / PEAK_OPS >= nbytes / PEAK_BYTES:
        return ops / PEAK_OPS * 1e3, "operations"
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def bitlevel_band(name, r):
    """Hold a chain's BER at z = BAND_Z against the JAX package's chain."""
    band(name, {"bit_errors": r["errors"], "total_bits": r["bits"], "bit_error_rate": r["errors"] / r["bits"]},
         BITLEVEL_READING)


def bitlevel_path(card, device):
    """K4 under bits.random_bits and K5 at the chains' shapes against their
    plain versions, then both chains at full size with their launch counts,
    bands and rates.  Returns the two kernels-line entries."""
    import torch

    from ofdm_tpu_torch.ops import bits as tb
    from ofdm_tpu_torch.ops import prng

    t_phase = time.perf_counter()
    key = prng.key_words(BITLEVEL_SEED)
    head, adapt = bitlevel_headline_link(device), bitlevel_adaptive_setup()
    # at 2^24 bits, at an odd count, and at each chain's block shape under its
    # first block's key: the words the timed chains draw
    checks = [(key, (nbits,)) for nbits in BITLEVEL_CHECK_BITS] + [
        (prng.fold_in(key, 0), (BITLEVEL_BLOCK, head["n"], head["const"].bits_per_symbol)),
        (prng.fold_in(key, 0), (BITLEVEL_BLOCK, adapt["mapper"].bits_per_ofdm_symbol))]
    u_err = 0.0
    for k, shape in checks:
        bk, bp = tb.random_bits(k, shape, device).cpu(), tb.random_bits(k, shape, "cpu")
        e = float((bk.to(torch.int16) - bp.to(torch.int16)).abs().max())
        print(f"random_bits {shape} ({bp.numel()} bits, {-(-bp.numel() // 32)} words): the card's vs "
              f"random_bits(device='cpu') max abs diff {e} (tolerance 0: bit-equal); mean "
              f"{float(bp.float().mean()):.6f}")
        if e != 0.0:
            raise AssertionError(f"random_bits at {shape}: the card's bits differ from the CPU's")
        u_err = max(u_err, e)
    z_err = 0.0
    for T in sorted({head["T"], adapt["n"] + adapt["L"]}):
        zk = prng.normal_planes(key, 3 * BITLEVEL_BLOCK, BITLEVEL_BLOCK, T, prng.AWGN_STREAM, device)
        zp = prng.normal_planes_plain(key, 3 * BITLEVEL_BLOCK, BITLEVEL_BLOCK, T, prng.AWGN_STREAM, device)
        e = max(float((zk[0] - zp[0]).abs().max()), float((zk[1] - zp[1]).abs().max()))
        print(f"normal_pair ({BITLEVEL_BLOCK}, {T}), c3 = {prng.AWGN_STREAM}: kernel vs plain max abs diff {e:.3e} "
              f"(tolerance 1e-5)")
        if e > 1e-5:
            raise AssertionError(f"normal_pair ({BITLEVEL_BLOCK}, {T}) kernel vs plain {e}")
        z_err = max(z_err, e)

    bitlevel_headline(device, 2 * BITLEVEL_BLOCK, BITLEVEL_BLOCK, seed=1)  # warm-up
    bitlevel_adaptive(device, 2 * BITLEVEL_BLOCK, BITLEVEL_BLOCK, seed=1)
    blocks = BITLEVEL_OFDM_SYMBOLS // BITLEVEL_BLOCK
    launches = {}
    results = {}
    for name, fn in (("bitlevel_headline", bitlevel_headline), ("bitlevel_adaptive", bitlevel_adaptive)):
        prng.random_u32.launches = prng.normal_planes.launches = 0
        r = fn(device)
        launches[name] = (prng.random_u32.launches, prng.normal_planes.launches)
        results[name] = r
        extra = (f", SER {r['symbol_errors'] / r['symbols']} ({r['symbol_errors']} / {r['symbols']})"
                 if "symbol_errors" in r else "")
        print(f"{name} [{card}]: {BITLEVEL_OFDM_SYMBOLS} OFDM symbols x 64 sc in blocks of {BITLEVEL_BLOCK}, "
              f"{r['ms']:.1f} ms, ofdm_symbols_per_s={BITLEVEL_OFDM_SYMBOLS / r['ms'] * 1e3:.1f} BER "
              f"{r['errors'] / r['bits']} ({r['errors']} / {r['bits']}){extra}; launches: random_u32 (K4) "
              f"{launches[name][0]}, normal_pair (K5) {launches[name][1]}")
        if launches[name] != (blocks, blocks):
            raise AssertionError(f"{name}: K4 / K5 launched {launches[name]}, not {blocks} each")
        bitlevel_band(name, r)
        print_profile(card, f"{name} (two blocks)", profile_call(lambda: fn(device, 2 * BITLEVEL_BLOCK, seed=2)))
    head_r = results["bitlevel_headline"]
    ber = head_r["errors"] / head_r["bits"]
    print(f"bitlevel_headline vs bench.py's gate {REFERENCE_BER_30DB} +- 1.5e-3 (for information; the chain "
          f"measures its noise power over each block's time samples): distance {ber - REFERENCE_BER_30DB:+.6f}")
    bad = [d for d in head_r["nn"] if abs(d[3]) > NN_TIE]
    print(f"bitlevel_headline block 0: decode_nn and decode_hard part on {len(head_r['nn'])} of "
          f"{BITLEVEL_BLOCK * 64} symbols" + "".join(f"; symbol {i}: nn {a}, hard {b}, score gap {g:.3e}"
                                                      for i, a, b, g in head_r["nn"]))
    if bad:
        raise AssertionError(f"decode_nn and decode_hard part off a tie: {bad[:5]}")

    # K4 and K5 at the headline chain's block shapes, beside their plain versions and bounds
    words = -(-BITLEVEL_BLOCK * 64 * head["const"].bits_per_symbol // 32)
    u_ms = cuda_ms(lambda: prng.random_u32(key, (words,), device), 20)
    up_ms = cuda_ms(lambda: prng.random_u32_plain(key, (words,), device), 3)
    u_ops, u_bytes = -(-words // 4) * OPS_PER_BIN["philox"], words * 4
    u_bound, u_by = l2_bound_ms(u_ops, u_bytes)
    T = head["T"]
    elems = BITLEVEL_BLOCK * T
    n_ms = cuda_ms(lambda: prng.normal_planes(key, 0, BITLEVEL_BLOCK, T, prng.AWGN_STREAM, device), 20)
    np_ms = cuda_ms(lambda: prng.normal_planes_plain(key, 0, BITLEVEL_BLOCK, T, prng.AWGN_STREAM, device), 3)
    n_ops, n_bytes = elems * (OPS_PER_BIN["philox"] + NORMAL_OPS), elems * 8
    n_bound, n_by = l2_bound_ms(n_ops, n_bytes)
    # the device's own time a launch (the wrappers' host work outlasts these small launches)
    u_dev = device_ms(lambda: prng.random_u32(key, (words,), device), "ofdm_sampler::philox_kernel")
    n_dev = device_ms(lambda: prng.normal_planes(key, 0, BITLEVEL_BLOCK, T, prng.AWGN_STREAM, device),
                      "ofdm_sampler::normal_pair_kernel")
    print(f"random_u32 at ({words},) (a headline block's bits) [{card}]: kernel {u_ms:.4f} ms a call (CUDA events, "
          f"20 calls), device {u_dev} ms a launch (profiler), plain {up_ms:.3f} ms, bound {u_bound:.6f} ms ({u_by}: "
          f"{u_ops} operations, {u_bytes} bytes); normal_pair at ({BITLEVEL_BLOCK}, {T}): kernel {n_ms:.4f} ms a call, "
          f"device {n_dev} ms a launch, plain {np_ms:.3f} ms, bound {n_bound:.6f} ms ({n_by}: {n_ops} operations, "
          f"{n_bytes} bytes)")
    print(f"bit-level phase: {time.perf_counter() - t_phase:.1f} s")
    total = [sum(v[i] for v in launches.values()) for i in (0, 1)]
    return [
        {"name": "random_u32 (bits.random_bits, bit-level chains)", "route": "cuda",
         "source": "ofdm_tpu_torch/csrc/boxmuller.cu", "replaces": "ofdm_tpu/ops/prng.py:64", "launches": total[0],
         "max_abs_err": u_err, "ms": u_ms, "device_ms": u_dev, "plain_ms": up_ms, "bound_ms": u_bound,
         "bound_by": u_by, "library_ms": None},
        {"name": "normal_pair (bit-level chains)", "route": "cuda", "source": "ofdm_tpu_torch/csrc/boxmuller.cu",
         "replaces": "ofdm_tpu/ops/prng.py:120", "launches": total[1], "max_abs_err": z_err, "ms": n_ms,
         "device_ms": n_dev, "plain_ms": np_ms, "bound_ms": n_bound, "bound_by": n_by, "library_ms": None},
    ]


def audit_path(card, device):
    """The shape audit (ofdm_tpu_torch.shape_audit): every production shape
    through LinkRunner on its kernel, its route and BER band; raises naming
    every bad shape."""
    from ofdm_tpu_torch import shape_audit

    t0 = time.perf_counter()
    results = shape_audit.audit(device)
    bad = [r["shape"] for r in results if r["faults"]]
    print(f"shape audit [{card}]: {len(results)} shapes, {len(bad)} bad, {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"shape audit: {bad}")


# The examples and tools: every module of ofdm_tpu_torch.examples
# through its main() at the JAX script's own size, in a temporary directory,
# each link's BER at z = BAND_Z against the JAX script's reading at that
# size (EXAMPLE_READINGS, jax_band_readings.py examples; the noise-bump
# points against JAX_CPU_READINGS' _Link readings), then the tools.
EXAMPLE_RUNS = (
    ("custom_channel_demo", []),
    ("pod_scale_sweep", []),
    ("quick_start_adaptive", []),
    ("adaptive_modulation_demo", []),
    ("configurable_simulation_demo", []),
    ("plot_adaptive_constellation_demo", []),
    ("plot_waterfilling_diagram", []),
    ("waterfilling_demo", []),
    ("generate_channel_models", []),
    ("waterfilling_noise_bump_experiment", []),
    ("overview", []),
    ("bit_loading_walkthrough", ["--out", "walkthrough"]),
    ("parity_report", ["--guard-grid", "--output", "results/parity_report.md"]),
    ("plot_constellations", ["--output", "constellation_16QAM.png"]),
)
EXAMPLE_READING = "the JAX script's own links, CPU, at the script's size and key"
# The counting kernel of each route (the counters of a chain's error-counting pass).
ROUTE_COUNTERS = {"diag": ("diag_main", "diag_wide"), "fold": ("fold_main", "fold_wide_main"), "lr": ("lr_main",),
                  "mm": ("mm_main", "mm_wide_main"), "eager": ("philox_plane",),
                  "bit-level ops": ("random_u32", "normal_pair"), "small-batch link": ("philox_plane", "normal_pair")}
TRACE_SYMBOLS = 1 << 24  # the traced headline run (128 chunks)
ON_CARD = ("cuda", "eager")  # the hotpath_used of a link that ran on the card
EXAMPLE_READINGS = {
    "custom_channel_demo/flat_fading": (0, 256000),
    "custom_channel_demo/two_ray": (1395, 256000),
    "custom_channel_demo/severe_multipath": (123, 256000),
    "custom_channel_demo/Lin-Phoong_P2.npy": (9484, 256000),
    "custom_channel_demo/custom 3-tap": (897, 256000),
    "pod_scale_sweep/0db": (40504498, 100663296),
    "pod_scale_sweep/10db": (18859727, 100663296),
    "pod_scale_sweep/20db": (2133123, 100663296),
    "pod_scale_sweep/30db": (366, 100663296),
    "quick_start_adaptive/quick_start": (47, 499790),
    "adaptive_modulation_demo/fixed_10db": (48104, 512000),
    "adaptive_modulation_demo/fixed_15db": (14975, 512000),
    "adaptive_modulation_demo/fixed_20db": (3538, 512000),
    "adaptive_modulation_demo/fixed_25db": (244, 512000),
    "adaptive_modulation_demo/adaptive_10db": (73, 184000),
    "adaptive_modulation_demo/adaptive_15db": (134, 316000),
    "adaptive_modulation_demo/adaptive_20db": (40, 460000),
    "adaptive_modulation_demo/adaptive_25db": (89, 692000),
    "configurable_simulation_demo/10db": (24139, 256000),
    "configurable_simulation_demo/15db": (7456, 256000),
    "configurable_simulation_demo/20db": (1780, 256000),
    "configurable_simulation_demo/25db": (127, 256000),
    "configurable_simulation_demo/30db": (0, 256000),
    "plot_adaptive_constellation_demo/adaptive_constellation": (160, 612000),
    "overview/overview": (27, 230000),
    "bit_loading_walkthrough/bit_loading_walkthrough": (16, 35568),
    "parity_report/baseline_sc_qpsk_0db": (8202521, 33554432),
    "parity_report/baseline_sc_qpsk_10db": (478537, 33554432),
    "parity_report/baseline_sc_qpsk_20db": (0, 33554432),
    "parity_report/multipath_64qam_zf_30db": (1879599, 100663296),
    "parity_report/multipath_64qam_mmse_30db": (1914034, 100663296),
    "parity_report/CYCLIC-ZF-0.34": (4120790, 100663296),
    "parity_report/CYCLIC-ZF-0.68": (2675420, 100663296),
    "parity_report/CYCLIC-ZF-1.0": (1879599, 100663296),
    "parity_report/CYCLIC-ZF-1.34": (1880388, 100663296),
    "parity_report/CYCLIC-MMSE-0.34": (4124125, 100663296),
    "parity_report/CYCLIC-MMSE-0.68": (2695190, 100663296),
    "parity_report/CYCLIC-MMSE-1.0": (1914034, 100663296),
    "parity_report/CYCLIC-MMSE-1.34": (1914601, 100663296),
    "parity_report/ZERO-ZF-0.34": (4122659, 100663296),
    "parity_report/ZERO-ZF-0.68": (2675891, 100663296),
    "parity_report/ZERO-ZF-1.0": (1879397, 100663296),
    "parity_report/ZERO-ZF-1.34": (1880314, 100663296),
    "parity_report/ZERO-MMSE-0.34": (4125918, 100663296),
    "parity_report/ZERO-MMSE-0.68": (2696698, 100663296),
    "parity_report/ZERO-MMSE-1.0": (1913284, 100663296),
    "parity_report/ZERO-MMSE-1.34": (1914331, 100663296),
}


def launch_counters():
    """{name: (wrapper, attribute)} of every launch counter the examples can move."""
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.ops import prng

    return {
        "diag_main": (lk.diag_chunk, "launches"), "diag_wide": (lk.diag_chunk, "wide_launches"),
        "power_partials": (lk.diag_chunk, "power_launches"), "norm_factors": (lk.diag_chunk, "norm_launches"),
        "diag_demap": (lk.diag_chunk, "demap_launches"), "diag_dump": (lk.diag_chunk, "dump_launches"),
        "fold_main": (fk.fold_chunk, "launches"), "fold_power": (fk.fold_chunk, "power_launches"),
        "fold_wide_main": (fk.fold_chunk, "wide_launches"), "fold_wide_power": (fk.fold_chunk, "wide_power_launches"),
        "fold_dump": (fk.fold_chunk, "dump_launches"),
        "lr_main": (lrk.lr_chunk, "launches"), "lr_power": (lrk.lr_chunk, "power_launches"),
        "lr_dump": (lrk.lr_chunk, "dump_launches"),
        "mm_front": (mmk.mm_chunk, "front_launches"), "mm_power": (mmk.mm_chunk, "power_launches"),
        "mm_main": (mmk.mm_chunk, "launches"), "mm_wide_front": (mmk.mm_chunk, "wide_front_launches"),
        "mm_wide_main": (mmk.mm_chunk, "wide_launches"), "mm_dump": (mmk.mm_chunk, "dump_launches"),
        "random_u32": (prng.random_u32, "launches"), "philox_plane": (prng.philox_plane, "launches"),
        "normal_pair": (prng.normal_planes, "launches"), "boxmuller": (lk.boxmuller_sample, "launches"),
    }


def reset_counters(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counters(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items() if getattr(fn, attr)}


def example_band(name, rec, reading, source):
    """Hold one example link's BER at z = BAND_Z against the JAX script's."""
    from ofdm_tpu_torch.ops import metrics as mt

    je, jb = reading
    if not mt.ber_equivalent(rec["bit_errors"], rec["total_bits"], je, jb, z=BAND_Z):
        raise AssertionError(f"{name} {rec['label']}: BER {rec['bit_error_rate']} ({rec['bit_errors']} / "
                             f"{rec['total_bits']}) outside z={BAND_Z} of {je / jb} ({je} / {jb}; {source})")


def nonblank_png(path):
    """Raise unless ``path`` is a PNG with some ink on it; returns its size."""
    from PIL import Image

    with Image.open(path) as im:
        lo, hi = im.convert("L").getextrema()
        if im.format != "PNG" or lo == hi:
            raise AssertionError(f"{path}: not a drawn PNG ({im.format}, extrema {lo}-{hi})")
        return im.size


def run_example(card, name, argv, counters):
    """One example through its main(): its records, launches and wall time,
    with each link's route, where it ran and its band checked."""
    import importlib

    import torch

    from ofdm_tpu_torch.experiments import noise_bump as nb

    mod = importlib.import_module(f"ofdm_tpu_torch.examples.{name}")
    reset_counters(counters)
    t0 = time.perf_counter()
    if name == "parity_report":
        recs = []
        rc = mod.main(argv, records=recs)
        if rc != 0:
            raise AssertionError(f"parity_report flagged a MISMATCH (exit status {rc})")
    else:
        recs = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    for rec in recs:
        if rec["hotpath_used"] not in ON_CARD:
            raise AssertionError(f"{name} {rec['label']}: ran on {rec['hotpath_used']}, not the card")
        if not any(launches.get(c) for c in ROUTE_COUNTERS[rec["kernel_mode"]]):
            raise AssertionError(f"{name} {rec['label']}: route {rec['kernel_mode']} launched none of "
                                 f"{ROUTE_COUNTERS[rec['kernel_mode']]} ({launches})")
        key = f"{name}/{rec['label']}"
        if name == "waterfilling_noise_bump_experiment" or rec["label"].startswith("noise_bump_"):
            scenario, snr = rec["label"].removeprefix("noise_bump_").rsplit("_", 1)
            example_band(name, rec, JAX_CPU_READINGS[noise_bump_name(scenario, float(snr[:-2]))],
                         "the JAX package's _Link, CPU, 2^16 OFDM symbols")
        else:
            example_band(name, rec, EXAMPLE_READINGS[key], EXAMPLE_READING)
    if name == "waterfilling_noise_bump_experiment":
        bers = {(r["label"].rsplit("_", 1)[0], float(r["label"].rsplit("_", 1)[1][:-2])): r["bit_error_rate"]
                for r in recs}
        for s in nb.SCENARIOS:
            for snr, ref in zip((0.0, 15.0, 30.0), NOISE_BUMP_REFERENCE[s.key]):
                if not abs(bers[(s.key, snr)] - ref) < NOISE_BUMP_TOL:
                    raise AssertionError(f"noise-bump example {s.key} {snr} dB: BER {bers[(s.key, snr)]} vs {ref}")
        symbols = nb.default_fused_symbols(None) * len(recs)
        for r in recs:
            r["ofdm_symbols_per_s"] = symbols / wall  # the example's wall clock over its fused symbols
    links = "; ".join(f"{r['label']}: {r['kernel_mode']} ({r['hotpath_used']}), BER {r['bit_error_rate']:.6g} "
                      f"({r['bit_errors']} / {r['total_bits']}), {r['ofdm_symbols_per_s']:.4g} OFDM syms/s"
                      for r in recs)
    print(f"example {name} [{card}]: {wall:.2f} s, {len(recs)} links{': ' + links if links else ''}; "
          f"launches {json.dumps(launches)}")
    return recs, launches, wall


def tools_checks(card, device):
    """watch --once and channel_plots write PNGs; trace() names the headline
    run's kernels; ThroughputMeter counts its OFDM symbols."""
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare
    from ofdm_tpu_torch.utils import channel_plots, profiling, watch
    from ofdm_tpu_torch.utils.report import ResultsManager

    rm = ResultsManager("watch", "watch_images", doc_figures_dir=None)
    watch.clear_results_file(str(rm.csv_path))
    for name, snr, ber in (("fixed", 10.0, 0.1), ("fixed", 20.0, 0.01), ("adaptive", 10.0, 0.05),
                           ("adaptive", 20.0, 0.002)):
        rm.update_ber_csv(name, snr, ber)
    rc = watch.main(["--results", str(rm.csv_path), "--output", "watch/ber_vs_snr_live.png", "--once"])
    size = nonblank_png("watch/ber_vs_snr_live.png")
    rc2 = channel_plots.main(["severe_multipath", "--out", "channel_response.png"])
    size2 = nonblank_png("channel_response.png")
    print(f"tools: watch --once exit {rc}, ber_vs_snr_live.png {size}; channel_plots exit {rc2}, "
          f"channel_response.png {size2}")
    if rc or rc2:
        raise AssertionError("watch or channel_plots exited non-zero")

    runner = LinkRunner(prepare(headline_cfg(TRACE_SYMBOLS, MAIN_CHUNK)), device)
    runner.run(1)  # warm-up
    with profiling.trace("trace") as prof:
        r = runner.run(MAIN_SEED)
    names = {e.key for e in prof.key_averages()}
    found = {k: sorted(n for n in names if k in n)[:2] for k in ("diag_main", "power_partials")}
    files = os.listdir("trace")
    print(f"trace() around the headline run ({TRACE_SYMBOLS} OFDM symbols) [{card}]: {len(names)} event names, "
          f"{json.dumps(found)}; files {files}")
    if not all(found.values()) or not files:
        raise AssertionError(f"trace() recorded {found}, files {files}")

    meter = profiling.ThroughputMeter()
    with meter.section(runner.setup.num_ofdm_symbols, runner.setup.total_bits):
        r = runner.run(MAIN_SEED)
    print(f"ThroughputMeter [{card}]: {meter.report()}; run()'s own ofdm_symbols_per_s "
          f"{r['ofdm_symbols_per_s']:.1f}")
    if meter.ofdm_symbols != TRACE_SYMBOLS or meter.bits != r["total_bits"] or \
            not meter.ofdm_symbols_per_s <= r["ofdm_symbols_per_s"]:
        raise AssertionError(f"ThroughputMeter: {meter} against the run's {r['ofdm_symbols_per_s']}")


def examples_path(card, device):
    """Every example through its main() on the card and the tools, in a
    temporary directory; raises on any failed check."""
    import tempfile

    import torch

    from ofdm_tpu_torch.utils import visualization as vis

    t_phase = time.perf_counter()
    counters = launch_counters()
    cwd = os.getcwd()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, argv in EXAMPLE_RUNS:
                recs, launches[name], _ = run_example(card, name, argv, counters)
            pngs = [f for _, _, fs in os.walk("images") for f in fs if f.endswith(".png")]
            print(f"noise-bump example: {len(pngs)} PNGs under images/ (drawn with "
                  f"{'matplotlib' if vis.have_matplotlib() else 'PIL'})")
            if len(pngs) != 22:
                raise AssertionError(f"the noise-bump example wrote {len(pngs)} PNGs, not 21 + 1")
            for path in ("adaptive_constellation.png", "waterfilling_diagram.png", "waterfilling_demo.png",
                         "walkthrough/bit_loading_constellation.png", "walkthrough/bit_loading_water_level.png",
                         "constellation_16QAM.png", *[os.path.join(r, f) for r, _, fs in os.walk("images")
                                                     for f in fs]):
                nonblank_png(path)
            with open("results/parity_report.md") as fh:
                report = fh.read()
            if "MISMATCH" in report:
                raise AssertionError("parity report holds a MISMATCH")
            tools_checks(card, device)
        finally:
            os.chdir(cwd)
    torch.cuda.synchronize()
    print(f"examples and tools phase [{card}]: {time.perf_counter() - t_phase:.1f} s; launches by example "
          f"{json.dumps(launches)}")
    return launches


def examples_main():
    """``--examples-only``: the build, then only the examples and tools phase."""
    import torch

    from ofdm_tpu_torch import build

    t0 = time.perf_counter()
    card = card_line()
    secs = build.build(build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(secs)} libraries)")
    examples_path(card, torch.device("cuda"))
    print(f"chip_smoke --examples-only: {time.perf_counter() - t0:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def nccl_main(ranks):
    """``--nccl-ranks N``: only the sharded runs on N cards under NCCL, one
    rank a card (``multi_rank_path``), after the build."""
    import torch

    from ofdm_tpu_torch import build

    if torch.cuda.device_count() < ranks:
        print(f"chip_smoke: {ranks} ranks need {ranks} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    secs = build.build(build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(secs)} libraries)")
    multi_rank_path(card, torch.device("cuda", 0), ranks, "nccl")
    print(f"chip_smoke --nccl-ranks {ranks}: {time.perf_counter() - t0:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# --- the giant path: lr and diag past 4096 subcarriers, E 63 and noise rank 128 -------

GIANT_CHUNK = 1 << 12  # past 4096 sc: 2^25-2^27 bins a chunk, so the plain version's planes fit the card
GIANT_LONG_CHUNK = 1 << 15  # the long channels at 1024 sc
GIANT_EAGER_BINS = 1 << 27  # subcarriers x OFDM symbols of each eager twin
GIANT_IR_SEED = 11  # the seeded long channels' (seeded_taps)
GIANT_LONG_SNR = 24.0  # the 160-tap link's SNR (16-QAM, ZP 1.0, 1024 sc): BER ~6e-3
GIANT_READING = "the port's eager chain on this card at the same config"
GIANT_KW = dict(constellation_order=64, constellation_type="QAM", channel_type="CUSTOM",
                channel_model="severe_multipath", prefix_type="CYCLIC", prefix_length_ratio=0.5,
                equalization_method="MMSE", noise_type="AWGN", snr_db=22.0)
_ZP10 = dict(prefix_type="ZERO", prefix_length_ratio=1.0)
GIANT_TAPS_KW = dict(num_subcarriers=1024, modulation_type="SC-OFDM", constellation_order=1024, snr_db=34.0,
                     hotpath="pallas", **_ZP10)
# The end-to-end runs: config changes, the taps of a seeded channel (None: the
# model's), OFDM symbols, the chain, and whether the band's reading is the
# JAX package's XLA path on a CPU (jax_band_readings.py giant; else the
# eager chain on the card: JAX readings are not taken at full width past
# 4096 sc).  The 8K / 32K links are the FFT modes of DVB-T2 (ETSI EN 302
# 755) and ATSC 3.0 (A/322); a 160-tap echo profile is what users load
# through channel_model_path.  A 16K lr link is not run end to end: its host
# factorization takes over a minute (``--factor-seconds``, ROADMAP).
GIANT_RUNS = {
    "giant_8k_cp05": (dict(num_subcarriers=8192), None, 1 << 16, "lr", False),
    "giant_8k_zp": (dict(num_subcarriers=8192, **_ZP10), None, 1 << 16, "lr", False),
    "flat_32k": (dict(num_subcarriers=32768, channel_model="flat_fading", snr_db=21.0), None, 1 << 14, "diag",
                 False),
    "long_ir_1024_zp": (dict(num_subcarriers=1024, constellation_order=16, snr_db=GIANT_LONG_SNR, **_ZP10), 160,
                        1 << 20, "lr", True),
    # the JAX plan's "taps" row (hotpath "pallas"): SC-FDE, ZP 1.0, 1024-QAM on mm_wide
    "taps_1024_zp": (dict(GIANT_TAPS_KW), None, 1 << 18, "mm", True),
}
# The kernels-line entries: a checked shape (giant_checks) and the run of
# GIANT_RUNS whose launches it reports.
GIANT_ENTRIES = {"lr_8k_cp05": "giant_8k_cp05", "lr_8k_zp": "giant_8k_zp", "lr_e159_1024_zp": "long_ir_1024_zp",
                 "diag_32k": "flat_32k", "mm_wide_taps_1024": "taps_1024_zp"}
# Checked lr shapes that no end-to-end run drives (their host factorization
# takes over a minute past 8192 sc, ROADMAP), timed beside the first entry:
# 32768 sc, and widths whose last 4096-bin slice is short.
GIANT_UNRUN = ("lr_32k_seeded", "lr_6k_seeded", "lr_10k_zp_seeded")


def seeded_taps(k, seed):
    """A unit-energy k-tap channel with an exponential power profile, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ir = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) * np.exp(-np.arange(k) / (k / 4.0))
    return ir / np.linalg.norm(ir)


def giant_cfg(kw, num_ofdm, chunk):
    from ofdm_tpu_torch.config import SimulationConfig

    base = dict(GIANT_KW, **kw)
    return SimulationConfig(**base, num_symbols=num_ofdm * base["num_subcarriers"], symbols_per_chunk=chunk)


def giant_ir(taps):
    return None if taps is None else seeded_taps(taps, GIANT_IR_SEED)


def seeded_factors(setup, E, rank, seed):
    """lowrank.LRFactors of the link's shapes on seeded rows, with no host
    factorization: D the channel's response, TailM the TX matrix's last E
    columns (the IDFT's, O(n E)), [Cr; Cp] and the noise factor seeded
    complex normals at ISI scale."""
    import numpy as np

    from ofdm_tpu_torch.config import PrefixType
    from ofdm_tpu_torch.ops import lowrank

    n = setup.cfg.num_subcarriers
    T = setup.block_length
    zp = setup.cfg.prefix_type == PrefixType.ZERO
    rng = np.random.default_rng(seed)
    cn = lambda *shape: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)  # noqa: E731
    cols = np.arange(n - E, n) if not zp else np.arange(n - E + (T - n), n)  # the block's last E samples
    tail = np.exp(2j * np.pi * np.outer(np.arange(n), cols % n) / n) / np.sqrt(n)
    if zp:  # a zero prefix's guard samples carry nothing
        tail = np.concatenate([tail, np.zeros((n, E - tail.shape[1]))], axis=1)[:, :E]
    scale = 0.05 / np.sqrt(E)
    return lowrank.LRFactors(d=np.asarray(setup.h_freq, np.complex128), tail=tail, cr=scale * cn(E, n),
                             cp=scale * cn(E, n), bnoise=cn(n, rank) / np.sqrt(n) if rank else None,
                             pw_scale=n / T if zp else 1.0, E=E)


def giant_factor(kw, taps=None):
    """The host factorization of the giant link ``kw`` (GIANT_KW changes;
    cached by lr_kernel.lr_factors)."""
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.pipeline import prepare

    return lrk.lr_factors(prepare(giant_cfg(kw, GIANT_CHUNK, GIANT_CHUNK), channel_ir=giant_ir(taps)))


def factor_main(n):
    """``--factor-seconds N``: the seconds of the host factorization
    (lowrank.factor, float64) of severe_multipath under CP 0.5 at N
    subcarriers, the step that keeps a 16K lr link out of the giant path."""
    card = card_line()
    t0 = time.perf_counter()
    f = giant_factor(dict(num_subcarriers=n))
    print(f"giant factorization at {n} sc (lowrank.factor, float64, CP 0.5, severe_multipath; E={f.E}) "
          f"[{card}]: {time.perf_counter() - t0:.2f} s")
    return 0


def giant_checks(card, device):
    """Every new variant against its plain version on the card, counts,
    PAPR and carry row exactly (``compare_chunk``): lr at 8192 sc on real
    factors (CP 0.5 at two sym0, ZP 1.0, 8-PSK, normalize), at 16384 and
    32768 on seeded factor rows, and at 6144 and 10000 (a short last
    slice); lr on the two long channels at 1024 sc (E = 99; E = rank = 159,
    two g2 rounds); diag at 8192 / 10000 / 16384 / 32768 (plain,
    normalize, aqam at 8192); mm_wide on the taps-planned link;
    the dump stage (``capture_check``) on lr at 8192 and diag at 32768.
    Returns ({name: (link, chunk, kernel, plain)} to time, the largest
    difference)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk
    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    err, links = 0.0, {}

    def check(name, chain, link, chunk, sym0, snr_db):
        nonlocal err
        _, kernel, plain, _ = chains()[chain]
        tile = lk.tile_for(chunk, link.tile_cap)
        extra = f", E={link.E}, rank={link.rank}" if chain == "lr" else ""
        err = max(err, compare_chunk(f"{chain}_chunk {name} (n={link.n}{extra}, tile {tile}, {link.q.mode}, "
                                     f"stages {lk.link_stages(link)})", kernel, plain, link, sym0, chunk, snr_db,
                                     device, no_papr=getattr(link, "txext", False)))
        links.setdefault(name, (link, chunk, kernel, plain))

    def setup_of(kw, taps=None, chunk=GIANT_CHUNK):
        return prepare(giant_cfg(kw, 4 * chunk, chunk), channel_ir=giant_ir(taps))

    for name, kw, sym0 in (("lr_8k_cp05", dict(num_subcarriers=8192), 3 * GIANT_CHUNK),
                           ("lr_8k_cp05", dict(num_subcarriers=8192), (1 << 32) + 77),
                           ("lr_8k_zp", dict(num_subcarriers=8192, **_ZP10), GIANT_CHUNK),
                           ("lr_8k_psk8", dict(num_subcarriers=8192, constellation_type="PSK", constellation_order=8,
                                               snr_db=16.0), GIANT_CHUNK),
                           ("lr_8k_normalize", dict(num_subcarriers=8192, normalize_before_demap=True), GIANT_CHUNK)):
        setup = setup_of(kw)
        if kernel_mode(setup) != "lr":
            raise AssertionError(f"{name} routes to {kernel_mode(setup)}")
        check(name, "lr", lrk.lr_link(setup, device), GIANT_CHUNK, sym0, setup.cfg.snr_db)
    for name, kw, E, rank in (("lr_16k_seeded", dict(num_subcarriers=16384), 7, 0),
                              ("lr_16k_zp_seeded", dict(num_subcarriers=16384, **_ZP10), 7, 7),
                              ("lr_32k_seeded", dict(num_subcarriers=32768), 7, 0),
                              # a short last slice: 2048 of 4096 bins; 1808, not a multiple of 256
                              ("lr_6k_seeded", dict(num_subcarriers=6144), 7, 0),
                              ("lr_10k_zp_seeded", dict(num_subcarriers=10000, **_ZP10), 7, 7)):
        setup = setup_of(kw)
        link = lrk.lr_link(setup, device, factors=seeded_factors(setup, E, rank, GIANT_IR_SEED))
        check(name, "lr", link, GIANT_CHUNK, GIANT_CHUNK, setup.cfg.snr_db)
    for name, kw, taps in (("lr_e99_1024", dict(num_subcarriers=1024, constellation_order=16), 100),
                           ("lr_e159_1024_zp", dict(num_subcarriers=1024, constellation_order=16, **_ZP10), 160)):
        setup = setup_of(kw, taps, GIANT_LONG_CHUNK)
        link = lrk.lr_link(setup, device)
        if kernel_mode(setup) != "lr" or (len(link.tail_rows) <= lrk.TAIL_PASS and len(link.bh_rows) <= lrk.G2_ROUND):
            raise AssertionError(f"{name}: {kernel_mode(setup)}, {len(link.tail_rows)} tail rows, "
                                 f"{len(link.bh_rows)} noise rows")
        check(name, "lr", link, GIANT_LONG_CHUNK, GIANT_LONG_CHUNK, setup.cfg.snr_db)
    flat = dict(channel_model="flat_fading", snr_db=21.0)
    for name, kw in (("diag_8k", dict(flat, num_subcarriers=8192)), ("diag_16k", dict(flat, num_subcarriers=16384)),
                     ("diag_10k", dict(flat, num_subcarriers=10000)),
                     ("diag_32k", dict(flat, num_subcarriers=32768)),
                     ("diag_32k_normalize", dict(flat, num_subcarriers=32768, normalize_before_demap=True)),
                     ("diag_8k_aqam", dict(flat, num_subcarriers=8192, **_ADAPT))):
        chunk = GIANT_CHUNK
        setup = prepare(audit_cfg(4 * chunk, chunk, **dict(GIANT_KW, **kw)))
        if kernel_mode(setup) != "diag":
            raise AssertionError(f"{name} routes to {kernel_mode(setup)}")
        check(name, "diag", lk.diag_link(setup, device), chunk, chunk, setup.cfg.snr_db)
    setup = prepare(giant_cfg(GIANT_TAPS_KW, 4 * GIANT_LONG_CHUNK, GIANT_LONG_CHUNK))
    link = mmk.mm_link(setup, device)
    if kernel_mode(setup) != "mm" or not mmk.is_wide(link):
        raise AssertionError(f"the taps link routes to {kernel_mode(setup)}")
    check("mm_wide_taps_1024", "mm", link, GIANT_LONG_CHUNK, GIANT_LONG_CHUNK, setup.cfg.snr_db)
    # the dump stage as clusters: a capture on lr at 8192 sc and diag at 32768 sc
    for name, chain, cfg in (("lr_8k_cp05", "lr", giant_cfg(dict(num_subcarriers=8192), 2 * GIANT_CHUNK, GIANT_CHUNK)),
                             ("diag_32k", "diag", audit_cfg(2 * GIANT_CHUNK, GIANT_CHUNK,
                                                            **dict(GIANT_KW, **flat, num_subcarriers=32768)))):
        err = max(err, capture_check(card, device, f"{name} (a cluster)", chain, cfg, CAPTURE_COLLECT)[0])
    return links, err


def giant_probe_check(card, device, link):
    """lr_probe on the 8192-sc link (a cluster of two blocks): bit-equal to
    its plain version and to the chunk kernel's carry row at sym0 = 0 and
    2^32 + 77; the chunk given its own predecessor's tail counts what it
    counts without it.  Returns the largest difference."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import prng

    key = prng.key_words(MAIN_SEED)
    snr_lin = lk.snr_linear(GIANT_KW["snr_db"])
    err = 0.0
    for sym0 in (0, (1 << 32) + 77):
        be, se, cr, ci = chunk_counts(lrk.lr_chunk, link, key, sym0, GIANT_CHUNK, snr_lin, device, None)
        got = [t.cpu() for t in lrk.lr_probe(link, key, sym0, GIANT_CHUNK)]
        ref = [t.cpu() for t in lrk.lr_probe_plain(link, key, sym0, GIANT_CHUNK)]
        err = max(err, *(float((a - b).abs().max()) for a, b in zip(got, ref)))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)) or not (torch.equal(got[0], cr)
                                                                        and torch.equal(got[1], ci)):
            raise AssertionError(f"lr_probe 8192 sc sym0={sym0}: probe, plain and carry row differ")
        own = (tuple(torch.zeros(link.E, dtype=torch.float32, device=device) for _ in range(2)) if sym0 == 0
               else tuple(lrk.lr_probe(link, key, sym0 - 1, 1)[2:]))
        pb, ps, _, _ = chunk_counts(lrk.lr_chunk, link, key, sym0, GIANT_CHUNK, snr_lin, device, None, prev=own)
        if (pb, ps) != (be, se):
            raise AssertionError(f"lr 8192 sc sym0={sym0}: with its own carry-in {pb}/{ps}, without {be}/{se}")
        print(f"lr_probe 8192 sc (a cluster of {link.n // 4096} blocks) sym0={sym0} [{card}]: probe = plain = "
              f"carry row (bit-equal); chunk {be}/{se} with and without its own carry-in")
    return err


def giant_counters():
    """The launch counters a giant run reads: lr_main, lr_power, diag_wide,
    wide_power, mm_wide_main, mm_wide_front."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    return {"lr_main": (lrk.lr_chunk, "launches"), "lr_power": (lrk.lr_chunk, "power_launches"),
            "diag_wide": (lk.diag_chunk, "wide_launches"), "wide_power": (lk.diag_chunk, "power_launches"),
            "mm_wide_main": (mmk.mm_chunk, "wide_launches"), "mm_wide_front": (mmk.mm_chunk, "wide_front_launches")}


def giant_run(card, device, name, factor_s=0.0):
    """One end-to-end run through prepare() -> LinkRunner.run(): its route,
    launch counters, OFDM syms/s, device busy share, host setup seconds
    (prepare, the link constants and the sampled-TX PAPR, plus ``factor_s``,
    the host factorization the caller timed) and peak device memory; then its eager twin on the card at the same
    config (GIANT_EAGER_BINS), and the band: z = 5 against the JAX
    package's XLA reading where it has one, else against the eager twin.
    Returns (record, runner)."""
    import torch

    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import metrics as mt
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    kw, taps, num_ofdm, chain, jax_band = GIANT_RUNS[name]
    n = kw["num_subcarriers"]
    chunk = GIANT_LONG_CHUNK if n <= 1024 else GIANT_CHUNK
    counters = giant_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = LinkRunner(prepare(giant_cfg(kw, num_ofdm, chunk), channel_ir=giant_ir(taps)), device)
    runner._papr_sample()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 + factor_s
    if runner.mode != chain:
        raise AssertionError(f"{name} routes to {runner.mode}, not {chain}")
    runner.run(1)  # warm-up
    reset_counters(counters)
    r = runner.run(MAIN_SEED)
    got = {k: read_counters(counters).get(k, 0) for k in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = -(-num_ofdm // chunk)
    want = {"lr": {"lr_main": chunks, "lr_power": chunks}, "diag": {"diag_wide": chunks, "wide_power": chunks},
            "mm": {"mm_wide_main": chunks, "mm_wide_front": chunks}}[chain]
    prof = profile_run(runner, runner.setup.cfg.snr_db)
    busy = None if prof is None else prof[1]
    link = runner.link
    print(f"giant {name} [{card}]: route {runner.mode} (n={n}, T={runner.setup.block_length}, "
          f"E={getattr(link, 'E', 0)}, rank={getattr(link, 'rank', 0)}, tile {lk.tile_for(chunk, link.tile_cap)}), "
          f"{num_ofdm} OFDM symbols, "
          f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} BER={r['bit_error_rate']} papr_db={r['papr_db']:.4f} "
          f"({r['papr_estimator']}) hotpath={r['hotpath_used']}; launches {json.dumps(got)}; device busy "
          f"{busy if busy is None else f'{busy:.4f}'}; host setup {setup_s:.2f} s; peak device memory "
          f"{peak_gb:.3f} GB")
    if any(got[k] != v for k, v in want.items()) or r["hotpath_used"] != "cuda":
        raise AssertionError(f"{name}: launches {got}, want {want}; {r['hotpath_used']}")
    eager = LinkRunner(prepare(giant_cfg(dict(kw, hotpath="xla"), GIANT_EAGER_BINS // n, chunk),
                               channel_ir=giant_ir(taps)), device)
    eager.run(1)
    e = eager.run(MAIN_SEED)
    print(f"giant {name} eager twin [{card}]: {GIANT_EAGER_BINS // n} OFDM symbols, "
          f"ofdm_symbols_per_s={e['ofdm_symbols_per_s']:.1f} BER={e['bit_error_rate']} hotpath={e['hotpath_used']}")
    if e["hotpath_used"] != "eager":
        raise AssertionError(f"{name}: the eager twin ran {e['hotpath_used']}")
    if jax_band:
        band(name, r, "XLA path, CPU, 2^24 / n OFDM symbols")
    else:
        ok = mt.ber_equivalent(r["bit_errors"], r["total_bits"], e["bit_errors"], e["total_bits"], z=BAND_Z)
        print(f"band {name}: BER {r['bit_error_rate']} ({r['bit_errors']} / {r['total_bits']}) vs "
              f"{e['bit_error_rate']} ({e['bit_errors']} / {e['total_bits']}; {GIANT_READING}) z={BAND_Z}: "
              f"{'inside' if ok else 'OUTSIDE'}")
        if not ok:
            raise AssertionError(f"{name}: BER {r['bit_error_rate']} outside its band around {e['bit_error_rate']}")
    if not 1e-3 <= r["bit_error_rate"] <= 1e-2:
        print(f"giant {name}: BER {r['bit_error_rate']} lies outside 1e-3..1e-2, where its SNR was chosen to put it")
    rec = dict(name=name, route=runner.mode, n=n, launches=got, ofdm_symbols_per_s=r["ofdm_symbols_per_s"],
               eager_ofdm_symbols_per_s=e["ofdm_symbols_per_s"], ber=r["bit_error_rate"], busy=busy,
               setup_s=setup_s, peak_gb=peak_gb)
    return rec, runner


def giant_entry(card, device, name, link, chunk, kernel, plain, launches, err, chain):
    """A kernels-line entry: the chunk kernel's time at ``chunk`` symbols
    (CUDA events) beside its plain version's and its bound (operations, as
    ``lr_operations`` / ``diag_operations`` count them; bytes: the link's
    rows and factors read once, the counters and the carry row written)."""
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    snr_lin = lk.snr_linear(GIANT_KW["snr_db"])
    acc, psum = lk.new_accumulators(device)
    work = {"lr": lrk, "diag": lk, "mm": mmk}[chain].chunk_workspace(link, chunk, device)
    k_ms = cuda_ms(lambda: kernel(link, (3, 4), chunk, chunk, snr_lin, acc, psum, work), 10)
    p_ms = cuda_ms(lambda: plain(link, (3, 4), chunk, chunk, snr_lin, acc, psum), 1)
    if chain == "lr":
        ops = lr_operations(link, chunk)[0]
        rank = link.rank if link.add_noise else 0
        nbytes = 4 * (2 * (3 * link.E * link.n + rank * link.n) + 7 * link.n) + 3 * 8 + 8 * link.T
    elif chain == "diag":
        ops = diag_operations(link, chunk, OPS_PER_BIN_AQAM if link.q.mode == "aqam" else OPS_PER_BIN)
        nbytes = 4 * 7 * link.n + 3 * 8 + 8 * link.T
    else:
        ops = dense_wide_operations("mm", link, chunk)[0]
        nbytes = 4 * 7 * link.n + 8 * (link.E + 1) + 3 * 8 + 8 * link.T
    bound = max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
    print(f"{chain}_chunk {name} at {chunk} symbols x {link.n} sc [{card}]: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.3f} ms, bound {bound:.4f} ms ({ops} operations, {nbytes} bytes)")
    source = {"lr": "ofdm_tpu_torch/csrc/lr_kernel.cu", "diag": "ofdm_tpu_torch/csrc/diag_wide_kernel.cu",
              "mm": "ofdm_tpu_torch/csrc/mm_wide_kernel.cu"}[chain]
    return {"name": f"{chain}_chunk {name}", "route": "cuda", "source": source,
            "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes", "library_ms": None}


def giant_path(card, device):
    """The lr and diag chains at the JAX plan's largest widths and longest
    channels: ``giant_checks`` and lr_probe on the card, then the end-to-end
    runs of GIANT_RUNS, each kernel's time at its checked shape.  Returns
    the kernels-line entries, each with the launches of the run that drives
    its shape (GIANT_ENTRIES)."""
    import torch

    t_phase = time.perf_counter()
    # the host factorization of each lr run first, while nothing is cached
    # (the checks and the runs then read its cache)
    factor_s = {}
    for name, (kw, taps, _, chain, _) in GIANT_RUNS.items():
        if chain != "lr":
            continue
        t0 = time.perf_counter()
        giant_factor(kw, taps)
        factor_s[name] = time.perf_counter() - t0
        print(f"giant {name}: the host factorization (lowrank.factor, float64, n={kw['num_subcarriers']}) took "
              f"{factor_s[name]:.2f} s [{card}]")
    links, err = giant_checks(card, device)
    probe_err = giant_probe_check(card, device, links["lr_8k_cp05"][0])
    runs = {name: giant_run(card, device, name, factor_s.get(name, 0.0))[0] for name in GIANT_RUNS}
    torch.cuda.empty_cache()
    print(f"giant runs: {json.dumps(runs)}")
    main = {"lr": "lr_main", "diag": "diag_wide", "mm": "mm_wide_main"}
    entries = []
    for name, run in GIANT_ENTRIES.items():
        chain = name.split("_")[0]
        entries.append(giant_entry(card, device, name, *links[name], runs[run]["launches"][main[chain]], err, chain))
    keep = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    entries[0]["shapes_no_run"] = [{k: e[k] for k in keep} for e in
                                   (giant_entry(card, device, name, *links[name], 0, err, "lr")
                                    for name in GIANT_UNRUN)]
    entries[0]["probe_max_abs_err"] = probe_err
    print(f"giant_path: {time.perf_counter() - t_phase:.1f} s")
    return entries


GIANT_LIBRARIES = ("lr_kernel", "lr_staged", "lr_bump", "diag_wide", "diag_wide_staged", "mm_wide", "boxmuller")


def giant_main():
    """``--giant-only``: the build of the libraries the giant path loads, then
    the giant path, its kernels line and the last two lines."""
    import torch

    from ofdm_tpu_torch import build

    t_start = time.perf_counter()
    card = card_line()
    t0 = time.perf_counter()
    secs = build.build(GIANT_LIBRARIES)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f}s' for k, v in secs.items())})")
    for name in GIANT_LIBRARIES:
        with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as fh:
            text = fh.read()
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text) if int(b)]
        print(f"ptxas {name}: {len(re.findall('Used', text))} kernels, {len(spills)} with spill stores")
    lr_layouts_fit(card)
    entries = giant_path(card, torch.device("cuda"))
    print(f"chip_smoke --giant-only: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--nccl-ranks" in sys.argv:
        return nccl_main(int(sys.argv[sys.argv.index("--nccl-ranks") + 1]))
    if "--examples-only" in sys.argv:
        return examples_main()
    if "--giant-only" in sys.argv:
        return giant_main()
    if "--factor-seconds" in sys.argv:
        return factor_main(int(sys.argv[sys.argv.index("--factor-seconds") + 1]))
    from ofdm_tpu_torch import build
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import prng
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    t_start = time.perf_counter()
    card = card_line()
    device = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 1. build every kernel source at once
    t0 = time.perf_counter()
    secs = build.build(build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f}s' for k, v in secs.items())})")
    for name in build.SOURCES:
        log = os.path.join(build.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            with open(log) as fh:
                text = fh.read()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text) if int(b)]
            print(f"ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, "
                  f"{len(spills)} with spill stores (at most {max(spills, default=0)} bytes)")
            if not name.endswith(("_staged", "_bump")) and name != "boxmuller":
                print(f"ptxas {name} qam entry points (registers): {json.dumps(qam_registers(text))}")

    # 2. Philox: kernel vs plain, bit for bit
    key = (0xA4093822, 0x299F31D0)
    wk = prng.philox_words(1 << 20, 7, 0, key, device)
    wp = prng.philox_words_plain(1 << 20, 7, 0, key, device)
    if not torch.equal(wk, wp):
        raise AssertionError("Philox kernel and plain words differ")
    print("philox: 2^20 counters bit-equal")

    # 3. boxmuller_sample: kernel vs plain (at the gate's shape, and at counts
    # with a scalar tail of 1 element and of 1 quad and 1 element), then the
    # moment gate (its own path)
    bm_err = 0.0
    for shape in (NOISE_SHAPE, *BOXMULLER_COUNTS):
        zk = lk.boxmuller_sample(*NOISE_SEEDS, shape, device)
        zp = lk.boxmuller_sample_plain(*NOISE_SEEDS, shape, device)
        err = max(float((zk[0] - zp[0]).abs().max()), float((zk[1] - zp[1]).abs().max()))
        geo = lk.boxmuller_geometry(zk[0].numel())
        print(f"boxmuller at {shape}: kernel vs plain max abs diff {err:.3e} (launch {json.dumps(geo)})")
        bm_err = max(bm_err, err)
    if bm_err > 1e-6:
        raise AssertionError(f"boxmuller kernel vs plain {bm_err}")
    lk.boxmuller_sample.launches = 0
    ok, m = moment_gate(*lk.boxmuller_sample(*NOISE_SEEDS, NOISE_SHAPE, device))
    bm_launches = lk.boxmuller_sample.launches
    print(f"noise gate: {json.dumps(m)} ok={ok} launches={bm_launches}")
    if not ok or bm_launches != 1:
        raise AssertionError("noise-moment gate failed")

    # 4. diag_chunk: kernel vs plain on the main path's seed, at 2^14 symbols
    # and, in every mode, on the run's last full chunk (16 tiles)
    last = MAIN_SYMBOLS - MAIN_CHUNK
    chunk_err = max([check_chunk({}, CHECK_SYMBOLS, 1 << 20, device)] + [
        check_chunk(kw, MAIN_CHUNK, last, device) for kw in (
            {}, dict(equalization_method="ZF"), dict(noise_type="NONE", equalization_method="ZF"),
            dict(equalization_method="NONE", snr_db=20.0))])

    # 5. the main path: prepare() -> LinkRunner.run() on 2^27 OFDM symbols
    runner = LinkRunner(prepare(headline_cfg(MAIN_SYMBOLS, MAIN_CHUNK)))
    runner.run(1, snr_db=25.0)  # warm-up
    lk.diag_chunk.launches = lk.diag_chunk.power_launches = 0
    r = runner.run(MAIN_SEED, snr_db=30.0)
    main_launches, power_launches = lk.diag_chunk.launches, lk.diag_chunk.power_launches
    num_chunks = MAIN_SYMBOLS // MAIN_CHUNK
    ber = r["bit_error_rate"]
    print(f"headline run [{card}]: {MAIN_SYMBOLS} OFDM symbols ({r['total_bits']} bits), "
          f"ofdm_symbols_per_s={r['ofdm_symbols_per_s']:.1f} run_s={r['transmission_time_ms'] / 1e3:.4f} "
          f"BER={ber} papr_db={r['papr_db']:.4f} hotpath={r['hotpath_used']} "
          f"launches: diag_main {main_launches}, power_partials {power_launches}")
    if main_launches != num_chunks or power_launches != num_chunks or r["hotpath_used"] != "cuda":
        raise AssertionError(f"main path launched diag_main {main_launches} and power_partials "
                             f"{power_launches} times, not {num_chunks} each")
    if not abs(ber - REFERENCE_BER_30DB) < 1.5e-3:
        raise AssertionError(f"BER gate: {ber} vs {REFERENCE_BER_30DB}")
    sweep = [runner.run(2, snr_db=s)["bit_error_rate"] for s in (0.0, 10.0, 20.0, 30.0)]
    print(f"sweep 0/10/20/30 dB BER: {sweep}")
    if not all(a > b for a, b in zip(sweep, sweep[1:])):
        raise AssertionError("BER does not fall with SNR")

    print_profile(card, "headline", profile_run(runner, 30.0))

    # 6. kernel times at the main path's shapes, beside the plain versions and bounds
    link = runner.link
    snr_lin = lk.snr_linear(30.0)
    acc, psum = lk.new_accumulators(device)
    work = lk.chunk_workspace(link, MAIN_CHUNK, device)
    dk_ms = cuda_ms(lambda: lk.diag_chunk(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum, work), 20)
    dp_ms = cuda_ms(lambda: lk.diag_chunk_plain(link, (3, 4), 0, MAIN_CHUNK, snr_lin, acc, psum), 3)
    diag_ops = diag_operations(link, MAIN_CHUNK, OPS_PER_BIN)
    diag_bound = max(diag_ops / PEAK_OPS, (4 * 7 * link.n + papr_matrix_bytes(link) + 3 * 8) / PEAK_BYTES) * 1e3
    bk_ms = cuda_ms(lambda: lk.boxmuller_sample(*NOISE_SEEDS, NOISE_SHAPE, device), 20)
    bk_dev_ms = device_ms(lambda: lk.boxmuller_sample(*NOISE_SEEDS, NOISE_SHAPE, device),
                          "ofdm_sampler::boxmuller_kernel")
    bp_ms = cuda_ms(lambda: lk.boxmuller_sample_plain(*NOISE_SEEDS, NOISE_SHAPE, device), 3)
    elems = NOISE_SHAPE[0] * NOISE_SHAPE[1]
    bm_ops = elems * (OPS_PER_BIN["philox"] + OPS_PER_BIN["noise"])
    bm_bytes = elems * 8
    bm_bound = max(bm_ops / PEAK_OPS, bm_bytes / PEAK_BYTES) * 1e3
    # the pipe-aware bound from the static SASS: one pass of the quad loop a 4-element step
    bm_sass = sass_counts(build.library_path("boxmuller"), {"boxmuller_kernel<>": lk.BOXMULLER_STEP})
    bm_sass = bm_sass["boxmuller_kernel<>"]
    bm_pipe_ms, bm_pipe_by = max(pipe_bound_ms(bm_sass["per_bin"], elems), (bm_bytes / PEAK_BYTES * 1e3, "bytes"))
    print(f"diag_chunk at {MAIN_CHUNK} symbols [{card}]: kernel {dk_ms:.4f} ms, plain {dp_ms:.3f} ms, "
          f"bound {diag_bound:.4f} ms ({diag_ops} operations)")
    print(f"boxmuller_sample at {NOISE_SHAPE} [{card}]: kernel {bk_ms:.4f} ms a call (CUDA events, 20 calls), "
          f"device {bk_dev_ms} ms a launch (profiler, 20 launches), plain {bp_ms:.3f} ms, bound {bm_bound:.4f} ms "
          f"(uniform), pipe-aware bound {bm_pipe_ms:.4f} ms ({bm_pipe_by}); geometry "
          f"{json.dumps(lk.boxmuller_geometry(elems))}; static SASS of the quad loop a element "
          f"{json.dumps(bm_sass['per_bin'])}, Philox calls a pass {bm_sass['philox']}")
    pipe_bounds = diag_layout(card, device, dk_ms)

    # 7. the SC-FDE default through the fold kernel
    fold = fold_path(card, device)

    # 8. bench.py's two 1024-subcarrier cells through the lr kernel
    lr = lr_path(card, device)

    # 9. zp_64sc and the published campaign through the mm kernel
    mm = mm_path(card, device)

    # 10. the new constellation modes on every chain, then the reference's
    # adaptive link through the diag kernel in aqam mode
    aqam = adaptive_path(card, device, dk_ms)

    # 11. the stages: each staged kernel against its plain version, the
    # noise-bump campaign (the study's path), both switches through LinkRunner
    stage_err = stage_checks(device)
    bump = noise_bump_path(card, device, dk_ms, stage_err)
    staged = staged_path(card, device, stage_err)

    # 12. K5 and K4's plane form; capture through the dump stage on every
    # chain; the eager chain at full width; the noise-bump eager campaign
    prng_entries = normal_entries(card, device)
    dumps = capture_path(card, device)
    eager_path(card, device, prng_entries)
    eager_noise_bump_path(card, device)

    # 12b. the noise-bump stages on fold, lr and mm; diag past 256 subcarriers
    # (diag_wide); the study's campaign at 512 and 1024 sc
    wide = wide_path(card, device)
    demaps = demap_entries(card, device, bump["demap_launches"],
                           next(e["launches"] for e in wide if e["name"].startswith("diag_wide (noise-bump")),
                           max(stage_err, next(e["max_abs_err"] for e in wide if e["name"].startswith("diag_wide"))))

    # 12c. the fold and zero-prefix mm chains past 256 subcarriers (fold_wide,
    # mm_wide): against their plain versions, the two audit cells they take
    # from the eager chain
    dense_wide = dense_wide_path(card, device)

    # 12d. adaptive SC-FDE (aqam, apsk) on fold, mm, fold_wide and mm_wide:
    # against their plain versions, the router, the cells through run_sweep
    # and LinkRunner
    adaptive_scfde = adaptive_scfde_path(card, device)

    # 12e. the bit-level chains (K4 under bits.random_bits, K5 their AWGN) and
    # the shape audit: every production shape on its kernel, route and band
    bitlevel = bitlevel_path(card, device)
    audit_path(card, device)

    # 12f. the lr and diag chains past 4096 subcarriers (clusters), past 63 tail
    # lanes and noise rank 128: against their plain versions, end to end
    giant = giant_path(card, device)

    # 13. K3 and the carry-in on every chain; the sharded runs (one rank
    # under NCCL, two ranks under gloo) and the CLI on the reference's configs
    t_sweep = time.perf_counter()
    probe_entries = probe_path(card, device) + [e for e in dense_wide if e["name"].endswith("_probe")]
    cli_s = sweep_path(card, device, probe_entries)
    print(f"sweep and shards phase: {time.perf_counter() - t_sweep:.1f} s (CLI s a point {json.dumps(cli_s)})")

    # 14. the examples and tools: every example of ofdm_tpu_torch.examples
    # through its main() at the JAX script's size, watch, channel_plots,
    # trace and ThroughputMeter
    examples_path(card, device)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, {time.perf_counter() - T_SCRIPT:.1f} s "
          f"from the script's start (the torch import and CUDA start included); wall clock {time.time():.1f}")

    # the one-pass chunks' pipe-aware bounds (diag_layout) beside their uniform ones
    one_pass = {"noise_bump_64": bump, "wf_64": next(e for e in staged if e["name"].startswith("diag_chunk")),
                "noise_bump_512": next(e for e in wide if e["name"].startswith("diag_wide (noise-bump"))}
    for key, entry in one_pass.items():
        entry["pipe_bound_ms"], entry["pipe_bound_by"] = pipe_bounds[key]
    kernels = [
        {"name": "diag_chunk", "route": "cuda", "source": "ofdm_tpu_torch/csrc/link_kernel.cu",
         "replaces": "ofdm_tpu/ops/pallas_link.py:1986", "launches": main_launches,
         "power_partials_launches": power_launches,
         "max_abs_err": chunk_err, "ms": dk_ms, "plain_ms": dp_ms, "bound_ms": diag_bound,
         "bound_by": "operations", "library_ms": None, "pipe_bound_ms": pipe_bounds["headline"][0],
         "pipe_bound_by": pipe_bounds["headline"][1]},
        {"name": "boxmuller_sample", "route": "cuda", "source": "ofdm_tpu_torch/csrc/boxmuller.cu",
         "replaces": "ofdm_tpu/ops/pallas_link.py:597", "launches": bm_launches,
         "max_abs_err": bm_err, "ms": bk_ms, "device_ms": bk_dev_ms, "plain_ms": bp_ms, "bound_ms": bm_bound,
         "bound_by": "operations" if bm_ops / PEAK_OPS >= bm_bytes / PEAK_BYTES else "bytes",
         "library_ms": None, "pipe_bound_ms": bm_pipe_ms, "pipe_bound_by": bm_pipe_by},
        fold,
        *lr,
        mm,
        aqam,
        bump,
        *staged,
        *prng_entries,
        *dumps,
        *wide,
        *demaps,
        *[e for e in dense_wide if not e["name"].endswith("_probe")],
        *adaptive_scfde,
        *bitlevel,
        *giant,
        *probe_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
