"""Generate the accuracy parity report: BER grids, the port vs the reference.

The port's examples/parity_report.py: runs the BASELINE config families
on ``--device`` (the card by default) and writes a Markdown report
(``--output``, results/parity_report.md by default) with the measured BER
tables beside the reference simulator's seeded values (the JAX script's
cached table, docs/PARITY.md).  The noise-bump table is measured here
too, on the same device.  A row whose BER is more than max(0.004, 0.15 x
reference) from its reference is flagged MISMATCH; the exit status is 1
when any row is.

Run:  python -m ofdm_tpu_torch.examples.parity_report [--output FILE] [--points N]
          [--guard-grid] [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ofdm_tpu_torch.examples import add_link_options, link_record, record

# The reference's BER, seeded runs at matched sizes (examples/parity_report.py).
CACHED_REFERENCE = {
    # configs[0]: SC-OFDM QPSK, Lin-Phoong P1, ZF (reference default config)
    "baseline_sc_qpsk": {0.0: 0.246083, 10.0: 0.014500, 20.0: 0.000000},
    # configs[1]: CP-OFDM 64-QAM, Lin-Phoong P2 (published campaign)
    "multipath_64qam_zf": {30.0: 0.01814},
    "multipath_64qam_mmse": {30.0: 0.01901},  # 6M-bit campaign run
}

# The reference's full published campaign grid (docs/OFDM-Based
# Systems.tex:199-244): {CP,ZP} x {ZF,MMSE} x guard ratio
# {0.34,0.68,1.00,1.34} (prefix lengths 1..4 on the 3rd-order Lin-Phoong
# P2 channel), 64-QAM, 30 dB, AWGN; seeded 6M-bit runs of the reference
# code (its LaTeX ZF tables predate the code, which the values match).
GUARD_GRID_REFERENCE = {
    "CYCLIC-ZF-0.34": 0.041035, "CYCLIC-ZF-0.68": 0.026598,
    "CYCLIC-ZF-1.0": 0.018704, "CYCLIC-ZF-1.34": 0.018632,
    "CYCLIC-MMSE-0.34": 0.041083, "CYCLIC-MMSE-0.68": 0.026817,
    "CYCLIC-MMSE-1.0": 0.019054, "CYCLIC-MMSE-1.34": 0.019021,
    "ZERO-ZF-0.34": 0.040943, "ZERO-ZF-0.68": 0.026517,
    "ZERO-ZF-1.0": 0.018671, "ZERO-ZF-1.34": 0.018709,
    "ZERO-MMSE-0.34": 0.040941, "ZERO-MMSE-0.68": 0.026777,
    "ZERO-MMSE-1.0": 0.019049, "ZERO-MMSE-1.34": 0.019078,
}

# The reference experiment's BER at 15 / 30 dB (the JAX script's table).
NOISE_BUMP_REFERENCE = {"uniform": (0.4078, 0.1495), "wf_plus3": (0.4367, 0.1578), "wf_plus6": (0.4404, 0.1727)}
NOISE_BUMP_SNRS = (15.0, 30.0)


def mismatch(ber: float, ref: float) -> bool:
    return abs(ber - ref) > max(0.004, 0.15 * ref)


def main(argv=None, records=None) -> int:
    """Write the report; 1 if a row is flagged MISMATCH, else 0.  The links'
    records are appended to ``records`` when it is given."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output", default="results/parity_report.md")
    parser.add_argument("--points", type=int, default=1 << 18, help="OFDM symbols per point")
    parser.add_argument("--guard-grid", action="store_true",
                        help="include the 16-cell CP/ZP x ZF/MMSE x guard ratio grid")
    add_link_options(parser)
    args = parser.parse_args(argv)

    import torch

    from ofdm_tpu_torch.config import (
        AdaptiveModulationMode,
        ChannelType,
        ConstellationType,
        EqualizationMethod,
        ModulationType,
        PowerAllocationType,
        PrefixType,
        SimulationConfig,
    )
    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.parallel import run_sweep
    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    records = [] if records is None else records
    device = torch.device("cuda" if args.device is None else args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    B = args.points
    flagged = []
    lines = [
        "# Measured BER parity (generated by python -m ofdm_tpu_torch.examples.parity_report)",
        "",
        f"Device: `{device}` ({name}); {B:,} OFDM symbols per point.",
        "Reference values: matched-size seeded runs of the reference simulator "
        "(see docs/PARITY.md).",
        "",
    ]

    def sweep(title, key, cfg, snrs, ref):
        t0 = time.perf_counter()
        results = run_sweep(cfg, snrs=snrs, sharded=False, key=args.seed, device=args.device)
        dt = time.perf_counter() - t0
        lines.append(f"## {title}")
        lines.append("")
        lines.append(f"`{cfg.title}-{cfg.constellation_order}"
                     f"{cfg.constellation_type.name}` on {cfg.channel_model} "
                     f"({dt:.0f}s wall incl. setup)")
        lines.append("")
        lines.append("| SNR (dB) | ofdm_tpu_torch BER | reference BER |")
        lines.append("|---|---|---|")
        for r in results:
            records.append(link_record(f"{key}_{r['snr_db']:.0f}db", cfg.replace(snr_db=r["snr_db"]), r))
            rv = ref.get(r["snr_db"])
            rtxt = f"{rv:.6f}" if rv is not None else "—"
            lines.append(f"| {r['snr_db']:.0f} | {r['bit_error_rate']:.6f} | {rtxt} |")
        lines.append("")
        for r in results:
            rv = ref.get(r["snr_db"])
            if rv is not None and mismatch(r["bit_error_rate"], rv):
                lines.append(f"**MISMATCH at {r['snr_db']} dB**")
                flagged.append(f"{key} {r['snr_db']} dB")
        print("\n".join(lines[-len(results) - 4:]), flush=True)

    # configs[0]: baseline / reference default
    sweep(
        "Baseline (reference default): SC-FDE QPSK, ZF, Lin-Phoong P1", "baseline_sc_qpsk",
        SimulationConfig(
            num_symbols=64 * B, num_subcarriers=64, constellation_order=4,
            constellation_type=ConstellationType.QAM,
            modulation_type=ModulationType.SC_OFDM,
            channel_type=ChannelType.CUSTOM, channel_model="Lin-Phoong_P1",
            prefix_type=PrefixType.CYCLIC, prefix_length_ratio=1.0,
            equalization_method=EqualizationMethod.ZF, snr_db=20.0,
            symbols_per_chunk=min(B, 1 << 17),
        ),
        [0.0, 10.0, 20.0],
        CACHED_REFERENCE["baseline_sc_qpsk"],
    )

    # configs[1]: published campaign, both equalizers
    for eqm, refkey in (
        (EqualizationMethod.ZF, "multipath_64qam_zf"),
        (EqualizationMethod.MMSE, "multipath_64qam_mmse"),
    ):
        sweep(
            f"Published campaign: CP-OFDM 64-QAM {eqm.name}, Lin-Phoong P2", refkey,
            SimulationConfig(
                num_symbols=64 * B, num_subcarriers=64, constellation_order=64,
                channel_type=ChannelType.CUSTOM, channel_model="Lin-Phoong_P2",
                prefix_type=PrefixType.CYCLIC, prefix_length_ratio=1.0,
                equalization_method=eqm, snr_db=30.0,
                symbols_per_chunk=min(B, 1 << 17),
            ),
            [30.0],
            CACHED_REFERENCE[refkey],
        )

    # The full published-campaign grid (optional).
    if args.guard_grid:
        lines += [
            "## Guard-length sweep: the reference's full published campaign",
            "",
            "CP/ZP-OFDM, ZF/MMSE, 64-QAM, Lin-Phoong P2, 30 dB, guard ratio",
            "0.34/0.68/1.00/1.34 (prefix length 1-4). Reference values are",
            "seeded 6M-bit runs of the reference code (its LaTeX ZF tables",
            "predate the current code; the values match the code).",
            "",
            "| prefix | equalizer | ratio | ofdm_tpu_torch BER | reference BER |",
            "|---|---|---|---|---|",
        ]
        for ptype in (PrefixType.CYCLIC, PrefixType.ZERO):
            for eqm in (EqualizationMethod.ZF, EqualizationMethod.MMSE):
                for ratio in (0.34, 0.68, 1.0, 1.34):
                    cfg = SimulationConfig(
                        num_symbols=64 * B, num_subcarriers=64,
                        constellation_order=64,
                        channel_type=ChannelType.CUSTOM,
                        channel_model="Lin-Phoong_P2",
                        prefix_type=ptype, prefix_length_ratio=ratio,
                        equalization_method=eqm, snr_db=30.0,
                        symbols_per_chunk=min(B, 1 << 17),
                    )
                    key = f"{ptype.name}-{eqm.name}-{ratio}"
                    r = run_sweep(cfg, snrs=[30.0], sharded=False, key=args.seed, device=args.device)[0]
                    records.append(link_record(key, cfg, r))
                    rv = GUARD_GRID_REFERENCE[key]
                    flag = ""
                    if mismatch(r["bit_error_rate"], rv):
                        flag = " **MISMATCH**"
                        flagged.append(key)
                    lines.append(
                        f"| {ptype.name} | {eqm.name} | {ratio} | "
                        f"{r['bit_error_rate']:.6f} | {rv:.6f}{flag} |"
                    )
                    print(lines[-1], flush=True)
        lines.append("")

    # configs[2]: adaptive modulation — deterministic setup parity
    setup = prepare(SimulationConfig(
        num_bits=1_000_000, num_subcarriers=64,
        channel_type=ChannelType.CUSTOM, channel_model="Lin-Phoong_P1",
        equalization_method=EqualizationMethod.MMSE,
        power_allocation_type=PowerAllocationType.WATERFILLING,
        adaptive_modulation_mode=AdaptiveModulationMode.CAPACITY_BASED,
        snr_db=20.0,
    ))
    lines += [
        "## Adaptive modulation (CAPACITY_BASED, waterfilling, 20 dB)",
        "",
        "Setup quantities are float64 and equal the JAX package's "
        "(test-pinned in tests/test_torch_setup.py):",
        "",
        f"- water level: `{setup.water_level:.12f}`",
        f"- bits per OFDM symbol: `{setup.bits_per_ofdm_symbol}`",
        f"- orders: `{setup.constellation_orders.tolist()}`",
        "",
    ]

    # configs[3]: the noise-bump study, measured on this device.
    out_dir = os.path.dirname(os.path.abspath(args.output))
    fused = nb.default_fused_symbols(args.device)
    symbols = fused or 2048
    t0 = time.perf_counter()
    study = nb.run_noise_bump_experiment(snr_values=NOISE_BUMP_SNRS, results_dir=os.path.join(out_dir, "noise_bump"),
                                         device=args.device)
    dt = time.perf_counter() - t0
    route = kernel_mode(prepare(nb.fused_config(fused, 64, 64, "Lin-Phoong_P2"))) if fused else "small-batch link"
    source = (f"the fused campaign, {symbols:,} OFDM symbols a point on `{route}`" if fused
              else f"the small-batch link, {symbols:,} OFDM symbols a point")
    lines += [
        "## Colored-noise waterfilling study (configs[3])",
        "",
        "`ofdm_tpu_torch.experiments.noise_bump` reproduces the reference",
        f"experiment; measured on this device ({source}, seed 42, {dt:.1f}s):",
        "",
        "| scenario | 15 dB | 30 dB | reference (15/30 dB) |",
        "|---|---|---|---|",
    ]
    bits = symbols * 64 * 6
    for s in nb.SCENARIOS:
        bers, refs = study[s.name], NOISE_BUMP_REFERENCE[s.key]
        flag = ""
        for snr, ber, rv in zip(NOISE_BUMP_SNRS, bers, refs):
            records.append(record(f"noise_bump_{s.key}_{snr:.0f}db", route, {
                "hotpath_used": "cuda" if device.type == "cuda" else "torch", "bit_errors": round(ber * bits),
                "total_bits": bits, "bit_error_rate": ber, "ofdm_symbols_per_s": float("nan")}))
            if mismatch(ber, rv):
                flag = " **MISMATCH**"
                flagged.append(f"noise_bump {s.key} {snr} dB")
        label = "uniform" if s.power_allocation == "UNIFORM" else "waterfilling"
        lines.append(f"| {label} +{s.noise_bump_db:.0f} dB | {bers[0]:.4f} | {bers[1]:.4f} | {refs[0]:.4f} / {refs[1]:.4f}{flag} |")
    lines.append("")
    print("\n".join(lines[-6:]), flush=True)

    os.makedirs(out_dir, exist_ok=True)
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines))
    print(f"wrote {args.output}")
    if flagged:
        print(f"MISMATCH: {', '.join(flagged)}")
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
