"""CLI runner: config JSON -> sharded SNR sweep -> CSV / plots / summary.

The port's counterpart of ``ofdm_tpu.main`` (the reference's entry point,
main.py:347-397 + ``SimulationRunner``, main.py:197-344): loads the same
JSON settings format, runs the SNR grid through ``run_sweep`` (sharded
over the ranks of the process group, one rank when there is none),
upserts the BER CSV per point, saves the constellation PNGs and the
BER-vs-SNR curve, and prints summary statistics.

Usage:
    python -m ofdm_tpu_torch [--settings config/settings.json]
                             [--simulation-settings config/simulation_settings.json]
                             [--results-dir results] [--images-dir images]
                             [--doc-figures-dir docs/figures] [--seed 0]
                             [--no-shard] [--no-grid] [--resume]
                             [--collect-symbols N] [--stream-mode independent|halo]
                             [--device cuda|cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the kernels'
plain versions.  Under a multi-process launcher (OFDM_TPU_COORDINATOR /
OFDM_TPU_NUM_PROCS / OFDM_TPU_PROC_ID) every process joins one process
group: NCCL on the card, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="ofdm_tpu_torch simulation runner")
    parser.add_argument("--settings", default="config/settings.json")
    parser.add_argument("--simulation-settings", default="config/simulation_settings.json")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--images-dir", default="images")
    parser.add_argument("--doc-figures-dir", default="docs/figures")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-shard", action="store_true", help="run on one device (no mesh)")
    parser.add_argument("--no-grid", action="store_true",
                        help="run each SNR point on its own (run) instead of through run_grid")
    parser.add_argument("--resume", action="store_true",
                        help="skip (simulation, snr) points already present in the BER CSV")
    parser.add_argument("--collect-symbols", type=int, default=32768,
                        help="received-symbol sample size for constellation plots (0 = no plots)")
    parser.add_argument("--stream-mode", choices=("independent", "halo"), default="independent",
                        help="sharded streams: one each (independent) or one contiguous stream (halo)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    from ofdm_tpu_torch.config import ChannelType, Settings, SimulationConfig

    try:
        settings: Optional[Settings] = None
        if os.path.exists(args.settings):
            settings = Settings.from_json(args.settings)
            print("=" * 80)
            print(f"  {settings.project_name} v{settings.version}")
            print("=" * 80)
        configs = SimulationConfig.from_json(args.simulation_settings)
    except FileNotFoundError as exc:
        print(f"Error: Configuration file not found - {exc}")
        return 1

    import torch

    from ofdm_tpu_torch.parallel import distributed_init, make_mesh, run_sweep
    from ofdm_tpu_torch.pipeline import prepare
    from ofdm_tpu_torch.utils.report import ResultsManager

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available (pass --device cpu to run the plain versions)")
        return 1
    distributed_init(backend="gloo" if args.device == "cpu" else "nccl")

    base = configs[0]
    snrs = [c.snr_db for c in configs]

    # Channel name for the per-channel image directory (main.py:357-365).
    channel_name = "default"
    if base.channel_type == ChannelType.CUSTOM and base.channel_model:
        channel_name = Path(base.channel_model).stem
    elif base.channel_type == ChannelType.FLAT:
        channel_name = "flat"

    manager = ResultsManager(results_dir=args.results_dir, images_dir=args.images_dir,
                             channel_name=channel_name, doc_figures_dir=args.doc_figures_dir)

    if args.resume:
        done = set(manager.completed_points(base.title.replace(" ", "_")))
        skipped = [s for s in snrs if s in done]
        snrs = [s for s in snrs if s not in done]
        if skipped:
            print(f"--resume: skipping {len(skipped)} completed point(s): {skipped}")
        if not snrs:
            print("--resume: nothing to do")
            return 0

    mesh = None if args.no_shard else make_mesh(args.device)
    if mesh is None:
        devices = [torch.device(args.device)]
    else:
        devices = [f"{mesh.device} (rank {mesh.rank} of {mesh.size}, backend {mesh.backend or 'none'})"]
    if args.device == "cuda":
        devices.append(torch.cuda.get_device_name(torch.cuda.current_device()))
    print(f"Devices: {devices}")
    print(f"Running {len(snrs)} SNR point(s) on channel '{channel_name}'\n")

    results = run_sweep(base, snrs=snrs, key=args.seed, mesh=mesh, sharded=not args.no_shard,
                        stream_mode=args.stream_mode, collect_symbols=args.collect_symbols,
                        results_manager=manager, grid=not args.no_grid, device=args.device)

    # Constellation plots + BER curve (SimulationRunner.process_results,
    # main.py:251-344).
    saved = 0
    for r in results:
        if r.get("received_symbols") is not None:
            setup = prepare(base.replace(snr_db=r["snr_db"]))
            if manager.save_constellation_plot(r, setup.constellation_points):
                saved += 1
    if saved:
        print(f"  Saved {saved} constellation plot(s) under {manager.images_dir}")
    plot_path = manager.plot_ber_vs_snr(results)
    print(f"  BER vs SNR plot: {plot_path}")
    print(f"  BER CSV: {manager.csv_path}")

    print("\n" + "=" * 80)
    print("  Summary Statistics")
    print("=" * 80)
    bers = [r["bit_error_rate"] for r in results]
    paprs = [r["papr_db"] for r in results]
    rates = [r["ofdm_symbols_per_s"] for r in results]
    print(f"  SNR Range: {min(r['snr_db'] for r in results):.1f} dB to "
          f"{max(r['snr_db'] for r in results):.1f} dB")
    print(f"  BER Range: {min(bers):.6e} to {max(bers):.6e}")
    print(f"  Average PAPR: {sum(paprs) / len(paprs):.2f} dB")
    print(f"  Peak throughput: {max(rates):,.0f} OFDM symbols/s")
    print("=" * 80)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
