"""Drive simulations from reference-format JSON settings files.

The port's examples/configurable_simulation_demo.py (the reference's
examples/configurable_simulation_demo.py): load a settings JSON
(config/simulation_settings_waterfilling.json), fan out one simulation per
SNR through ``run_sweep``, print the curve.

Run:  python -m ofdm_tpu_torch.examples.configurable_simulation_demo [--num-ofdm-symbols N]
                                                                    [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import add_link_options, link_record, repo_file


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=1000,
                   help="OFDM symbols a point (the demo's shrink of the settings file's size)")
    add_link_options(p)
    args = p.parse_args(argv)

    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.parallel import run_sweep

    configs = SimulationConfig.from_json(repo_file("config/simulation_settings_waterfilling.json"))
    base = configs[0].replace(num_symbols=64 * args.num_ofdm_symbols)  # shrink for the demo
    snrs = [c.snr_db for c in configs]
    print(f"Loaded {len(configs)} simulation points: SNRs {snrs}")

    results = run_sweep(base, snrs=snrs, sharded=False, key=args.seed, device=args.device)
    for r in results:
        print(
            f"  SNR {r['snr_db']:5.1f} dB -> BER {r['bit_error_rate']:.6f}, "
            f"PAPR {r['papr_db']:.2f} dB, water level "
            f"{r['water_level']:.4f}" if r["water_level"] else
            f"  SNR {r['snr_db']:5.1f} dB -> BER {r['bit_error_rate']:.6f}"
        )
    return [link_record(f"{r['snr_db']:.0f}db", base.replace(snr_db=r["snr_db"]), r) for r in results]


if __name__ == "__main__":
    main()
