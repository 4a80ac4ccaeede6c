"""FIXED vs CAPACITY_BASED adaptive modulation comparison.

The port's examples/adaptive_modulation_demo.py (the reference's
examples/adaptive_modulation_demo.py): run the same channel / SNR grid in
both modes through ``run_sweep`` and compare BER and spectral efficiency.
``--num-ofdm-symbols`` counts OFDM symbols in both modes; the fixed mode's
config takes 64 times as many QAM symbols (``num_symbols`` counts QAM
symbols there and OFDM symbols under adaptive loading, a reference quirk).

Run:  python -m ofdm_tpu_torch.examples.adaptive_modulation_demo [--num-ofdm-symbols N]
                                                                [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import add_link_options, link_record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=2000)
    add_link_options(p)
    args = p.parse_args(argv)

    import numpy as np

    from ofdm_tpu_torch.config import (
        AdaptiveModulationMode,
        ChannelType,
        EqualizationMethod,
        PowerAllocationType,
        SimulationConfig,
    )
    from ofdm_tpu_torch.parallel import run_sweep

    snrs = [10.0, 15.0, 20.0, 25.0]
    base = SimulationConfig(
        num_symbols=64 * args.num_ofdm_symbols,  # FIXED: QAM symbols (reference quirk)
        num_subcarriers=64,
        constellation_order=16,
        channel_type=ChannelType.CUSTOM,
        channel_model="Lin-Phoong_P1",
        equalization_method=EqualizationMethod.MMSE,
        power_allocation_type=PowerAllocationType.WATERFILLING,
        snr_db=20.0,
    )
    records = []

    print("--- FIXED 16-QAM ---")
    fixed = run_sweep(base, snrs=snrs, sharded=False, key=args.seed, device=args.device)
    for r in fixed:
        records.append(link_record(f"fixed_{r['snr_db']:.0f}db", base.replace(snr_db=r["snr_db"]), r))
        print(f"  SNR {r['snr_db']:5.1f} dB: BER {r['bit_error_rate']:.5f} "
              f"(4.0 bits/subcarrier)")

    print("--- CAPACITY_BASED (gap-function bit loading) ---")
    adaptive_cfg = base.replace(
        num_symbols=args.num_ofdm_symbols,  # adaptive: OFDM symbols (reference quirk)
        adaptive_modulation_mode=AdaptiveModulationMode.CAPACITY_BASED,
    )
    adaptive = run_sweep(adaptive_cfg, snrs=snrs, sharded=False, key=args.seed, device=args.device)
    for r in adaptive:
        records.append(link_record(f"adaptive_{r['snr_db']:.0f}db", adaptive_cfg.replace(snr_db=r["snr_db"]), r))
        orders = np.asarray(r["constellation_order_per_subcarrier"])
        bits = np.where(orders > 0, np.log2(np.maximum(orders, 1)), 0)
        print(f"  SNR {r['snr_db']:5.1f} dB: BER {r['bit_error_rate']:.5f} "
              f"({bits.mean():.1f} bits/subcarrier, "
              f"{int((orders > 0).sum())}/{len(orders)} active)")
    return records


if __name__ == "__main__":
    main()
