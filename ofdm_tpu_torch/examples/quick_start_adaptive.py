"""Quick start: adaptive modulation in a few lines.

The port's examples/quick_start_adaptive.py (the reference's
examples/quick_start_adaptive.py): run one CAPACITY_BASED point with
waterfilling and print the per-subcarrier orders.

Run:  python -m ofdm_tpu_torch.examples.quick_start_adaptive [--num-bits N] [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import add_link_options, record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-bits", type=int, default=500_000)
    add_link_options(p)
    args = p.parse_args(argv)

    from ofdm_tpu_torch.config import (
        AdaptiveModulationMode,
        ChannelType,
        EqualizationMethod,
        PowerAllocationType,
        SimulationConfig,
    )
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    cfg = SimulationConfig(
        num_bits=args.num_bits,
        num_subcarriers=64,
        channel_type=ChannelType.CUSTOM,
        channel_model="Lin-Phoong_P1",
        equalization_method=EqualizationMethod.MMSE,
        power_allocation_type=PowerAllocationType.WATERFILLING,
        adaptive_modulation_mode=AdaptiveModulationMode.CAPACITY_BASED,
        desired_symbol_error_rate=1e-3,
        snr_db=20.0,
    )
    setup = prepare(cfg)
    print("Constellation orders per subcarrier:")
    print(setup.constellation_orders)
    print(f"Water level: {setup.water_level:.6f}")
    print(f"Bits per OFDM symbol: {setup.bits_per_ofdm_symbol}")

    runner = LinkRunner(setup, args.device)
    result = runner.run(args.seed)
    print(f"BER: {result['bit_error_rate']:.6f}")
    print(f"SER: {result['symbol_error_rate']:.6f}")
    print(f"Throughput: {result['ofdm_symbols_per_s']:,.0f} OFDM symbols/s")
    return [record("quick_start", runner.mode, result)]


if __name__ == "__main__":
    main()
