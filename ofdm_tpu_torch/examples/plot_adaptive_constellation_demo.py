"""Render the adaptive constellation diagram colored by order.

The port's examples/plot_adaptive_constellation_demo.py (the reference's
examples/plot_adaptive_constellation_demo.py): one CAPACITY_BASED link
over severe_multipath at 22 dB, its first 32768 equalized points captured
(``run(collect_symbols=32768)``: chunk 0 replayed through the kernel's dump
stage), drawn by order into adaptive_constellation.png (PIL where
matplotlib is missing).

Run:  python -m ofdm_tpu_torch.examples.plot_adaptive_constellation_demo [--num-ofdm-symbols N]
                                                                        [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import add_link_options, record, save_figure


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=2000)
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
    from ofdm_tpu_torch.utils import plot_adaptive_constellation_diagram

    cfg = SimulationConfig(
        num_symbols=args.num_ofdm_symbols,
        num_subcarriers=64,
        channel_type=ChannelType.CUSTOM,
        channel_model="severe_multipath",
        equalization_method=EqualizationMethod.MMSE,
        power_allocation_type=PowerAllocationType.WATERFILLING,
        adaptive_modulation_mode=AdaptiveModulationMode.CAPACITY_BASED,
        snr_db=22.0,
    )
    setup = prepare(cfg)
    runner = LinkRunner(setup, args.device)
    r = runner.run(args.seed, collect_symbols=32768)
    fig = plot_adaptive_constellation_diagram(
        r["received_symbols"],
        setup.constellation_orders,
        setup.amap.name,
        cfg.num_subcarriers,
        r["bit_error_rate"],
        r["symbol_error_rate"],
        r["snr_db"],
        r["papr_db"],
    )
    save_figure(fig, "adaptive_constellation.png", 150)
    print(f"BER {r['bit_error_rate']:.5f}; saved adaptive_constellation.png")
    return [record("adaptive_constellation", runner.mode, r)]


if __name__ == "__main__":
    main()
