"""Custom channel models: built-ins, .npy files, and your own taps.

The port's examples/custom_channel_demo.py (the reference's
examples/custom_channel_demo.py + CUSTOM_CHANNELS.md): load channels three
ways and compare BER across them, each through ``pipeline.simulate``.

Run:  python -m ofdm_tpu_torch.examples.custom_channel_demo [--num-ofdm-symbols N]
                                                           [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import add_link_options, link_record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=1000)
    add_link_options(p)
    args = p.parse_args(argv)

    import numpy as np

    from ofdm_tpu_torch.config import ChannelType, EqualizationMethod, SimulationConfig
    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.pipeline import simulate

    base = SimulationConfig(
        num_symbols=64 * args.num_ofdm_symbols,
        num_subcarriers=64,
        constellation_order=16,
        channel_type=ChannelType.CUSTOM,
        equalization_method=EqualizationMethod.MMSE,
        snr_db=20.0,
    )
    records = []

    def run(label, cfg, channel_ir=None):
        r = simulate(cfg, args.seed, channel_ir=channel_ir, device=args.device)
        records.append(link_record(label, cfg, r, channel_ir))
        return r

    print("Built-in channel models:", chm.list_channels())

    # 1. Built-in by name.
    for name in ("flat_fading", "two_ray", "severe_multipath"):
        r = run(name, base.replace(channel_model=name))
        print(f"  {name:20s}: BER {r['bit_error_rate']:.5f}")

    # 2. From a .npy file (reference CUSTOM-channel path semantics).
    r = run("Lin-Phoong_P2.npy", base.replace(channel_model="config/channel_models/Lin-Phoong_P2.npy"))
    print(f"  {'Lin-Phoong_P2.npy':20s}: BER {r['bit_error_rate']:.5f}")

    # 3. Your own impulse response, passed directly.
    my_channel = np.array([1.0 + 0.0j, 0.4 - 0.2j, 0.1 + 0.1j])
    r = run("custom 3-tap", base, my_channel)
    print(f"  {'custom 3-tap':20s}: BER {r['bit_error_rate']:.5f}")
    return records


if __name__ == "__main__":
    main()
