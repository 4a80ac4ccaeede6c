"""Render the waterfilling water-level diagram for a channel.

The port's examples/plot_waterfilling_diagram.py (the reference's
examples/plot_waterfilling_diagram.py): host only, writes
waterfilling_diagram.png (PIL where matplotlib is missing).

Run:  python -m ofdm_tpu_torch.examples.plot_waterfilling_diagram
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import save_figure


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.ops import allocate as al
    from ofdm_tpu_torch.utils import plot_water_level_diagram

    n, snr_db = 64, 15.0
    noise_power = 10 ** (-snr_db / 10)
    gains = chm.channel_gains(chm.get_channel("severe_multipath"), n)
    power = al.waterfilling(float(n), gains, noise_power)
    mu = al.water_level(power, gains, noise_power)
    fig = plot_water_level_diagram(
        power, gains, noise_power, water_level=mu,
        title=f"Waterfilling over severe_multipath @ {snr_db:.0f} dB",
    )
    save_figure(fig, "waterfilling_diagram.png", 150)
    print(f"Water level mu = {mu:.6f}; saved waterfilling_diagram.png")
    return []


if __name__ == "__main__":
    main()
