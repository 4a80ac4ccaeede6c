"""Waterfilling vs uniform allocation: capacity comparison + diagrams.

The port's examples/waterfilling_demo.py (the reference's
examples/waterfilling_demo.py: 64 subcarriers, P = 1.0, SNR 20 dB,
Lin-Phoong P2).  Host only, float64: the capacities equal the JAX
package's to the last digit; writes waterfilling_demo.png (PIL where
matplotlib is missing).

Run:  python -m ofdm_tpu_torch.examples.waterfilling_demo
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import save_figure


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.ops import allocate as al
    from ofdm_tpu_torch.utils import plot_water_level_diagram

    n = 64
    snr_db = 20.0
    noise_power = 10 ** (-snr_db / 10)
    h = chm.get_channel("Lin-Phoong_P2")
    gains = chm.channel_gains(h, n)

    uniform = al.uniform(1.0, n)
    wf = al.waterfilling(1.0, gains, noise_power)
    comparison = al.compare_allocations(uniform, wf, gains, noise_power)

    print(f"Uniform capacity:      {comparison['uniform_capacity']:.4f} bits/use")
    print(f"Waterfilling capacity: {comparison['waterfilling_capacity']:.4f} bits/use")
    print(f"Gain: {comparison['capacity_gain']:.4f} bits/use "
          f"({comparison['capacity_gain_percent']:.2f}%)")

    # Water-level flatness check (constant-level property).
    floor = noise_power / (gains * n)
    level = (wf + floor)[wf > 1e-10]
    print(f"Water level: mean={level.mean():.6f}, std={level.std():.2e}")

    mu = al.water_level(wf, gains, noise_power)
    fig = plot_water_level_diagram(wf, gains, noise_power, water_level=mu)
    save_figure(fig, "waterfilling_demo.png", 150)
    print("Saved waterfilling_demo.png")
    return []


if __name__ == "__main__":
    main()
