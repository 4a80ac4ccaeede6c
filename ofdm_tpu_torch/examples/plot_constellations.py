"""Standalone labeled constellation plotter.

The port's plot_constellations.py (the reference's
plot_constellations.py:25-193): draw a QAM or PSK constellation from
``mapping.make_constellation`` with its bit labels and a symbol-power
colormap (PIL where matplotlib is missing).

Run:  python -m ofdm_tpu_torch.examples.plot_constellations --type QAM --order 16 [--output out.png]
"""

from __future__ import annotations

import argparse
from typing import Optional


def _pil_draw(const, power):
    """The PIL form's painter: the points coloured by power, each with its label."""
    import numpy as np

    from ofdm_tpu_torch.utils import visualization as vis

    table, b = const.table, const.bits_per_symbol
    palette = vis.viridis(256)
    span = float(power.max() - power.min()) or 1.0
    lim = float(np.max(np.abs(table))) * 1.25

    def draw(d, box):
        inner = vis._pil_panel(d, vis._square(box), f"{const.name} constellation (Gray-coded, unit average power)",
                               "In-Phase", "Quadrature")
        vis._pil_axes_cross(d, inner)
        for i, (point, p) in enumerate(zip(table, power)):
            color = palette[int(round((p - power.min()) / span * 255))]
            vis._pil_scatter(d, inner, [point], lim, color, radius=6)
            x = inner[0] + (point.real + lim) / (2 * lim) * (inner[2] - inner[0])
            y = inner[3] - (point.imag + lim) / (2 * lim) * (inner[3] - inner[1])
            label = format(i, f"0{b}b")
            d.text((x - 3 * len(label), y - 20), label, fill="black")

    return draw


def plot_constellation(kind: str, order: int, output: Optional[str] = None) -> str:
    import numpy as np

    from ofdm_tpu_torch.ops.mapping import make_constellation
    from ofdm_tpu_torch.utils import visualization as vis

    const = make_constellation(kind, order)
    table = const.table
    b = const.bits_per_symbol
    power = np.abs(table) ** 2
    path = output or f"constellation_{order}{kind}.png"
    if not vis.have_matplotlib():
        vis.PilFigure((9, 9), _pil_draw(const, power)).savefig(path, dpi=150)
        return path

    plt = vis._pyplot()
    fig, ax = plt.subplots(figsize=(9, 9))
    sc = ax.scatter(table.real, table.imag, c=power, cmap="viridis", s=120,
                    edgecolor="black", linewidth=0.8, zorder=3)
    for i, point in enumerate(table):
        ax.annotate(
            format(i, f"0{b}b"),
            (point.real, point.imag),
            textcoords="offset points",
            xytext=(0, 9),
            ha="center",
            fontsize=max(5, 10 - b),
        )
    fig.colorbar(sc, ax=ax, label="Symbol power |s|^2", shrink=0.8)
    ax.set_title(f"{const.name} constellation (Gray-coded, unit average power)")
    ax.set_xlabel("In-Phase")
    ax.set_ylabel("Quadrature")
    ax.axhline(0, color="gray", lw=0.5)
    ax.axvline(0, color="gray", lw=0.5)
    ax.grid(True, linestyle=":", alpha=0.5)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot labeled constellations")
    parser.add_argument("--type", choices=["QAM", "PSK"], default="QAM")
    parser.add_argument("--order", type=int, default=16)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    path = plot_constellation(args.type, args.order, args.output)
    print(f"Saved {path}")
    return []


if __name__ == "__main__":
    main()
