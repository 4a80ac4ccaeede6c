"""Constellation figures of a run's results (host-side matplotlib).

The port's own copy of what ``LinkRunner.run(render_constellation=True)``
needs from ``ofdm_tpu.utils.visualization``: ``render_results_constellation``
and the helpers it calls, with the same figure layouts (the reference's
in-run rendering, simulation/models.py:630-796).  matplotlib and PIL are
imported inside the functions that draw, so importing the port never
needs them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from numpy.typing import NDArray


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _order_bars(ax, constellation_orders: NDArray[np.int64]) -> None:
    from matplotlib import cm

    active = constellation_orders[constellation_orders > 0]
    unique_orders, counts = np.unique(active, return_counts=True)
    colors = cm.viridis(np.linspace(0, 1, max(len(unique_orders), 1)))
    bars = ax.bar(range(len(unique_orders)), counts, color=colors, edgecolor="black")
    ax.set_xlabel("Constellation Order (M-QAM/PSK)")
    ax.set_ylabel("Number of Subcarriers")
    ax.set_xticks(range(len(unique_orders)))
    ax.set_xticklabels([f"{int(o)}" for o in unique_orders])
    ax.grid(True, axis="y", alpha=0.3)
    for bar, count in zip(bars, counts):
        ax.text(bar.get_x() + bar.get_width() / 2.0, bar.get_height(), f"{int(count)}",
                ha="center", va="bottom", fontsize=9)


def _stats_box(ax, constellation_orders: NDArray[np.int64], num_subcarriers: int) -> None:
    active = int(np.sum(constellation_orders > 0))
    inactive = int(np.sum(constellation_orders == 0))
    avg = float(np.mean(constellation_orders[constellation_orders > 0])) if active else 0.0
    text = (f"Total Subcarriers: {num_subcarriers}\n"
            f"Active: {active}\nInactive: {inactive}\nAvg Order: {avg:.1f}")
    ax.text(0.98, 0.98, text, transform=ax.transAxes, fontsize=9, va="top", ha="right",
            bbox=dict(facecolor="white", alpha=0.8))


def _constellation_scatter(ax, received, ideal, ber: float, snr_db: float, papr_db: float, title: str) -> None:
    ax.scatter(received.real, received.imag, color="blue", marker=".", alpha=0.1, label="Received Symbols")
    ax.scatter(ideal.real, ideal.imag, color="red", marker="o", s=50, label="Ideal Constellation Points")
    ax.set_title(title)
    ax.set_xlabel("In-Phase")
    ax.set_ylabel("Quadrature")
    ax.axhline(0, color="black", lw=0.5)
    ax.axvline(0, color="black", lw=0.5)
    ax.legend(loc="upper right")
    ax.grid(True)
    ax.set_xlim(-1.5, 1.5)
    ax.set_ylim(-1.5, 1.5)
    ax.set_aspect("equal")
    ax.text(0.05, 0.95, f"BER: {ber:.6f}\nSNR: {snr_db} dB\nPAPR: {papr_db:.2f} dB",
            transform=ax.transAxes, fontsize=10, va="top", bbox=dict(facecolor="white", alpha=0.8))


def plot_combined_constellation_analysis(
    constellation_orders: NDArray[np.int64],
    demodulated_symbols: NDArray[np.complex128],
    ideal_constellation_points: NDArray[np.complex128],
    num_subcarriers: int,
    ber: float,
    snr_db: float,
    papr_db: float,
    figsize: Tuple[float, float] = (16, 8),
    title_prefix: str = "Adaptive Modulation",
):
    """Two-panel figure: constellation + order distribution (adaptive mode)."""
    plt = _pyplot()
    fig = plt.figure(figsize=figsize)
    ax1 = plt.subplot(1, 2, 1)
    _constellation_scatter(ax1, np.asarray(demodulated_symbols), np.asarray(ideal_constellation_points),
                           ber, snr_db, papr_db, f"Constellation Diagram ({title_prefix})")
    ax2 = plt.subplot(1, 2, 2)
    _order_bars(ax2, np.asarray(constellation_orders))
    ax2.set_title("Constellation Order Distribution")
    _stats_box(ax2, np.asarray(constellation_orders), num_subcarriers)
    fig.tight_layout()
    return fig


def render_results_constellation(
    results: dict,
    ideal_points: NDArray[np.complex128],
    constellation_orders: NDArray[np.int64],
    num_subcarriers: int,
    adaptive: bool,
):
    """The rendered constellation figure of ``results["constellation_plot"]``:
    fixed mode draws the received-vs-ideal scatter with the BER / SNR / PAPR
    box, adaptive mode the two-panel scatter + order-distribution figure.
    Returns a PIL image, saved through a PNG buffer as the reference does."""
    from io import BytesIO

    from PIL import Image

    plt = _pyplot()
    received = results.get("received_symbols")
    received = np.zeros(0, np.complex128) if received is None else np.asarray(received)
    ber = float(results["bit_error_rate"])
    snr_db = results["snr_db"]
    papr_db = float(results["papr_db"])
    if adaptive:
        fig = plot_combined_constellation_analysis(np.asarray(constellation_orders), received,
                                                   np.asarray(ideal_points), num_subcarriers, ber, snr_db,
                                                   papr_db)
    else:
        fig = plt.figure(figsize=(8, 8))
        _constellation_scatter(fig.gca(), received, np.asarray(ideal_points), ber, snr_db, papr_db,
                               str(results["title"]))
        fig.tight_layout()
    buf = BytesIO()
    fig.savefig(buf, format="png")
    buf.seek(0)
    image = Image.open(buf)
    image.load()
    plt.close(fig)
    return image
