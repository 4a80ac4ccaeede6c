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


# --- PNG figures without matplotlib -------------------------------------------------
#
# A machine may have PIL but not matplotlib; the results manager then
# draws its two figures with PIL: the same data and titles, in a plainer
# style.


def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _pil_axes(title: str, xlabel: str, ylabel: str, size=(900, 600)):
    """(image, draw, plot box (x0, y0, x1, y1)) of an empty figure with its
    frame and labels."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    box = (90, 50, size[0] - 30, size[1] - 70)
    draw.rectangle(box, outline="black")
    draw.text((size[0] // 2 - 4 * len(title), 15), title, fill="black")
    draw.text((size[0] // 2 - 3 * len(xlabel), size[1] - 35), xlabel, fill="black")
    draw.text((5, size[1] // 2), ylabel, fill="black")
    return img, draw, box


def pil_ber_curve(path, snrs, bers, title: str = "BER vs SNR Performance") -> None:
    """The BER-vs-SNR curve on a log axis as a PNG at ``path`` (PIL)."""
    img, draw, (x0, y0, x1, y1) = _pil_axes(title, "SNR (dB)", "Bit Error Rate (BER)")
    pos = [b for b in bers if b > 0]
    lo = np.floor(np.log10(min(pos))) if pos else -6.0
    hi = max(np.ceil(np.log10(max(pos))), lo + 1) if pos else 0.0
    smin, smax = min(snrs), max(snrs)
    span = (smax - smin) or 1.0

    def xy(s, b):
        yb = np.log10(b) if b > 0 else lo
        return (x0 + (s - smin) / span * (x1 - x0), y1 - (yb - lo) / (hi - lo) * (y1 - y0))

    for d in range(int(lo), int(hi) + 1):
        y = y1 - (d - lo) / (hi - lo) * (y1 - y0)
        draw.line((x0, y, x1, y), fill=(210, 210, 210))
        draw.text((x0 - 60, y - 6), f"1e{d}", fill="black")
    for s in snrs:
        draw.text((xy(s, 1.0)[0] - 8, y1 + 8), f"{s:g}", fill="black")
    pts = [xy(s, b) for s, b in zip(snrs, bers)]
    if len(pts) > 1:
        draw.line(pts, fill="blue", width=2)
    for x, y in pts:
        draw.ellipse((x - 4, y - 4, x + 4, y + 4), fill="blue")
    img.save(path, format="png")


def pil_constellation(path, received, ideal, ber: float, snr_db: float, papr_db: float, title: str) -> None:
    """The received-vs-ideal constellation scatter with the BER / SNR / PAPR
    text as a PNG at ``path`` (PIL), on the [-1.5, 1.5] square."""
    img, draw, (x0, y0, x1, y1) = _pil_axes(title, "In-Phase", "Quadrature", size=(800, 800))

    def xy(z):
        return x0 + (z.real + 1.5) / 3.0 * (x1 - x0), y1 - (z.imag + 1.5) / 3.0 * (y1 - y0)

    cx, cy = xy(0j)
    draw.line((x0, cy, x1, cy), fill="black")
    draw.line((cx, y0, cx, y1), fill="black")
    for z in np.asarray(received).reshape(-1):
        if abs(z.real) <= 1.5 and abs(z.imag) <= 1.5:
            x, y = xy(z)
            draw.point((x, y), fill=(110, 110, 255))
    for z in np.asarray(ideal).reshape(-1):
        x, y = xy(z)
        draw.ellipse((x - 4, y - 4, x + 4, y + 4), fill="red")
    draw.text((x0 + 10, y0 + 10), f"BER: {ber:.6f}\nSNR: {snr_db} dB\nPAPR: {papr_db:.2f} dB", fill="black")
    img.save(path, format="png")
