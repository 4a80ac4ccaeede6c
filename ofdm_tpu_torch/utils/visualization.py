"""Plots of a run's results and of a link's setup (host side).

The port's copy of ``ofdm_tpu.utils.visualization``: the constellation
figure of ``LinkRunner.run(render_constellation=True)``
(``render_results_constellation``, the reference's in-run rendering,
simulation/models.py:630-796), the order-distribution bar chart, the
waterfilling water-level diagram and the adaptive constellation diagram
coloured by order, with the JAX package's signatures and layouts.
matplotlib and PIL are imported inside the functions that draw, so
importing the port never needs them.  Where matplotlib is missing, each
plot function draws the same content with PIL and returns a
``PilFigure``, whose ``savefig(path, dpi=...)`` writes the PNG, so
callers written for a matplotlib figure run unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def plot_constellation_order_distribution(
    constellation_orders: NDArray[np.int64],
    num_subcarriers: int,
    figsize: Tuple[float, float] = (10, 6),
    title: str = "Constellation Order Distribution",
):
    """Bar chart of constellation orders across subcarriers."""
    orders = np.asarray(constellation_orders)
    if not have_matplotlib():
        return PilFigure(figsize, lambda draw, box: _pil_order_panel(draw, box, orders, num_subcarriers, title))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    _order_bars(ax, orders)
    ax.set_title(title)
    _stats_box(ax, orders, num_subcarriers)
    fig.tight_layout()
    return fig


def plot_water_level_diagram(
    power_allocation: NDArray[np.float64],
    channel_gains: NDArray[np.float64],
    noise_power: float,
    water_level: Optional[float] = None,
    figsize: Tuple[float, float] = (12, 6),
    title: str = "Waterfilling Power Allocation",
):
    """Stacked-bar waterfilling diagram: noise floor + allocated power + mu line."""
    power_allocation = np.asarray(power_allocation, dtype=np.float64)
    noise_floor = noise_power / np.asarray(channel_gains, dtype=np.float64)
    if not have_matplotlib():
        return PilFigure(figsize, lambda draw, box: _pil_water_panel(draw, box, power_allocation, noise_floor,
                                                                     water_level, title))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    idx = np.arange(len(power_allocation))
    ax.bar(idx, noise_floor, color="lightcoral", label="Noise Floor (N0/|H|^2)", edgecolor="darkred", linewidth=0.5)
    ax.bar(idx, power_allocation, bottom=noise_floor, color="steelblue", label="Allocated Power",
           edgecolor="navy", linewidth=0.5)
    if water_level is not None:
        ax.axhline(water_level, color="darkgreen", linestyle="--", linewidth=2,
                   label=f"Water Level (mu = {water_level:.4f})")
    ax.set_xlabel("Subcarrier Index")
    ax.set_ylabel("Power Level")
    ax.set_title(title)
    ax.legend(loc="upper right")
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    return fig


def _orders_per_symbol(received, orders, num_subcarriers):
    """Each received point's order (the points are symbol-major) and the active orders."""
    per_symbol = np.tile(orders, len(received) // num_subcarriers + 1)[: len(received)]
    return per_symbol, [int(o) for o in np.unique(orders) if o > 0]


def plot_adaptive_constellation_diagram(
    received_symbols: NDArray[np.complex128],
    constellation_orders: NDArray[np.int64],
    constellation_title: str,
    num_subcarriers: int,
    ber: float,
    ser: float,
    snr_db: float,
    papr_db: float,
    figsize: Tuple[float, float] = (14, 6),
    title_prefix: str = "Adaptive Modulation",
):
    """Constellation diagram with received symbols color-coded by order, and
    the order distribution; the ideal points from ``mapping.make_constellation``."""
    received = np.asarray(received_symbols)
    orders = np.asarray(constellation_orders)
    kind = "QAM" if "QAM" in constellation_title.upper() else "PSK"
    title = f"{title_prefix}: {constellation_title}"
    text = f"BER: {ber:.6f}\nSER: {ser:.6f}\nSNR: {snr_db} dB\nPAPR: {papr_db:.2f} dB"
    if not have_matplotlib():
        return PilFigure(figsize, lambda draw, box: _pil_adaptive(draw, box, received, orders, kind, num_subcarriers,
                                                                  title, text))
    from matplotlib import cm

    from ofdm_tpu_torch.ops.mapping import make_constellation

    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=figsize)
    per_symbol, unique_orders = _orders_per_symbol(received, orders, num_subcarriers)
    colors = cm.viridis(np.linspace(0, 1, max(len(unique_orders), 1)))
    for color, order in zip(colors, unique_orders):
        pts = received[per_symbol == order]
        ax1.scatter(pts.real, pts.imag, color=color, marker=".", alpha=0.15, label=f"{order}-{kind}")
        ideal = make_constellation(kind, order).table
        ax1.scatter(ideal.real, ideal.imag, color=color, marker="o", s=40, edgecolor="black", linewidth=0.5)
    ax1.set_title(title)
    ax1.set_xlabel("In-Phase")
    ax1.set_ylabel("Quadrature")
    ax1.axhline(0, color="black", lw=0.5)
    ax1.axvline(0, color="black", lw=0.5)
    ax1.legend(loc="upper right", fontsize=8)
    ax1.grid(True)
    ax1.set_aspect("equal")
    ax1.text(0.05, 0.95, text, transform=ax1.transAxes, fontsize=9, va="top", bbox=dict(facecolor="white", alpha=0.8))
    _order_bars(ax2, orders)
    ax2.set_title("Constellation Order Distribution")
    _stats_box(ax2, orders, num_subcarriers)
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
# A machine may have PIL but not matplotlib (the H100 machine has no
# matplotlib); the plots above, the results manager's two figures, the
# watcher's curves and the noise-bump study's figures are then drawn with
# PIL: the same data and titles, in a plainer style.


def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


class PilFigure:
    """A figure drawn with PIL where matplotlib is missing.  ``draw(draw,
    box)`` paints it into an ``ImageDraw`` over ``box`` (x0, y0, x1, y1);
    ``savefig`` renders it at ``figsize`` inches x ``dpi`` pixels."""

    def __init__(self, figsize: Tuple[float, float], draw: Callable):
        self.figsize = tuple(figsize)
        self._draw = draw

    def render(self, dpi: float = 100):
        from PIL import Image, ImageDraw

        size = tuple(max(int(round(f * dpi)), 1) for f in self.figsize)
        img = Image.new("RGB", size, "white")
        self._draw(ImageDraw.Draw(img), (0, 0, *size))
        return img

    def savefig(self, fname, dpi: Optional[float] = None, format: Optional[str] = None, **_):
        """Write the figure as a PNG to ``fname`` (a path or a file object)."""
        self.render(dpi or 100).save(fname, format="png")

    def _repr_png_(self) -> bytes:
        """The PNG bytes, so a notebook shows the figure."""
        from io import BytesIO

        buf = BytesIO()
        self.savefig(buf)
        return buf.getvalue()


_VIRIDIS = ((68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37))


def viridis(k: int):
    """``k`` RGB colours evenly along viridis (``cm.viridis(np.linspace(0, 1, k))``, five anchors)."""
    out = []
    for t in np.linspace(0, 1, max(k, 1)):
        x = t * (len(_VIRIDIS) - 1)
        i = min(int(x), len(_VIRIDIS) - 2)
        f = x - i
        out.append(tuple(int(round(a + (b - a) * f)) for a, b in zip(_VIRIDIS[i], _VIRIDIS[i + 1])))
    return out[:k]


def _pil_panel(draw, box, title: str, xlabel: str, ylabel: str):
    """The plot box of one panel inside ``box``: its frame and labels drawn."""
    x0, y0, x1, y1 = box
    inner = (x0 + 70, y0 + 35, x1 - 15, y1 - 45)
    draw.rectangle(inner, outline="black")
    cx = (x0 + x1) // 2
    for i, line in enumerate(title.split("\n")):
        draw.text((cx - 3 * len(line), y0 + 5 + 11 * i), line, fill="black")
    draw.text((cx - 3 * len(xlabel), y1 - 18), xlabel, fill="black")
    draw.text((x0 + 3, (y0 + y1) // 2), ylabel[:11], fill="black")
    return inner


def _pil_text_box(draw, xy, text: str, anchor_right: bool = False) -> None:
    lines = text.split("\n")
    w, h = 6 * max(len(s) for s in lines) + 8, 11 * len(lines) + 6
    x, y = (xy[0] - w, xy[1]) if anchor_right else xy
    draw.rectangle((x, y, x + w, y + h), fill="white", outline="gray")
    draw.multiline_text((x + 4, y + 3), text, fill="black")


def _pil_legend(draw, inner, items) -> None:
    """(colour, label) entries at the top right of the plot box."""
    if items:
        w = 6 * max(len(label) for _, label in items) + 30
        x, y = inner[2] - w - 5, inner[1] + 5
        draw.rectangle((x, y, x + w, y + 14 * len(items) + 4), fill="white", outline="gray")
        for i, (color, label) in enumerate(items):
            yy = y + 4 + 14 * i
            draw.rectangle((x + 4, yy + 2, x + 18, yy + 10), fill=color)
            draw.text((x + 24, yy), label, fill="black")


def _pil_bars(draw, inner, heights, bottoms, ymax: float, color, outline) -> None:
    x0, y0, x1, y1 = inner
    n = max(len(heights), 1)
    step = (x1 - x0) / n
    for i, (h, b) in enumerate(zip(heights, bottoms)):
        top = y1 - (b + h) / ymax * (y1 - y0)
        base = y1 - b / ymax * (y1 - y0)
        draw.rectangle((x0 + step * (i + 0.1), max(top, y0), x0 + step * (i + 0.9), min(base, y1)),
                       fill=color[i] if isinstance(color, list) else color, outline=outline)


def _pil_order_panel(draw, box, orders, num_subcarriers: int, title: str) -> None:
    active = orders[orders > 0]
    unique_orders, counts = np.unique(active, return_counts=True)
    inner = _pil_panel(draw, box, title, "Constellation Order (M-QAM/PSK)", "Subcarriers")
    ymax = max(int(counts.max()) if len(counts) else 1, 1) * 1.15
    _pil_bars(draw, inner, counts, np.zeros(len(counts)), ymax, viridis(len(counts)), "black")
    step = (inner[2] - inner[0]) / max(len(counts), 1)
    for i, (order, count) in enumerate(zip(unique_orders, counts)):
        xc = inner[0] + step * (i + 0.5)
        draw.text((xc - 3 * len(str(order)), inner[3] + 5), str(int(order)), fill="black")
        draw.text((xc - 3 * len(str(count)), inner[3] - count / ymax * (inner[3] - inner[1]) - 13), str(int(count)),
                  fill="black")
    n_active = int(np.sum(orders > 0))
    avg = float(np.mean(active)) if n_active else 0.0
    _pil_text_box(draw, (inner[2] - 5, inner[1] + 5),
                  f"Total Subcarriers: {num_subcarriers}\nActive: {n_active}\n"
                  f"Inactive: {int(np.sum(orders == 0))}\nAvg Order: {avg:.1f}", anchor_right=True)


def _pil_water_panel(draw, box, power, noise_floor, water_level, title: str) -> None:
    inner = _pil_panel(draw, box, title, "Subcarrier Index", "Power Level")
    top = float(np.max(noise_floor + power)) if len(power) else 1.0
    ymax = max(top, water_level or 0.0) * 1.05 or 1.0
    _pil_bars(draw, inner, noise_floor, np.zeros(len(power)), ymax, (240, 128, 128), (139, 0, 0))
    _pil_bars(draw, inner, power, noise_floor, ymax, (70, 130, 180), (0, 0, 128))
    items = [((240, 128, 128), "Noise Floor (N0/|H|^2)"), ((70, 130, 180), "Allocated Power")]
    if water_level is not None:
        y = inner[3] - water_level / ymax * (inner[3] - inner[1])
        for x in range(int(inner[0]), int(inner[2]), 12):
            draw.line((x, y, min(x + 7, inner[2]), y), fill=(0, 100, 0), width=2)
        items.append(((0, 100, 0), f"Water Level (mu = {water_level:.4f})"))
    for frac in (0.25, 0.5, 0.75, 1.0):
        y = inner[3] - frac * (inner[3] - inner[1])
        draw.text((inner[0] - 60, y - 5), f"{frac * ymax:.3g}", fill="black")
    _pil_legend(draw, inner, items)


def _pil_scatter(draw, inner, points, lim: float, color, radius: int = 0) -> None:
    """Points inside [-lim, lim]^2 into the plot box (dots, or discs of ``radius``)."""
    x0, y0, x1, y1 = inner
    pts = np.asarray(points).reshape(-1)
    pts = pts[(np.abs(pts.real) <= lim) & (np.abs(pts.imag) <= lim)]
    xs = x0 + (pts.real + lim) / (2 * lim) * (x1 - x0)
    ys = y1 - (pts.imag + lim) / (2 * lim) * (y1 - y0)
    if radius:
        for x, y in zip(xs, ys):
            draw.ellipse((x - radius, y - radius, x + radius, y + radius), fill=color, outline="black")
    elif len(xs):
        draw.point(list(zip(xs.tolist(), ys.tolist())), fill=color)


def _square(box):
    """The largest square panel box centred in ``box``."""
    x0, y0, x1, y1 = box
    side = min(x1 - x0, y1 - y0)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    return (int(cx - side / 2), int(cy - side / 2), int(cx + side / 2), int(cy + side / 2))


def _pil_axes_cross(draw, inner) -> None:
    cx, cy = (inner[0] + inner[2]) / 2, (inner[1] + inner[3]) / 2
    draw.line((inner[0], cy, inner[2], cy), fill="black")
    draw.line((cx, inner[1], cx, inner[3]), fill="black")


def _pil_adaptive(draw, box, received, orders, kind: str, num_subcarriers: int, title: str, text: str) -> None:
    from ofdm_tpu_torch.ops.mapping import make_constellation

    x0, y0, x1, y1 = box
    mid = (x0 + x1) // 2
    inner = _pil_panel(draw, _square((x0, y0, mid, y1)), title, "In-Phase", "Quadrature")
    _pil_axes_cross(draw, inner)
    per_symbol, unique_orders = _orders_per_symbol(received, orders, num_subcarriers)
    lim = max(1.5, float(np.max(np.abs(make_constellation(kind, max(unique_orders)).table))) * 1.2
              if unique_orders else 1.5)
    colors = viridis(len(unique_orders))
    for color, order in zip(colors, unique_orders):
        _pil_scatter(draw, inner, received[per_symbol == order], lim, color)
    for color, order in zip(colors, unique_orders):
        _pil_scatter(draw, inner, make_constellation(kind, order).table, lim, color, radius=3)
    _pil_legend(draw, inner, [(c, f"{o}-{kind}") for c, o in zip(colors, unique_orders)])
    _pil_text_box(draw, (inner[0] + 5, inner[1] + 5), text)
    _pil_order_panel(draw, (mid, y0, x1, y1), orders, num_subcarriers, "Constellation Order Distribution")


def pil_ber_curves(path, series, title: str = "BER vs SNR Performance", size=(900, 600)) -> None:
    """BER-vs-SNR curves on a log axis as a PNG at ``path`` (PIL): ``series``
    maps a label to its (snrs, bers), each in its own colour."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    x0, y0, x1, y1 = inner = _pil_panel(draw, (0, 0, *size), title, "SNR (dB)", "Bit Error Rate (BER)")
    all_snrs = [s for snrs, _ in series.values() for s in snrs]
    pos = [b for _, bers in series.values() for b in bers if b > 0]
    lo = np.floor(np.log10(min(pos))) if pos else -6.0
    hi = max(np.ceil(np.log10(max(pos))), lo + 1) if pos else 0.0
    smin, smax = min(all_snrs), max(all_snrs)
    span = (smax - smin) or 1.0

    def xy(s, b):
        yb = np.log10(b) if b > 0 else lo
        return (x0 + (s - smin) / span * (x1 - x0), y1 - (yb - lo) / (hi - lo) * (y1 - y0))

    for d in range(int(lo), int(hi) + 1):
        y = y1 - (d - lo) / (hi - lo) * (y1 - y0)
        draw.line((x0, y, x1, y), fill=(210, 210, 210))
        draw.text((x0 - 60, y - 6), f"1e{d}", fill="black")
    for s in sorted(set(all_snrs)):
        draw.text((xy(s, 1.0)[0] - 8, y1 + 8), f"{s:g}", fill="black")
    palette = ["blue", "red", "green", "orange", "purple", "brown", "magenta", "gray"]
    items = []
    for i, (label, (snrs, bers)) in enumerate(series.items()):
        color = palette[i % len(palette)]
        pts = [xy(s, b) for s, b in sorted(zip(snrs, bers))]
        if len(pts) > 1:
            draw.line(pts, fill=color, width=2)
        for x, y in pts:
            draw.ellipse((x - 4, y - 4, x + 4, y + 4), fill=color)
        items.append((color, str(label)))
    _pil_legend(draw, inner, items)
    img.save(path, format="png")


def pil_ber_curve(path, snrs, bers, title: str = "BER vs SNR Performance") -> None:
    """The BER-vs-SNR curve on a log axis as a PNG at ``path`` (PIL)."""
    pil_ber_curves(path, {"BER vs SNR": (snrs, bers)}, title)


def pil_scatter_figure(received, ideal, title: str, lim: float = 1.5, text: Optional[str] = None,
                       legend=(), figsize: Tuple[float, float] = (8, 8)) -> PilFigure:
    """Received points over the ideal ones on the [-lim, lim] square (PIL),
    with an optional text box and legend entries."""
    def draw(d, box):
        inner = _pil_panel(d, _square(box), title, "In-Phase", "Quadrature")
        _pil_axes_cross(d, inner)
        _pil_scatter(d, inner, received, lim, (31, 119, 180))
        _pil_scatter(d, inner, ideal, lim, (214, 39, 40), radius=4)
        if text:
            _pil_text_box(d, (inner[0] + 10, inner[1] + 10), text)
        _pil_legend(d, inner, [((31, 119, 180), legend[0]), ((214, 39, 40), legend[1])] if legend else [])

    return PilFigure(figsize, draw)


def pil_constellation(path, received, ideal, ber: float, snr_db: float, papr_db: float, title: str) -> None:
    """The received-vs-ideal constellation scatter with the BER / SNR / PAPR
    text as a PNG at ``path`` (PIL), on the [-1.5, 1.5] square."""
    pil_scatter_figure(received, ideal, title, text=f"BER: {ber:.6f}\nSNR: {snr_db} dB\nPAPR: {papr_db:.2f} dB"
                       ).savefig(path)
