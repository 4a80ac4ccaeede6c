"""Channel impulse-response time / frequency plot tool.

The port's ``ofdm_tpu.utils.channel_plots`` (the reference's
``utils/channel-plots.py``:1-29): normalize an impulse response and plot
its time response and N-point frequency-response magnitude, stacked, for
any built-in channel model name or ``.npy`` path.  Host side: numpy and
matplotlib, or PIL where matplotlib is missing.

Usage:
    python -m ofdm_tpu_torch.utils.channel_plots [channel] [--n 512] [--out FILE]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
from numpy.typing import NDArray

from ofdm_tpu_torch.utils import visualization as vis

DEFAULT_TAPS = (0.5, 0, 0, 0.3, 0.1)  # the reference script's example taps (:7)


def channel_response(h: NDArray[np.complex128], n: int = 512):
    """(unit-energy h, the frequency axis over [0, 2 pi], |H| at n points)."""
    h = np.asarray(h, dtype=np.complex128)
    h = h / np.linalg.norm(h)  # normalize, as the reference does (:9)
    return h, np.linspace(0, 2 * np.pi, n), np.abs(np.fft.fft(h, n))


def _pil_line(draw, inner, xs, ys, color) -> None:
    x0, y0, x1, y1 = inner
    xs, ys = np.asarray(xs, dtype=np.float64), np.asarray(ys, dtype=np.float64)
    lo, hi = float(min(ys.min(), 0.0)), float(max(ys.max(), 0.0))
    span_y = (hi - lo) or 1.0
    span_x = (xs.max() - xs.min()) or 1.0
    px = x0 + (xs - xs.min()) / span_x * (x1 - x0)
    py = y1 - (ys - lo) / span_y * (y1 - y0)
    draw.line(list(zip(px.tolist(), py.tolist())), fill=color, width=2)
    draw.text((x0 - 60, y0), f"{hi:.3g}", fill="black")
    draw.text((x0 - 60, y1 - 10), f"{lo:.3g}", fill="black")


def _pil_response(draw, box, h, freq, mag, title_prefix: str) -> None:
    x0, y0, x1, y1 = box
    mid = (y0 + y1) // 2
    top = vis._pil_panel(draw, (x0, y0, x1, mid), f"{title_prefix}Time Response".strip(), "Sample", "Amplitude")
    samples = np.arange(len(h))
    if np.allclose(h.imag, 0):
        _pil_line(draw, top, samples, h.real, "blue")
    else:
        _pil_line(draw, top, samples, h.real, "blue")
        _pil_line(draw, top, samples, h.imag, "orange")
        vis._pil_legend(draw, top, [("blue", "Re"), ("orange", "Im")])
    bottom = vis._pil_panel(draw, (x0, mid, x1, y1), "Frequency Response", "Frequency (radians)", "Magnitude")
    _pil_line(draw, bottom, freq, mag, "blue")


def plot_channel_response(h: NDArray[np.complex128], n: int = 512, title_prefix: str = ""):
    """Two-panel figure: time response and N-point |H(e^jw)| (ref :12-28)."""
    h, freq, mag = channel_response(h, n)
    if not vis.have_matplotlib():
        return vis.PilFigure((6.4, 4.8), lambda draw, box: _pil_response(draw, box, h, freq, mag, title_prefix))
    plt = vis._pyplot()
    fig = plt.figure()
    ax1 = plt.subplot(2, 1, 1)
    if np.allclose(h.imag, 0):
        ax1.plot(h.real)
    else:
        ax1.plot(h.real, label="Re")
        ax1.plot(h.imag, label="Im")
        ax1.legend()
    ax1.set_title(f"{title_prefix}Time Response".strip())
    ax1.set_xlabel("Sample")
    ax1.set_ylabel("Amplitude")

    ax2 = plt.subplot(2, 1, 2)
    ax2.plot(freq, mag)
    ax2.set_title("Frequency Response")
    ax2.set_xlabel("Frequency (radians)")
    ax2.set_ylabel("Magnitude")

    fig.tight_layout()
    return fig


def main(argv: Optional[list] = None) -> int:
    from ofdm_tpu_torch.models import channels as chm

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "channel",
        nargs="?",
        default=None,
        help="built-in channel name or .npy path; default = the reference "
        "script's example taps [0.5, 0, 0, 0.3, 0.1]",
    )
    p.add_argument("--n", type=int, default=512, help="FFT length (default 512)")
    p.add_argument("--out", default="channel_response.png")
    args = p.parse_args(argv)

    if args.channel is None:
        h = np.array(DEFAULT_TAPS, dtype=np.complex128)
        prefix = ""
    else:
        h = chm.get_channel(args.channel)
        prefix = f"{args.channel}: "

    fig = plot_channel_response(h, n=args.n, title_prefix=prefix)
    fig.savefig(args.out)
    if vis.have_matplotlib():
        vis._pyplot().close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
