"""The port's host utilities against the JAX package's, on the CPU.

* The three plots the port adds to ``utils/visualization.py`` and
  ``utils/channel_plots.py``: the same seeded inputs through both
  packages' matplotlib figures, the figures' data compared (bar heights
  and bottoms, the mu line, scatter offsets per order, text boxes, the
  channel plot's lines); each plot's PIL form with matplotlib unimportable:
  a drawn PNG of figsize x dpi pixels.
* ``utils/watch.py``: the two-series CSV's curves as the JAX watcher plots
  them, the PIL form, ``clear_results_file`` byte-equal to the JAX
  function's file, ``main(["--once"])`` exit 0.
* ``utils/profiling.py``: ``ThroughputMeter`` as ``tests/test_profiling.py``
  holds the JAX one, and ``trace`` around a CPU ``LinkRunner`` run writing
  its trace under ``log_dir``.
"""

import json
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from ofdm_tpu.models import channels as jchm  # noqa: E402
from ofdm_tpu.ops import allocate as jal  # noqa: E402
from ofdm_tpu.utils import channel_plots as jcp  # noqa: E402
from ofdm_tpu.utils import visualization as jvis  # noqa: E402
from ofdm_tpu.utils import watch as jwatch  # noqa: E402
from ofdm_tpu_torch import utils as tutils  # noqa: E402
from ofdm_tpu_torch.utils import channel_plots as tcp  # noqa: E402
from ofdm_tpu_torch.utils import profiling as tprof  # noqa: E402
from ofdm_tpu_torch.utils import visualization as tvis  # noqa: E402
from ofdm_tpu_torch.utils import watch as twatch  # noqa: E402

torch.set_num_threads(1)
ORDERS = np.array([16] * 19 + [4] * 9 + [0] * 4 + [64] * 20 + [256] * 12)


def _received(n_points=64 * 40, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n_points) + 1j * rng.normal(size=n_points)) * 0.6


def _water_inputs():
    gains = jchm.channel_gains(jchm.get_channel("severe_multipath"), 64)
    noise_power = 10 ** (-15.0 / 10)
    power = jal.waterfilling(64.0, gains, noise_power)
    return power, gains, noise_power, jal.water_level(power, gains, noise_power)


def _bars(ax):
    return [(p.get_x(), p.get_height(), p.get_y(), p.get_facecolor()) for p in ax.patches]


def _texts(ax):
    return [t.get_text() for t in ax.texts]


def _axes_data(fig):
    """Everything a figure draws, per axes: bars, texts, titles, labels,
    ticks, lines and scatter offsets with their colours."""
    out = []
    for ax in fig.axes:
        out.append({
            "bars": _bars(ax), "texts": _texts(ax), "title": ax.get_title(),
            "labels": (ax.get_xlabel(), ax.get_ylabel()),
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "lines": [(np.asarray(line.get_xdata(), float), np.asarray(line.get_ydata(), float))
                      for line in ax.lines],
            "scatter": [(np.asarray(c.get_offsets()), np.asarray(c.get_facecolors())) for c in ax.collections],
            "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else [],
        })
    return out


def _assert_same_figures(a, b):
    da, db = _axes_data(a), _axes_data(b)
    assert len(da) == len(db)
    for x, y in zip(da, db):
        for key in ("texts", "title", "labels", "xticks", "legend"):
            assert x[key] == y[key], key
        assert len(x["bars"]) == len(y["bars"])
        for (x0, h0, b0, c0), (x1, h1, b1, c1) in zip(x["bars"], y["bars"]):
            assert (x0, b0, c0) == (x1, b1, c1) and h0 == pytest.approx(h1, rel=1e-12)
        assert len(x["lines"]) == len(y["lines"])
        for (u0, v0), (u1, v1) in zip(x["lines"], y["lines"]):
            np.testing.assert_allclose(u0, u1, rtol=1e-12)
            np.testing.assert_allclose(v0, v1, rtol=1e-12)
        assert len(x["scatter"]) == len(y["scatter"])
        for (o0, c0), (o1, c1) in zip(x["scatter"], y["scatter"]):
            np.testing.assert_array_equal(o0, o1)
            np.testing.assert_array_equal(c0, c1)


def _plots():
    power, gains, noise_power, mu = _water_inputs()
    rx = _received()
    return {
        "order_distribution": (lambda m: m.plot_constellation_order_distribution(ORDERS, 64), (10, 6)),
        "water_level": (lambda m: m.plot_water_level_diagram(power, gains, noise_power, mu, title="WF"), (12, 6)),
        "water_level_no_mu": (lambda m: m.plot_water_level_diagram(power, gains, noise_power), (12, 6)),
        "adaptive_qam": (lambda m: m.plot_adaptive_constellation_diagram(
            rx, ORDERS, "Adaptive-4-to-256-QAM", 64, 0.0123, 0.0456, 20.0, 9.87), (14, 6)),
        "adaptive_psk": (lambda m: m.plot_adaptive_constellation_diagram(
            rx[:640], np.array([8] * 32 + [4] * 32), "PSK", 64, 0.1, 0.2, 15.0, 3.0, title_prefix="P"), (14, 6)),
    }


@pytest.mark.parametrize("name", list(_plots()))
def test_plot_data_equal_to_jax(name):
    draw, _ = _plots()[name]
    fig_j, fig_t = draw(jvis), draw(tvis)
    try:
        _assert_same_figures(fig_j, fig_t)
    finally:
        plt.close(fig_j)
        plt.close(fig_t)


def test_water_level_figure_holds_the_allocation():
    power, gains, noise_power, mu = _water_inputs()
    fig = tvis.plot_water_level_diagram(power, gains, noise_power, mu)
    ax = fig.axes[0]
    floor_bars, power_bars = ax.patches[:64], ax.patches[64:]
    np.testing.assert_allclose([p.get_height() for p in floor_bars], noise_power / gains)
    np.testing.assert_allclose([p.get_height() for p in power_bars], power)
    np.testing.assert_allclose([p.get_y() for p in power_bars], noise_power / gains)
    assert ax.lines[0].get_ydata()[0] == mu
    plt.close(fig)


@pytest.mark.parametrize("taps", [None, "two_ray", "rayleigh_fading"])
def test_channel_plot_lines_equal_to_jax(taps):
    h = np.array(tcp.DEFAULT_TAPS, dtype=np.complex128) if taps is None else jchm.get_channel(taps)
    fig_j, fig_t = jcp.plot_channel_response(h, 256, "x: "), tcp.plot_channel_response(h, 256, "x: ")
    try:
        _assert_same_figures(fig_j, fig_t)
        assert len(fig_t.axes[0].lines) == (1 if taps is None else 2) and len(fig_t.axes[1].lines) == 1
    finally:
        plt.close(fig_j)
        plt.close(fig_t)


def _png_ok(path, size):
    with Image.open(path) as im:
        lo, hi = im.convert("L").getextrema()
        assert im.format == "PNG" and im.size == size and lo < hi


@pytest.mark.parametrize("name", list(_plots()))
def test_plot_pil_form_without_matplotlib(name, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    draw, figsize = _plots()[name]
    fig = draw(tvis)
    assert isinstance(fig, tvis.PilFigure)
    fig.savefig(tmp_path / "f.png", dpi=50)
    _png_ok(tmp_path / "f.png", (figsize[0] * 50, figsize[1] * 50))
    assert fig._repr_png_().startswith(b"\x89PNG")


def test_channel_plots_main_pil_and_matplotlib(tmp_path, monkeypatch, capsys):
    assert tcp.main(["--out", str(tmp_path / "a.png")]) == 0
    _png_ok(tmp_path / "a.png", (640, 480))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tcp.main(["two_ray", "--n", "128", "--out", str(tmp_path / "b.png")]) == 0
    _png_ok(tmp_path / "b.png", (640, 480))
    assert capsys.readouterr().out.splitlines() == [f"wrote {tmp_path / 'a.png'}", f"wrote {tmp_path / 'b.png'}"]


def test_utils_exports_the_jax_names():
    import ofdm_tpu.utils as jutils

    assert tutils.__all__ == jutils.__all__
    assert all(callable(getattr(tutils, n)) for n in tutils.__all__)


CSV = ("simulation_name,snr_db,bit_error_rate\n"
       "CP-OFDM-MMSE,20.0,0.02\nCP-OFDM-MMSE,0.0,0.4\nSC-ZF,10.0,0.05\nCP-OFDM-MMSE,10.0,0.1\nSC-ZF,0.0,0.3\n")


def _plotted_lines(module, csv_path, out, monkeypatch):
    monkeypatch.setattr(plt, "close", lambda *a: None)
    assert module.render_ber_plot(str(csv_path), str(out))
    fig = plt.gcf()
    lines = [(line.get_label(), list(line.get_xdata()), list(line.get_ydata())) for line in fig.axes[0].lines]
    title = fig.axes[0].get_title()
    plt.close("all")
    return lines, title


def test_watch_render_equal_to_jax(tmp_path, monkeypatch):
    csv_path = tmp_path / "ber.csv"
    csv_path.write_text(CSV)
    jax_lines = _plotted_lines(jwatch, csv_path, tmp_path / "j.png", monkeypatch)
    port_lines = _plotted_lines(twatch, csv_path, tmp_path / "t.png", monkeypatch)
    assert port_lines == jax_lines
    assert [name for name, _, _ in port_lines[0]] == ["CP-OFDM-MMSE", "SC-ZF"]
    assert port_lines[0][0][1:] == ([0.0, 10.0, 20.0], [0.4, 0.1, 0.02])
    _png_ok(tmp_path / "t.png", (1500, 900))


def test_watch_pil_form_and_main(tmp_path, monkeypatch, capsys):
    csv_path = tmp_path / "ber.csv"
    assert not twatch.render_ber_plot(str(csv_path), str(tmp_path / "none.png"))
    twatch.clear_results_file(str(csv_path))
    assert not twatch.render_ber_plot(str(csv_path), str(tmp_path / "none.png"))
    csv_path.write_text(CSV)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "live.png"
    assert twatch.main(["--results", str(csv_path), "--output", str(out), "--once"]) == 0
    _png_ok(out, (1500, 900))
    assert twatch.main(["--results", str(csv_path), "--mode", "clear"]) == 0
    assert capsys.readouterr().out.splitlines()[-2:] == [f"updated {out}", f"cleared {csv_path}"]


def test_clear_results_file_byte_equal_to_jax(tmp_path):
    jwatch.clear_results_file(str(tmp_path / "j.csv"))
    twatch.clear_results_file(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_throughput_meter_accumulates():
    m = tprof.ThroughputMeter()
    with m.section(ofdm_symbols=100, bits=600):
        pass
    with m.section(ofdm_symbols=50, bits=300):
        pass
    assert m.ofdm_symbols == 150
    assert m.bits == 900
    assert m.seconds > 0
    assert m.ofdm_symbols_per_s > 0
    rep = m.report(num_devices=2)
    assert "150" in rep and "Mbit/s" in rep
    # the default device count: this process alone (no group, no card here)
    assert f"({m.ofdm_symbols_per_s:,.0f}/device)" in m.report()


def test_throughput_meter_requires_start():
    m = tprof.ThroughputMeter()
    with pytest.raises(RuntimeError):
        m.stop(1, 1)


def test_trace_around_a_cpu_run(tmp_path):
    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    cfg = SimulationConfig(num_symbols=64 * 64, num_subcarriers=64, constellation_order=16,
                           channel_type="CUSTOM", channel_model="Lin-Phoong_P1", snr_db=20.0)
    runner = LinkRunner(prepare(cfg), device="cpu")
    d = tmp_path / "trace"
    meter = tprof.ThroughputMeter()
    with tprof.trace(str(d)) as prof:
        with meter.section(runner.setup.num_ofdm_symbols, runner.setup.total_bits):
            r = runner.run(0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(d / files[0]) as fh:
        assert json.load(fh)["traceEvents"]
    assert prof.key_averages()
    assert meter.ofdm_symbols == 64 and meter.bits == r["total_bits"]
    assert meter.ofdm_symbols_per_s <= r["ofdm_symbols_per_s"]
