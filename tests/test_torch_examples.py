"""The port's examples against the JAX package's scripts, on the CPU.

* The host-only examples (``waterfilling_demo``, ``plot_waterfilling_diagram``,
  ``generate_channel_models``): stdout line for line equal to the JAX
  script's, the exported ``.npy`` files byte-equal, each figure a PNG.
* ``quick_start_adaptive`` at the script's own size: its setup lines equal
  to the JAX script's, its BER within z = 5 of the JAX link's
  (``chip_smoke.EXAMPLE_READINGS``, ``jax_band_readings.py examples``).
* The notebook ``ofdm_tpu_torch/examples/bit_loading.ipynb``: no cell
  imports ``jax`` or ``ofdm_tpu``; its cells run in order, the host values
  (allocation, water level, orders, capacities) equal the JAX package's,
  the SER under the JAX test's 2e-2 and the BER within z = 5 of the JAX
  chain's at the same size and key.
* ``plot_constellations`` with matplotlib and with PIL.

The link examples and the parity report: ``tests/test_torch_examples_links.py``.
"""

import ast
import importlib
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from ofdm_tpu_torch.ops import metrics as mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "ofdm_tpu_torch", "examples", "bit_loading.ipynb")
torch.set_num_threads(1)


def _jax_script(name, tmp_path, monkeypatch, capsys, argv=()):
    """stdout of the JAX package's examples/<name>.py run in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def _port(name, argv, tmp_path, monkeypatch, capsys, **kw):
    """(records, stdout lines) of ofdm_tpu_torch.examples.<name>.main(argv) run in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    out = importlib.import_module(f"ofdm_tpu_torch.examples.{name}").main(argv, **kw)
    return out, capsys.readouterr().out.splitlines()


def _drawn(path):
    with Image.open(path) as im:
        lo, hi = im.convert("L").getextrema()
        return im.format == "PNG" and lo < hi


def _in_band(rec, errors, bits):
    return mt.ber_equivalent(rec["bit_errors"], rec["total_bits"], errors, bits, z=cs.BAND_Z)


HOST = {
    "waterfilling_demo": ["waterfilling_demo.png"],
    "plot_waterfilling_diagram": ["waterfilling_diagram.png"],
    "generate_channel_models": [],
}


@pytest.mark.parametrize("name", list(HOST))
def test_host_example_stdout_equal_to_jax(name, tmp_path, monkeypatch, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        (d / "config" / "channel_models").mkdir(parents=True)
    jax_lines = _jax_script(name, jdir, monkeypatch, capsys)
    recs, port_lines = _port(name, [], tdir, monkeypatch, capsys)
    assert recs == [] and port_lines == jax_lines and jax_lines
    for png in HOST[name]:
        assert _drawn(tdir / png)
    if name == "generate_channel_models":
        files = sorted(os.listdir(jdir / "config" / "channel_models"))
        assert files == sorted(os.listdir(tdir / "config" / "channel_models")) and len(files) == 7
        for f in files:
            assert (tdir / "config/channel_models" / f).read_bytes() == (jdir / "config/channel_models" / f).read_bytes()


def test_quick_start_adaptive_setup_lines_and_band(tmp_path, monkeypatch, capsys):
    jax_lines = _jax_script("quick_start_adaptive", tmp_path, monkeypatch, capsys)
    recs, port_lines = _port("quick_start_adaptive", ["--device", "cpu"], tmp_path, monkeypatch, capsys)
    setup = next(i for i, line in enumerate(jax_lines) if line.startswith("Bits per OFDM symbol")) + 1
    assert port_lines[:setup] == jax_lines[:setup] and setup >= 4
    assert [line.split(":")[0] for line in port_lines[setup:]] == ["BER", "SER", "Throughput"]
    (rec,) = recs
    errors, bits = cs.EXAMPLE_READINGS["quick_start_adaptive/quick_start"]
    assert rec["kernel_mode"] == "diag" and rec["hotpath_used"] == "torch" and rec["total_bits"] == bits
    assert _in_band(rec, errors, bits)


def _cells(path):
    with open(path) as fh:
        return ["".join(c["source"]) for c in json.load(fh)["cells"] if c["cell_type"] == "code"]


def _exec_cells(cells):
    ns = {}
    for src in cells:
        exec(compile(src, "bit_loading.ipynb", "exec"), ns)
    return ns


def test_notebook_cells_import_no_jax():
    for src in _cells(NOTEBOOK):
        for node in ast.walk(ast.parse(src)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "ofdm_tpu") for n in names), names


def test_notebook_cells_execute_against_the_jax_package():
    from ofdm_tpu.models import channels as jchm
    from ofdm_tpu.ops import adaptive as jad
    from ofdm_tpu.ops import allocate as jal
    from ofdm_tpu.ops import mapping as jmp

    import matplotlib.pyplot as plt

    try:
        port = _exec_cells(_cells(NOTEBOOK))
    finally:
        plt.close("all")
    assert str(port["DEVICE"]) == "cpu"
    # the JAX notebook's host steps (cells 2-5), float64
    taps = jchm.normalize_impulse_response(jchm.get_channel(port["CHANNEL"]))
    gains = jchm.channel_gains(taps, 64)
    noise_power = 1.0 / 10.0 ** 2
    power = jal.waterfilling(1.0, gains, noise_power)
    orders = jmp.bit_loading_orders("QAM", 1e-3, power * gains / (noise_power / 64))
    np.testing.assert_array_equal(port["gains"], gains)
    np.testing.assert_array_equal(port["power"], power)
    np.testing.assert_array_equal(port["orders"], orders)
    assert port["mu"] == jal.water_level(power, gains, noise_power)
    assert port["stats"] == jal.compare_allocations(jal.uniform(1.0, 64), power, gains, noise_power / 64)
    assert port["total_bits"] == jad.calculate_requirements(orders, port["NUM_OFDM_SYMBOLS"])[0]
    # the JAX test's gate (tests/test_examples.py), and the JAX chain's BER at z = 5
    # (bit_loading_walkthrough is the notebook's script form: the same link, size and key)
    assert 0.0 <= port["ser"] < 2e-2
    assert port["ber"] < port["ser"] or port["ser"] == 0.0
    assert port["mapper"].bits_per_ofdm_symbol == jad.make_adaptive_mapper("QAM", orders).bits_per_ofdm_symbol > 0
    errors, bits = cs.EXAMPLE_READINGS["bit_loading_walkthrough/bit_loading_walkthrough"]
    assert port["tx_bits"].numel() == bits
    assert mt.ber_equivalent(round(port["ber"] * bits), bits, errors, bits, z=cs.BAND_Z)


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "pil"])
def test_plot_constellations(matplotlib, tmp_path, monkeypatch, capsys):
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, lines = _port("plot_constellations", [], tmp_path, monkeypatch, capsys)
    assert lines == ["Saved constellation_16QAM.png"] and _drawn(tmp_path / "constellation_16QAM.png")
    _, lines = _port("plot_constellations", ["--type", "PSK", "--order", "8", "--output", "p.png"], tmp_path,
                     monkeypatch, capsys)
    assert lines == ["Saved p.png"] and _drawn(tmp_path / "p.png")
