"""The port's link examples and parity report against the JAX package's scripts, on the CPU.

Each example runs through its ``main()`` with ``--device cpu`` (the
kernels' plain versions) in ``tmp_path``, and each link it records is held
at z = 5 (``metrics.ber_equivalent``) against the JAX script's link:

* at the script's own size where that is cheap here, against the JAX
  script's reading at that size and key (``chip_smoke.EXAMPLE_READINGS``,
  ``jax_band_readings.py examples``): the custom channels, the adaptive
  and configurable demos, the adaptive constellation demo, the overview
  and the walkthrough;
* at a cut size against the JAX package run here at that size: the pod
  sweep at 128 subcarriers and the parity report at 512 OFDM symbols a
  point;
* the noise-bump study's points (the example's at 512 OFDM symbols, the
  parity report's) against the JAX ``_Link``'s at 2^16
  (``JAX_CPU_READINGS``).

Each example's routes and figures are checked as well.
"""

import importlib
import os
import sys

import pytest
import torch
from PIL import Image

import chip_smoke as cs
import jax_band_readings as jbr
from ofdm_tpu_torch.ops import metrics as mt

torch.set_num_threads(1)


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


def _noise_bump_reading(label):
    scenario, snr = label.removeprefix("noise_bump_").rsplit("_", 1)
    return cs.JAX_CPU_READINGS[cs.noise_bump_name(scenario, float(snr[:-2]))]


# example: (its routes by label prefix, the lines it prints a link, its figures)
DEFAULT_SIZE = {
    "custom_channel_demo": ({"": "diag"}, 1, []),
    "adaptive_modulation_demo": ({"": "diag"}, 1, []),
    "configurable_simulation_demo": ({"": "diag"}, 1, []),
    "plot_adaptive_constellation_demo": ({"": "diag"}, 1, ["adaptive_constellation.png"]),
    "overview": ({"": "bit-level ops"}, 2, []),
    "bit_loading_walkthrough": ({"": "bit-level ops"}, 1, []),
}


@pytest.mark.parametrize("name", list(DEFAULT_SIZE))
def test_example_at_its_size_in_band(name, tmp_path, monkeypatch, capsys):
    routes, _, pngs = DEFAULT_SIZE[name]
    recs, lines = _port(name, ["--device", "cpu"], tmp_path, monkeypatch, capsys)
    readings = {k.split("/", 1)[1]: v for k, v in cs.EXAMPLE_READINGS.items() if k.startswith(name + "/")}
    assert [r["label"] for r in recs] == list(readings) and recs and lines
    for r in recs:
        errors, bits = readings[r["label"]]
        assert r["hotpath_used"] == "torch" and r["kernel_mode"] == routes[""]
        assert r["total_bits"] == bits and _in_band(r, errors, bits), (r, errors, bits)
    for png in pngs:
        assert _drawn(tmp_path / png)


def test_pod_scale_sweep_at_a_cut_size(tmp_path, monkeypatch, capsys):
    recs, lines = _port("pod_scale_sweep", ["--subcarriers", "128", "--qam-symbols", str(1 << 16), "--device", "cpu"],
                        tmp_path, monkeypatch, capsys)
    assert lines[0] == "Mesh: 1 device(s) — cpu"
    assert lines[1] == "512 OFDM symbols x 128 subcarriers per point (65,536 QAM symbols, 393,216 bits)"
    assert lines[-1].startswith("  grid wall ") and len(lines) == 7
    ref = jbr.pod_scale_sweep_reading(1 << 16, 128)
    assert [r["label"] for r in recs] == list(ref) == ["0db", "10db", "20db", "30db"]
    for r in recs:
        assert r["kernel_mode"] == "diag" and r["total_bits"] == ref[r["label"]][1]
        assert _in_band(r, *ref[r["label"]]), (r, ref[r["label"]])


def test_noise_bump_example(tmp_path, monkeypatch, capsys):
    # its 22 figures drawn with PIL, as on a machine without matplotlib
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    recs, lines = _port("waterfilling_noise_bump_experiment", ["--num-ofdm-symbols", "512", "--device", "cpu"],
                        tmp_path, monkeypatch, capsys)
    assert lines[-4] == "BER summary (SNR 0..30 dB):" and len(recs) == 21
    pngs = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "images")
                  for r, _, fs in os.walk(tmp_path / "images") for f in fs)
    assert len(pngs) == 22 and all(_drawn(tmp_path / "images" / p) for p in pngs)
    assert "Lin-Phoong_P2/CP-OFDM-Waterfilling-Study/CP-OFDM-WF-6dB/CP-OFDM-WF-6dB-SNR05dB.png" in pngs
    assert sorted(os.listdir(tmp_path / "results")) == sorted(
        f"ber_{k}_waterfilling_study.csv" for k in ("uniform", "wf_plus3", "wf_plus6"))
    for r in recs:
        assert r["kernel_mode"] == "small-batch link" and r["total_bits"] == 512 * 64 * 6
        assert _in_band(r, *_noise_bump_reading(r["label"])), r


def test_parity_report_at_a_cut_size(tmp_path, monkeypatch, capsys):
    out = tmp_path / "r" / "parity.md"
    recs = []
    rc, lines = _port("parity_report", ["--points", "512", "--output", str(out), "--device", "cpu"], tmp_path,
                      monkeypatch, capsys, records=recs)
    assert rc == 0 and lines[-1] == f"wrote {out}"
    text = out.read_text()
    assert "MISMATCH" not in text and "## Baseline" in text and "| uniform +3 dB |" in text
    assert sorted(os.listdir(out.parent / "noise_bump")) == sorted(
        f"ber_{k}_waterfilling_study.csv" for k in ("uniform", "wf_plus3", "wf_plus6"))
    ref = jbr.parity_report_reading(points=512, guard_grid=False)
    labels = [r["label"] for r in recs]
    assert labels[:5] == list(ref) and len(labels) == 11
    routes = {r["label"]: r["kernel_mode"] for r in recs}
    assert routes["baseline_sc_qpsk_0db"] == "fold" and routes["multipath_64qam_mmse_30db"] == "diag"
    for r in recs:
        errors, bits = _noise_bump_reading(r["label"]) if r["label"].startswith("noise_bump_") else ref[r["label"]]
        assert _in_band(r, errors, bits), (r, errors, bits)
