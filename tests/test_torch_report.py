"""The port's results manager and CLI against the JAX package's.

* ``ResultsManager`` writes the same CSV rows (upsert by simulation name
  and SNR), reports the same ``completed_points`` and names its PNGs as
  ``ofdm_tpu.utils.report.ResultsManager`` does on the same result dicts;
  its figures are PNGs with matplotlib and without it (PIL).
* ``python -m ofdm_tpu_torch --device cpu`` end to end on a tiny config:
  the CSV, the BER curve and a constellation PNG a point, mirrored into the
  docs directory; ``--resume`` skips what the CSV holds; a missing config
  returns 1.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ofdm_tpu.utils.report import ResultsManager as JaxResultsManager
from ofdm_tpu_torch.main import main
from ofdm_tpu_torch.utils import visualization as vis
from ofdm_tpu_torch.utils.report import ResultsManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(snr, ber, title="CP-SC_OFDM-ZF", **kw):
    r = dict(snr_db=snr, bit_error_rate=ber, title=title, prefix_acronym="CP", modulator_type="SC_OFDM",
             equalizator_type="ZF", constellation_order=4, constellation_scheme="QAM",
             power_allocation_acronym="UNIFORM", papr_db=0.0, num_subcarriers=64,
             adaptive_modulation_mode="FIXED", constellation_order_per_subcarrier=[4] * 64,
             received_symbols=None)
    r.update(kw)
    return r


RESULTS = [_result(0.0, 0.2441), _result(10.0, 0.0143), _result(20.0, 0.0), _result(10.0, 0.01425),
           _result(30.0, 3.7e-06, title="CP-OFDM-MMSE"), _result(5.5, 1e-12)]


def _csv_rows(path):
    with open(path, newline="") as fh:
        return [(r["simulation_name"], float(r["snr_db"]), float(r["bit_error_rate"])) for r in csv.DictReader(fh)]


def test_csv_completed_points_and_names_match_jax(tmp_path):
    ours = ResultsManager(tmp_path / "p", tmp_path / "pi", "Lin-Phoong_P1", tmp_path / "pd")
    theirs = JaxResultsManager(str(tmp_path / "j"), str(tmp_path / "ji"), "Lin-Phoong_P1", str(tmp_path / "jd"))
    for r in RESULTS:
        ours.record(r)
        theirs.record(r)
    assert _csv_rows(ours.csv_path) == _csv_rows(theirs.csv_path)
    assert len(_csv_rows(ours.csv_path)) == 5  # the 10 dB point was upserted
    for name in ("CP-SC_OFDM-ZF", "CP-OFDM-MMSE", "none"):
        assert ours.completed_points(name) == theirs.completed_points(name)
    for r in RESULTS:
        assert ours.image_filename(r) == theirs.image_filename(r)
        assert ours.image_filename(r, "BER_vs_SNR") == theirs.image_filename(r, "BER_vs_SNR")
    assert ours.images_dir.name == theirs.images_dir.name == "Lin-Phoong_P1"


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "pil"])
def test_figures_are_pngs(tmp_path, monkeypatch, matplotlib):
    if not matplotlib:
        monkeypatch.setattr(vis, "have_matplotlib", lambda: False)
    m = ResultsManager(tmp_path / "r", tmp_path / "i", "ch", tmp_path / "d")
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal(256) + 1j * rng.standard_normal(256)) * 0.1 + 0.7 + 0.7j
    ideal = np.array([0.7 + 0.7j, -0.7 + 0.7j, 0.7 - 0.7j, -0.7 - 0.7j])
    paths = [m.save_constellation_plot(_result(10.0, 0.01, received_symbols=pts), ideal),
             m.save_constellation_plot(_result(20.0, 1e-4, received_symbols=pts, adaptive_modulation_mode=
                                               "CAPACITY_BASED"), ideal),
             m.plot_ber_vs_snr([_result(0.0, 0.24), _result(10.0, 0.014), _result(20.0, 0.0)])]
    for p in paths:
        assert p.exists() and (tmp_path / "d" / "ch" / p.name).exists()
        with Image.open(p) as im:
            assert im.format == "PNG" and im.size[0] > 100


def _tiny_config(tmp_path):
    path = tmp_path / "sim.json"
    path.write_text('{"num_bands": 64, "signal_noise_ratios": [0, 10], "channel_model_path": '
                    f'"{REPO}/config/channel_models/Lin-Phoong_P1.npy", "channel_type": "CUSTOM", '
                    '"num_symbols": 16384, "constellation_order": 4, "constellation_type": "QAM", "noise_type": '
                    '"AWGN", "prefix_length_ratio": 1.0, "prefix_type": "CYCLIC", "modulation_type": "SC-OFDM", '
                    '"equalization_method": "ZF", "power_allocation_type": "UNIFORM"}')
    return path


def test_cli_end_to_end_on_cpu(tmp_path, capsys):
    args = ["--simulation-settings", str(_tiny_config(tmp_path)), "--settings", f"{REPO}/config/settings.json",
            "--results-dir", str(tmp_path / "res"), "--images-dir", str(tmp_path / "img"),
            "--doc-figures-dir", str(tmp_path / "docs"), "--collect-symbols", "512", "--device", "cpu",
            "--stream-mode", "halo"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "Devices:" in out and "Summary Statistics" in out
    rows = _csv_rows(tmp_path / "res" / "ber_results.csv")
    assert [(n, s) for n, s, _ in rows] == [("CP-SC_OFDM-ZF", 0.0), ("CP-SC_OFDM-ZF", 10.0)]
    assert 0.2 < rows[0][2] < 0.3 and 0.005 < rows[1][2] < 0.03
    pngs = sorted(os.listdir(tmp_path / "img" / "Lin-Phoong_P1"))
    assert pngs == sorted(["CP-SC_OFDM-ZF-4QAM-UNIFORM-BER_vs_SNR.png", "CP-SC_OFDM-ZF-4QAM-UNIFORM-SNR0_0dB.png",
                           "CP-SC_OFDM-ZF-4QAM-UNIFORM-SNR10_0dB.png"])
    assert sorted(os.listdir(tmp_path / "docs" / "Lin-Phoong_P1")) == pngs
    assert main(args + ["--resume"]) == 0
    assert "nothing to do" in capsys.readouterr().out


def test_cli_missing_config_returns_1(tmp_path):
    done = subprocess.run([sys.executable, "-m", "ofdm_tpu_torch", "--simulation-settings",
                           str(tmp_path / "missing.json"), "--device", "cpu", "--results-dir", str(tmp_path / "r"),
                           "--images-dir", str(tmp_path / "i"), "--doc-figures-dir", str(tmp_path / "d")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 1 and "Configuration file not found" in done.stdout
