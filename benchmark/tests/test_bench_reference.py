"""The plain reference against the program on the CPU, at sizes the CPU
holds: the program's plain versions (float32) count what the float64
reference counts but for the odd point within rounding of a boundary,
inside the cells' limits; and the configuration files' estimator
settings are the program's rule at their widths."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import check, program, spec


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name,symbols,chunk,snrs", [
    ("headline_64sc", 4096, 2048, (0.0, 15.0, 30.0)),
    ("pod_1024sc", 256, 128, (0.0, 20.0)),
])
def test_reference_counts_the_program_exactly(name, symbols, chunk, snrs):
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    config = _config(name)
    config["link"]["symbols_per_chunk"] = chunk
    with open(os.path.join(BENCH_DIR, "limits", f"{name}.campaign.json")) as fh:
        limits = json.load(fh)
    runner = LinkRunner(prepare(program.simulation_config(config, symbols), program.channel_ir(config)), "cpu")
    link = spec.load_module(os.path.join(BENCH_DIR, "reference", f"{config['reference']}.py")).Link(config, "cpu")
    for i, snr in enumerate(snrs):
        key = (0xDEADBEEF12345 * (i + 3)) % (1 << 64)
        got = program.answer(runner.run(seed=key, snr_db=snr))
        want = link.point(key, snr, symbols)
        assert abs(got[0] - want["bit_errors"]) <= 4 and abs(got[1] - want["symbol_errors"]) <= 4
        assert check.verdict(check.gaps(got, want), limits)


def test_qam_table_is_the_programs():
    from ofdm_tpu_torch.ops.mapping import make_constellation

    link = spec.load_module(os.path.join(BENCH_DIR, "reference", "ofdm_link.py"))
    for order in (4, 16, 64, 256):
        np.testing.assert_allclose(link.qam_table(order), make_constellation("QAM", order).table, atol=1e-15)


@pytest.mark.parametrize("name", ["headline_64sc", "pod_1024sc"])
def test_estimator_settings_are_the_programs_rule(name):
    from ofdm_tpu_torch.ops import link_kernel as lk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    config = _config(name)
    runner = LinkRunner(prepare(program.simulation_config(config, 1 << 17), program.channel_ir(config)), "cpu")
    est = config["estimator"]
    link = runner.link
    assert runner.mode == {"headline_64sc": "diag", "pod_1024sc": "lr"}[name]
    assert (link.tile_cap, link.slice, link.pstride, link.txext) == (
        est["power_tile_cap"], est["power_slice_symbols"], est["papr_tile_stride"], est["papr_sampled_tx"])
    assert lk.tile_for(1 << 17, link.tile_cap) == min(est["power_tile_cap"], 8192)
    if runner.mode == "lr":
        assert float(max(link.cc_r.abs().max(), link.cc_i.abs().max())) < 1e-12  # the guard covers the channel
        assert lrk.lr_factors(runner.setup).E == 7


def test_philox_matches_the_published_vectors():
    """Philox4x32-10 known-answer tests (Random123's kat_vectors)."""
    import torch

    link = spec.load_module(os.path.join(BENCH_DIR, "reference", "ofdm_link.py"))
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    out = link.philox(t(0), t(0), t(0), t(0), (0, 0))
    assert [int(o) for o in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    M = 0xFFFFFFFF
    out = link.philox(t(M), t(M), t(M), t(M), (M, M))
    assert [int(o) for o in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
