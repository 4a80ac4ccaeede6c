"""Port host setup against the JAX package, exactly in float64.

The port keeps its own copies of the config, channels, constellation,
allocation and matrix builders; each must give the JAX package's values
bit for bit, so both packages simulate the very same link.
"""

import dataclasses

import numpy as np
import pytest

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import mapping as jmap
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import convert
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import linops as tlin
from ofdm_tpu_torch.ops import mapping as tmap

HEADLINE = dict(
    num_symbols=64 * 1024,
    num_subcarriers=64,
    constellation_order=64,
    channel_type="CUSTOM",
    channel_model="Lin-Phoong_P2",
    prefix_type="CYCLIC",
    prefix_length_ratio=1.0,
    equalization_method="MMSE",
    snr_db=30.0,
)

CONFIGS = {
    "headline": {},
    "lin_phoong_p1_zf": dict(channel_model="Lin-Phoong_P1", equalization_method="ZF", snr_db=20.0),
    "flat_fading": dict(channel_model="flat_fading", prefix_length_ratio=0.25),
    "severe_multipath_16qam": dict(
        channel_model="severe_multipath", constellation_order=16, num_symbols=16 * 4096
    ),
    "qam256_none_eq": dict(constellation_order=256, equalization_method="NONE", noise_type="NONE"),
    "waterfilling": dict(power_allocation_type="WATERFILLING", snr_db=12.0),
    "default_channel_num_bits": dict(channel_type="FLAT", channel_model=None, num_symbols=None,
                                     num_bits=6 * 64 * 512),
    "zero_prefix": dict(prefix_type="ZERO"),
    # ISI-free past the 256-subcarrier warp layout: the eager chain until the
    # block-per-symbol diag kernel (ROADMAP item 6b), which takes it now
    "psk_unsupported": dict(constellation_type="PSK", constellation_order=8, num_subcarriers=384,
                            num_symbols=384 * 16),
}

SCALARS = ("noise_power", "prefix_length", "water_level", "num_ofdm_symbols",
           "bits_per_ofdm_symbol", "total_bits")
ARRAYS = ("taps", "h_freq", "channel_gains", "power_allocation", "constellation_orders")


def _both(name):
    kw = dict(HEADLINE, **CONFIGS[name])
    return jpl.prepare(jcfg.SimulationConfig(**kw)), tpl.prepare(tcfg.SimulationConfig(**kw))


def _assert_setup_equal(a, b):
    for f in ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.const.table, b.const.table)
    assert np.array_equal(a.const.inv_index, b.const.inv_index)
    assert a.const.scale == b.const.scale and a.const.coding == b.const.coding


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prepare_equals_jax_exactly(name):
    js, ts = _both(name)
    _assert_setup_equal(js, ts)
    runner = tpl.LinkRunner(ts, device="cpu")
    assert runner.setup is ts
    assert runner.mode == ("mm" if name == "zero_prefix" else "diag")


@pytest.mark.parametrize("name", ["headline", "waterfilling", "qam256_none_eq"])
def test_setup_arrays_round_trip(name):
    js, ts = _both(name)
    from_jax = convert.setup_from_arrays(ts.cfg, convert.setup_to_arrays(js))
    _assert_setup_equal(from_jax, ts)
    _assert_setup_equal(convert.setup_from_arrays(ts.cfg, convert.setup_to_arrays(ts)), ts)


@pytest.mark.parametrize(
    "kind,order,coding",
    [("QAM", o, c) for o in (4, 16, 64, 256, 1024) for c in ("gray", "none")]
    + [("PSK", o, "gray") for o in (2, 4, 8, 16)],
)
def test_constellation_tables_equal(kind, order, coding):
    a = jmap.make_constellation(kind, order, coding)
    b = tmap.make_constellation(kind, order, coding)
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.inv_index, b.inv_index)
    assert a.scale == b.scale


@pytest.mark.parametrize(
    "n,prefix,L",
    [(64, "CYCLIC", 3), (16, "CYCLIC", 0), (32, "NONE", 0), (64, "ZERO", 3), (8, "CYCLIC", 7)],
)
def test_matrix_builders_equal(n, prefix, L):
    jp, tp = jcfg.PrefixType(prefix), tcfg.PrefixType(prefix)
    for mod in ("OFDM", "SC-OFDM"):
        a = jlin.tx_matrix(n, jp, L, jcfg.ModulationType(mod))
        b = tlin.tx_matrix(n, tp, L, tcfg.ModulationType(mod))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(jlin.rx_matrix(n, jp, L), tlin.rx_matrix(n, tp, L)))
    taps = np.array([0.8 + 0.1j, -0.3 + 0.2j, 0.1 - 0.05j, 0.02j])
    assert np.array_equal(jlin.conv_matrix_merged(taps, n + L), tlin.conv_matrix_merged(taps, n + L))
    if prefix != "ZERO":
        assert np.array_equal(jlin.conv_rx_merged(taps, n, jp, L), tlin.conv_rx_merged(taps, n, tp, L))


@pytest.mark.parametrize("name", ["headline", "lin_phoong_p1_zf", "flat_fading"])
def test_diag_response_is_h_freq(name):
    _, ts = _both(name)
    cfg = ts.cfg
    d = tlin.diag_response(ts.taps, cfg.num_subcarriers, cfg.prefix_type, ts.prefix_length)
    # the JAX package's own identity check (pallas_link._consts_for)
    ftx = jlin.tx_matrix(cfg.num_subcarriers, jcfg.PrefixType(cfg.prefix_type.value),
                         ts.prefix_length, jcfg.ModulationType.OFDM)
    cm = jlin.conv_rx_merged(ts.taps, cfg.num_subcarriers, jcfg.PrefixType(cfg.prefix_type.value),
                             ts.prefix_length)
    T = cfg.num_subcarriers + ts.prefix_length
    assert np.array_equal(d, np.einsum("kt,tk->k", ftx[0] + 1j * ftx[1], cm[:T, :]))
    assert np.allclose(d, ts.h_freq, rtol=1e-5, atol=1e-7)


def test_diag_response_rejects_isi():
    taps = np.array([1.0, 0.5, 0.25, 0.1], np.complex128)
    with pytest.raises(ValueError, match="not diagonal"):
        tlin.diag_response(taps, 16, tcfg.PrefixType.CYCLIC, 1)


def test_config_copy_matches():
    ja = {f.name: f.default for f in dataclasses.fields(jcfg.SimulationConfig)}
    tb = {f.name: f.default for f in dataclasses.fields(tcfg.SimulationConfig)}
    assert list(ja) == list(tb)
    assert {k: str(v) for k, v in ja.items()} == {k: str(v) for k, v in tb.items()}
    for enum in ("PrefixType", "EqualizationMethod", "NoiseType", "ModulationType",
                 "ConstellationType", "PowerAllocationType", "AdaptiveModulationMode"):
        assert [m.value for m in getattr(jcfg, enum)] == [m.value for m in getattr(tcfg, enum)]
    with pytest.raises(ValueError):
        tcfg.SimulationConfig(num_symbols=64, num_bits=64)
