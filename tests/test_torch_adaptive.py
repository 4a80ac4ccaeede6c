"""Adaptive (CAPACITY_BASED) loading in the port against the JAX package.

* Host setup, exactly: the gap-function bit loading (QAM and PSK), the
  adaptive mapper and its index mask, ``prepare``'s adaptive branch on the
  reference's adaptive config, and the carry of an adaptive setup across
  packages; docs/RESULTS.md:61-67's published setup.
* The slice end to end: the reference's adaptive config through the port's
  runner on the CPU against the JAX runner's XLA path, statistically, and
  the sampled-TX PAPR of a 512-subcarrier adaptive lr link.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import adaptive as jad
from ofdm_tpu.ops import mapping as jmap
from ofdm_tpu.ops import metrics as jmt
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import convert
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import adaptive as tad
from ofdm_tpu_torch.ops import mapping as tmap
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTIVE_JSON = os.path.join(REPO, "config", "simulation_settings_adaptive.json")
# docs/RESULTS.md:61-67: the reference's adaptive setup at 20 dB
RESULTS_WATER_LEVEL = 1.020873477957
RESULTS_BITS = 230
RESULTS_ORDERS = [16] * 19 + [4] * 13 + [16] * 32


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(pkg, snr_db, **kw):
    """The reference's adaptive config (its 20 dB entry) at ``snr_db``, in
    package ``pkg``'s config."""
    cfg = {c.snr_db: c for c in pkg.SimulationConfig.from_json(ADAPTIVE_JSON)}[20.0]
    return cfg.replace(snr_db=snr_db, **kw)


@pytest.mark.parametrize("kind", ["QAM", "PSK"])
def test_bit_loading_orders_equal_jax(kind):
    # per-subcarrier SNRs from -20 to 45 dB, zero, and 36 dB flat fading
    snr = np.concatenate([10.0 ** (np.linspace(-20.0, 45.0, 1301) / 10.0), [0.0, 1e-12, 10.0 ** 3.6]])
    for ser in (1e-3, 1e-5, 0.05):
        a = jmap.bit_loading_orders(kind, ser, snr)
        b = tmap.bit_loading_orders(kind, ser, snr)
        # exactly, orders above any configured maximum included
        assert b.dtype == np.int64 and np.array_equal(a, b)
    assert tmap.bit_loading_orders("QAM", 1e-3, np.array([10.0 ** 3.6]))[0] == 1024


MAPPER_CASES = {
    "reference_15db_inactive": ("QAM", 15.0),
    "reference_20db": ("QAM", 20.0),
    "psk_10db_inactive": ("PSK", 10.0),
    "psk_25db": ("PSK", 25.0),
}


@pytest.mark.parametrize("kind,snr_db", MAPPER_CASES.values(), ids=list(MAPPER_CASES))
def test_mapper_mask_and_table_encode_equal_jax(kind, snr_db):
    js = jpl.prepare(_reference(jcfg, snr_db, constellation_type=kind))
    ts = tpl.prepare(_reference(tcfg, snr_db, constellation_type=kind))
    a, b = js.amap, ts.amap
    assert (a.kind, a.max_order) == (b.kind, b.max_order)
    for f in ("orders", "bits_per_subcarrier", "tables", "group_id", "composite_constellation"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.bits_per_ofdm_symbol == b.bits_per_ofdm_symbol
    ma, mb = jad.index_mask(a), tad.index_mask(b)
    assert mb.dtype == np.uint32 and np.array_equal(ma, mb)
    assert np.array_equal(js.constellation_points, ts.constellation_points)
    # indices under the per-subcarrier mask, then each subcarrier's table
    idx = prng.uniform_indices((5, 6), (512, 64), mb, "cpu")
    assert (idx.numpy() <= mb.astype(np.int64)).all() and (idx.numpy()[:, mb == 0] == 0).all()
    sj = np.asarray(jad.encode_from_indices(jnp.asarray(idx.numpy()), a))
    sr, si = tad.encode_from_indices(idx, b)
    assert np.array_equal(sj.real, sr.numpy()) and np.array_equal(sj.imag, si.numpy())


@pytest.mark.parametrize("snr_db", [15.0, 20.0, 25.0])
@pytest.mark.parametrize("allocation", ["WATERFILLING", "UNIFORM"])
def test_prepare_adaptive_equals_jax(snr_db, allocation):
    js = jpl.prepare(_reference(jcfg, snr_db, power_allocation_type=allocation))
    ts = tpl.prepare(_reference(tcfg, snr_db, power_allocation_type=allocation))
    assert ts.const is None and ts.is_adaptive
    # orders exactly; powers and the water level to 1e-12
    assert np.array_equal(js.constellation_orders, ts.constellation_orders)
    assert ts.constellation_orders.dtype == np.int64
    np.testing.assert_allclose(ts.power_allocation, js.power_allocation, rtol=0, atol=1e-12)
    if allocation == "WATERFILLING":
        assert abs(ts.water_level - js.water_level) <= 1e-12
    else:
        assert ts.water_level is None and js.water_level is None
    for f in ("num_ofdm_symbols", "bits_per_ofdm_symbol", "total_bits", "prefix_length", "noise_power"):
        assert getattr(ts, f) == getattr(js, f), f
    runner = tpl.LinkRunner(ts, device="cpu")
    assert runner.mode == "diag" and runner.link.q.mode == "aqam"
    assert runner.point_params(snr_db)[1] == ts.water_level


def test_results_md_adaptive_setup():
    ts = tpl.prepare(_reference(tcfg, 20.0))
    assert abs(ts.water_level - RESULTS_WATER_LEVEL) <= 1e-12
    assert ts.bits_per_ofdm_symbol == RESULTS_BITS
    assert ts.constellation_orders.tolist() == RESULTS_ORDERS
    # num_bits floors to whole OFDM symbols
    by_bits = tpl.prepare(_reference(tcfg, 20.0, num_symbols=None, num_bits=230 * 100 + 229))
    assert by_bits.num_ofdm_symbols == 100 and by_bits.total_bits == 230 * 100


def test_adaptive_setup_round_trip():
    js = jpl.prepare(_reference(jcfg, 15.0))
    ts = tpl.prepare(_reference(tcfg, 15.0))
    for src in (js, ts):
        back = convert.setup_from_arrays(ts.cfg, convert.setup_to_arrays(src))
        assert back.const is None and np.array_equal(back.amap.tables, ts.amap.tables)
        assert np.array_equal(back.constellation_orders, ts.constellation_orders)
        assert back.water_level == ts.water_level and back.total_bits == ts.total_bits
        assert np.array_equal(back.power_allocation, ts.power_allocation)


def mean_papr_db(port_setup, jax_runner, seeds=32):
    """Mean papr_db of ``seeds`` runs in each package.  One run's PAPR peak
    spreads by ~0.38 dB sd (64 seeds a side on the reference's adaptive link
    at 2^12 symbols, noise off; a little more at 2^10), so 32 runs a side put
    ~0.1 dB sd on the difference of the means."""
    runner = tpl.LinkRunner(port_setup, device="cpu")
    port = np.mean([runner.run(s)["papr_db"] for s in range(seeds)])
    return port, np.mean([jax_runner.run(jax.random.PRNGKey(s))["papr_db"] for s in range(seeds)])


def test_adaptive_slice_end_to_end_matches_jax_runner():
    B = 1 << 13
    port = tpl.LinkRunner(tpl.prepare(_reference(tcfg, 20.0, num_symbols=B)), device="cpu").run(0)
    ref = jpl.LinkRunner(jpl.prepare(_reference(jcfg, 20.0, num_symbols=B))).run(jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and ref["hotpath_used"] == "xla"
    for k in ("total_bits", "constellation_order_per_subcarrier", "water_level", "allocated_power",
              "adaptive_modulation_mode", "papr_estimator"):
        assert port[k] == ref[k], k
    assert port["bit_errors"] > 100
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"], ref["total_bits"], z=4)
    quiet = dict(num_symbols=1 << 10, noise_type="NONE")  # PAPR is TX-side
    port_db, ref_db = mean_papr_db(tpl.prepare(_reference(tcfg, 20.0, **quiet)),
                                   jpl.LinkRunner(jpl.prepare(_reference(jcfg, 20.0, **quiet))))
    assert abs(port_db - ref_db) < 0.3


def test_adaptive_sampled_papr_matches_jax_runner():
    kw = dict(num_symbols=2048, num_subcarriers=512, channel_type="CUSTOM", channel_model="severe_multipath",
              prefix_type="ZERO", prefix_length_ratio=0.5, power_allocation_type="WATERFILLING",
              adaptive_modulation_mode="CAPACITY_BASED", snr_db=20.0)
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    assert runner.mode == "lr" and runner.link.txext
    assert int((runner.setup.amap.orders == 0).sum()) == 0
    r = runner.run(0)
    assert r["papr_estimator"] == "sampled_tx" and r["papr_sample_fraction"] == 1.0
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw)))
    peak, total, count = jr._papr_sample()
    assert count == runner._papr_sample()[2]
    # two fixed-seed batches of ~1.06M samples from different generators: the
    # peak statistic's spread, ~0.45 dB on this link family (test_torch_lr.py)
    assert abs(r["papr_db"] - jmt.papr_db(peak, total, count)) < 0.45


def test_adaptive_scfde_and_snr_override_raise():
    # adaptive SC-FDE runs on the fold kernel (its plain version on the
    # CPU), with the XLA path's semantics: lane t's order demaps time sample t
    sc = tpl.prepare(_reference(tcfg, 20.0, num_symbols=16, modulation_type="SC-OFDM"))
    sc_runner = tpl.LinkRunner(sc, device="cpu")
    assert sc_runner.mode == "fold" and sc_runner.run(0)["hotpath_used"] == "torch"
    runner = tpl.LinkRunner(tpl.prepare(_reference(tcfg, 20.0, num_symbols=16)), device="cpu")
    with pytest.raises(ValueError, match="SNR-dependent"):
        runner.run(0, snr_db=25.0)
    assert runner.run(0, snr_db=20.0)["snr_db"] == 20.0
