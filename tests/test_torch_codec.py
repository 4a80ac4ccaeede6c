"""The port's arithmetic codec and noise chain against the JAX kernel's own helpers.

The JAX functions are the Pallas kernel's (pallas_link._encode_tile,
_cossin_u24, _demap_tile), run as plain jax ops on the CPU, on the same
seeded numpy words as the port's plain versions.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu.config import EqualizationMethod
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch.ops import link_kernel as lk

RNG_SEED = 20260
N_WORDS = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # With JAX's CPU runtime in the same process, torch's multi-threaded
    # CPU kernels were seen to compute float32 log with ~4e-5 relative
    # error on one worker thread's share of a plane; on one thread torch's
    # log stays within 1 ulp.  The comparisons here are at the ulp level.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def words():
    w = np.random.default_rng(RNG_SEED).integers(0, 1 << 32, size=N_WORDS, dtype=np.uint64)
    return w.astype(np.uint32)


def _spec(order, gray=True):
    # the fields of pallas_link._Spec that the qam codec reads
    return types.SimpleNamespace(
        mode="qam", order=order, is_gray=gray, bits=order.bit_length() - 1,
        method=EqualizationMethod.MMSE,
    )


@pytest.mark.parametrize("order,gray", [(o, True) for o in (4, 16, 64, 256, 1024)] + [(64, False)])
def test_encode_equals_jax(words, order, gray):
    tx_j, sr_j, si_j = pk._encode_tile(_spec(order, gray), jnp.asarray(words.view(np.int32)), None)
    q = lk.Qam.of(order, "gray" if gray else "none")
    tx_t, sr_t, si_t = lk.qam_encode(torch.from_numpy(words.astype(np.int64)), q)
    assert np.array_equal(np.asarray(tx_j), tx_t.numpy())
    assert np.array_equal(np.asarray(sr_j, np.float32), sr_t.numpy())
    assert np.array_equal(np.asarray(si_j, np.float32), si_t.numpy())


def test_cossin_u24_matches_jax(words):
    u = (words >> 8) & 0xFFFFFF
    cj, sj = pk._cossin_u24(jnp.asarray(u.astype(np.int32)))
    ct, st = lk.cossin_u24(torch.from_numpy(u.astype(np.int64)))
    assert np.abs(np.asarray(cj, np.float32) - ct.numpy()).max() <= 2e-7
    assert np.abs(np.asarray(sj, np.float32) - st.numpy()).max() <= 2e-7
    theta = 2.0 * np.pi * u.astype(np.float64) / 2.0**24
    assert np.abs(np.cos(theta) - ct.numpy()).max() < 1e-6


def test_boxmuller_chain_matches_jax(words):
    w1 = words
    w2 = np.roll(words, 1)
    u1_j = jnp.maximum(((jnp.asarray(w1.view(np.int32)) >> 8) & 0xFFFFFF).astype(jnp.float32)
                       * np.float32(pk._INV_2_24), np.float32(pk._INV_2_24))
    rad_j = jnp.sqrt(np.float32(-2.0) * jnp.log(u1_j))
    co_j, si_j = pk._cossin_u24((jnp.asarray(w2.view(np.int32)) >> 8) & 0xFFFFFF)
    u1_t = lk.uniform24_floored(torch.from_numpy(w1.astype(np.int64)))
    rad_t = torch.sqrt(-2.0 * torch.log(u1_t))
    co_t, si_t = lk.cossin_u24((torch.from_numpy(w2.astype(np.int64)) >> 8) & 0xFFFFFF)
    assert np.array_equal(np.asarray(u1_j, np.float32), u1_t.numpy())
    for zj, zt in ((rad_j * co_j, rad_t * co_t), (rad_j * si_j, rad_t * si_t)):
        assert np.abs(np.asarray(zj, np.float32) - zt.numpy()).max() <= 1e-6
    assert float(rad_t.max()) <= 5.77 + 1e-4


@pytest.mark.parametrize("order,gray", [(o, True) for o in (4, 16, 64, 256, 1024)] + [(16, False)])
def test_demap_equals_jax(order, gray):
    rng = np.random.default_rng(order)
    m = int(np.sqrt(order))
    pts = rng.uniform(-m / 2 - 1, m / 2 + 1, size=(2, 1 << 16)).astype(np.float32)
    # dead-bin magnitudes, exact half-way points and the grid edges
    pts[:, :8] = np.array([[1e10, -1e10, 3e9, 0.5, -0.5, (m - 1) / 2, -(m - 1) / 2, 2.5],
                           [-1e10, 1e10, -3e9, 1.5, -1.5, (m - 1) / 2, 0.0, -2.5]], np.float32)
    rx_j = pk._demap_tile(_spec(order, gray), jnp.asarray(pts[0]), jnp.asarray(pts[1]), None)
    rx_t = lk.qam_demap(torch.from_numpy(pts[0]), torch.from_numpy(pts[1]),
                        lk.Qam.of(order, "gray" if gray else "none"))
    assert np.array_equal(np.asarray(rx_j), rx_t.numpy())


@pytest.mark.parametrize("order", [4, 64, 1024])
def test_encode_demap_round_trip(order):
    q = lk.Qam.of(order)
    raw = torch.arange(order, dtype=torch.int64)
    tx, sr, si = lk.qam_encode(raw, q)
    slicer = float(np.float32(0.5) / np.float32(q.scale))
    assert torch.equal(lk.qam_demap(sr * slicer, si * slicer, q), tx)


def test_metrics_match_jax():
    from ofdm_tpu.ops import metrics as jmt
    from ofdm_tpu_torch.ops import metrics as tmt

    rng = np.random.default_rng(99)
    tx = rng.integers(0, 1024, size=50000).astype(np.int32)
    rx = np.where(rng.random(50000) < 0.1, rng.integers(0, 1024, size=50000), tx).astype(np.int32)
    assert int(tmt.index_bit_errors(torch.from_numpy(tx), torch.from_numpy(rx))) == int(
        jmt.index_bit_errors(jnp.asarray(tx), jnp.asarray(rx), 10))
    assert int(tmt.symbol_errors(torch.from_numpy(tx), torch.from_numpy(rx))) == int(
        jmt.symbol_errors(jnp.asarray(tx), jnp.asarray(rx)))
    x = (rng.standard_normal((64, 67)) + 1j * rng.standard_normal((64, 67))).astype(np.complex64)
    pk_t, sum_t, n_t = tmt.papr_stats(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    pk_j, sum_j, n_j = jmt.papr_stats(jnp.asarray(x))
    assert n_t == n_j and float(pk_t) == pytest.approx(float(pk_j), rel=1e-6)
    assert float(sum_t) == pytest.approx(float(sum_j), rel=1e-6)
    assert tmt.papr_db(4.0, 10.0, 5) == jmt.papr_db(4.0, 10.0, 5)
    for e, b in ((0, 100), (17, 10**6), (10**5, 10**6)):
        assert tmt.ber_confidence_interval(e, b) == jmt.ber_confidence_interval(e, b)
    assert tmt.popcount(torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001])).tolist() == [0, 1, 32, 2]


# --- the PSK and adaptive codecs (pallas_link._encode_tile / _demap_tile /
# psk_sector_arith(_vec) with the rows of _consts_for) --------------------------


def _mode_spec(mode, bits, order=0, gray=True):
    # the fields of pallas_link._Spec that the codec reads
    return types.SimpleNamespace(mode=mode, order=order, is_gray=gray, bits=bits,
                                 method=EqualizationMethod.MMSE)


PSK_CASES = [(o, True) for o in (2, 4, 8, 16, 64, 1024)] + [(8, False)]


@pytest.mark.parametrize("order,gray", PSK_CASES)
def test_psk_encode_equals_jax(words, order, gray):
    w = words[: 1 << 16]
    spec = _mode_spec("psk", order.bit_length() - 1, order, gray)
    tx_j, sr_j, si_j = pk._encode_tile(spec, jnp.asarray(w.view(np.int32)), None)
    c = lk.Codec.psk(order, "gray" if gray else "none")
    tx_t, sr_t, si_t = lk.encode(torch.from_numpy(w.astype(np.int64)), c)
    # indices exactly, points bit for bit
    assert np.array_equal(np.asarray(tx_j), tx_t.numpy())
    assert np.array_equal(np.asarray(sr_j, np.float32), sr_t.numpy())
    assert np.array_equal(np.asarray(si_j, np.float32), si_t.numpy())


@pytest.mark.parametrize("order,gray", PSK_CASES)
def test_psk_encoder_points_are_the_table(order, gray):
    from ofdm_tpu_torch.ops.mapping import psk_constellation

    coding = "gray" if gray else "none"
    tx, sr, si = lk.encode(torch.arange(order, dtype=torch.int64), lk.Codec.psk(order, coding))
    table = psk_constellation(order, coding).table
    # the cos/sin lattice against the f64 table: within 1e-6
    assert np.abs(sr.numpy() + 1j * si.numpy() - table[tx.numpy()]).max() < 1e-6


def _near_sector_boundaries(rng, order, count):
    """Points on the unit circle and scaled, half of them within a few ulp of
    a sector boundary, plus the axes and zero."""
    k = rng.integers(0, 2 * order, size=count)
    ang = (k + 0.5 * (k % 2 == 0)) * np.pi / order  # boundaries and sector centres
    ang = ang + rng.choice([-1, 1], size=count) * rng.integers(0, 4, size=count) * 1e-7
    r = rng.uniform(0.05, 3.0, size=count)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)]).astype(np.float32)
    pts[:, :6] = np.array([[0.0, -0.0, 1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 1.0, -1.0]], np.float32)
    return pts


@pytest.mark.parametrize("order,gray", PSK_CASES)
def test_psk_demap_equals_jax(order, gray):
    rng = np.random.default_rng(order + gray)
    pts = np.concatenate([_near_sector_boundaries(rng, order, 1 << 15),
                          rng.standard_normal((2, 1 << 15)).astype(np.float32)], axis=1)
    spec = _mode_spec("psk", order.bit_length() - 1, order, gray)
    rx_j = pk._demap_tile(spec, jnp.asarray(pts[0]), jnp.asarray(pts[1]), None)
    rx_t = lk.demap(torch.from_numpy(pts[0]), torch.from_numpy(pts[1]), lk.Codec.psk(order, "gray" if gray else "none"))
    assert np.array_equal(np.asarray(rx_j), rx_t.numpy())
    sector = np.asarray(pk.psk_sector_arith(jnp.asarray(pts[0]), jnp.asarray(pts[1]), order))
    assert np.array_equal(sector, lk.psk_sector(torch.from_numpy(pts[0]), torch.from_numpy(pts[1]), order).numpy())


def _adaptive_setups(kind, snr_db, channel="severe_multipath"):
    """The JAX and port setups of a 64-sc adaptive link, and the JAX runner."""
    from ofdm_tpu import config as jcfg
    from ofdm_tpu import pipeline as jpl
    from ofdm_tpu_torch import config as tcfg
    from ofdm_tpu_torch import pipeline as tpl

    kw = dict(num_symbols=1024, num_subcarriers=64, channel_type="CUSTOM", channel_model=channel,
              constellation_type=kind, power_allocation_type="WATERFILLING",
              adaptive_modulation_mode="CAPACITY_BASED", snr_db=snr_db, equalization_method="ZF")
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    return jr, tpl.prepare(tcfg.SimulationConfig(**kw))


def jax_lane_rows(jr, spec):
    """The adaptive lane rows of pallas_link._consts_for, unpacked: the last
    five (aqam) or six (apsk) constants."""
    consts = pk._consts_for(jr, spec)
    k = 5 if spec.mode == "aqam" else 6
    return [np.asarray(c)[0, : spec.n] for c in consts[-k:]]


# orders 4/16/64; 0 (8 inactive lanes)/4/16; 2/4/8/16; 0 (8 inactive)/2/4;
# 1024 (above the config's 256)
ADAPTIVE_CASES = {
    "aqam_severe_20db": ("QAM", 20.0, "severe_multipath"),
    "aqam_p1_15db_inactive": ("QAM", 15.0, "Lin-Phoong_P1"),
    "apsk_p1_20db": ("PSK", 20.0, "Lin-Phoong_P1"),
    "apsk_p1_10db_inactive": ("PSK", 10.0, "Lin-Phoong_P1"),
    "aqam_1024qam_flat_36db": ("QAM", 36.0, "flat_fading"),
}


@pytest.mark.parametrize("kind,snr_db,channel", ADAPTIVE_CASES.values(), ids=list(ADAPTIVE_CASES))
def test_adaptive_codec_equals_jax(words, kind, snr_db, channel):
    jr, ts = _adaptive_setups(kind, snr_db, channel)
    spec = pk._spec_for(jr, 1024, True)
    codec, _ = lk.codec_for(ts, "cpu")
    assert (codec.mode, codec.bits) == (spec.mode, spec.bits)
    rows = jax_lane_rows(jr, spec)
    # the lane rows exactly: aqam [mask, m, log2 m, scale, slicer], apsk
    # [mask, order, log2 order, amplitude, cos(pi/M), sin(pi/M)]
    k = 3
    assert all(np.array_equal(codec.irows[i].numpy(), rows[i]) for i in range(k))
    assert all(np.array_equal(codec.frows[i].numpy(), rows[k + i]) for i in range(len(rows) - k))
    if channel == "flat_fading":
        # the loader exceeds max_constellation_order; the width covers it
        assert int(ts.amap.orders.max()) == 1024 and codec.bits == 10
    w = words[: 1 << 16].reshape(-1, 64)
    aq_enc = (rows[0], rows[1], rows[2], rows[3]) if kind == "QAM" else (rows[0], rows[2], rows[3])
    tx_j, sr_j, si_j = pk._encode_tile(spec, jnp.asarray(w.view(np.int32)), tuple(jnp.asarray(r) for r in aq_enc))
    tx_t, sr_t, si_t = lk.encode(torch.from_numpy(w.astype(np.int64)), codec)
    assert np.array_equal(np.asarray(tx_j), tx_t.numpy())
    assert np.array_equal(np.asarray(sr_j, np.float32), sr_t.numpy())
    assert np.array_equal(np.asarray(si_j, np.float32), si_t.numpy())
    # demap: the encoded points moved by noise, in slicer units for aqam
    rng = np.random.default_rng(7)
    gain = rows[4] if kind == "QAM" else np.float32(1.0)
    er = (np.asarray(sr_j) + 0.35 * rng.standard_normal(w.shape).astype(np.float32)) * gain
    ei = (np.asarray(si_j) + 0.35 * rng.standard_normal(w.shape).astype(np.float32)) * gain
    er, ei = er.astype(np.float32), ei.astype(np.float32)
    aq_dec = (rows[1], rows[2]) if kind == "QAM" else (rows[1], rows[4], rows[5])
    rx_j = pk._demap_tile(spec, jnp.asarray(er), jnp.asarray(ei), tuple(jnp.asarray(r) for r in aq_dec))
    rx_t = lk.demap(torch.from_numpy(er), torch.from_numpy(ei), codec)
    assert np.array_equal(np.asarray(rx_j), rx_t.numpy())
    active = ts.amap.orders > 0
    assert bool(active.all()) == (snr_db not in (10.0, 15.0))
    # inactive lanes send 0 and decode to index 0: no errors, no bits
    assert (rx_t.numpy()[:, ~active] == 0).all() and (tx_t.numpy()[:, ~active] == 0).all()
    assert (sr_t.numpy()[:, ~active] == 0).all() and (si_t.numpy()[:, ~active] == 0).all()
