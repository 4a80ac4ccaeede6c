"""The port's eager chain (pipeline.eager_chunk and its ops) against the JAX package.

* Each op module against its JAX function on the same numpy inputs:
  ofdm (DFTs, guards, framing), channel (stream convolution with its carry
  across two chunks, AWGN on given normals), equalize, mapping and adaptive
  hard decisions, metrics.  Planes within 1e-5 relative, indices exact.
* ``chunk_body`` (planar engine, hotpath "xla") against the eager chain on
  the same injected draws: the JAX package's PRNG is monkeypatched in this
  test only.
* The runner's BER against the JAX XLA runner within z = 5.
* The draws: the eager TX words equal ``link_words``' word 0, the K4 plane
  form equals Philox, and K5's plain version passes bench.py's moment gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import adaptive as jad
from ofdm_tpu.ops import channel as jch
from ofdm_tpu.ops import cplx
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import equalize as jeq
from ofdm_tpu.ops import framing as jfr
from ofdm_tpu.ops import mapping as jmp
from ofdm_tpu.ops import metrics as jmt
from ofdm_tpu.ops import ofdm as jofdm
from ofdm_tpu.ops import prng as jprng
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import adaptive as tad
from ofdm_tpu_torch.ops import channel as tch
from ofdm_tpu_torch.ops import equalize as teq
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import mapping as tmp
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import ofdm as tofdm
from ofdm_tpu_torch.ops import prng

HEADLINE = dict(num_symbols=64 * 1024, num_subcarriers=64, constellation_order=64, channel_type="CUSTOM",
                channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                equalization_method="MMSE", snr_db=30.0)
# chunk_body's links: the headline, SC-FDE ZF, ZP OFDM, 8-PSK and an
# adaptive link with both power switches.
CHAIN_LINKS = {
    "headline": {},
    "scfde_zf": dict(modulation_type="SC-OFDM", constellation_order=4, channel_model="Lin-Phoong_P1",
                     equalization_method="ZF", snr_db=10.0),
    "zp_ofdm": dict(prefix_type="ZERO"),
    "psk8": dict(constellation_type="PSK", constellation_order=8, channel_model="severe_multipath", snr_db=15.0),
    "adaptive_wf_switches": dict(adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING",
                                 snr_db=20.0, apply_power_allocation=True, normalize_before_demap=True),
    # per-bin adaptive tables decoded after the SC IDFT, as the XLA path does
    "adaptive_scfde": dict(adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING",
                           modulation_type="SC-OFDM", snr_db=20.0),
}
# Links on the eager chain (two of tools/shape_audit.py's shapes, cut in
# symbols and taken to 20 dB, where so few symbols see errors) and the
# headline forced onto it.
BAND_LINKS = {
    "headline_xla": (dict(hotpath="xla"), 1 << 12),
    # the audit's 512-sc ISI-free shape routes to the wide diag kernel: its
    # eager chain is asked for by hotpath, as JAX's XLA path is
    "OFDM-CY1.0-512": (dict(num_subcarriers=512, channel_model="severe_multipath", snr_db=20.0, hotpath="xla"),
                       1 << 9),
    # as is the audit's zero-prefix SC-FDE shape since its wide mm kernel
    "SC-ZE1.0-1024": (dict(num_subcarriers=1024, channel_model="severe_multipath", modulation_type="SC-OFDM",
                           prefix_type="ZERO", snr_db=20.0, hotpath="xla"), 1 << 8),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("prefix", ["CYCLIC", "ZERO", "NONE"])
def test_ofdm_ops_match_jax(prefix):
    rng = np.random.default_rng(1)
    x = _cplx(rng, (8, 64))
    p = tcfg.PrefixType(prefix)
    jp = jcfg.PrefixType(prefix)
    t = torch.from_numpy(x)
    _close(tofdm.fft_ortho(t, 64), jdft.fft_ortho(jnp.asarray(x), 64))
    _close(tofdm.ifft_ortho(t, 64), jdft.ifft_ortho(jnp.asarray(x), 64))
    tx = tofdm.ofdm_modulate(t, 64, p, 16)
    _close(tx, jofdm.ofdm_modulate(jnp.asarray(x), 64, jp, 16))
    _close(tofdm.sc_modulate(t, p, 16), jofdm.sc_modulate(jnp.asarray(x), jp, 16))
    blocks = _cplx(rng, (8, 64 + (0 if prefix == "NONE" else 16)))
    _close(tofdm.ofdm_demodulate_to_freq(torch.from_numpy(blocks), 64, p, 16),
           jofdm.ofdm_demodulate_to_freq(jnp.asarray(blocks), 64, jp, 16))
    _close(tofdm.sc_demodulate_from_freq(t, 64), jofdm.sc_demodulate_from_freq(jnp.asarray(x), 64))
    stream = t.reshape(-1)
    assert torch.equal(tofdm.to_parallel(stream, 64), t)
    assert np.array_equal(np.asarray(jfr.to_parallel(jnp.asarray(x).reshape(-1), 64)), x)
    assert torch.equal(tofdm.to_serial(t), stream)
    with pytest.raises(ValueError):
        tofdm.to_parallel(stream, 7)


def test_channel_carry_and_awgn_match_jax():
    rng = np.random.default_rng(2)
    taps = _cplx(rng, (5,))
    a, b = _cplx(rng, (6, 20)), _cplx(rng, (4, 20))
    ja, jcarry = jch.convolve_blocks(jnp.asarray(a), jnp.asarray(taps))
    jb, jcarry2 = jch.convolve_blocks(jnp.asarray(b), jnp.asarray(taps), jcarry)
    ta, carry = tch.convolve_blocks(torch.from_numpy(a), torch.from_numpy(taps))
    tb, carry2 = tch.convolve_blocks(torch.from_numpy(b), torch.from_numpy(taps), carry)
    for p, r in ((ta, ja), (carry, jcarry), (tb, jb), (carry2, jcarry2)):
        _close(p, r)
    # two chunks with the carry equal one stream convolution
    full = np.convolve(np.concatenate([a.ravel(), b.ravel()]), taps)[: a.size + b.size]
    _close(torch.cat([ta, tb]).reshape(-1), full, rtol=1e-4, atol=1e-5)
    z0, z1 = rng.standard_normal((2, 6, 20)).astype(np.float32)
    sig = cplx.from_complex(jnp.asarray(a))
    ref = jch.awgn.__wrapped__ if hasattr(jch.awgn, "__wrapped__") else jch.awgn
    orig = jprng.normal_planes
    jprng.normal_planes = lambda key, shape: (jnp.asarray(z0), jnp.asarray(z1))
    try:
        jy = cplx.to_numpy(ref(jax.random.PRNGKey(0), sig, 17.0))
    finally:
        jprng.normal_planes = orig
    _close(tch.awgn(torch.from_numpy(a), 17.0, (torch.from_numpy(z0), torch.from_numpy(z1))), jy)
    y, c = tch.transmit(torch.from_numpy(a), torch.from_numpy(taps[:1]), 17.0, add_noise=False)
    assert c.numel() == 0
    _close(y, taps[0] * a)


@pytest.mark.parametrize("method", ["ZF", "MMSE", "NONE"])
def test_equalize_matches_jax(method):
    rng = np.random.default_rng(3)
    rx = _cplx(rng, (16, 64))
    h = _cplx(rng, (64,))
    h[5] = 0  # ZF's eps
    got = teq.equalize(torch.from_numpy(rx), torch.from_numpy(h), tcfg.EqualizationMethod(method), 12.0)
    ref = jeq.equalize(jnp.asarray(rx), jnp.asarray(h), jcfg.EqualizationMethod(method), 12.0)
    if method == "ZF":
        got, ref = np.delete(np.asarray(got), 5, axis=1), np.delete(np.asarray(ref), 5, axis=1)
    _close(got, ref)


@pytest.mark.parametrize("kind,order,coding", [("QAM", 16, "gray"), ("QAM", 256, "gray"), ("QAM", 64, "none"),
                                               ("PSK", 8, "gray"), ("PSK", 32, "none")])
def test_mapping_matches_jax(kind, order, coding):
    rng = np.random.default_rng(4)
    tc, jc = tmp.make_constellation(kind, order, coding), jmp.make_constellation(kind, order, coding)
    idx = rng.integers(0, order, size=(32, 16)).astype(np.int32)
    _close(tmp.encode_indices(torch.from_numpy(idx), tc), jmp.encode_indices(jnp.asarray(idx), jc))
    y = (tc.table[idx] + 0.3 * _cplx(rng, idx.shape)).astype(np.complex64)
    got = tmp.decode_hard(torch.from_numpy(y), tc).numpy()
    assert np.array_equal(got, np.asarray(jmp.decode_hard(jnp.asarray(y), jc)))
    assert np.array_equal(tmp.decode_hard(torch.from_numpy(tc.table.astype(np.complex64)), tc).numpy(),
                          np.arange(order))


@pytest.mark.parametrize("kind", ["QAM", "PSK"])
def test_adaptive_decode_matches_jax(kind):
    orders = np.array([0, 4, 16, 64, 4, 0, 256, 16] * 2)
    tm, jm = tad.make_adaptive_mapper(kind, orders), jad.make_adaptive_mapper(kind, orders)
    rng = np.random.default_rng(5)
    idx = (rng.integers(0, 1 << 16, size=(40, 16)) & jad.index_mask(jm)).astype(np.int32)
    clean = tad.encode_complex(torch.from_numpy(idx), tm)
    _close(clean, jad.encode_from_indices(jnp.asarray(idx), jm))
    y = (clean.numpy() + 0.05 * _cplx(rng, idx.shape)).astype(np.complex64)
    got = tad.decode_to_indices(torch.from_numpy(y), tm, rows=16).numpy()
    _, ref = jad.decode(jnp.asarray(y), jm)
    assert np.array_equal(got, np.asarray(ref))


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    tx = rng.integers(0, 64, size=(50, 16)).astype(np.int32)
    rx = rng.integers(0, 64, size=(50, 16)).astype(np.int32)
    for bits in (6, 8):
        assert int(tmt.index_bit_errors(torch.from_numpy(tx), torch.from_numpy(rx), bits)) == int(
            jmt.index_bit_errors(jnp.asarray(tx), jnp.asarray(rx), bits))
    x = _cplx(rng, (8, 80))
    peak, total, count = tmt.papr_stats(torch.from_numpy(x))
    jpeak, jtotal, jcount = jmt.papr_stats(jnp.asarray(x))
    assert count == jcount and float(peak) == pytest.approx(float(jpeak), rel=1e-6)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)


def _draws(setup, B, rng):
    mask = jad.index_mask(setup.amap) if setup.is_adaptive else np.uint32(setup.const.order - 1)
    tx = (rng.integers(0, 1 << 32, size=(B, setup.cfg.num_subcarriers), dtype=np.uint64).astype(np.uint32)
          & mask).astype(np.int32)
    z = rng.standard_normal((2, B, setup.block_length)).astype(np.float32)
    return tx, z[0], z[1]


@pytest.mark.parametrize("name", list(CHAIN_LINKS))
def test_chunk_body_matches_eager_chain_on_injected_draws(monkeypatch, name):
    kw = dict(HEADLINE, **CHAIN_LINKS[name])
    B = 128
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="xla")))
    tx, z0, z1 = _draws(jr.setup, B, np.random.default_rng(7))
    monkeypatch.setattr(jprng, "uniform_indices", lambda key, shape, mask: jnp.asarray(tx))
    monkeypatch.setattr(jprng, "normal_planes", lambda key, shape: (jnp.asarray(z0), jnp.asarray(z1)))
    stats, _ = jr.chunk_body(jax.random.PRNGKey(0), jr._init_carry(), B, return_symbols=True)
    jdata = cplx.to_numpy(stats["received_symbols"]).reshape(B, -1)

    ts = tpl.prepare(tcfg.SimulationConfig(**kw))
    link = tpl.eager_link(ts, "cpu")
    acc, psum = lk.new_accumulators("cpu")
    rows = (torch.tensor(np.sqrt(ts.power_allocation)[None], dtype=torch.float32)
            if kw.get("apply_power_allocation") else None)
    _, data = tpl.eager_chunk(link, (0, 0), 0, B, kw["snr_db"], acc, psum, tpl.eager_carry(link), rows,
                              draws=(tx, z0, z1))
    pdata = data.numpy()
    # torch.fft against the JAX package's planar DFT matmuls, both f32
    np.testing.assert_allclose(pdata, jdata, rtol=1e-4, atol=1e-4)
    got = (int(acc[0]), int(acc[1]))
    want = (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    if got != want:
        # a difference is allowed only at points within 1e-4 of a decision
        # boundary: the two packages' points decode differently there
        if ts.is_adaptive:
            prx = tad.decode_to_indices(data, ts.amap).numpy()
            jrx = tad.decode_to_indices(torch.from_numpy(jdata), ts.amap).numpy()
        else:
            prx = tmp.decode_hard(data, ts.const).numpy()
            jrx = tmp.decode_hard(torch.from_numpy(jdata), ts.const).numpy()
        differ = prx != jrx
        assert differ.any() and np.abs(pdata - jdata)[differ].max() < 1e-4
    assert got[0] > 0


@pytest.mark.parametrize("name", list(BAND_LINKS))
def test_eager_ber_matches_jax_xla_runner(name):
    extra, B = BAND_LINKS[name]
    kw = dict(HEADLINE, **extra)
    kw["num_symbols"] = kw["num_subcarriers"] * B
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    assert tpl.kernel_mode(setup) == "eager"
    port = tpl.LinkRunner(setup, device="cpu").run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert ref["hotpath_used"] == "xla" and port["hotpath_used"] == "eager"
    assert port["matmul_passes_used"] == "fp32" and port["papr_estimator"] == "in_run"
    assert port["papr_sample_fraction"] == 1.0 and port["total_bits"] == ref["total_bits"]
    assert port["bit_errors"] > 0
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"], ref["total_bits"], z=5)
    # a peak from another generator: at 512 sc and 512 symbols six seeds a
    # side read 10.76-11.80 dB (port) and 10.70-11.78 dB (JAX)
    assert abs(port["papr_db"] - ref["papr_db"]) < 1.5


def test_eager_chunking_carries_the_stream():
    # noiseless ZF over an ISI-free link decodes every symbol, whatever the chunking
    kw = dict(HEADLINE, num_symbols=64 * 300, noise_type="NONE", equalization_method="ZF", hotpath="xla",
              symbols_per_chunk=128)
    r = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu").run(1)
    assert (r["bit_errors"], r["symbol_errors"]) == (0, 0)
    # the carry is the stream's: a chunked noisy run counts what one chunk counts, but for
    # the per-chunk measured power
    one = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**dict(kw, noise_type="NONE",
                                                                   symbols_per_chunk=0))), device="cpu").run(1)
    assert one["papr_db"] == pytest.approx(r["papr_db"], rel=1e-6)


def test_eager_tx_words_are_the_kernels():
    key = (0x12345678, 0x9ABCDEF0)
    sym0 = (1 << 32) + 5
    raw, _, _ = prng.link_words(key, sym0, 6, 64)
    plane = prng.philox_plane(key, sym0, 6, 64, 0, "cpu")
    assert plane.dtype == torch.int32 and torch.equal(plane.to(torch.int64) & prng.M32, raw)
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(HEADLINE, hotpath="xla", num_symbols=64 * 6)))
    link = tpl.eager_link(setup, "cpu")
    assert torch.equal((prng.philox_plane(key, 0, 6, 64, 0, "cpu") & link.mask).to(torch.int64),
                       prng.link_words(key, 0, 6, 64)[0] & 63)


def test_philox_plane_plain_is_philox():
    key = (7, 11)
    got = prng.philox_plane_plain(key, 3, 4, 5, 9).to(torch.int64) & prng.M32
    b = torch.arange(3, 7, dtype=torch.int64)[:, None]
    c = torch.arange(5, dtype=torch.int64)[None, :]
    w0, _, _, _ = prng.philox4x32_10(b & prng.M32, b >> 32, c, torch.tensor(9), key)
    assert torch.equal(got, w0)
    # the Philox4x32-10 known-answer vector (Salmon et al., counter 0, key 0)
    z = torch.zeros((), dtype=torch.int64)
    assert [int(w) for w in prng.philox4x32_10(z, z, z, z, (0, 0))] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_normal_planes_plain_passes_moment_gate():
    z0, z1 = prng.normal_planes((987654321, 123456789), 0, 1 << 15, 128, prng.AWGN_STREAM, device="cpu")
    assert z0.shape == (1 << 15, 128) and z0.dtype == torch.float32
    a, b = z0.reshape(-1).double(), z1.reshape(-1).double()
    assert abs(float(a.mean())) < 3e-3 and abs(float(a.var(unbiased=False)) - 1.0) < 5e-3
    assert 0.0025 <= float((a.abs() > 3.0).double().mean()) <= 0.0029
    assert 4.0 < max(float(a.abs().max()), float(b.abs().max())) <= 5.78
    assert abs(float((a * b).mean())) < 3e-3
    # plane-addressed: a sub-plane at sym0 > 0 is the same draw
    again = prng.normal_planes((987654321, 123456789), 100, 4, 128, prng.AWGN_STREAM, device="cpu")
    assert torch.equal(again[0], z0[100:104]) and torch.equal(again[1], z1[100:104])
    other = prng.normal_planes((987654321, 123456789), 0, 4, 128, prng.BUMP_STREAM, device="cpu")
    assert not torch.equal(other[0], z0[:4])
