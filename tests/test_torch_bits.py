"""The port's bit-level building blocks against the JAX package's, on the CPU.

* Exact: pack / unpack, bits <-> indices, ``mapping.encode``, hard
  decisions, ``bit_errors``, every ``AdaptiveMapper`` table,
  ``adaptive.encode``, the host order and capacity helpers, the channel
  helpers (an ``export_channel_models`` round trip in ``tmp_path``).
* Nearest-neighbour decisions (``mapping.decode_nn``,
  ``adaptive.decode``): exact on points away from the decision boundaries;
  on random points every disagreement is a tie (the two packages' f32
  scores round apart), counted; the same for any block size.
* ``linops.modulate`` / ``convolve`` / ``demodulate`` (the port's f32
  products against the JAX package's bf16x3 split) within 1e-4 of the
  block RMS.
* ``bits.random_bits``: the JAX package's unpacking of the port's own
  Philox words (``jax.random.bits`` monkeypatched in the test only), and a
  5-sigma mean at 2^20 bits, bit 31 of the words on its own.
* examples/overview.py's adaptive chain at 64 sc x 256 OFDM symbols through
  both packages with the bits and the noise injected from one numpy seed:
  equal bit errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu.config import EqualizationMethod as JEq
from ofdm_tpu.config import ModulationType as JMod
from ofdm_tpu.config import PrefixType as JPrefix
from ofdm_tpu.models import channels as jchm
from ofdm_tpu.ops import adaptive as jad
from ofdm_tpu.ops import allocate as jal
from ofdm_tpu.ops import bits as jbits
from ofdm_tpu.ops import channel as jch
from ofdm_tpu.ops import cplx
from ofdm_tpu.ops import equalize as jeq
from ofdm_tpu.ops import framing as jfr
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import mapping as jmp
from ofdm_tpu.ops import metrics as jmt
from ofdm_tpu.ops import ofdm as jofdm
from ofdm_tpu_torch.config import EqualizationMethod, ModulationType, PrefixType
from ofdm_tpu_torch.models import channels as tchm
from ofdm_tpu_torch.ops import adaptive as tad
from ofdm_tpu_torch.ops import allocate as tal
from ofdm_tpu_torch.ops import bits as tbits
from ofdm_tpu_torch.ops import channel as tch
from ofdm_tpu_torch.ops import dft as tdft
from ofdm_tpu_torch.ops import equalize as teq
from ofdm_tpu_torch.ops import framing as tfr
from ofdm_tpu_torch.ops import linops as tlin
from ofdm_tpu_torch.ops import mapping as tmp
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import ofdm as tofdm
from ofdm_tpu_torch.ops import prng

CONSTS = [("QAM", 4), ("QAM", 64), ("QAM", 1024), ("PSK", 8)]
# order layouts: the overview link's kind, one with inactive subcarriers and
# four orders, a single order, and PSK
LAYOUTS = {
    "qam_mixed": ("QAM", [16] * 5 + [4] * 3 + [0] * 2 + [64] * 4 + [256] * 2),
    "qam_single": ("QAM", [16] * 8),
    "psk_mixed": ("PSK", [8] * 4 + [0] + [2] * 3 + [16] * 4 + [4] * 4),
}
RMS_TOL = 1e-4  # linops against JAX's bf16x3 products, of the block RMS; measured at most 1.4e-6 (CPU)


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


def test_pack_unpack_match_jax():
    bits = np.random.default_rng(0).integers(0, 2, (5, 7, 24), dtype=np.uint8)
    jpacked, junpacked = jax.jit(lambda b: (jbits.pack_bits(b), jbits.unpack_bits(jbits.pack_bits(b))))(bits)
    packed = tbits.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.uint8
    assert np.array_equal(_np(packed), np.asarray(jpacked))
    unpacked = tbits.unpack_bits(packed)
    assert unpacked.dtype == torch.uint8 and np.array_equal(_np(unpacked), bits)
    assert np.array_equal(_np(unpacked), np.asarray(junpacked))
    with pytest.raises(ValueError, match="multiple of 8"):
        tbits.pack_bits(torch.zeros((3, 12), dtype=torch.uint8))


def test_framing_and_dft_match_jax():
    x = _cplx(np.random.default_rng(1), (96,))
    jt, jf = jax.jit(lambda v: (jfr.to_parallel(v, 32), jnp.fft.ifft(jfr.to_parallel(v, 32), norm="ortho")))(x)
    t = tfr.to_parallel(torch.from_numpy(x), 32)
    assert np.array_equal(_np(t), np.asarray(jt))
    assert torch.equal(tfr.to_serial(t), torch.from_numpy(x))
    assert tofdm.to_parallel is tfr.to_parallel and tofdm.fft_ortho is tdft.fft_ortho
    for bad in ((torch.from_numpy(x), 7), (torch.from_numpy(x), 0), (t, 4)):
        with pytest.raises(ValueError):
            tfr.to_parallel(*bad)
    np.testing.assert_allclose(_np(tdft.ifft_ortho(t, 32)), np.asarray(jf), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,order", CONSTS)
def test_bit_mapping_matches_jax(kind, order):
    tc, jc = tmp.make_constellation(kind, order), jmp.make_constellation(kind, order)
    b = tc.bits_per_symbol
    bits = np.random.default_rng(order).integers(0, 2, (40, 8, b), dtype=np.uint8)
    idx = tmp.bits_to_indices(torch.from_numpy(bits), b)
    assert idx.dtype == torch.int32
    back = tmp.indices_to_bits(idx, b)
    assert back.dtype == torch.uint8 and np.array_equal(_np(back), bits)
    sym = tmp.encode(torch.from_numpy(bits), tc)
    # hard decisions on noisy points: exact
    y = _np(sym) + _cplx(np.random.default_rng(7), sym.shape, 0.3 * np.sqrt(1.0 / order))
    port = tmp.decode_bits(torch.from_numpy(y), tc)

    @jax.jit
    def jax_side(jb, jy):
        jbits_ = jmp.decode_bits(jy, jc)
        return (jmp.bits_to_indices(jb, b), jmp.encode(jb, jc), jbits_, jmt.bit_errors(jb, jbits_))

    jidx, jsym, jport, jerrors = jax_side(bits, y)
    assert np.array_equal(_np(idx), np.asarray(jidx))
    assert sym.dtype == torch.complex64 and np.array_equal(_np(sym), np.asarray(jsym))
    assert np.array_equal(_np(port), np.asarray(jport))
    errors = tmt.bit_errors(torch.from_numpy(bits), port)
    assert errors.dtype == torch.int64 and errors.ndim == 0
    assert int(errors) == int(jerrors)


def _ties(y, c, a, b):
    """|score(a) - score(b)| in float64 of points y against table c."""
    y = y.astype(np.complex128)
    s = lambda j: 2.0 * (y * np.conj(c[j])).real - np.abs(c[j]) ** 2  # noqa: E731
    return np.abs(s(a) - s(b))


@pytest.mark.parametrize("kind,order", CONSTS)
def test_decode_nn_matches_jax(kind, order):
    tc, jc = tmp.make_constellation(kind, order), jmp.make_constellation(kind, order)
    rng = np.random.default_rng(order + 1)
    # away from the boundaries: table points plus a tenth of the half distance
    idx = rng.integers(0, order, 3000)
    half = np.min(np.abs(tc.table[:, None] - tc.table[None, :]) + 9 * np.eye(order)) / 2
    near = (tc.table[idx] + 0.1 * half * np.exp(2j * np.pi * rng.random(3000))).astype(np.complex64)
    y = _cplx(rng, (4000,), 0.8)
    jnear, jy = jax.jit(lambda a, b: (jmp.decode_nn(a, jc), jmp.decode_nn(b, jc)))(near, y)
    got = _np(tmp.decode_nn(torch.from_numpy(near), tc))
    assert np.array_equal(got, idx)
    assert np.array_equal(got, np.asarray(jnear))
    assert np.array_equal(got, _np(tmp.decode_hard(torch.from_numpy(near), tc)))
    # random points: every disagreement with the JAX package or the slicer is a tie
    got = _np(tmp.decode_nn(torch.from_numpy(y), tc))
    for other in (np.asarray(jy), _np(tmp.decode_hard(torch.from_numpy(y), tc))):
        apart = got != other
        assert apart.sum() <= 2 and (_ties(y[apart], tc.table, got[apart], other[apart]) < 1e-5).all()
    # any block size: the same indices, shape kept
    y2, want = y.reshape(40, 100), got.reshape(40, 100)
    for rows, k in ((1, 3), (7, 40), (1000, 40)):
        assert np.array_equal(_np(tmp.decode_nn(torch.from_numpy(y2[:k]), tc, rows=rows)), want[:k])
    bits = tmp.decode_bits(torch.from_numpy(y), tc, hard=False)
    assert np.array_equal(_np(bits), _np(tmp.indices_to_bits(torch.from_numpy(got), tc.bits_per_symbol)))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adaptive_mapper_tables_match_jax(layout):
    kind, orders = LAYOUTS[layout]
    tm, jm = tad.make_adaptive_mapper(kind, orders), jad.make_adaptive_mapper(kind, orders)
    for field in ("orders", "bits_per_subcarrier", "tables", "group_id", "gather_idx", "bit_mask", "weights",
                  "src_k", "src_j", "active", "composite_constellation"):
        a, b = getattr(tm, field), getattr(jm, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("num_subcarriers", "max_bits", "max_order", "bits_per_ofdm_symbol", "name", "kind"):
        assert getattr(tm, field) == getattr(jm, field), field


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adaptive_encode_decode_match_jax(layout):
    kind, orders = LAYOUTS[layout]
    tm, jm = tad.make_adaptive_mapper(kind, orders), jad.make_adaptive_mapper(kind, orders)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (300, tm.bits_per_ofdm_symbol), dtype=np.uint8)
    jencode = jax.jit(lambda b: jad.encode(b, jm))
    jdecode = jax.jit(lambda y: jad.decode(y, jm))
    sym, idx = tad.encode(torch.from_numpy(bits), tm)
    jsym, jidx = jencode(jnp.asarray(bits))
    assert sym.dtype == torch.complex64 and idx.dtype == torch.int32
    assert np.array_equal(_np(sym), np.asarray(jsym)) and np.array_equal(_np(idx), np.asarray(jidx))
    # near each sent point (a tenth of the smallest half distance): exact indices and bits
    near = (_np(sym) + _cplx(rng, sym.shape, 0.004)).astype(np.complex64)
    rx_bits, rx_idx = tad.decode(torch.from_numpy(near), tm)
    jbits_, jidx_ = jdecode(jnp.asarray(near))
    assert rx_bits.dtype == torch.uint8 and np.array_equal(_np(rx_bits), bits)
    assert np.array_equal(_np(rx_bits), np.asarray(jbits_).astype(np.uint8))
    assert np.array_equal(_np(rx_idx), np.asarray(jidx_))
    assert torch.equal(rx_idx, tad.decode_to_indices(torch.from_numpy(near), tm))
    # random points: disagreements only on ties; any block size gives the same
    y = _cplx(rng, (300, len(orders)), 0.8)
    r_bits, r_idx = tad.decode(torch.from_numpy(y), tm)
    j_idx = np.asarray(jdecode(jnp.asarray(y))[1])
    apart = _np(r_idx) != j_idx
    k = np.nonzero(apart)[1]
    tab = tm.tables[tm.group_id[k]]
    gaps = [_ties(y[apart][i:i + 1], tab[i], _np(r_idx)[apart][i:i + 1], j_idx[apart][i:i + 1])[0]
            for i in range(int(apart.sum()))]
    assert apart.sum() <= 2 and all(g < 1e-5 for g in gaps)
    for rows in (1, 17):
        b2, i2 = tad.decode(torch.from_numpy(y), tm, rows=rows)
        assert torch.equal(b2, r_bits) and torch.equal(i2, r_idx)


def test_host_helpers_match_jax(tmp_path):
    orders = np.array([16, 0, 4, 64, 256, 0, 2, 1024])
    total, bits = tad.calculate_requirements(orders, 37)
    jtotal, jb = jad.calculate_requirements(orders, 37)
    assert total == jtotal and np.array_equal(bits, jb) and bits.dtype == jb.dtype
    cap = np.random.default_rng(4).random(64) * 11.0
    for kind in ("QAM", "PSK"):
        for lo, hi, f in ((4, 256, 1.0), (2, 1024, 0.7), (16, 64, 1.3)):
            a = tad.calculate_constellation_orders(cap, lo, hi, f, kind)
            b = jad.calculate_constellation_orders(cap, lo, hi, f, kind)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    gains = tchm.channel_gains(tchm.get_channel("Lin-Phoong_P2"), 64)
    assert np.array_equal(gains, jchm.channel_gains(jchm.get_channel("Lin-Phoong_P2"), 64))
    uni = tal.uniform(1.0, 64)
    wf = tal.waterfilling(1.0, gains, 0.01)
    assert tal.capacity(wf, gains, 0.01) == jal.capacity(wf, gains, 0.01)
    assert np.array_equal(tal.capacity_per_subcarrier(wf, gains, 0.01), jal.capacity_per_subcarrier(wf, gains, 0.01))
    assert tal.compare_allocations(uni, wf, gains, 0.01) == jal.compare_allocations(uni, wf, gains, 0.01)
    assert tchm.list_channels() == jchm.list_channels()
    tchm.export_channel_models(str(tmp_path / "t"))
    jchm.export_channel_models(str(tmp_path / "j"))
    for name in tchm.list_channels():
        h = np.load(tmp_path / "t" / f"{name}.npy")
        assert h.dtype == np.complex128 and np.array_equal(h, np.load(tmp_path / "j" / f"{name}.npy"))
        assert np.array_equal(tchm.get_channel(str(tmp_path / "t" / f"{name}.npy")), tchm.CHANNEL_MODELS[name])


def _rms_err(port, ref):
    ref = np.asarray(ref.re) + 1j * np.asarray(ref.im) if isinstance(ref, cplx.CArray) else np.asarray(ref)
    return float(np.abs(_np(port) - ref).max() / np.sqrt(np.mean(np.abs(ref) ** 2)))


LINOPS_LINKS = [(64, "CYCLIC", 16, "OFDM"), (64, "ZERO", 64, "OFDM"), (32, "ZERO", 11, "SC-OFDM")]


@pytest.mark.parametrize("n,prefix,L,mod", LINOPS_LINKS)
def test_linops_match_jax(n, prefix, L, mod):
    rng = np.random.default_rng(n + L)
    T = n + L
    x = _cplx(rng, (24, n), np.sqrt(0.5))
    tp, jp = PrefixType(prefix), JPrefix(prefix)
    blocks = tlin.modulate(torch.from_numpy(x), n, tp, L, ModulationType(mod))
    b = _np(blocks)
    taps = tchm.normalize_impulse_response(tchm.get_channel("severe_multipath"))
    t0, t1 = tlin.conv_matrices(taps, T)
    E = tlin.ext_width(len(taps), T)
    carry = _cplx(rng, (T,))

    def f32(m):
        return jnp.asarray(m.real, jnp.float32), jnp.asarray(m.imag, jnp.float32)

    forms = [(None, t1, None), (E, t1[T - E:], carry), (0, t1[:0], carry)]

    @jax.jit
    def jax_side(jx, jb, jc):
        conv = [jlin.convolve(jb, f32(t0), f32(band), None if c is None else jc, ext=ext) for ext, band, c in forms]
        return jlin.modulate(jx, n, jp, L, JMod(mod)), conv, jlin.demodulate(jb, n, jp, L)

    jblocks, jconv, jdemod = jax_side(*(cplx.from_complex(v) for v in (x, b, carry)))
    assert blocks.dtype == torch.complex64 and _rms_err(blocks, jblocks) < RMS_TOL
    for (ext, band, c), (jout, jlast) in zip(forms, jconv):
        out, last = tlin.convolve(torch.from_numpy(b), t0, band, None if c is None else torch.from_numpy(c), ext=ext)
        assert _rms_err(out, jout) < RMS_TOL
        assert np.array_equal(_np(last), b[-1]) and np.array_equal(np.asarray(jlast.re), b[-1].real)
    # the carry chains: two halves equal one call
    whole, _ = tlin.convolve(torch.from_numpy(b), t0, t1[T - E:], ext=E)
    h1, c1 = tlin.convolve(torch.from_numpy(b[:10]), t0, t1[T - E:], ext=E)
    h2, _ = tlin.convolve(torch.from_numpy(b[10:]), t0, t1[T - E:], c1, ext=E)
    assert torch.equal(torch.cat([h1, h2]), whole)
    y = tlin.demodulate(torch.from_numpy(b), n, tp, L)
    assert _rms_err(y, jdemod) < RMS_TOL


def test_random_bits_unpack_the_ports_words(monkeypatch):
    seed = 1234
    for shape in [(1000, 37), (4096,), (3, 5, 7), ()]:
        nbits = int(np.prod(shape)) if shape else 1
        words = prng.random_u32(prng.key_words(seed), (-(-nbits // 32),), "cpu").numpy().view(np.uint32)
        monkeypatch.setattr(jax.random, "bits", lambda key, sh, dtype: jnp.asarray(words[: sh[0]], dtype))
        port = tbits.random_bits(seed, shape, "cpu")
        assert port.dtype == torch.uint8 and tuple(port.shape) == shape
        jport = jax.jit(lambda k: jbits.random_bits(k, shape))(jax.random.PRNGKey(0))
        assert np.array_equal(_np(port), np.asarray(jport))
    # a key pair from fold_in draws its own stream
    assert not torch.equal(tbits.random_bits(prng.fold_in(seed, 1), (512,), "cpu"),
                           tbits.random_bits(seed, (512,), "cpu"))


def test_random_bits_are_fair():
    n = 1 << 20
    bits = tbits.random_bits(99, (n // 32, 32), "cpu").to(torch.float64)
    assert abs(float(bits.mean()) - 0.5) < 5 * 0.5 / np.sqrt(n)
    # bit 31 of every word (the int32 words' sign bit) on its own
    assert abs(float(bits[:, 31].mean()) - 0.5) < 5 * 0.5 / np.sqrt(n // 32)


def test_overview_chain_matches_jax():
    # examples/overview.py at 64 sc x 256 OFDM symbols; bits and normals from one numpy seed
    n, snr_db, B = 64, 20.0, 256
    raw = tchm.get_channel("Lin-Phoong_P1")
    h_freq = tchm.channel_frequency_response(raw, n)
    gains = np.abs(h_freq) ** 2
    noise_power = 10 ** (-snr_db / 10)
    L = tchm.channel_order(raw)
    power = tal.waterfilling(float(n), gains, noise_power)
    assert np.array_equal(power, jal.waterfilling(float(n), gains, noise_power))
    orders = tmp.qam_bit_loading_orders(1e-3, power * gains / noise_power)
    tm, jm = tad.make_adaptive_mapper("QAM", orders), jad.make_adaptive_mapper("QAM", orders)
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (B, tm.bits_per_ofdm_symbol), dtype=np.uint8)
    z0, z1 = (rng.standard_normal((B, n + L)).astype(np.float32) for _ in range(2))
    taps = tchm.normalize_impulse_response(raw)

    # the port
    sym, tx_idx = tad.encode(torch.from_numpy(bits), tm)
    sym = sym * torch.from_numpy(np.sqrt(power).astype(np.float32)).to(torch.complex64)
    blocks = tofdm.ofdm_modulate(sym, n, PrefixType.CYCLIC, L)
    rx, _ = tch.transmit(blocks, torch.tensor(taps, dtype=torch.complex64), snr_db,
                         z=(torch.from_numpy(z0), torch.from_numpy(z1)))
    freq = tofdm.ofdm_demodulate_to_freq(rx, n, PrefixType.CYCLIC, L)
    eqd = teq.equalize(freq, torch.tensor(h_freq, dtype=torch.complex64), EqualizationMethod.MMSE, snr_db)
    p = (eqd.real * eqd.real + eqd.imag * eqd.imag).mean(dim=0, keepdim=True)
    eqd = torch.where(p > 1e-10, eqd / p.sqrt(), eqd)
    rx_bits, rx_idx = tad.decode(eqd, tm)
    errors = int(tmt.bit_errors(torch.from_numpy(bits), rx_bits))

    # the JAX package: transmit without noise, then sigma z with sigma as awgn computes it
    @jax.jit
    def jax_chain(jbits_, jz0, jz1):
        jsym, _ = jad.encode(jbits_, jm)
        jsym = jsym * jnp.sqrt(jnp.asarray(power)).astype(jsym.dtype)
        jblocks = jofdm.ofdm_modulate(jsym, n, JPrefix.CYCLIC, L)
        jrx, _ = jch.transmit(None, jblocks, jnp.asarray(taps, jnp.complex64), snr_db, add_noise=False)
        sigma = jnp.sqrt(jnp.mean(jnp.abs(jrx) ** 2) / 10.0 ** (jnp.float32(snr_db) / 10.0) / 2.0)
        jrx = jrx + sigma * (jz0 + 1j * jz1)
        jfreq = jofdm.ofdm_demodulate_to_freq(jrx, n, JPrefix.CYCLIC, L)
        jeqd = jeq.equalize(jfreq, jnp.asarray(h_freq, jnp.complex64), JEq.MMSE, snr_db)
        jp = jnp.mean(jnp.abs(jeqd) ** 2, axis=0, keepdims=True)
        jeqd = jnp.where(jp > 1e-10, jeqd / jnp.sqrt(jp), jeqd)
        jrx_bits, jrx_idx = jad.decode(jeqd, jm)
        return jmt.bit_errors(jbits_, jrx_bits), jrx_idx

    jerrors, jrx_idx = jax_chain(jnp.asarray(bits), jnp.asarray(z0), jnp.asarray(z1))
    jerrors = int(jerrors)

    assert errors == jerrors > 0
    assert int(tmt.symbol_errors(tx_idx, rx_idx)) == int(jmt.symbol_errors(jnp.asarray(_np(tx_idx)), jrx_idx))
