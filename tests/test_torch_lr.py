"""The port's lr chunk, its factorization, routing and sampled-TX PAPR against
the JAX package.

* ``lowrank.factor`` against the JAX package's in float64.
* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros; matmul_passes=3 for f32-grade products) at n = 64, with both
  packages' lr threshold lowered to 64: the port's plain lr chunk on
  all-zero words counts the same errors.
* On seeded random words, sym0 > 0: the port's plain chunk against a
  float64 oracle built from the JAX package's factors and helpers, the
  previous symbol's tail and the colored-noise draws included.
* The tile rule against ``_spec_for``, routing against ``plan_for``,
  chunking independence, the slice end to end against the JAX runner's XLA
  path at 128 subcarriers, and the sampled-TX PAPR statistic.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import cplx as jcplx
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import lowrank as jlr
from ofdm_tpu.ops import mapping as jmap
from ofdm_tpu.ops import metrics as jmt
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import convert
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lowrank as tlr
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import ofdm as tofdm
from ofdm_tpu_torch.ops import prng

BASE = dict(
    num_symbols=64 * 1024,
    num_subcarriers=64,
    constellation_order=64,
    channel_type="CUSTOM",
    channel_model="severe_multipath",
    prefix_type="CYCLIC",
    prefix_length_ratio=0.34,
    equalization_method="ZF",
    noise_type="NONE",
    snr_db=30.0,
)
# bench.py's two lr cells, at their own widths
WIDE = dict(num_symbols=1024 * 64, num_subcarriers=1024, prefix_length_ratio=1.0,
            equalization_method="MMSE", noise_type="AWGN")
WIDE_ZP = dict(WIDE, prefix_type="ZERO")
# the four n = 64 links of the kernel checks
LINKS = {
    "a_cp034_zf": {},
    "b_zp1_mmse_6db": dict(prefix_type="ZERO", prefix_length_ratio=1.0, equalization_method="MMSE",
                           snr_db=6.0),
    "c_zp05_mmse_noise": dict(prefix_type="ZERO", prefix_length_ratio=0.5, equalization_method="MMSE",
                              noise_type="AWGN", constellation_order=16, snr_db=25.0),
    "d_cp034_mmse_noise": dict(equalization_method="MMSE", noise_type="AWGN", constellation_order=16,
                               snr_db=25.0),
}
# Zero words turn the noise into one deterministic offset of 5.77 sigma; at
# 25 dB it leaves links (c) and (d) 0.005 and 0.0002 from a boundary, at 30 dB 0.07.
ZERO_WORDS_SNR = {"c_zp05_mmse_noise": 30.0, "d_cp034_mmse_noise": 30.0}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lr_from_64(monkeypatch):
    """Both packages route ISI OFDM links to lr from 64 subcarriers."""
    monkeypatch.setattr(pk, "_LR_MIN_N", 64)
    monkeypatch.setattr(tpl, "LR_MIN_N", 64)


def _custom_64_taps():
    rng = np.random.default_rng(11)
    ir = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    return ir / np.linalg.norm(ir)


def _jax_runner(kw, channel_ir=None, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra),
                                      channel_ir=channel_ir))


def _port_setup(kw, channel_ir=None):
    return tpl.prepare(tcfg.SimulationConfig(**kw), channel_ir=channel_ir)


def _kw(name, **extra):
    return {**BASE, **LINKS[name], **extra}


FACTOR_CASES = {
    "wide_1024sc": ({**BASE, **WIDE}, None),
    "lr_1024sc_zp": ({**BASE, **WIDE_ZP}, None),
    "cp034_128sc": (dict(BASE, num_subcarriers=128, num_symbols=128 * 16), None),
    "zp05_128sc": (dict(BASE, num_subcarriers=128, num_symbols=128 * 16, prefix_type="ZERO",
                        prefix_length_ratio=0.5), None),
    "custom64_256sc_zp": (dict(BASE, num_subcarriers=256, num_symbols=256 * 16, prefix_type="ZERO",
                               prefix_length_ratio=1.0), "custom64"),
}


@pytest.mark.parametrize("name", list(FACTOR_CASES))
def test_factor_matches_jax_in_f64(name):
    kw, ir = FACTOR_CASES[name]
    ir = _custom_64_taps() if ir else None
    js = jpl.prepare(jcfg.SimulationConfig(**kw), channel_ir=ir)
    cfg = js.cfg
    args = (np.asarray(js.taps), cfg.num_subcarriers, cfg.prefix_type, js.prefix_length, cfg.modulation_type)
    jf = jlr.factor(*args)
    pcfg = tcfg.SimulationConfig(**kw)
    tf = tlr.factor(np.asarray(js.taps), pcfg.num_subcarriers, pcfg.prefix_type, js.prefix_length,
                    pcfg.modulation_type)
    assert jf is not None and tf is not None
    assert (tf.E, tf.noise_rank, tf.pw_scale) == (jf.E, jf.noise_rank, jf.pw_scale)
    for a, b in ((tf.d, jf.d), (tf.tail, jf.tail), (tf.cr, jf.cr), (tf.cp, jf.cp)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert (tf.bnoise is None) == (jf.bnoise is None)
    if jf.bnoise is not None:
        np.testing.assert_allclose(tf.bnoise, jf.bnoise, rtol=1e-12, atol=1e-12)
    # the factored oracle, on seeded symbols and tail
    rng = np.random.default_rng(5)
    n = cfg.num_subcarriers
    sym = rng.standard_normal((6, n)) + 1j * rng.standard_normal((6, n))
    tail = rng.standard_normal(jf.E) + 1j * rng.standard_normal(jf.E)
    np.testing.assert_allclose(tlr.apply_reference(tf, sym, tail, pcfg.modulation_type),
                               jlr.apply_reference(jf, sym, tail, cfg.modulation_type),
                               rtol=1e-12, atol=1e-12)
    # the port's chunk runs on the JAX package's own factors, carried across as arrays
    carried = convert.lr_factors_from_arrays(jf.d, jf.tail, jf.cr, jf.cp, jf.bnoise, jf.pw_scale, jf.E)
    a = lrk.lr_link(_port_setup(kw, ir), "cpu", factors=carried)
    b = lrk.lr_link(_port_setup(kw, ir), "cpu")
    for f in ("tail_r", "tail_i", "cc_r", "cc_i", "dr", "di", "bh_r", "bh_i"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.allclose(x, y, rtol=1e-6, atol=1e-7), f


@pytest.mark.parametrize(
    "kw",
    [
        {**BASE, **WIDE},
        {**BASE, **WIDE_ZP},
        dict(BASE, num_subcarriers=128, num_symbols=128 * 16, prefix_type="ZERO", prefix_length_ratio=0.5,
             noise_type="AWGN"),
        {**BASE, **WIDE_ZP, "num_subcarriers": 2048, "num_symbols": 2048 * 16},
        {**BASE, **WIDE_ZP, "num_subcarriers": 4096, "num_symbols": 4096 * 16},
    ],
    ids=["wide_1024sc", "lr_1024sc_zp", "zp05_128sc", "zp_2048sc", "zp_4096sc"],
)
def test_lr_link_and_tile_match_jax_spec(kw):
    chunk = 1 << 17
    spec = pk._spec_for(_jax_runner(kw), chunk, True)
    assert spec.conv == "lr"
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == "lr"
    link = lrk.lr_link(setup, "cpu")
    n = kw["num_subcarriers"]
    tile = lk.tile_for(chunk, link.tile_cap)
    assert (tile, link.E, link.rank, link.txext, link.pstride) == (
        spec.tile, spec.lre, spec.nrank, spec.txext, spec.pstride)
    assert link.slice == max(64, -(-65536 // n)) and min(link.slice, tile) == min(spec.tile, max(64, -(-65536 // n)))
    assert tile == {128: 8192, 1024: 1024, 2048: 512, 4096: 512}[n]
    assert lrk.papr_samples(link, chunk) == (0 if spec.txext else -(-spec.tiles // spec.pstride) * spec.tile * spec.T)
    if n == 128:
        # the f32 rows against the JAX package's consts: after cg and the
        # staged matrices' bf16 splits come D, h, |h|^2 and the ZF gains
        consts = pk._consts_for(_jax_runner(kw), spec)
        rows = [np.asarray(c, np.float32)[0, :n] for c in consts[1 + 3 * 4 :]][:7]
        for t, ref in zip((link.dr, link.di, link.hr, link.hi, link.habs2, link.gr, link.gi), rows):
            assert np.array_equal(t.numpy(), ref)
        assert link.cg == float(np.asarray(consts[0])[0])
        assert link.pw_scale == float(np.float32(n / (n + setup.prefix_length)))


ROUTES = [
    # (extra, JAX conv, port mode: "eager" where no kernel of the port takes the link)
    (dict(num_subcarriers=64), "mm", "fold"),
    (dict(num_subcarriers=128), "lr", "lr"),
    (dict(num_subcarriers=64, prefix_type="ZERO", prefix_length_ratio=1.0), "mm", "mm"),
    (dict(num_subcarriers=128, prefix_type="ZERO", prefix_length_ratio=1.0), "lr", "lr"),
    (dict(num_subcarriers=256, prefix_length_ratio=1.0), "diag", "diag"),
    (dict(num_subcarriers=512, prefix_length_ratio=1.0), "diag", "diag"),
    (dict(num_subcarriers=1024, prefix_length_ratio=1.0), "lr", "lr"),
    (dict(num_subcarriers=1024, prefix_length_ratio=1.0, channel_model="flat_fading"), "diag", "diag"),
]


@pytest.mark.parametrize("extra,conv,mode", ROUTES,
                         ids=["cp034_64sc", "cp034_128sc", "zp_64sc", "zp_128sc", "isi_free_256sc",
                              "isi_free_512sc", "isi_free_1024sc", "flat_fading_1024sc"])
def test_routing_mirrors_jax_plan(extra, conv, mode):
    kw = {**BASE, **extra}
    kw["num_symbols"] = kw["num_subcarriers"] * 16
    assert pk.plan_for(_jax_runner(kw))[1] == conv
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == mode == tpl.LinkRunner(setup, device="cpu").mode


def _boundary_margin(er, ei, m):
    """Distance of each slicer-unit coordinate to its nearest decision boundary."""
    c0 = (m - 1) * 0.5
    bounds = np.arange(m - 1) + 0.5
    d = np.full(np.shape(er), np.inf)
    for v in (np.asarray(er, np.float64) + c0, c0 - np.asarray(ei, np.float64)):
        d = np.minimum(d, np.abs(v[..., None] - bounds).min(axis=-1))
    return d


def _zero_words(link, chunk):
    z = np.zeros((chunk, link.n), np.int64)
    words = (z, z, z)
    if link.add_noise and link.rank:
        g = np.zeros((chunk, link.rank), np.int64)
        words += (g, g)
    return words


@pytest.mark.parametrize("name", list(LINKS))
def test_zero_words_match_pallas_kernel(lr_from_64, name):
    kw = _kw(name, **({"snr_db": ZERO_WORDS_SNR[name]} if name in ZERO_WORDS_SNR else {}))
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, 1024, True)
    assert spec.conv == "lr"
    fn = pk.make_pallas_chunk(jr, 1024, interpret=True)
    stats, carry = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.float32(1.0))
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == "lr"
    link = lrk.lr_link(setup, "cpu")
    assert (link.E, link.rank) == (spec.lre, spec.nrank)
    words = _zero_words(link, 1024)
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, *_ = lrk.lr_planes(link, (0, 0), 0, 1024, snr_lin, "cpu", words)
    # zero words make every symbol after the first alike: one flipped
    # decision moves a count by ~1024, so no point may sit near a boundary
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-2
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = lrk.lr_chunk_plain(link, (0, 0), 0, 1024, snr_lin, acc, psum, words=words)
    be, se, peak = acc.tolist()
    assert (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    if name.startswith("b_"):
        assert se > 0  # MMSE at 6 dB shrinks the corner point across a boundary
    assert lrk.papr_samples(link, 1024) == int(stats["papr_count"]) > 0
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=1e-4)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=1e-4)
    np.testing.assert_allclose(cr.numpy(), np.asarray(carry.re), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(carry.im), rtol=1e-4, atol=1e-5)


def _oracle(kw, words, chunk):
    """The lr chain in float64 from the JAX package's factors and helpers.
    ``words`` hold chunk + 1 rows (the previous symbol's, then the chunk's)
    and, for colored noise, the chunk's (chunk, r) g2 draws."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)
    s = jr.setup
    cfg = s.cfg
    n, T = spec.n, spec.T
    f = jlr.factor(np.asarray(s.taps), n, cfg.prefix_type, s.prefix_length, cfg.modulation_type)
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    tx, sr, si = pk._encode_tile(spec, i32[0], None)
    sym = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    t = sym @ f.tail
    y = jlr.apply_reference(f, sym[1:], t[0], cfg.modulation_type)
    snr = 10.0 ** (kw["snr_db"] / 10.0)

    def normal(w1, w2):
        u1 = np.maximum(((np.asarray(w1, np.int64) >> 8) & 0xFFFFFF) * 2.0 ** -24, 2.0 ** -24)
        co, sn = pk._cossin_u24((jnp.asarray(np.asarray(w2, np.uint32).view(np.int32)) >> 8) & 0xFFFFFF)
        return np.sqrt(-2.0 * np.log(u1)) * (np.asarray(co, np.float64) + 1j * np.asarray(sn, np.float64))

    if kw.get("noise_type", "AWGN") == "AWGN":
        S = max(64, -(-65536 // n))
        pw = n / T if cfg.prefix_type == jcfg.PrefixType.ZERO else 1.0
        sigma = np.concatenate([
            np.full((min(spec.tile, chunk - t0), 1),
                    np.sqrt(np.mean(np.abs(y[t0 : t0 + min(S, spec.tile)]) ** 2) * pw / snr / 2.0))
            for t0 in range(0, chunk, spec.tile)])
        z = normal(words[1][1:], words[2][1:])
        if f.bnoise is not None:
            z = z + normal(words[3], words[4]) @ f.bnoise.conj().T
        y = y + sigma * z
    h = np.asarray(s.h_freq, np.complex128)
    slicer = 0.5 / pk._qam_geometry(spec.order)[2]
    if kw["equalization_method"] == "ZF":
        e = y / h * slicer
    else:
        nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = y * np.conj(h) * slicer / (np.abs(h) ** 2 + nv)
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32), None))
    rows = 1 + np.flatnonzero((np.arange(chunk) // spec.tile) % spec.pstride == 0)
    fr, fi = jlin.tx_matrix(n, cfg.prefix_type, spec.L, cfg.modulation_type)
    x = sym[rows] @ (fr + 1j * fi)
    return np.asarray(tx)[1:], rx, e, np.abs(x) ** 2, t[-1]


@pytest.mark.parametrize("name", list(LINKS))
def test_random_words_match_float64_oracle(lr_from_64, name):
    kw = _kw(name)
    chunk = 1024
    link = lrk.lr_link(_port_setup(kw), "cpu")
    rng = np.random.default_rng(99)
    words = tuple(rng.integers(0, 1 << 32, size=(chunk + 1, 64), dtype=np.uint64).astype(np.int64)
                  for _ in range(3))
    if link.add_noise and link.rank:
        words += tuple(rng.integers(0, 1 << 32, size=(chunk, link.rank), dtype=np.uint64).astype(np.int64)
                       for _ in range(2))
    sym0 = 5 * chunk + 3
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, *_ = lrk.lr_planes(link, (0, 0), sym0, chunk, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = lrk.lr_chunk_plain(link, (0, 0), sym0, chunk, snr_lin, acc, psum, words=words)
    be, se, peak = acc.tolist()
    jtx, jrx, e, pw, t_last = _oracle(kw, words, chunk)
    rx = lk.qam_demap(er, ei, link.q).numpy()
    assert np.array_equal(tx.numpy(), jtx)
    # f32 against f64; a wrong previous tail or colored draw moves points by ~0.1
    np.testing.assert_allclose(er.numpy() + 1j * ei.numpy(), e, rtol=1e-5, atol=1e-4)
    near = _boundary_margin(e.real, e.imag, link.q.m) < 1e-4
    assert near.sum() <= 1e-3 * near.size
    assert np.array_equal(rx[~near], jrx[~near])
    assert be > 0 and (be, se) == (int(tmt.index_bit_errors(tx, torch.from_numpy(rx))),
                                   int(tmt.symbol_errors(tx, torch.from_numpy(rx))))
    assert lk.bits_f32(peak) == pytest.approx(pw.max(), rel=1e-5)
    assert float(psum) == pytest.approx(pw.sum(), rel=1e-5)
    T = link.T
    assert not cr[: T - link.E].any() and not ci[: T - link.E].any()
    np.testing.assert_allclose(cr[T - link.E :].numpy() + 1j * ci[T - link.E :].numpy(), t_last,
                               rtol=1e-5, atol=1e-5)


def _runner(kw):
    return tpl.LinkRunner(_port_setup(kw), device="cpu")


@pytest.mark.parametrize("name", ["c_zp05_mmse_noise", "d_cp034_mmse_noise"])
def test_counts_do_not_depend_on_chunking(lr_from_64, name):
    # 3584 symbols: the whole run and chunks of 1536, 1536 and 512 all take
    # 512-symbol tiles, so sigma is unchanged
    kw = _kw(name, num_symbols=64 * 3584, snr_db=20.0)
    whole = _runner(kw).run(7)
    split = _runner(dict(kw, symbols_per_chunk=1536)).run(7)
    assert whole["bit_errors"] > 0
    assert (whole["bit_errors"], whole["symbol_errors"]) == (split["bit_errors"], split["symbol_errors"])
    # every chunk's first tile feeds the PAPR statistic: 1 of 7 tiles, then 3
    assert split["papr_sample_fraction"] == 3 * whole["papr_sample_fraction"]


@pytest.mark.parametrize(
    "extra",
    [dict(prefix_type="ZERO", prefix_length_ratio=1.0), dict(prefix_length_ratio=0.34)],
    ids=["zp1_mmse", "cp034_mmse"],
)
def test_slice_end_to_end_matches_jax_runner(extra):
    B = 1 << 12
    kw = {**BASE, "num_subcarriers": 128, "num_symbols": 128 * B, "equalization_method": "MMSE",
          "noise_type": "AWGN", "constellation_order": 16, "snr_db": 14.0, **extra}
    port_runner = _runner(kw)
    assert port_runner.mode == "lr"
    port = port_runner.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and port["papr_estimator"] == "in_run"
    assert 3e-3 < port["bit_error_rate"] < 3e-2
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"],
                              ref["total_bits"], z=4)
    assert abs(port["papr_db"] - ref["papr_db"]) < 0.5


def test_sampled_papr_on_injected_indices():
    kw = {**BASE, **WIDE_ZP}
    js = jpl.prepare(jcfg.SimulationConfig(**kw))
    n, L = 1024, js.prefix_length
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 64, size=(300, n))
    fr, fi = jlin.tx_matrix(n, js.cfg.prefix_type, L, js.cfg.modulation_type)
    sym = jmap.encode_indices_planar(jnp.asarray(idx, jnp.int32), js.const)
    x = jcplx.matmul(sym, jnp.asarray(fr, jnp.float32), jnp.asarray(fi, jnp.float32), passes=3)
    jpeak, jsum, jcount = jmt.papr_stats(x)
    ps = _port_setup(kw)
    modulate = functools.partial(tofdm.ofdm_modulate, n_sc=n, prefix_type=ps.cfg.prefix_type, prefix_length=L)
    peak, total, count = tpl.sampled_tx_papr(torch.from_numpy(idx), ps.const, modulate, rows=128)
    assert count == jcount == 300 * (n + L)
    assert peak == pytest.approx(float(jpeak), rel=1e-5)
    assert total == pytest.approx(float(jsum), rel=1e-5)


def test_sampled_papr_estimator_matches_jax_runner():
    B = 512
    kw = {**BASE, **WIDE_ZP, "num_subcarriers": 512, "num_symbols": 512 * B}
    runner = _runner(kw)
    assert runner.mode == "lr" and runner.link.txext
    r = runner.run(0)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw)))
    # the XLA path sees every time sample; the peak of ~2.7e5 samples spreads
    # by ~0.45 dB from draw to draw, so the reference averages eight runs
    refs = [jr.run(jax.random.PRNGKey(k)) for k in range(8)]
    _, _, jcount = jr._papr_sample()
    T = 512 + runner.setup.prefix_length
    assert r["papr_estimator"] == "sampled_tx"
    assert r["papr_sample_fraction"] == jcount / (B * T) == refs[0]["papr_sample_fraction"] == 1.0
    assert abs(r["papr_db"] - np.mean([ref["papr_db"] for ref in refs])) < 0.5
    assert runner._papr_sample() is runner._papr_sample()  # cached once per runner


def test_factor_refuses_scfde():
    taps = np.array([1.0, 0.5, 0.25], np.complex128)
    with pytest.raises(ValueError, match="OFDM only"):
        tlr.factor(taps, 64, tcfg.PrefixType.CYCLIC, 1, tcfg.ModulationType.SC_OFDM)
    f = tlr.factor(taps, 64, tcfg.PrefixType.CYCLIC, 1, tcfg.ModulationType.OFDM)
    with pytest.raises(ValueError, match="OFDM only"):
        tlr.apply_reference(f, np.zeros((2, 64)), np.zeros(f.E), tcfg.ModulationType.SC_OFDM)


def test_random_u32_plain_is_philox_words_flattened():
    key = prng.key_words(0x9A9)
    words = prng.random_u32(key, (7, 9), "cpu")
    flat = prng.philox_words_plain(16, *prng.U32_STREAM, key).reshape(-1)[:63]
    assert words.shape == (7, 9) and words.dtype == torch.int32
    assert torch.equal(words.reshape(-1).to(torch.int64) & prng.M32, flat)
    assert bool((words < 0).any())  # the uint32 bits, not values clipped to int32
    idx = prng.uniform_indices(key, (7, 9), 63, "cpu")
    assert idx.dtype == torch.int32 and torch.equal(idx.to(torch.int64), flat.reshape(7, 9) & 63)
    with pytest.raises(ValueError):
        prng.uniform_indices(key, (7, 9), 1 << 31, "cpu")


def test_lr_runner_needs_cuda_or_an_explicit_cpu():
    setup = _port_setup({**BASE, **WIDE})
    if torch.cuda.is_available():
        assert tpl.LinkRunner(setup).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(setup)
    with pytest.raises(ValueError):
        lrk.lr_chunk(lrk.lr_link(setup, "cpu"), (0, 0), 0, 64, 1.0,
                     torch.zeros(3, dtype=torch.int64, device="meta"),
                     torch.zeros(1, dtype=torch.float64, device="meta"))
