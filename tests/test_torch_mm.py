"""The port's zero-prefix mm chunk, its routing and its links against the JAX package.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros), with f32-grade products on the JAX side (matmul_passes=3): the
  port's plain mm chunk on all-zero words counts the same errors.
* On seeded random words, sym0 > 0: the port's plain chunk against a
  float64 oracle built from the JAX package's own builders and helpers, the
  previous symbol's tail and the T-wide noise words included.
* Host constants and the tile rule against ``_spec_for``, routing against
  ``plan_for`` (the certification fallback included), chunking
  independence, and the slice end to end against the JAX runner's XLA path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import mm_kernel as mmk
from ofdm_tpu_torch.ops import prng

# The published campaign's zero-prefix link (docs/OFDM-Based Systems.tex:199-264):
# 64 subcarriers, 64-QAM, Lin-Phoong P2, 30 dB; ZP ratio 1.0, MMSE is zp_64sc.
ZP_64SC = dict(
    num_symbols=64 * 1024,
    num_subcarriers=64,
    constellation_order=64,
    channel_type="CUSTOM",
    channel_model="Lin-Phoong_P2",
    modulation_type="OFDM",
    prefix_type="ZERO",
    prefix_length_ratio=1.0,
    equalization_method="MMSE",
    snr_db=30.0,
)
# The reference's default link with a zero prefix.
SCFDE_ZP = dict(modulation_type="SC-OFDM", constellation_order=4, channel_model="Lin-Phoong_P1",
                equalization_method="ZF", snr_db=10.0)
LINKS = {
    "a_zp1_zf": dict(equalization_method="ZF", noise_type="NONE"),
    "b_zp034_zf": dict(prefix_length_ratio=0.34, equalization_method="ZF", noise_type="NONE"),
    "c_zp034_mmse_noise": dict(prefix_length_ratio=0.34),
    "d_scfde_zp": SCFDE_ZP,
    "e_flat_none": dict(channel_model="flat_fading", equalization_method="NONE"),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(name, **extra):
    return {**ZP_64SC, **LINKS[name], **extra}


def _sized(kw, n):
    return dict(kw, num_subcarriers=n, num_symbols=n * 16)


def _port_setup(kw):
    return tpl.prepare(tcfg.SimulationConfig(**kw))


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas",
                                                            **extra)))


def _boundary_margin(er, ei, m):
    """Distance of each slicer-unit coordinate to its nearest decision boundary."""
    c0 = (m - 1) * 0.5
    bounds = np.arange(m - 1) + 0.5
    d = np.full(np.shape(er), np.inf)
    for v in (np.asarray(er, np.float64) + c0, c0 - np.asarray(ei, np.float64)):
        d = np.minimum(d, np.abs(v[..., None] - bounds).min(axis=-1))
    return d


# (config, JAX tile at a 2^17-symbol chunk, T, E)
SPEC_CASES = {
    "zp_64sc": (ZP_64SC, 8192, 67, 3),
    "zp034_64sc": (dict(ZP_64SC, prefix_length_ratio=0.34), 8192, 65, 3),
    "zp068_64sc_zf": (dict(ZP_64SC, prefix_length_ratio=0.68, equalization_method="ZF"), 8192, 66, 3),
    "zp134_64sc": (dict(ZP_64SC, prefix_length_ratio=1.34), 8192, 68, 3),
    "zp_32sc": (_sized(ZP_64SC, 32), 8192, 35, 3),
    "zp_64sc_severe": (dict(ZP_64SC, channel_model="severe_multipath"), 8192, 71, 7),
    "scfde_zp_64sc": ({**ZP_64SC, **SCFDE_ZP}, 8192, 67, 3),
    "scfde_zp_256sc": (_sized({**ZP_64SC, **SCFDE_ZP, "channel_model": "Lin-Phoong_P2"}, 256), 4096, 259, 3),
    "flat_zp_64sc": (dict(ZP_64SC, channel_model="flat_fading"), 8192, 64, 0),
    "flat_zp_256sc": (_sized(dict(ZP_64SC, channel_model="flat_fading"), 256), 4096, 256, 0),
}


@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_mm_link_and_tile_match_jax_spec(name):
    kw, tile, T, E = SPEC_CASES[name]
    chunk = 1 << 17
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.conv == "mm" and not spec.fold
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == "mm"
    link = mmk.mm_link(setup, "cpu")
    assert (lk.tile_for(chunk, link.tile_cap), link.T, link.E, link.pstride) == (spec.tile, spec.T, spec.ext,
                                                                                spec.pstride)
    assert (spec.tile, spec.T, spec.ext) == (tile, T, E)
    assert mmk.papr_samples(link, chunk) == chunk * T
    if name in ("zp_64sc", "scfde_zp_64sc"):
        # the f32 matrices and rows against the JAX package's builders and consts
        cfg = jr.setup.cfg
        n, L = spec.n, spec.L
        jtx = pk._tx_ext_matrix(spec._replace(pack=1), jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type))
        jcv = jlin.conv_matrix_merged(jr.setup.taps, T)
        jrx = jlin.rx_matrix(n, cfg.prefix_type, L)
        pairs = [(link.txr, jtx[0]), (link.txi, jtx[1]), (link.cvr, jcv.real), (link.cvi, jcv.imag),
                 (link.rxr, jrx[0]), (link.rxi, jrx[1])]
        if spec.is_sc:
            jid = jdft.dft_matrix(n, inverse=True)
            pairs += [(link.idr, jid[0]), (link.idi, jid[1])]
        else:
            assert link.idr is None
        for t, ref in pairs:
            assert np.array_equal(t.numpy(), np.asarray(ref).astype(np.float32))
        consts = pk._consts_for(jr, spec)
        first = 1 + 3 * (4 if spec.is_sc else 3)  # after cg and the staged matrices' bf16 splits
        rows = [np.asarray(c, np.float32)[0, :n] for c in consts[first : first + 5]]
        for t, ref in zip((link.hr, link.hi, link.habs2, link.gr, link.gi), rows):
            assert np.array_equal(t.numpy(), ref)
        assert link.cg == float(np.asarray(consts[0])[0])


ROUTES = [
    # (config, JAX conv, port mode: past 256 subcarriers the block-per-symbol mm kernel)
    (_sized(ZP_64SC, 32), "mm", "mm"),
    (ZP_64SC, "mm", "mm"),
    (_sized(ZP_64SC, 127), "mm", "mm"),
    (_sized(ZP_64SC, 128), "lr", "lr"),
    (dict(ZP_64SC, channel_model="flat_fading"), "mm", "mm"),
    (_sized(dict(ZP_64SC, channel_model="flat_fading"), 256), "mm", "mm"),
    (_sized(dict(ZP_64SC, channel_model="flat_fading"), 512), "mm", "mm"),
    ({**ZP_64SC, **SCFDE_ZP}, "mm", "mm"),
    (_sized({**ZP_64SC, **SCFDE_ZP}, 256), "mm", "mm"),
    (_sized({**ZP_64SC, **SCFDE_ZP}, 512), "mm", "mm"),
]


@pytest.mark.parametrize("kw,conv,mode", ROUTES,
                         ids=["zp_32sc", "zp_64sc", "zp_127sc", "zp_128sc", "flat_zp_64sc", "flat_zp_256sc",
                              "flat_zp_512sc", "scfde_zp_64sc", "scfde_zp_256sc", "scfde_zp_512sc"])
def test_routing_mirrors_jax_plan(kw, conv, mode):
    assert pk.plan_for(_jax_runner(kw))[1] == conv
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == mode == tpl.LinkRunner(setup, device="cpu").mode


@pytest.mark.parametrize(
    "kw,mode",
    [(_sized(dict(ZP_64SC, prefix_length_ratio=0.5, channel_model="severe_multipath"), 128), "mm"),
     (_sized(dict(ZP_64SC, prefix_type="CYCLIC", prefix_length_ratio=0.34, channel_model="severe_multipath"),
             128), "fold")],
    ids=["zp05_128sc", "cp034_128sc"],
)
def test_failed_certification_falls_back_as_jax(monkeypatch, kw, mode):
    setup = _port_setup(kw)
    assert tpl.kernel_mode(setup) == "lr"
    monkeypatch.setattr(pk, "lr_factors", lambda runner: None)
    monkeypatch.setattr(lrk, "lr_factors", lambda setup: None)
    plan = pk.plan_for(_jax_runner(kw))
    assert plan[1] == "mm" and pk._fold_for(_jax_runner(kw).setup.cfg) == (mode == "fold")
    assert tpl.kernel_mode(setup) == mode == tpl.LinkRunner(setup, device="cpu").mode


@pytest.mark.parametrize("name", list(LINKS))
def test_zero_words_match_pallas_kernel(name):
    kw = _kw(name)
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, 1024, True)
    assert spec.conv == "mm" and not spec.fold
    fn = pk.make_pallas_chunk(jr, 1024, interpret=True)
    stats, carry = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                      jnp.ones(64, jnp.float32))
    link = mmk.mm_link(_port_setup(kw), "cpu")
    assert link.E == spec.ext
    z = np.zeros((1024, link.T), np.int64)
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, _, _ = mmk.mm_planes(link, (0, 0), 0, 1024, snr_lin, "cpu", (z, z, z))
    # zero words make every symbol alike: one flipped decision moves a count
    # by 1024, so no point may sit near a boundary
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-2
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = mmk.mm_chunk_plain(link, (0, 0), 0, 1024, snr_lin, acc, psum, words=(z, z, z))
    be, se, peak = acc.tolist()
    assert (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    assert mmk.papr_samples(link, 1024) == int(stats["papr_count"])
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=1e-4)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=1e-4)
    np.testing.assert_allclose(cr.numpy(), np.asarray(carry.re), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(carry.im), rtol=1e-4, atol=1e-5)


def _oracle(kw, words, chunk):
    """The zero-prefix mm chain in float64 from the JAX package's builders and
    helpers.  ``words`` hold chunk + 1 rows of T: the previous symbol's, then
    the chunk's."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)._replace(pack=1)
    s = jr.setup
    cfg = s.cfg
    n, L, T = spec.n, spec.L, spec.T
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    tx, sr, si = pk._encode_tile(spec, i32[0][:, :n], None)
    sym = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    fr, fi = pk._tx_ext_matrix(spec, jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type))
    x = sym @ (fr + 1j * fi)
    act = np.concatenate([x[1:, :T], x[:-1, T:]], axis=1)
    y = act @ jlin.conv_matrix_merged(s.taps, T)
    snr = 10.0 ** (kw["snr_db"] / 10.0)
    if kw.get("noise_type", "AWGN") == "AWGN":
        sigma = np.concatenate([
            np.full((min(spec.tile, chunk - t0), 1),
                    np.sqrt(np.mean(np.abs(y[t0 : t0 + spec.tile]) ** 2) / snr / 2.0))
            for t0 in range(0, chunk, spec.tile)])
        u1 = np.maximum(((np.asarray(words[1][1:], np.int64) >> 8) & 0xFFFFFF) * 2.0 ** -24, 2.0 ** -24)
        co, sn = pk._cossin_u24((i32[2][1:] >> 8) & 0xFFFFFF)
        y = y + sigma * np.sqrt(-2.0 * np.log(u1)) * (np.asarray(co, np.float64) + 1j * np.asarray(sn, np.float64))
    rr, ri = jlin.rx_matrix(n, cfg.prefix_type, L)
    yf = y @ (rr + 1j * ri)
    h = np.asarray(s.h_freq, np.complex128)
    slicer = 0.5 / pk._qam_geometry(spec.order)[2]
    if kw["equalization_method"] == "ZF":
        e = yf / h * slicer
    elif kw["equalization_method"] == "MMSE":
        nv = np.mean(np.abs(yf) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = yf * np.conj(h) * slicer / (np.abs(h) ** 2 + nv)
    else:
        e = yf * slicer
    if spec.is_sc:
        dr, di = jdft.dft_matrix(n, inverse=True)
        e = e @ (dr + 1j * di)
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32),
                                   None))
    return np.asarray(tx)[1:], rx, e, x[1:, :T]


@pytest.mark.parametrize("name,snr_db", [("b_zp034_zf", None), ("c_zp034_mmse_noise", 20.0),
                                         ("d_scfde_zp", None), ("e_flat_none", 15.0)])
def test_random_words_match_float64_oracle(name, snr_db):
    kw = _kw(name, **({} if snr_db is None else {"snr_db": snr_db}))
    chunk = 1024
    link = mmk.mm_link(_port_setup(kw), "cpu")
    rng = np.random.default_rng(99)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, link.T), dtype=np.uint64).astype(np.int64)
             for _ in range(3)]
    sym0 = 5 * chunk + 3
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, _, _ = mmk.mm_planes(link, (0, 0), sym0, chunk, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = mmk.mm_chunk_plain(link, (0, 0), sym0, chunk, snr_lin, acc, psum, words=words)
    be, se, peak = acc.tolist()
    jtx, jrx, e, x = _oracle(kw, words, chunk)
    rx = lk.qam_demap(er, ei, link.q).numpy()
    assert np.array_equal(tx.numpy(), jtx)
    # f32 against f64; a wrong previous tail moves the chunk's first symbol
    # by ~0.1 on the ISI links, a wrong noise word by ~sigma
    np.testing.assert_allclose(er.numpy() + 1j * ei.numpy(), e, rtol=1e-5, atol=1e-4)
    near = _boundary_margin(e.real, e.imag, link.q.m) < 1e-4
    assert near.sum() <= 1e-3 * near.size
    assert np.array_equal(rx[~near], jrx[~near])
    assert be > 0 and (be, se) == (int(tmt.index_bit_errors(tx, torch.from_numpy(rx))),
                                   int(tmt.symbol_errors(tx, torch.from_numpy(rx))))
    pw = np.abs(x) ** 2
    assert lk.bits_f32(peak) == pytest.approx(pw.max(), rel=1e-5)
    assert float(psum) == pytest.approx(pw.sum(), rel=1e-5)
    np.testing.assert_allclose(cr.numpy() + 1j * ci.numpy(), x[-1], rtol=1e-5, atol=1e-5)


def _runner(kw):
    return tpl.LinkRunner(_port_setup(kw), device="cpu")


@pytest.mark.parametrize("name", ["b_zp034_zf", "c_zp034_mmse_noise"])
def test_counts_do_not_depend_on_chunking(name):
    # 3584 symbols: the whole run and ragged chunks of 1536, 1536 and 512 all
    # take 512-symbol tiles, so sigma is unchanged
    kw = _kw(name, num_symbols=64 * 3584, snr_db=20.0)
    whole = _runner(kw)
    assert whole.mode == "mm"
    whole = whole.run(7)
    split = _runner(dict(kw, symbols_per_chunk=1536)).run(7)
    assert whole["bit_errors"] > 0
    assert (whole["bit_errors"], whole["symbol_errors"]) == (split["bit_errors"], split["symbol_errors"])
    assert whole["papr_db"] == pytest.approx(split["papr_db"], rel=1e-12)
    assert whole["papr_sample_fraction"] == split["papr_sample_fraction"] == 1.0


@pytest.mark.parametrize(
    "kw",
    [dict(ZP_64SC, prefix_length_ratio=0.34, constellation_order=16, snr_db=30.0), {**ZP_64SC, **SCFDE_ZP}],
    ids=["zp034_mmse", "scfde_zp"],
)
def test_slice_end_to_end_matches_jax_runner(kw):
    B = 1 << 12
    kw = dict(kw, num_symbols=64 * B)
    port_runner = _runner(kw)
    assert port_runner.mode == "mm"
    port = port_runner.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and port["papr_estimator"] == "in_run"
    assert port["papr_sample_fraction"] == 1.0
    assert 3e-3 < port["bit_error_rate"] < 3e-2
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"],
                              ref["total_bits"], z=4)
    assert abs(port["papr_db"] - ref["papr_db"]) < 0.5


def test_link_words_with_width_t_extend_the_bin_draw():
    key = prng.key_words(0x5EED)
    narrow = prng.link_words(key, 1000, 17, 64)
    wide = prng.link_words(key, 1000, 17, 67)
    assert all(torch.equal(w[:, :64], v) for w, v in zip(wide, narrow))
    # the extra columns are fresh words: not the colored-noise draws of lr
    assert not torch.equal(wide[1][:, 64:], prng.noise_words(key, 1000, 17, 3)[0])


def test_mm_runner_needs_cuda_or_an_explicit_cpu():
    setup = _port_setup(ZP_64SC)
    if torch.cuda.is_available():
        assert tpl.LinkRunner(setup).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(setup)
    with pytest.raises(ValueError):
        mmk.mm_chunk(mmk.mm_link(setup, "cpu"), (0, 0), 0, 64, 1.0,
                     torch.zeros(3, dtype=torch.int64, device="meta"),
                     torch.zeros(1, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="zero-prefix"):
        mmk.mm_link(_port_setup(dict(ZP_64SC, prefix_type="CYCLIC")), "cpu")
