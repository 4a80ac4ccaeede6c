"""The port's fold chunk and its links against the JAX package.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros), with f32-grade products on the JAX side (matmul_passes=3): the
  port's plain fold chunk on all-zero words counts the same errors.
* On seeded random words, sym0 > 0: the port's plain chunk against a
  float64 oracle built from the JAX package's own builders and helpers.
* Host constants against the JAX builders, the tile rule against
  ``_spec_for``, chunking independence, the slice end to end against the
  JAX runner's XLA path, and the SNR sweep.
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
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import linops as tlin
from ofdm_tpu_torch.ops import metrics as tmt

# The reference's default configuration (bench.py's scfde_default cell).
SCFDE_DEFAULT = dict(
    num_symbols=64 * 1024,
    num_subcarriers=64,
    constellation_order=4,
    channel_type="CUSTOM",
    channel_model="Lin-Phoong_P1",
    modulation_type="SC-OFDM",
    prefix_type="CYCLIC",
    prefix_length_ratio=1.0,
    equalization_method="ZF",
    snr_db=10.0,
)
REFERENCE_BER_SCFDE_10DB = 0.0145  # docs/RESULTS.md

_ISI_OFDM = dict(modulation_type="OFDM", prefix_length_ratio=0.5, channel_model="severe_multipath",
                 constellation_order=16, equalization_method="MMSE", snr_db=20.0)
LINKS = {
    "scfde_default": {},
    "scfde_mmse_16qam_severe": dict(equalization_method="MMSE", constellation_order=16,
                                    channel_model="severe_multipath", snr_db=15.0),
    "ofdm_short_cp": _ISI_OFDM,  # E = 7, real ISI
    "ofdm_no_prefix_p2": dict(modulation_type="OFDM", prefix_type="NONE", channel_model="Lin-Phoong_P2",
                              constellation_order=16, snr_db=20.0),
    "ofdm_short_cp_noiseless": dict(_ISI_OFDM, noise_type="NONE"),
}
# Zero words turn the noise into one deterministic offset of 5.77 sigma;
# at 20 dB it leaves link (c)'s points 0.007 from a boundary, at 30 dB 0.08.
ZERO_WORDS_SNR = {"ofdm_short_cp": 30.0}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(name, **extra):
    return {**SCFDE_DEFAULT, **LINKS[name], **extra}


def _port_link(kw):
    return fk.fold_link(tpl.prepare(tcfg.SimulationConfig(**kw)), "cpu")


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


@pytest.mark.parametrize("name", list(LINKS))
def test_zero_words_match_pallas_kernel(name):
    kw = _kw(name, **({"snr_db": ZERO_WORDS_SNR[name]} if name in ZERO_WORDS_SNR else {}))
    jr = _jax_runner(kw, matmul_passes=3)
    assert pk._spec_for(jr, 1024, True).conv == "mm" and pk._spec_for(jr, 1024, True).fold
    fn = pk.make_pallas_chunk(jr, 1024, interpret=True)
    stats, carry = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                      jnp.ones(64, jnp.float32))
    link = _port_link(kw)
    z = np.zeros((1024, 64), np.int64)
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, _, _ = fk.fold_planes(link, (0, 0), 0, 1024, snr_lin, "cpu", (z, z, z))
    # zero words make every symbol alike: one flipped decision moves a count
    # by 1024, so no point may sit near a boundary
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-2
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = fk.fold_chunk_plain(link, (0, 0), 0, 1024, snr_lin, acc, psum, words=(z, z, z))
    be, se, peak = acc.tolist()
    assert (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    assert fk.papr_samples(link, 1024) == int(stats["papr_count"])
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=1e-4)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=1e-4)
    np.testing.assert_allclose(cr.numpy(), np.asarray(carry.re), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(carry.im), rtol=1e-4, atol=1e-5)


def _oracle(kw, words, chunk):
    """The fold chain in float64 from the JAX package's builders and helpers.
    ``words`` hold chunk + 1 rows: the previous symbol's, then the chunk's."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)._replace(pack=1)
    s = jr.setup
    cfg = s.cfg
    n, L, T, E = spec.n, spec.L, spec.T, spec.ext
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    tx, sr, si = pk._encode_tile(spec, i32[0], None)
    sym = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    fr, fi = pk._tx_ext_matrix(spec, jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type))
    x = sym @ (fr + 1j * fi)
    act = np.concatenate([x[1:, :T], x[:-1, T:]], axis=1)
    y = act @ jlin.conv_rx_merged(s.taps, n, cfg.prefix_type, L)
    snr = 10.0 ** (kw["snr_db"] / 10.0)
    if kw.get("noise_type", "AWGN") == "AWGN":
        S = lk.slice_symbols(n)
        sigma = np.concatenate([
            np.full((min(spec.tile, chunk - t0), 1),
                    np.sqrt(np.mean(np.abs(y[t0 : t0 + min(S, spec.tile)]) ** 2) / snr / 2.0))
            for t0 in range(0, chunk, spec.tile)])
        u1 = np.maximum(((np.asarray(words[1][1:], np.int64) >> 8) & 0xFFFFFF) * 2.0 ** -24, 2.0 ** -24)
        co, sn = pk._cossin_u24((i32[2][1:] >> 8) & 0xFFFFFF)
        y = y + sigma * np.sqrt(-2.0 * np.log(u1)) * (np.asarray(co, np.float64) + 1j * np.asarray(sn, np.float64))
    h = np.asarray(s.h_freq, np.complex128)
    slicer = 0.5 / pk._qam_geometry(spec.order)[2]
    if kw["equalization_method"] == "ZF":
        e = y / h * slicer
    else:
        nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = y * np.conj(h) * slicer / (np.abs(h) ** 2 + nv)
    if spec.is_sc:
        dr, di = jdft.dft_matrix(n, inverse=True)
        e = e @ (dr + 1j * di)
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32),
                                   None))
    return np.asarray(tx)[1:], rx, e, x[1:, :T]


@pytest.mark.parametrize("name,chunk", [(name, 1024 if i % 2 else 2048) for i, name in enumerate(LINKS)])
def test_random_words_match_float64_oracle(name, chunk):
    kw = _kw(name)
    rng = np.random.default_rng(99)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, 64), dtype=np.uint64).astype(np.int64)
             for _ in range(3)]
    sym0 = 5 * chunk + 3
    link = _port_link(kw)
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, _, _ = fk.fold_planes(link, (0, 0), sym0, chunk, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = fk.fold_chunk_plain(link, (0, 0), sym0, chunk, snr_lin, acc, psum, words=words)
    be, se, peak = acc.tolist()
    jtx, jrx, e, x = _oracle(kw, words, chunk)
    rx = lk.qam_demap(er, ei, link.q).numpy()
    assert np.array_equal(tx.numpy(), jtx)
    # f32 against f64 (largest gap seen 3e-5); a wrong previous tail moves
    # the chunk's first symbol by ~0.1 on the ISI links
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


@pytest.mark.parametrize("name", list(LINKS)[:4])
def test_fold_link_matches_jax_builders(name):
    kw = _kw(name)
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, 1024, True)
    s = jr.setup
    cfg = s.cfg
    n, L, T, E = spec.n, spec.L, spec.T, spec.ext
    link = _port_link(kw)
    assert (link.n, link.T, link.E, link.is_sc) == (n, T, E, spec.is_sc)
    pcfg = tcfg.SimulationConfig(**kw)
    tx = tlin.tx_ext_matrix(tlin.tx_matrix(n, pcfg.prefix_type, L, pcfg.modulation_type), E)
    jtx = pk._tx_ext_matrix(spec._replace(pack=1), jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type))
    cm = tlin.conv_rx_merged(np.asarray(s.taps), n, pcfg.prefix_type, L)
    jcm = jlin.conv_rx_merged(s.taps, n, cfg.prefix_type, L)
    for a, b in zip(tx + (cm,), jtx + (jcm,)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for t, ref in ((link.txr, jtx[0]), (link.txi, jtx[1]), (link.cmr, jcm.real), (link.cmi, jcm.imag)):
        assert np.array_equal(t.numpy(), ref.astype(np.float32))
    if spec.is_sc:
        assert np.array_equal(link.idr.numpy(), jdft.dft_matrix(n, inverse=True)[0].astype(np.float32))
        assert np.array_equal(link.idi.numpy(), jdft.dft_matrix(n, inverse=True)[1].astype(np.float32))
    else:
        assert link.idr is None
    consts = pk._consts_for(jr, spec)
    first = 1 + 3 * (3 if spec.is_sc else 2)  # after cg and the staged matrices' bf16 splits
    rows = [np.asarray(c, np.float32)[0, :n] for c in consts[first : first + 5]]
    for t, ref in zip((link.hr, link.hi, link.habs2, link.gr, link.gi), rows):
        assert np.array_equal(t.numpy(), ref)
    assert link.cg == float(np.asarray(consts[0])[0])


@pytest.mark.parametrize(
    "extra,tile",
    [({}, 8192), (dict(num_subcarriers=256, num_symbols=256 * 64), 4096), (LINKS["ofdm_short_cp"], 8192)],
    ids=["scfde_default", "scfde_256sc", "ofdm_short_cp"],
)
def test_tile_matches_jax_spec(extra, tile):
    kw = dict(SCFDE_DEFAULT, **extra)
    link = _port_link(kw)
    assert lk.tile_for(1 << 17, link.tile_cap) == pk._spec_for(_jax_runner(kw), 1 << 17, True).tile == tile


def _runner(name, num_ofdm, **extra):
    kw = _kw(name, num_symbols=64 * num_ofdm, **extra)
    return tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")


@pytest.mark.parametrize(
    "name,num_ofdm,chunk",
    [
        # noisy: the chunks keep the whole run's 512-symbol tiles, so sigma is unchanged
        ("ofdm_short_cp", 4608, 1536),
        # noiseless: chunks of 1100, 1100 and 800, each with a ragged last tile
        ("ofdm_short_cp_noiseless", 3000, 1100),
    ],
)
def test_counts_do_not_depend_on_chunking(name, num_ofdm, chunk):
    whole = _runner(name, num_ofdm).run(7)
    split = _runner(name, num_ofdm, symbols_per_chunk=chunk).run(7)
    assert whole["bit_errors"] > 0
    assert (whole["bit_errors"], whole["symbol_errors"]) == (split["bit_errors"], split["symbol_errors"])
    assert whole["papr_db"] == pytest.approx(split["papr_db"], rel=1e-12)
    assert whole["papr_sample_fraction"] == split["papr_sample_fraction"] == 1.0


@pytest.mark.parametrize("name", ["scfde_default", "ofdm_short_cp"])
def test_slice_end_to_end_matches_jax_runner(name):
    B = 1 << 14
    port_runner = _runner(name, B)
    assert port_runner.mode == "fold"
    port = port_runner.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**_kw(name, num_symbols=64 * B)))).run(
        jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and port["papr_estimator"] == "in_run"
    if name == "scfde_default":
        for r in (port, ref):
            assert abs(r["bit_error_rate"] - REFERENCE_BER_SCFDE_10DB) < 1.5e-3
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"],
                              ref["total_bits"], z=4)
    assert abs(port["papr_db"] - ref["papr_db"]) < 0.3


def test_scfde_snr_sweep_falls():
    runner = _runner("scfde_default", 1 << 12)
    bers = [runner.run(3, snr_db=s)["bit_error_rate"] for s in (0.0, 10.0, 20.0)]
    assert bers[0] > bers[1] > bers[2]


@pytest.mark.parametrize(
    "extra,conv,mode",
    [
        ({}, "mm", "fold"),
        (dict(num_subcarriers=256, num_symbols=256 * 16), "mm", "fold"),
        (LINKS["ofdm_short_cp"], "mm", "fold"),
        (LINKS["ofdm_no_prefix_p2"], "mm", "fold"),
        (dict(LINKS["ofdm_short_cp"], num_subcarriers=128, num_symbols=128 * 16), "lr", "lr"),
        (dict(modulation_type="OFDM", channel_model="Lin-Phoong_P2"), "diag", "diag"),
        # ISI-free past the 256-subcarrier warp layout (JAX: diag, tile
        # 2048): the block-per-symbol diag kernel
        (dict(modulation_type="OFDM", channel_model="Lin-Phoong_P2", num_subcarriers=384,
              num_symbols=384 * 16), "diag", "diag"),
    ],
    ids=["scfde_default", "scfde_256sc", "ofdm_short_cp", "ofdm_no_prefix", "ofdm_short_cp_128sc",
         "ofdm_cp_covers", "ofdm_isi_free_384sc"],
)
def test_routing_mirrors_jax_plan(extra, conv, mode):
    kw = dict(SCFDE_DEFAULT, **extra)
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    assert pk.plan_for(_jax_runner(kw))[1] == conv
    assert tpl.kernel_mode(setup) == mode == tpl.LinkRunner(setup, device="cpu").mode


def test_fold_runner_needs_cuda_or_an_explicit_cpu():
    setup = tpl.prepare(tcfg.SimulationConfig(**SCFDE_DEFAULT))
    if torch.cuda.is_available():
        assert tpl.LinkRunner(setup).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(setup)
    with pytest.raises(ValueError):
        fk.fold_chunk(fk.fold_link(setup, "cpu"), (0, 0), 0, 64, 1.0,
                      torch.zeros(3, dtype=torch.int64, device="meta"),
                      torch.zeros(1, dtype=torch.float64, device="meta"))
