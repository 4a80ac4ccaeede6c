"""The port's power stages (apply_power, normalize) on all four chains.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros), f32-grade products on the JAX side (matmul_passes=3): the port's
  plain chunks with both switches on count the same errors on diag, fold
  (SC-FDE), mm (ZP), lr (128 sc, CP 0.34) and an aqam diag link.
* On seeded random words at sym0 > 0: each chain's staged plain chunk
  against a float64 oracle built from the JAX package's builders, which
  scales the previous symbol's tail too and normalizes over the tile.
* The two faults the slice repairs: diag links over an IR without unit
  energy (their channel rows, and the BER against the JAX runner's XLA
  path), and the tile rule's bf16 staging factor against ``_spec_for``.
* End to end: one waterfilling link a chain with both switches through
  ``LinkRunner(device="cpu")`` against the JAX runner's XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import metrics as tmt

BASE = dict(num_subcarriers=64, constellation_order=64, channel_type="CUSTOM", channel_model="Lin-Phoong_P2",
            prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="ZF", noise_type="NONE",
            snr_db=30.0, apply_power_allocation=True, normalize_before_demap=True)
# One link a chain, as the JAX package routes them.
CHAINS = {
    "diag": {},
    "fold": dict(modulation_type="SC-OFDM", channel_model="Lin-Phoong_P1"),
    "mm": dict(prefix_type="ZERO"),
    "lr": dict(num_subcarriers=128, prefix_length_ratio=0.34),
}
_ADAPTIVE = dict(adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING",
                 channel_model="Lin-Phoong_P1", snr_db=20.0)


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(chain, num_ofdm=1024, **extra):
    kw = {**BASE, **CHAINS.get(chain, {}), **extra}
    adaptive = kw.get("adaptive_modulation_mode") == "CAPACITY_BASED"
    kw["num_symbols"] = num_ofdm if adaptive else num_ofdm * kw["num_subcarriers"]
    return kw


def _jax_runner(kw, channel_ir=None, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra),
                                      channel_ir))


def _port_runner(kw, channel_ir=None):
    return tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw), channel_ir), device="cpu")


def _width(runner):
    return runner.setup.block_length if runner.mode == "mm" else runner.setup.cfg.num_subcarriers


@pytest.mark.parametrize("chain", ["diag", "fold", "mm", "lr", "aqam_diag"])
def test_zero_words_match_pallas_kernel(chain):
    kw = _kw("diag", **_ADAPTIVE) if chain == "aqam_diag" else _kw(chain)
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, 1024, True)
    assert spec.apply_power and spec.normalize
    n = kw["num_subcarriers"]
    sqrt_power = np.linspace(0.52, 1.47, n).astype(np.float32)
    fn = pk.make_pallas_chunk(jr, 1024, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.asarray(sqrt_power))
    port = _port_runner(dict(kw, matmul_passes=3))
    assert port.mode == ("diag" if chain == "aqam_diag" else chain)
    assert port.link.q.mode == ("aqam" if chain == "aqam_diag" else "qam")
    z = np.zeros((1024, _width(port)), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    _plain_chunk(port.mode)(port.link, (0, 0), 0, 1024, lk.snr_linear(kw["snr_db"]), acc, psum, words=(z, z, z),
          rows=torch.tensor(sqrt_power)[None])
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))


def _plain_chunk(mode):
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    return {"diag": lk.diag_chunk_plain, "fold": fk.fold_chunk_plain, "lr": lrk.lr_chunk_plain,
            "mm": mmk.mm_chunk_plain}[mode]


def _planes(port, sym0, chunk, words, rows):
    from ofdm_tpu_torch.ops import fold_kernel as fk
    from ofdm_tpu_torch.ops import lr_kernel as lrk
    from ofdm_tpu_torch.ops import mm_kernel as mmk

    snr_lin = lk.snr_linear(port.setup.cfg.snr_db)
    fn = {"diag": lk.diag_planes, "fold": fk.fold_planes, "lr": lrk.lr_planes, "mm": mmk.mm_planes}[port.mode]
    tx, er, ei = fn(port.link, (0, 0), sym0, chunk, snr_lin, "cpu", words, rows)[:3]
    return tx.numpy(), er.numpy(), ei.numpy()


def _oracle(kw, words, chunk, sqrt_power, tile):
    """The chain in float64 from the JAX package's builders: the scaled
    symbols (the previous symbol's too), the dense channel, ZF or MMSE
    against the raw h_freq, the SC IDFT, then each tile normalized to unit
    mean power with the slicer gain.  ``words`` hold chunk + 1 rows: the
    previous symbol's, then the chunk's."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)._replace(pack=1)
    s = jr.setup
    cfg = s.cfg
    n, L, T = spec.n, s.prefix_length, spec.n + s.prefix_length
    i32 = jnp.asarray(np.asarray(words[0], np.uint32).view(np.int32))
    tx, sr, si = pk._encode_tile(spec, i32[:, :n], None)
    sym = (np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)) * np.asarray(sqrt_power, np.float64)
    h = np.asarray(s.h_freq, np.complex128)
    E = jlin.ext_width(len(np.asarray(s.taps)), T)
    ftx = jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    fr, fi = pk._tx_ext_matrix(spec._replace(ext=E), ftx)
    x = sym @ (fr + 1j * fi)
    act = np.concatenate([x[1:, :T], x[:-1, T:]], axis=1)
    if cfg.prefix_type == jcfg.PrefixType.ZERO:
        rr, ri = jlin.rx_matrix(n, cfg.prefix_type, L)
        y = (act @ jlin.conv_matrix_merged(s.taps, T)) @ (rr + 1j * ri)
    elif E:
        y = act @ jlin.conv_rx_merged(s.taps, n, cfg.prefix_type, L)
    else:
        y = sym[1:] * h
    snr = 10.0 ** (kw["snr_db"] / 10.0)
    if kw["equalization_method"] == "ZF":
        e = y / h
    else:
        nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = y * np.conj(h) / (np.abs(h) ** 2 + nv)
    if spec.is_sc:
        dr, di = jdft.dft_matrix(n, inverse=True)
        e = e @ (dr + 1j * di)
    slicer = 0.5 / pk._qam_geometry(spec.order)[2]
    for t0 in range(0, chunk, tile):
        e[t0 : t0 + tile] *= slicer / np.sqrt(np.mean(np.abs(e[t0 : t0 + tile]) ** 2))
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32), None))
    return np.asarray(tx)[1:], rx, e, x[1:, :T]


def _boundary_margin(e, m):
    c0 = (m - 1) * 0.5
    bounds = np.arange(m - 1) + 0.5
    d = np.full(e.shape, np.inf)
    for v in (e.real + c0, c0 - e.imag):
        d = np.minimum(d, np.abs(v[..., None] - bounds).min(axis=-1))
    return d


@pytest.mark.parametrize("chain,method,chunk", [("diag", "MMSE", 2048), ("fold", "ZF", 2048), ("mm", "MMSE", 2048),
                                                ("lr", "ZF", 1024)])
def test_random_words_match_float64_oracle(chain, method, chunk):
    """Each tile covers two measured-power slices, so a slice mean would
    not pass; the guard (ratio 0.34) is shorter than the channel on the
    ISI chains, so the previous symbol's tail enters the chunk's first
    symbol and an unscaled tail would not pass either."""
    sym0 = 3 * chunk + 5
    kw = _kw(chain, num_ofdm=8 * chunk, equalization_method=method, constellation_order=16,
             **({} if chain == "diag" else {"prefix_length_ratio": 0.34}))
    port = _port_runner(kw)
    assert port.mode == chain and port.link.apply_power and port.link.normalize
    tile = lk.tile_for(chunk, port.link.tile_cap)
    assert tile == chunk
    n, width = kw["num_subcarriers"], _width(port)
    rng = np.random.default_rng(6)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, width), dtype=np.uint64).astype(np.int64) for _ in range(3)]
    sqrt_power = rng.uniform(0.5, 1.5, n).astype(np.float32)
    rows = torch.tensor(sqrt_power)[None]
    port_words = [w[1:] for w in words] if chain == "diag" else words
    tx, er, ei = _planes(port, sym0, chunk, port_words, rows)
    jtx, jrx, e, x = _oracle(kw, words, chunk, sqrt_power, tile)
    assert np.array_equal(tx, jtx)
    np.testing.assert_allclose(er + 1j * ei, e, rtol=1e-5, atol=1e-4)
    near = _boundary_margin(e, 4) < 1e-4
    assert near.sum() <= 1e-3 * near.size
    rx = lk.qam_demap(torch.from_numpy(er), torch.from_numpy(ei), port.link.q).numpy()
    assert np.array_equal(rx[~near], jrx[~near])
    acc, psum = lk.new_accumulators("cpu")
    _plain_chunk(port.mode)(port.link, (0, 0), sym0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum,
                              words=port_words, rows=rows)
    be, se, peak = acc.tolist()
    assert be > 0 and (be, se) == (int(tmt.index_bit_errors(torch.from_numpy(tx), torch.from_numpy(rx))),
                                   int(tmt.symbol_errors(torch.from_numpy(tx), torch.from_numpy(rx))))
    # the PAPR statistic sees the scaled symbols (one tile: every chain samples it)
    pw = np.abs(x) ** 2
    assert lk.bits_f32(peak) == pytest.approx(pw.max(), rel=1e-5)
    assert float(psum) == pytest.approx(pw.sum(), rel=1e-5)


def test_noise_bump_chunk_matches_pallas_kernel():
    """The study's chunk (post-EQ noise, 1/sqrt(P), normalization) against
    make_noise_bump_chunk in interpret mode, on
    test_noise_bump_kernel_matches_oracle's rows."""
    kw = _kw("diag")
    jr = _jax_runner(kw, matmul_passes=3)
    fn, consts, spec = pk.make_noise_bump_chunk(jr, 1024, interpret=True)
    sqrt_power = np.linspace(0.52, 1.47, 64).astype(np.float32)
    inv = sqrt_power.copy()
    inv[inv < 1e-10] = 1.0
    noise_std = np.full(64, 0.03, np.float32)
    noise_std[48:] *= 2.0
    rows = np.stack([sqrt_power, 1.0 / inv, noise_std]).astype(np.float32)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(30.0), jnp.asarray(rows), consts)
    link = lk.noise_bump_link(_port_runner(dict(kw, matmul_passes=3)).link)
    z = np.zeros((1024, 64), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    lk.diag_chunk_plain(link, (0, 0), 0, 1024, lk.snr_linear(30.0), acc, psum, words=(z,) * 5,
                        rows=torch.tensor(rows))
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    with pytest.raises(ValueError, match="noise_type=NONE"):
        lk.noise_bump_link(_port_runner(dict(kw, noise_type="AWGN")).link)


def test_stage_rows_are_checked():
    port = _port_runner(_kw("diag", num_ofdm=64))
    acc, psum = lk.new_accumulators("cpu")
    with pytest.raises(ValueError, match="rows"):
        lk.diag_chunk_plain(port.link, (0, 0), 0, 64, 1.0, acc, psum)
    with pytest.raises(ValueError, match="rows"):
        lk.diag_chunk_plain(port.link, (0, 0), 0, 64, 1.0, acc, psum, rows=torch.ones(1, 32))


# --- the repaired faults ---------------------------------------------------------

# examples/custom_channel_demo.py's IR (energy 1.22) and a 4-tap IR of energy
# 1.3225: CP 1.0 covers both, so they route to diag.
CUSTOM_IRS = {"custom_channel_demo": [1.0, 0.4 - 0.2j, 0.1 + 0.1j], "ir_4tap": [1.0, 0.5, 0.25j, 0.1]}


@pytest.mark.parametrize("name", list(CUSTOM_IRS))
def test_diag_link_over_an_ir_without_unit_energy(name):
    ir = np.asarray(CUSTOM_IRS[name], np.complex128)
    kw = dict(BASE, num_symbols=64 * (1 << 12), constellation_order=16, equalization_method="MMSE",
              noise_type="AWGN", snr_db=20.0, apply_power_allocation=False, normalize_before_demap=False)
    port = _port_runner(kw, ir)
    assert port.mode == "diag"
    link = port.link
    h = np.fft.fft(ir, 64)
    np.testing.assert_array_equal(link.hr.numpy(), h.real.astype(np.float32))
    np.testing.assert_allclose(link.cr.numpy() + 1j * link.ci.numpy(), h / np.linalg.norm(ir), rtol=1e-6, atol=1e-6)
    r = port.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw), ir)).run(jax.random.PRNGKey(0))
    assert ref["hotpath_used"] == "xla"
    assert tmt.ber_equivalent(r["bit_errors"], r["total_bits"], ref["bit_errors"], ref["total_bits"], z=5)


def test_unit_energy_links_keep_the_h_rows():
    link = _port_runner(_kw("diag", num_ofdm=64)).link
    assert torch.equal(link.cr, link.hr) and torch.equal(link.ci, link.hi)


def _custom_ir(taps, seed=3):
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal(taps) + 1j * rng.standard_normal(taps)
    return ir / np.linalg.norm(ir)


@pytest.mark.parametrize(
    "extra,taps,mode,tile",
    [
        # SC-FDE, 128 sc, 16 taps, CP 0.87: T = 141, E = 15
        (dict(modulation_type="SC-OFDM", num_subcarriers=128, prefix_length_ratio=0.87), 16, "fold", 4096),
        # the same with a zero prefix
        (dict(modulation_type="SC-OFDM", num_subcarriers=128, prefix_type="ZERO", prefix_length_ratio=0.87), 16,
         "mm", 4096),
        # OFDM, 128 sc, 34 taps, CP 0.85: T = 156, E = 33
        (dict(num_subcarriers=128, prefix_length_ratio=0.85), 34, "lr", 4096),
    ],
    ids=["fold", "mm", "lr"],
)
def test_three_pass_tiles_match_jax_spec(extra, taps, mode, tile):
    """1024-QAM stages three bf16 passes in the JAX planner; the port's tile
    caps follow (at one pass these links would take 8192)."""
    kw = dict(_kw("diag", **extra), constellation_order=1024, apply_power_allocation=False,
              normalize_before_demap=False)
    ir = _custom_ir(taps)
    port = _port_runner(kw, ir)
    assert port.mode == mode and lk.selected_passes(port.setup) == 3
    spec = pk._spec_for(_jax_runner(kw, ir), 1 << 17, True)
    assert lk.tile_for(1 << 17, port.link.tile_cap) == spec.tile == tile
    assert spec.passes == 3


# --- end to end --------------------------------------------------------------------


@pytest.mark.parametrize("chain", list(CHAINS))
def test_waterfilling_link_matches_jax_runner(chain):
    kw = _kw(chain, num_ofdm=1 << 10, power_allocation_type="WATERFILLING", noise_type="AWGN",
             equalization_method="MMSE", constellation_order=16, snr_db=15.0)
    port = _port_runner(kw)
    assert port.mode == chain
    r = port.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert ref["hotpath_used"] == "xla" and r["papr_estimator"] == "in_run"
    assert r["bit_errors"] > 0
    assert tmt.ber_equivalent(r["bit_errors"], r["total_bits"], ref["bit_errors"], ref["total_bits"], z=5)


def test_apply_power_keeps_the_wide_lr_papr_in_run():
    """From 512 subcarriers the sampled TX batch is unscaled, so a link that
    applies its allocation takes its PAPR from the run (the JAX tile rule
    with the TX matrix staged)."""
    kw = _kw("lr", num_ofdm=64, num_subcarriers=512, channel_model="severe_multipath", constellation_order=16,
             power_allocation_type="WATERFILLING")
    port = _port_runner(kw)
    assert port.mode == "lr" and not port.link.txext
    assert lk.tile_for(1 << 17, port.link.tile_cap) == pk._spec_for(_jax_runner(kw), 1 << 17, True).tile
    r = port.run(0)
    assert r["papr_estimator"] == "in_run" and 5.0 < r["papr_db"] < 15.0
