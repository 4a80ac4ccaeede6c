"""The port's fold chain past 256 subcarriers (fold_wide) against the JAX package.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros), f32-grade products on the JAX side (matmul_passes=3): the wide
  plain chunk on all-zero words counts the same errors on SC-FDE with a
  cyclic prefix at 300 and 512 subcarriers and without one at 512, and on
  a staged link (apply_power + normalize).
* On seeded random words, sym0 > 0: the wide plain chunk against a float64
  oracle from the JAX package's builders (tx_matrix, conv_rx_merged, the
  IDFT matrix), the previous symbol's tail included.
* The plain block DFT against numpy.fft; the seam at 256 subcarriers, where
  the wide chain forced on a narrow link meets the warp-per-symbol one; the
  tile and fits rules against ``_spec_for``; routing against ``plan_for``;
  chunking, the carry-in and the probe; end to end against the JAX XLA
  runner.
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
from ofdm_tpu_torch.ops import dft as tdft
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import linops as tlin
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.parallel import ShardedLinkRunner, make_mesh

# tools/shape_audit.py's SC-FDE shapes: 64-QAM, severe_multipath, CP ratio
# 1.0, MMSE (SC-CY1.0-<n>); 16-QAM where zero words need decision margin.
AUDIT = dict(constellation_order=64, channel_type="CUSTOM", channel_model="severe_multipath",
             modulation_type="SC-OFDM", prefix_type="CYCLIC", prefix_length_ratio=1.0,
             equalization_method="MMSE", snr_db=30.0)
LINKS = {
    "sc_cp_300_flat": dict(num_subcarriers=300, channel_model="flat_fading", constellation_order=16),
    "sc_cp_512": dict(num_subcarriers=512, constellation_order=16),
    "sc_none_512": dict(num_subcarriers=512, prefix_type="NONE", constellation_order=16),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(extra, num_ofdm=1024):
    kw = {**AUDIT, **extra}
    kw["num_symbols"] = kw["num_subcarriers"] * num_ofdm
    return kw


def _setup(kw):
    return tpl.prepare(tcfg.SimulationConfig(**kw))


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra)))


def _plan_runner(kw):
    """A JAX runner on the default hotpath, as the port's runner routes: no
    "taps" fallback (hotpath="pallas" only), no kernel where the plan fails."""
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar")))


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
    kw = _kw(LINKS[name])
    n, chunk = kw["num_subcarriers"], 256
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.conv == "mm" and spec.fold
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, carry = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                      jnp.ones(n, jnp.float32))
    link = fk.fold_link(_setup(kw), "cpu")
    assert fk.is_wide(link) and link.txr is None
    z = np.zeros((chunk, n), np.int64)
    snr_lin = lk.snr_linear(kw["snr_db"])
    _, er, ei, _, _ = fk.fold_wide_planes(link, (0, 0), 0, chunk, snr_lin, "cpu", (z, z, z))
    # zero words make the symbols alike, so a flipped decision moves a count
    # by up to the chunk; the JAX products (bf16 x 3) agree with f32 to
    # ~1e-5 in slicer units, so every point keeps 1e-3 from a boundary
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-3
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = fk.fold_chunk_plain(link, (0, 0), 0, chunk, snr_lin, acc, psum, words=(z, z, z))
    be, se, peak = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    assert fk.papr_samples(link, chunk) == int(stats["papr_count"])
    # PAPR and carry: f32 against the JAX kernel's bf16 x 3 TX product
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=1e-4)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=1e-4)
    np.testing.assert_allclose(cr.numpy(), np.asarray(carry.re), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(carry.im), rtol=1e-4, atol=1e-5)


def test_staged_zero_words_match_pallas_kernel():
    kw = _kw(dict(LINKS["sc_cp_512"], noise_type="NONE", equalization_method="ZF", apply_power_allocation=True,
                  normalize_before_demap=True))
    n, chunk = 512, 256
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.apply_power and spec.normalize and spec.conv == "mm"
    sqrt_power = np.linspace(0.52, 1.47, n).astype(np.float32)
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.asarray(sqrt_power))
    link = fk.fold_link(_setup(kw), "cpu")
    z = np.zeros((chunk, n), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    fk.fold_chunk_plain(link, (0, 0), 0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=(z, z, z),
                        rows=torch.tensor(sqrt_power)[None])
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))


def _oracle(kw, words, chunk):
    """The fold chain in float64 from the JAX package's builders and helpers.
    ``words`` hold chunk + 1 rows: the previous symbol's, then the chunk's."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)._replace(pack=1)
    s = jr.setup
    cfg = s.cfg
    n, L, T = spec.n, spec.L, spec.T
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    tx, sr, si = pk._encode_tile(spec, i32[0], None)
    sym = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    fr, fi = pk._tx_ext_matrix(spec, jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type))
    x = sym @ (fr + 1j * fi)
    act = np.concatenate([x[1:, :T], x[:-1, T:]], axis=1)
    y = act @ jlin.conv_rx_merged(s.taps, n, cfg.prefix_type, L)
    snr = 10.0 ** (kw["snr_db"] / 10.0)
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
    nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
    e = y * np.conj(h) * slicer / (np.abs(h) ** 2 + nv)
    dr, di = jdft.dft_matrix(n, inverse=True)
    e = e @ (dr + 1j * di)
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32),
                                   None))
    return np.asarray(tx)[1:], rx, e, x[1:, :T]


@pytest.mark.parametrize("n", [300, 512])
def test_random_words_match_float64_oracle(n):
    kw = _kw(dict(num_subcarriers=n, snr_db=20.0))
    chunk = 256
    rng = np.random.default_rng(99)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, n), dtype=np.uint64).astype(np.int64) for _ in range(3)]
    sym0 = 5 * chunk + 3
    link = fk.fold_link(_setup(kw), "cpu")
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, _, _ = fk.fold_wide_planes(link, (0, 0), sym0, chunk, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = fk.fold_chunk_plain(link, (0, 0), sym0, chunk, snr_lin, acc, psum, words=words)
    be, se, peak = acc.tolist()
    jtx, jrx, e, x = _oracle(kw, words, chunk)
    rx = lk.qam_demap(er, ei, link.q).numpy()
    assert np.array_equal(tx.numpy(), jtx)
    # f32 block transforms against f64 products (largest gap seen 2e-5); a
    # wrong previous tail moves the chunk's first symbol by ~0.1
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


@pytest.mark.parametrize("n", [300, 512, 1024])
def test_block_dft_matches_numpy_fft(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    plan = tdft.dft_plan(n, "cpu")
    assert (plan.log2n >= 0) == (n & (n - 1) == 0) and plan.n1 * plan.n2 == n
    xr, xi = (torch.tensor(v, dtype=torch.float32) for v in (x.real, x.imag))
    for inverse, ref in ((False, np.fft.fft(x, norm="ortho")), (True, np.fft.ifft(x, norm="ortho"))):
        yr, yi = tdft.block_dft(xr, xi, plan, inverse)
        err = np.abs(yr.numpy() + 1j * yi.numpy() - ref).max(axis=1)
        # f32 twiddles and sums: the largest error within 1e-5 of the output's norm
        assert (err <= 1e-5 * np.linalg.norm(ref, axis=1)).all()


def test_seam_at_256_subcarriers_meets_the_narrow_chain():
    kw = _kw(dict(num_subcarriers=256, snr_db=20.0))
    link = fk.fold_link(_setup(kw), "cpu")
    assert not fk.is_wide(link)
    snr_lin = lk.snr_linear(20.0)
    narrow = fk.fold_planes(link, (3, 4), 1000, 512, snr_lin, "cpu")
    wide = fk.fold_wide_planes(link, (3, 4), 1000, 512, snr_lin, "cpu")
    assert torch.equal(narrow[0], wide[0])
    # dense f32 products against the block DFT: the points agree within
    # 1e-4 (seen: 7e-6); the rounding differs, the draws do not
    for a, b in zip(narrow[1:3], wide[1:3]):
        assert (a - b).abs().max() < 1e-4
    counts = []
    for fn in (fk.fold_planes, fk.fold_wide_planes):
        tx, er, ei, _, _ = fn(link, (3, 4), 1000, 512, snr_lin, "cpu")
        counts.append(int(tmt.index_bit_errors(tx, lk.qam_demap(er, ei, link.q))))
    # a point within 1e-4 of a boundary may flip: a handful of bits at most
    assert counts[0] > 1000 and abs(counts[0] - counts[1]) <= 4


# (link, JAX tile at a 2^17-symbol chunk or None where no fused kernel takes it)
TILE_CASES = {
    "SC-CY1.0-512": (dict(num_subcarriers=512), 2048),
    "SC-CY1.0-1024": (dict(num_subcarriers=1024), 512),
    "SC-CY1.0-1024_1024qam": (dict(num_subcarriers=1024, constellation_order=1024), 512),
    "sc_flat_cp_300": (dict(num_subcarriers=300, channel_model="flat_fading"), 4096),
    "SC-CY1.0-1500_mm4": (dict(num_subcarriers=1500), 512),
    "SC-CY1.0-2048": (dict(num_subcarriers=2048), None),
}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_and_fits_match_jax_spec(name):
    extra, tile = TILE_CASES[name]
    kw = _kw(extra, num_ofdm=16)
    setup = _setup(kw)
    n, T = kw["num_subcarriers"], setup.block_length
    E = tlin.ext_width(len(setup.taps), T)
    passes = lk.selected_passes(setup)
    spec = pk._spec_for(_plan_runner(kw), 1 << 17, True)
    assert lk.fold_fits(n, T, E, True, passes) == (tile is not None)
    if tile is None:
        assert spec is None and tpl.kernel_mode(setup) == "eager"
        return
    assert spec.conv == ("mm4" if "mm4" in name else "mm") and spec.tile == tile
    assert passes == (3 if "1024qam" in name else 1)
    assert lk.tile_for(1 << 17, fk.fold_link(setup, "cpu").tile_cap) == tile


@pytest.mark.parametrize("prefix", ["CYCLIC", "NONE"])
@pytest.mark.parametrize("channel", ["severe_multipath", "flat_fading", "Lin-Phoong_P2"])
def test_routing_mirrors_jax_plan(prefix, channel):
    # the audit's SC-FDE shapes with a cyclic prefix or none: the JAX plan
    # takes them on its "mm" kernel up to 1024 subcarriers, on none at 2048
    for n in (300, 512, 1024, 2048):
        kw = _kw(dict(num_subcarriers=n, prefix_type=prefix, channel_model=channel), num_ofdm=16)
        plan = pk.plan_for(_plan_runner(kw))
        mode = tpl.kernel_mode(_setup(kw))
        assert (plan[1] if plan else None, mode) == (("mm", "fold") if n <= 1024 else (None, "eager"))


def _runner(kw):
    return tpl.LinkRunner(_setup(kw), device="cpu")


def test_counts_do_not_depend_on_chunking():
    # the chunks keep the whole run's 512-symbol tiles, so sigma is unchanged
    kw = _kw(dict(num_subcarriers=512, snr_db=20.0), num_ofdm=1536)
    whole = _runner(kw).run(7)
    split = _runner(dict(kw, symbols_per_chunk=512)).run(7)
    assert whole["bit_errors"] > 0 and whole["hotpath_used"] == "torch"
    assert (whole["bit_errors"], whole["symbol_errors"]) == (split["bit_errors"], split["symbol_errors"])
    assert whole["papr_db"] == pytest.approx(split["papr_db"], rel=1e-12)


def test_carry_in_and_probe_match_one_chunk():
    # no prefix, so the previous symbol's tail reaches the kept samples
    kw = _kw(dict(num_subcarriers=300, channel_model="Lin-Phoong_P2", prefix_type="NONE", snr_db=20.0))
    link = fk.fold_link(_setup(kw), "cpu")
    assert link.E > 0
    snr_lin, key, sym0, C = lk.snr_linear(20.0), (11, 12), 4096 + 5, 128
    runs = {}
    for name, s, prev in (("a", sym0, None), ("b", sym0 + C, None),
                          ("b_prev", sym0 + C, fk.fold_probe(link, key, sym0, C)[2:])):
        acc, psum = lk.new_accumulators("cpu")
        carry = fk.fold_chunk(link, key, s, C, snr_lin, acc, psum, prev=prev)
        runs[name] = (acc, carry)
    # the probe gives chunk a's carry row, and its tail as a carry-in gives
    # chunk b exactly what b's own recomputed predecessor gives
    pr, pi, _, _ = fk.fold_probe(link, key, sym0, C)
    assert torch.equal(pr, runs["a"][1][0]) and torch.equal(pi, runs["a"][1][1])
    assert runs["b"][0].tolist() == runs["b_prev"][0].tolist() and runs["b"][0][0] > 0
    assert all(torch.equal(u, v) for u, v in zip(runs["b"][1], runs["b_prev"][1]))
    # and a wrong carry-in is read: it moves the first symbol's points alone
    # (noise off, so the tile's measured power does not move with it)
    quiet = fk.fold_link(_setup(dict(kw, noise_type="NONE")), "cpu")
    tail = fk.fold_probe(quiet, key, sym0, C)[2:]
    good = fk.fold_wide_planes(quiet, key, sym0 + C, C, snr_lin, "cpu", prev=tail)
    bad = fk.fold_wide_planes(quiet, key, sym0 + C, C, snr_lin, "cpu", prev=(-tail[0], -tail[1]))
    assert (good[1][0] - bad[1][0]).abs().max() > 1e-2 and torch.equal(good[1][1:], bad[1][1:])


def test_one_rank_halo_mesh_equals_link_runner():
    # halo mode probes each chunk's carry through the chain's probe (the
    # wide one past the narrow widths) and feeds it to the next as prev
    kw = _kw(dict(num_subcarriers=300, channel_model="Lin-Phoong_P2", prefix_type="NONE", snr_db=20.0), num_ofdm=768)
    kw["symbols_per_chunk"] = 256
    setup = _setup(kw)
    runner = ShardedLinkRunner(setup, mesh=make_mesh("cpu"), stream_mode="halo")
    assert fk.is_wide(runner.link) and runner.link.E > 0 and runner.kernel.probe is not None
    r = runner.run(21)
    want = tpl.LinkRunner(setup, device="cpu").run(prng.fold_in(21, 0))
    assert r["bit_errors"] > 0
    assert (r["bit_errors"], r["symbol_errors"], r["papr_db"]) == (want["bit_errors"], want["symbol_errors"],
                                                                    want["papr_db"])


def test_slice_end_to_end_matches_jax_runner():
    # SC-CY1.0-512 at 20 dB, where 512 OFDM symbols see errors
    kw = _kw(dict(num_subcarriers=512, snr_db=20.0), num_ofdm=512)
    port_runner = _runner(kw)
    assert port_runner.mode == "fold" and fk.is_wide(port_runner.link)
    port = port_runner.run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert ref["hotpath_used"] == "xla" and port["hotpath_used"] == "torch"
    assert port["bit_errors"] > 0 and port["total_bits"] == ref["total_bits"]
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"], ref["total_bits"], z=5)
    assert port["papr_estimator"] == "in_run" and port["papr_sample_fraction"] == 1.0


def test_wide_runner_needs_cuda_or_an_explicit_cpu():
    setup = _setup(_kw(dict(num_subcarriers=1024), num_ofdm=16))
    if torch.cuda.is_available():
        assert tpl.LinkRunner(setup).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(setup)
    with pytest.raises(ValueError):
        fk.fold_chunk(fk.fold_link(setup, "cpu"), (0, 0), 0, 64, 1.0,
                      torch.zeros(3, dtype=torch.int64, device="meta"),
                      torch.zeros(1, dtype=torch.float64, device="meta"))
