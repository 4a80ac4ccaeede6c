"""The noise-bump stages (post-EQ noise, 1/sqrt(P)) on the fold, lr and mm chains.

* Against the JAX package's ``make_noise_bump_chunk`` in interpret mode
  (whose PRNG emits zeros), f32-grade products on the JAX side
  (matmul_passes=3), on the rows of test_torch_power.py's noise-bump test:
  the port's plain chunks with all four stages count the same errors on
  fold (OFDM with a short CP, and the SC-FDE default, whose post-EQ noise
  lands on time samples after the IDFT), lr (128 sc, CP 0.34) and mm (ZP).
* On seeded random words at sym0 > 0: each chain's points against a
  float64 oracle of the stage order (the chain from the JAX package's
  builders, then the post-EQ noise, 1/sqrt(P) and the tile's unit power).
* ``FusedLink`` routes the study at 64 / 512 / 1024 sc to diag / diag / lr,
  as the JAX package's plan does, and one point at 1024 sc lies within
  z = 5 of the JAX package's ``_Link``.
* ``noise_bump_link`` refuses a link with channel noise on every chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.experiments import noise_bump as jnb
from ofdm_tpu.models import channels as jchm
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.experiments import noise_bump as tnb
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import mm_kernel as mmk

BASE = dict(num_subcarriers=64, constellation_order=64, channel_type="CUSTOM", channel_model="Lin-Phoong_P2",
            prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="ZF", noise_type="NONE",
            snr_db=30.0, apply_power_allocation=True, normalize_before_demap=True)
# (the chain each routes to, its config on BASE)
LINKS = {
    "fold_ofdm_short_cp": ("fold", dict(prefix_length_ratio=0.5, channel_model="severe_multipath")),
    # the reference's default SC-FDE link (Lin-Phoong P1) at 64-QAM: its QPSK
    # points stay clear of every boundary under the zero-word offsets
    "fold_scfde_default": ("fold", dict(modulation_type="SC-OFDM", channel_model="Lin-Phoong_P1")),
    "lr_cp034_128sc": ("lr", dict(num_subcarriers=128, prefix_length_ratio=0.34)),
    "mm_zp_64sc": ("mm", dict(prefix_type="ZERO")),
}
PLAIN = {"fold": (fk.fold_chunk_plain, fk.fold_planes), "lr": (lrk.lr_chunk_plain, lrk.lr_planes),
         "mm": (mmk.mm_chunk_plain, mmk.mm_planes), "diag": (lk.diag_chunk_plain, lk.diag_planes)}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(name, num_ofdm=1024, **extra):
    kw = {**BASE, **LINKS[name][1], **extra}
    kw["num_symbols"] = num_ofdm * kw["num_subcarriers"]
    return kw


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra)))


def _port_link(kw, chain):
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    assert runner.mode == chain
    return runner, lk.noise_bump_link(runner.link)


def _rows(n):
    """test_torch_power.py's noise-bump rows: sqrt(P), 1/sqrt(P), sigma."""
    sqrt_power = np.linspace(0.52, 1.47, n).astype(np.float32)
    inv = sqrt_power.copy()
    inv[inv < 1e-10] = 1.0
    noise_std = np.full(n, 0.03, np.float32)
    noise_std[3 * n // 4 :] *= 2.0
    return np.stack([sqrt_power, 1.0 / inv, noise_std]).astype(np.float32)


def _width(link):
    return link.T if isinstance(link, mmk.MmLink) else link.n


@pytest.mark.parametrize("name", list(LINKS))
def test_zero_words_match_noise_bump_pallas_kernel(name):
    chain = LINKS[name][0]
    kw = _kw(name)
    jr = _jax_runner(kw, matmul_passes=3)
    fn, consts, spec = pk.make_noise_bump_chunk(jr, 1024, interpret=True)
    assert spec.post_noise and spec.compensate and spec.conv == ("lr" if chain == "lr" else "mm")
    rows = _rows(kw["num_subcarriers"])
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.asarray(rows), consts)
    runner, link = _port_link(dict(kw, matmul_passes=3), chain)
    assert link.post_noise and link.compensate and lk.rows_needed(link) == 3
    z, zn = np.zeros((1024, _width(link)), np.int64), np.zeros((1024, link.n), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    PLAIN[chain][0](link, (0, 0), 0, 1024, lk.snr_linear(kw["snr_db"]), acc, psum, words=(z, z, z, zn, zn),
                    rows=torch.tensor(rows))
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))


def _oracle(kw, words, pwords, chunk, rows, tile):
    """The chain in float64 from the JAX package's builders (as
    test_torch_power.py's oracle: the scaled symbols, the previous symbol's
    too, the dense channel, ZF or MMSE against the raw h_freq, the SC
    IDFT), then the noise-bump stages in the reference kernel's order: e +
    sigma x Box-Muller of the post-EQ words, x 1/sqrt(P), and each tile
    normalized to unit mean power with the slicer gain.  ``words`` hold
    chunk + 1 rows (the previous symbol's first), ``pwords`` chunk rows."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)._replace(pack=1)
    s = jr.setup
    cfg = s.cfg
    n, L, T = spec.n, s.prefix_length, spec.n + s.prefix_length
    i32 = jnp.asarray(np.asarray(words[0], np.uint32).view(np.int32))
    tx, sr, si = pk._encode_tile(spec, i32[:, :n], None)
    sym = (np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)) * rows[0].astype(np.float64)
    h = np.asarray(s.h_freq, np.complex128)
    E = jlin.ext_width(len(np.asarray(s.taps)), T)
    ftx = jlin.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    fr, fi = pk._tx_ext_matrix(spec._replace(ext=E), ftx)
    x = sym @ (fr + 1j * fi)
    act = np.concatenate([x[1:, :T], x[:-1, T:]], axis=1)
    if cfg.prefix_type == jcfg.PrefixType.ZERO:
        rr, ri = jlin.rx_matrix(n, cfg.prefix_type, L)
        y = (act @ jlin.conv_matrix_merged(s.taps, T)) @ (rr + 1j * ri)
    else:
        y = act @ jlin.conv_rx_merged(s.taps, n, cfg.prefix_type, L)
    snr = 10.0 ** (kw["snr_db"] / 10.0)
    if kw["equalization_method"] == "ZF":
        e = y / h
    else:
        nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = y * np.conj(h) / (np.abs(h) ** 2 + nv)
    if spec.is_sc:
        dr, di = jdft.dft_matrix(n, inverse=True)
        e = e @ (dr + 1j * di)
    u1 = np.maximum(((pwords[0] >> 8) & 0xFFFFFF) * 2.0**-24, 2.0**-24)
    phase = 2.0 * np.pi * ((pwords[1] >> 8) & 0xFFFFFF) * 2.0**-24
    e = e + rows[2].astype(np.float64) * np.sqrt(-2.0 * np.log(u1)) * np.exp(1j * phase)
    e = e * rows[1].astype(np.float64)
    slicer = 0.5 / pk._qam_geometry(spec.order)[2]
    for t0 in range(0, chunk, tile):
        e[t0 : t0 + tile] *= slicer / np.sqrt(np.mean(np.abs(e[t0 : t0 + tile]) ** 2))
    rx = np.asarray(pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32), None))
    return np.asarray(tx)[1:], rx, e


def _boundary_margin(e, m):
    c0 = (m - 1) * 0.5
    bounds = np.arange(m - 1) + 0.5
    d = np.full(e.shape, np.inf)
    for v in (e.real + c0, c0 - e.imag):
        d = np.minimum(d, np.abs(v[..., None] - bounds).min(axis=-1))
    return d


@pytest.mark.parametrize("name,method", [("fold_ofdm_short_cp", "MMSE"), ("fold_scfde_default", "ZF"),
                                         ("lr_cp034_128sc", "MMSE"), ("mm_zp_64sc", "ZF")])
def test_random_words_match_float64_oracle(name, method):
    """Two tiles of random words at sym0 > 0 (the previous symbol's tail
    enters the first), post-EQ noise of sigma up to 0.06 with random
    phases: the stage order (after the IDFT, before the normalization) and
    the per-lane rows are held to the float64 chain."""
    chain = LINKS[name][0]
    chunk = 1024
    sym0 = 3 * chunk + 5
    kw = _kw(name, num_ofdm=8 * chunk, equalization_method=method, constellation_order=16)
    runner, link = _port_link(kw, chain)
    tile = lk.tile_for(chunk, link.tile_cap)
    assert tile == chunk
    n, width = link.n, _width(link)
    rng = np.random.default_rng(9)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, width), dtype=np.uint64).astype(np.int64) for _ in range(3)]
    pwords = [rng.integers(0, 1 << 32, size=(chunk, n), dtype=np.uint64).astype(np.int64) for _ in range(2)]
    rows = _rows(n)
    rows[0] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    rows[1] = (1.0 / rows[0]).astype(np.float32)
    rows[2] *= 2.0
    plain, planes = PLAIN[chain]
    tx, er, ei = planes(link, (0, 0), sym0, chunk, lk.snr_linear(kw["snr_db"]), "cpu", (*words, *pwords),
                        torch.tensor(rows))[:3]
    jtx, jrx, e = _oracle(kw, words, pwords, chunk, rows, tile)
    assert np.array_equal(tx.numpy(), jtx)
    np.testing.assert_allclose(er.numpy() + 1j * ei.numpy(), e, rtol=1e-5, atol=1e-4)
    near = _boundary_margin(e, 4) < 1e-4
    assert near.sum() <= 1e-3 * near.size
    rx = lk.qam_demap(er, ei, link.q).numpy()
    assert np.array_equal(rx[~near], jrx[~near])
    acc, psum = lk.new_accumulators("cpu")
    plain(link, (0, 0), sym0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=(*words, *pwords),
          rows=torch.tensor(rows))
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(tmt.index_bit_errors(tx, torch.from_numpy(rx))),
                                   int(tmt.symbol_errors(tx, torch.from_numpy(rx))))


@pytest.mark.parametrize("n,chain", [(64, "diag"), (512, "diag"), (1024, "lr")])
def test_fused_link_routes_as_jax_plan(n, chain):
    fused = tnb.FusedLink(64, n, 64, "Lin-Phoong_P2", chunk=64, device="cpu")
    assert fused.runner.mode == chain and fused.link.post_noise and fused.link.compensate
    jr = _jax_runner(dict(num_symbols=n * 64, num_subcarriers=n, constellation_order=64, channel_type="CUSTOM",
                          channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                          equalization_method="MMSE", noise_type="NONE", snr_db=30.0, apply_power_allocation=True,
                          normalize_before_demap=True))
    assert pk.plan_for(jr)[1] == chain


def test_fused_point_at_1024sc_matches_jax_link():
    """One point of the study at 1024 subcarriers (the lr chain, the in-run
    PAPR from the scaled symbols) against the JAX package's ``_Link`` at
    z = 5: 64 OFDM symbols on the port, 256 on the JAX side."""
    scen = tnb.SCENARIOS[1]
    profile = tnb.create_noise_profile(1024, scen.noise_bump_db)
    fused = tnb.FusedLink(64, 1024, 64, "Lin-Phoong_P2", chunk=64, device="cpu")
    ber = fused.run_point(11, scen, profile, 15.0)
    bits = 64 * 1024 * 6
    jlink = jnb._Link(256, 1024, 64, jchm.get_channel("Lin-Phoong_P2"))
    jber, _ = jlink.run_point(jax.random.PRNGKey(3), jnb.SCENARIOS[1], profile, 15.0)
    jbits = 256 * 1024 * 6
    assert 0.2 < ber < 0.6
    assert tmt.ber_equivalent(int(round(ber * bits)), bits, int(round(jber * jbits)), jbits, z=5)


@pytest.mark.parametrize("chain", ["diag", "fold", "lr", "mm"])
def test_noise_bump_link_refuses_channel_noise(chain):
    extra = {} if chain == "diag" else LINKS[next(k for k, v in LINKS.items() if v[0] == chain)][1]
    kw = {**BASE, **extra, "noise_type": "AWGN"}
    kw["num_symbols"] = 64 * kw["num_subcarriers"]
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    assert runner.mode == chain
    with pytest.raises(ValueError, match="noise_type=NONE"):
        lk.noise_bump_link(runner.link)
    with pytest.raises(ValueError, match="noise_type=NONE"):
        lk.noise_bump_link(tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(
            **dict(kw, noise_type="NONE", apply_power_allocation=False))), device="cpu").link)
