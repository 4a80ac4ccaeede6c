"""The lr and diag chains at every width and channel length the JAX plan admits.

* Routing: ``kernel_mode`` equals the JAX package's ``plan_for`` (its "mm" /
  "mm4" kernel is the port's fold chain without a zero prefix and its mm
  chain with one, "taps" the mm chain under a zero prefix) at 4096-32768
  subcarriers, on a flat channel, severe_multipath and a seeded 100-tap
  channel, under CP 0.5, CP 1.0 and ZP 1.0, with the defaults, with the
  power allocation applied and with papr_stride 1, and on a link the JAX
  package plans on its "taps" kernel under hotpath="pallas"; 6144
  subcarriers stands for the widths past 4096 that are not whole 4096-bin
  slices (a short last slice in the lr cluster).  Past 1024
  subcarriers both packages' ``lowrank.factor`` is stood in by its closed
  form (the factors exist, with the ZP noise rank L), as
  tests/test_torch_shape_audit.py does.
* The cluster layout's plain version: ``link_kernel.CLUSTER_BINS`` set
  small (64-bin slices at 256 subcarriers for lr, and at 160, whose last
  slice is short; 128-bin slices at 512 for diag), each chain's plain chunk counts what the JAX package's Pallas
  kernel counts (Mosaic interpret mode, all-zero words); at one slice the
  sums are the one-block sums bit for bit.
* Long channels: the lr plain chunk at E = 99 (a seeded 100-tap channel,
  CP 0.5) and at E = rank = 159 (a 160-tap channel, ZP 1.0; g2 in two
  rounds of at most 128 rows) at 256 subcarriers against the JAX lr kernel
  in interpret mode.
* The "taps" link: mm_wide's plain chunk against the JAX package's taps
  kernel in interpret mode on a link the JAX plan puts there, with the JAX
  module's staged limit lowered inside the test to force a small one.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import lowrank as jlr
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import linops as tlin
from ofdm_tpu_torch.ops import lowrank as tlr
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import mm_kernel as mmk

BASE = dict(num_subcarriers=4096, constellation_order=64, channel_type="CUSTOM", channel_model="severe_multipath",
            prefix_type="CYCLIC", prefix_length_ratio=0.5, equalization_method="MMSE", noise_type="AWGN",
            snr_db=30.0)
WIDTHS = (4096, 6144, 8192, 16384, 32768)
CHANNELS = ("flat_fading", "severe_multipath", "taps100")
PREFIXES = {"cp05": dict(prefix_type="CYCLIC", prefix_length_ratio=0.5),
            "cp10": dict(prefix_type="CYCLIC", prefix_length_ratio=1.0),
            "zp10": dict(prefix_type="ZERO", prefix_length_ratio=1.0)}
POWER = {"default": {}, "apply_power": dict(power_allocation_type="WATERFILLING", apply_power_allocation=True),
         "papr_stride_1": dict(papr_stride=1)}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # counts here are compared exactly (as in test_torch_lr.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ir(channel):
    return cs.seeded_taps(100, 7) if channel == "taps100" else None


def _model(channel):
    return "severe_multipath" if channel == "taps100" else channel


def closed_form(taps, n, prefix, L, modulation):
    """What the routers read of ``lowrank.factor`` past 1024 subcarriers:
    factors that exist, E tail lanes and the ZP noise rank L."""
    zp = getattr(prefix, "value", prefix) == "ZERO"
    return SimpleNamespace(E=tlin.ext_width(len(taps), n + L), noise_rank=L if zp else 0)


def _jax_route(kw, ir, monkeypatch):
    if kw["num_subcarriers"] > 1024:
        monkeypatch.setattr(jlr, "factor", closed_form)
    runner = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw), channel_ir=ir))
    plan = pk.plan_for(runner)
    if plan is None or not pk.supports(runner, interpret=True):
        return "eager"
    if plan[1] in ("mm", "mm4"):
        return "mm" if kw["prefix_type"] == "ZERO" else "fold"
    if plan[1] == "taps":
        return "mm" if kw["prefix_type"] == "ZERO" else "eager"
    return plan[1]


def _port_route(kw, ir, monkeypatch):
    if kw["num_subcarriers"] > 1024:
        monkeypatch.setattr(lrk, "lr_factors", lambda s: closed_form(
            s.taps, s.cfg.num_subcarriers, s.cfg.prefix_type, s.prefix_length, None))
    return tpl.kernel_mode(tpl.prepare(tcfg.SimulationConfig(**kw), channel_ir=ir))


@pytest.mark.parametrize("prefix", list(PREFIXES))
@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("n", WIDTHS)
def test_route_is_the_jax_plan(n, channel, prefix, monkeypatch):
    ir = _ir(channel)
    for power, extra in POWER.items():
        kw = dict(BASE, num_subcarriers=n, num_symbols=16 * n, channel_model=_model(channel), **PREFIXES[prefix],
                  **extra)
        assert _port_route(kw, ir, monkeypatch) == _jax_route(kw, ir, monkeypatch), power


def test_routes_of_the_giant_links(monkeypatch):
    # severe_multipath on lr at 8K / 16K / 32K under every prefix, the 100-tap
    # channel to 16K (its ZP 1.0 link to 8K), single-tap CP links on diag to
    # 32K, and the 4096-sc links with an in-run PAPR eager (a TPU VMEM budget)
    route = lambda n, ch, p, **extra: _port_route(  # noqa: E731
        dict(BASE, num_subcarriers=n, num_symbols=16 * n, channel_model=_model(ch), **PREFIXES[p], **extra),
        _ir(ch), monkeypatch)
    assert [route(n, "severe_multipath", p) for n in (8192, 16384, 32768) for p in PREFIXES] == ["lr"] * 9
    assert [route(n, "taps100", p) for n in (8192, 16384, 32768) for p in PREFIXES] == (
        ["lr"] * 5 + ["eager"] * 4)
    assert [route(n, "flat_fading", "cp05") for n in WIDTHS] == ["diag"] * 5
    assert route(4096, "severe_multipath", "cp10", apply_power_allocation=True) == "eager"
    assert route(4096, "severe_multipath", "cp10", papr_stride=1) == "eager"
    assert route(2048, "severe_multipath", "cp10", papr_stride=1) == "lr"
    # past 4096 the lr cluster's last slice may be short: 6144 and 10000 sc run lr
    assert route(6144, "severe_multipath", "cp05") == "lr" and route(10000, "severe_multipath", "zp10") == "lr"


def _jax_runner(kw, ir=None, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra),
                                      channel_ir=ir))


def _boundary_margin(er, ei, m):
    """Distance of each slicer-unit coordinate to its nearest decision boundary."""
    c0 = (m - 1) * 0.5
    bounds = np.arange(m - 1) + 0.5
    d = np.full(np.shape(er), np.inf)
    for v in (np.asarray(er, np.float64) + c0, c0 - np.asarray(ei, np.float64)):
        d = np.minimum(d, np.abs(v[..., None] - bounds).min(axis=-1))
    return d


def _pallas_counts(kw, ir, chunk):
    """(bit errors, symbol errors) of the JAX package's fused kernel on one
    chunk in Mosaic interpret mode (its PRNG emits zeros), matmul_passes=3."""
    jr = _jax_runner(kw, ir, matmul_passes=3)
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                  jnp.ones(kw["num_subcarriers"], jnp.float32))
    return pk._spec_for(jr, chunk, True), (int(stats["bit_errors"]), int(stats["symbol_errors"]))


def _zero_words(n, chunk, rank=0):
    z = np.zeros((chunk, n), np.int64)
    g = np.zeros((chunk, rank), np.int64)
    return (z, z, z) + ((g, g) if rank else ())


def _lr_counts(link, kw, chunk):
    words = _zero_words(link.n, chunk, link.rank if link.add_noise else 0)
    snr_lin = lk.snr_linear(kw["snr_db"])
    _, er, ei, *_ = lrk.lr_planes(link, (0, 0), 0, chunk, snr_lin, "cpu", words)
    # zero words make the symbols alike, so a flipped decision moves a count
    # by up to the chunk; the JAX products (bf16 x 3) agree with f32 to ~1e-5
    # in slicer units, so every point keeps 1e-3 from a boundary
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-3
    acc, psum = lk.new_accumulators("cpu")
    lrk.lr_chunk_plain(link, (0, 0), 0, chunk, snr_lin, acc, psum, words=words)
    return tuple(acc.tolist()[:2])


def test_block_sum_slices():
    v = torch.tensor(np.random.default_rng(3).standard_normal((3, 300)), dtype=torch.float32)
    by_slice = torch.zeros(3)
    for c in range(0, 300, 64):
        by_slice = by_slice + lk.block_sum(v[:, c : c + 64], 256)
    assert torch.equal(lk.block_sum(v, 256, 64), by_slice)
    # one slice: the one-block sum, bit for bit
    assert torch.equal(lk.block_sum(v, 256, 300), lk.block_sum(v, 256))
    assert torch.equal(lk.block_sum(v, 256, 4096), lk.block_sum(v, 256))


SLICED = {
    # lr at 256 sc in four 64-bin slices: severe_multipath, CP 0.5, MMSE with noise
    "lr_256sc": ("lr", dict(BASE, num_subcarriers=256, constellation_order=16), 64),
    # lr, zero prefix 0.5: the colored noise and t's pass over the listed lanes
    "lr_256sc_zp05": ("lr", dict(BASE, num_subcarriers=256, constellation_order=16, prefix_type="ZERO"), 64),
    # lr at 160 sc in 64-bin slices, the last one 32 bins: lr_power's partials
    # then hold one slice of one symbol each, the short one padded
    "lr_160sc_short_slice": ("lr", dict(BASE, num_subcarriers=160, constellation_order=16), 64),
    # diag_wide at 512 sc in four 128-bin slices (CP 1.0 covers the channel)
    "diag_512sc": ("diag", dict(BASE, num_subcarriers=512, prefix_length_ratio=1.0, constellation_order=16), 128),
}


@pytest.mark.parametrize("name", list(SLICED))
def test_cluster_slices_match_pallas_kernel(name, monkeypatch):
    chain, kw, bins = SLICED[name]
    chunk = 64
    kw = dict(kw, num_symbols=kw["num_subcarriers"] * chunk)
    spec, want = _pallas_counts(kw, None, chunk)
    assert spec.conv == chain
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    assert tpl.kernel_mode(setup) == chain
    monkeypatch.setattr(lk, "CLUSTER_BINS", bins)
    if chain == "lr":
        got = _lr_counts(lrk.lr_link(setup, "cpu"), kw, chunk)
    else:
        link = lk.diag_link(setup, "cpu")
        z = _zero_words(link.n, chunk)
        acc, psum = lk.new_accumulators("cpu")
        lk.diag_chunk_plain(link, (0, 0), 0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=z)
        got = tuple(acc.tolist()[:2])
    assert got == want


LONG = {
    # a seeded 100-tap channel under CP 0.5: E = 99 tail lanes, t summed in two passes
    "e99_cp05": (dict(BASE, num_subcarriers=256, constellation_order=16), 100, (99, 0)),
    # a seeded 160-tap channel under ZP 1.0: E = rank = 159, TailM zero, g2 in two
    # rounds; QPSK, as zero words leave 16-QAM points of its deepest fades 1e-4
    # from a boundary
    "e159_zp10": (dict(BASE, num_subcarriers=256, constellation_order=4, prefix_type="ZERO",
                       prefix_length_ratio=1.0), 160, (159, 159)),
}


@pytest.mark.parametrize("name", list(LONG))
def test_long_channels_match_pallas_kernel(name):
    kw, taps, (E, rank) = LONG[name]
    chunk = 64
    kw = dict(kw, num_symbols=kw["num_subcarriers"] * chunk)
    ir = cs.seeded_taps(taps, cs.GIANT_IR_SEED)
    spec, want = _pallas_counts(kw, ir, chunk)
    setup = tpl.prepare(tcfg.SimulationConfig(**kw), channel_ir=ir)
    assert spec.conv == "lr" and tpl.kernel_mode(setup) == "lr"
    link = lrk.lr_link(setup, "cpu")
    assert (link.E, link.rank) == (E, rank) == (spec.lre, spec.nrank)
    assert len(link.tail_rows) > lrk.TAIL_PASS or len(link.bh_rows) > lrk.G2_ROUND
    assert _lr_counts(link, kw, chunk) == want


# SC-FDE, zero prefix 1.0, 1024-QAM (three bf16 passes): the JAX plan's
# "taps" row under hotpath="pallas" (its dense "mm" staging exceeds the
# staged limit, "mm4" takes one pass only)
TAPS = dict(BASE, modulation_type="SC-OFDM", prefix_type="ZERO", prefix_length_ratio=1.0,
            constellation_order=1024, num_subcarriers=1024)


def test_taps_link_routes_to_mm_wide():
    kw = dict(TAPS, num_symbols=1024 * 16, hotpath="pallas")
    assert pk.plan_for(jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw)))) == (2048, "taps")
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    assert tpl.kernel_mode(setup) == "mm" and mmk.is_wide(mmk.mm_link(setup, "cpu"))
    assert mmk.mm_link(setup, "cpu").tile_cap == 2048
    # on the default hotpath neither package takes it on a kernel
    auto = dict(kw, hotpath="auto")
    assert pk.plan_for(jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**auto)))) is None
    assert tpl.kernel_mode(tpl.prepare(tcfg.SimulationConfig(**auto))) == "eager"


def test_taps_kernel_matches_mm_wide(monkeypatch):
    # at 300 sc a staged limit of 4e6 bytes leaves the JAX package only its
    # "taps" kernel (mm at three passes stages 4.5e6, taps 3.3e6)
    monkeypatch.setattr(pk, "_VMEM_STAGED_LIMIT", 4_000_000)
    chunk = 32
    kw = dict(TAPS, num_subcarriers=300, num_symbols=300 * chunk, snr_db=40.0)
    spec, want = _pallas_counts(kw, None, chunk)
    assert spec.conv == "taps"
    link = mmk.mm_link(tpl.prepare(tcfg.SimulationConfig(**kw)), "cpu")
    assert mmk.is_wide(link)
    z = np.zeros((chunk, link.T), np.int64)
    snr_lin = lk.snr_linear(kw["snr_db"])
    _, er, ei, _, _ = mmk.mm_wide_planes(link, (0, 0), 0, chunk, snr_lin, "cpu", (z, z, z))
    assert _boundary_margin(er.numpy(), ei.numpy(), link.q.m).min() > 1e-3
    acc, psum = lk.new_accumulators("cpu")
    mmk.mm_chunk_plain(link, (0, 0), 0, chunk, snr_lin, acc, psum, words=(z, z, z))
    assert tuple(acc.tolist()[:2]) == want


def test_closed_forms_match_the_dense_host_matrices(monkeypatch):
    # past linops.DENSE_MAX_N the diag response is the taps' FFT, and the
    # sampled-TX PAPR is the ortho IFFT and guard at every width: the dense
    # forms' values
    n, L = 128, 8
    taps = cs.seeded_taps(6, 3)
    dense = tlin.diag_response(taps, n, tcfg.PrefixType.CYCLIC, L)
    monkeypatch.setattr(tlin, "DENSE_MAX_N", 64)
    np.testing.assert_allclose(tlin.diag_response(taps, n, tcfg.PrefixType.CYCLIC, L), dense, rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="not diagonal"):
        tlin.diag_response(taps, n, tcfg.PrefixType.CYCLIC, 4)
    kw = dict(BASE, num_subcarriers=n, num_symbols=n * 2048, channel_model="flat_fading")
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    peak, total, count = runner._papr_sample()
    idx = tpl.prng.uniform_indices(tpl.prng.key_words(tpl.PAPR_SAMPLE_SEED), (2048, n), 63, "cpu")
    s = torch.from_numpy(runner.setup.const.table.astype(np.complex128))[idx]
    fr, fi = tlin.tx_matrix(n, tcfg.PrefixType.CYCLIC, runner.setup.prefix_length, tcfg.ModulationType.OFDM)
    x = s @ torch.from_numpy(fr + 1j * fi)
    p = (x.real**2 + x.imag**2).to(torch.float64)
    assert count == p.numel()
    assert peak == pytest.approx(float(p.max()), rel=1e-5) and total == pytest.approx(float(p.sum()), rel=1e-6)


def test_banded_factor_is_the_dense_algebra():
    # lowrank.factor builds CR and Cp from the conv's band: the dense merged
    # conv times the receiver, as the JAX package forms them
    for prefix, ratio in (("CYCLIC", 0.5), ("NONE", 0.0), ("ZERO", 0.5)):
        n, taps = 64, cs.seeded_taps(9, 5)
        L = int(ratio * (len(taps) - 1))
        f = tlr.factor(taps, n, tcfg.PrefixType(prefix), L, tcfg.ModulationType.OFDM)
        T = n + L
        rr, ri = tlin.rx_matrix(n, tcfg.PrefixType(prefix), L)
        cm = tlin.conv_matrix_merged(taps, T) @ (rr + 1j * ri)
        np.testing.assert_allclose(f.cp, cm[T:], rtol=0, atol=1e-14)
        sym = np.random.default_rng(1).standard_normal((1, n)) + 0j
        fr, fi = tlin.tx_matrix(n, tcfg.PrefixType(prefix), L, tcfg.ModulationType.OFDM)
        # a symbol after a silent one: the intra-symbol map alone
        np.testing.assert_allclose(tlr.apply_reference(f, sym, np.zeros(f.E), tcfg.ModulationType.OFDM),
                                   sym @ (fr + 1j * fi) @ cm[:T], rtol=0, atol=1e-9)


def test_link_check_takes_the_giant_shapes():
    # past 4096 subcarriers the lr kernel takes any width under txext
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(BASE, num_subcarriers=8192, num_symbols=8192 * 16)))
    f = cs.seeded_factors(setup, 7, 0, 1)
    link = lrk.lr_link(setup, "cpu", factors=f)
    assert link.txext and lk.tile_for(1 << 12, link.tile_cap) == 128
    lrk._check_link(link, torch.device("cpu"))
    ftx = torch.zeros((8192, link.T))  # what the in-run PAPR would read
    with pytest.raises(ValueError, match="takes txext links"):
        lrk._check_link(dataclasses.replace(link, txext=False, fr=ftx, fi=ftx), torch.device("cpu"))
    odd = tpl.prepare(tcfg.SimulationConfig(**dict(BASE, num_subcarriers=6144, num_symbols=6144 * 16)))
    link = lrk.lr_link(odd, "cpu", factors=cs.seeded_factors(odd, 7, 0, 1))
    lrk._check_link(link, torch.device("cpu"))
    # two 4096-bin slices a symbol, the second 2048 bins: lr_power's partials hold one slice each
    assert lk.cluster_width(6144) == 8192 and lrk._chunk_geometry(link, 64)[2] == 2 * min(link.slice, 64)
