"""Adaptive (CAPACITY_BASED) SC-FDE on the fold and mm chains, narrow and wide, against the JAX package.

The port demaps time sample t with lane t's order after the SC IDFT, the
JAX XLA path's order (ofdm_tpu/pipeline.py:533-549): the equalizer takes
no slicer gain and aqam's per-lane row 0.5/scale multiplies the time
sample (``link_kernel.sc_slicer``; under normalize_before_demap it rides
the normalization, as the JAX kernel's deferred fold does).

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros; matmul_passes=3 for f32-grade products), where that kernel takes
  the same order (normalized aqam, apsk): the port's plain chunk on
  all-zero words counts the same errors, on fold, mm and fold_wide.
* The JAX kernel without normalize folds the lane row into the equalizer
  before the IDFT (pallas_link.py:1766-1812): a float64 oracle of that
  order reproduces its zero-word counts; a float64 oracle of the XLA order
  equals the port's plain fold, mm, fold_wide and mm_wide chains on random
  words.
* The plain chains against the eager chain and ``chunk_body`` on injected
  draws; routing against ``plan_for`` + ``supports`` over the adaptive
  SC-FDE grid; the carry-in, the probe and a one-rank halo mesh; the slice
  end to end against the JAX XLA runner; the setup carried across.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu.ops import prng as jprng
from ofdm_tpu.ops import cplx
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import convert
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import mm_kernel as mmk
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.parallel import ShardedLinkRunner, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTIVE_JSON = os.path.join(REPO, "config", "simulation_settings_adaptive.json")
# 512 sc over severe_multipath loads orders {4: 44, 16: 413, 64: 55}
_WIDE = dict(num_subcarriers=512, channel_model="severe_multipath")
_NORM = dict(normalize_before_demap=True)
# (chain, changes to the reference's adaptive link on SC-FDE, chunk, the JAX
# kernel's zero-word (bit, symbol) errors).  Zero words turn the noise into
# one deterministic offset of 5.77 sigma; two links' SNR is picked by the
# margin it leaves alone: at 20 dB the ZF link's points come 3.7e-4 from a
# boundary (its counts (23552, 15360) still agree), the 512-sc link's 9.5e-4.
ZERO_WORD_LINKS = {
    "cp_aqam_norm_mmse": ("fold", _NORM, 1024, (20480, 15360)),
    "cp_aqam_norm_zf_18db": ("fold", dict(_NORM, equalization_method="ZF", snr_db=18.0), 1024, (84992, 45056)),
    "cp_apsk_mmse": ("fold", dict(constellation_type="PSK"), 1024, (11264, 6144)),
    "zp_aqam_norm_mmse": ("mm", dict(_NORM, prefix_type="ZERO"), 1024, (55296, 52224)),
    "cp_aqam_norm_512_22db": ("fold", dict(_NORM, snr_db=22.0, **_WIDE), 256, (265216, 131072)),
}
PLAIN = {"fold": (fk.fold_link, fk.fold_chunk_plain, fk.fold_planes, fk.fold_wide_planes),
         "mm": (mmk.mm_link, mmk.mm_chunk_plain, mmk.mm_planes, mmk.mm_wide_planes)}
# The random-word links of the oracle: each chain, narrow and wide, at 20 dB,
# with the (bit, symbol) errors of the XLA order (the port's) and of the JAX
# kernel's un-normalized pre-IDFT order on the same draws.
ORACLE_LINKS = {
    "fold": ("fold", dict(equalization_method="ZF"), 256, (39, 39), (2366, 2266)),
    "mm": ("mm", dict(prefix_type="ZERO", channel_model="Lin-Phoong_P2"), 256, (3730, 2884), (13115, 7881)),
    "fold_wide": ("fold", dict(num_subcarriers=300, channel_model="severe_multipath"), 64, (262, 217),
                  (9971, 7113)),
    "mm_wide": ("mm", dict(_WIDE, prefix_type="ZERO"), 64, (494, 436), (16647, 11827)),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(pkg, num_ofdm=1024, **kw):
    """The reference's adaptive config (its 20 dB entry) on SC-FDE, in
    package ``pkg``'s config."""
    cfg = {c.snr_db: c for c in pkg.SimulationConfig.from_json(ADAPTIVE_JSON)}[20.0]
    return cfg.replace(modulation_type="SC-OFDM", num_symbols=num_ofdm, **kw)


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(_reference(jcfg, **kw, engine="planar", hotpath="pallas", **extra)))


def _port_link(chain, kw):
    setup = tpl.prepare(_reference(tcfg, **kw))
    assert tpl.kernel_mode(setup) == chain
    return PLAIN[chain][0](setup, "cpu")


def _width(chain, link):
    return link.T if chain == "mm" else link.n


def _planes(chain, link):
    """The chain's plain planes function (narrow or wide)."""
    wide = (fk if chain == "fold" else mmk).is_wide(link)
    return PLAIN[chain][3 if wide else 2]


def _decision_margin(er, ei, codec):
    """Distance of each point to its nearest decision boundary: slicer units
    for aqam, radians for apsk (inf on inactive lanes)."""
    er, ei = np.asarray(er, np.float64), np.asarray(ei, np.float64)
    M = codec.irows[1].numpy().astype(np.float64)
    if codec.mode == "aqam":
        c0 = (M - 1) * 0.5
        d = np.full(er.shape, np.inf)
        for v in (er + c0, c0 - ei):
            inside = (v > 0.5) & (v < M - 1.5)
            d = np.minimum(d, np.where(inside, np.abs(v - np.floor(v) - 0.5), np.inf))
        return np.where(M > 1, d, np.inf)
    sec = np.angle(er + 1j * ei) * M / (2 * np.pi)
    return np.where(M > 1, np.abs(sec - np.floor(sec) - 0.5) * 2 * np.pi / M, np.inf)


def _jax_zero_words(kw, chunk):
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.is_sc and spec.mode == ("apsk" if kw.get("constellation_type") == "PSK" else "aqam")
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw.get("snr_db", 20.0)),
                  jnp.ones(spec.n, jnp.float32))
    return int(stats["bit_errors"]), int(stats["symbol_errors"])


@pytest.mark.parametrize("name", list(ZERO_WORD_LINKS))
def test_zero_words_match_pallas_kernel(name):
    chain, kw, chunk, counts = ZERO_WORD_LINKS[name]
    assert _jax_zero_words(kw, chunk) == counts
    link = _port_link(chain, kw)
    z = np.zeros((chunk, _width(chain, link)), np.int64)
    snr_lin = lk.snr_linear(kw.get("snr_db", 20.0))
    _, er, ei, _, _ = _planes(chain, link)(link, (0, 0), 0, chunk, snr_lin, "cpu", (z, z, z))
    # zero words make every symbol alike: one flipped decision moves a count
    # by up to the chunk, so no point may sit near a boundary; the JAX
    # products (bf16 x 3) agree with f32 to ~1e-5 in slicer units
    assert _decision_margin(er.numpy(), ei.numpy(), link.q).min() > 1e-3
    acc, psum = lk.new_accumulators("cpu")
    PLAIN[chain][1](link, (0, 0), 0, chunk, snr_lin, acc, psum, words=(z, z, z))
    assert tuple(acc.tolist()[:2]) == counts


def _capture_equalizer_input(monkeypatch):
    seen = {}
    real = lk.equalize

    def equalize(link, yr, yi, *a, **k):
        seen["y"] = yr.double().numpy() + 1j * yi.double().numpy()
        return real(link, yr, yi, *a, **k)

    monkeypatch.setattr(lk, "equalize", equalize)
    return seen


def _oracle(kw, y, chunk, pre_idft):
    """(slicer-unit points, rx indices) of the chain after the channel in
    float64, on the port's equalizer input ``y`` (the channel is held
    against the JAX package's matrices in test_torch_{fold,mm}{,_wide}.py): ZF / MMSE
    against the raw-IR h, the lane row 0.5/scale of _consts_for before the
    SC IDFT (``pre_idft``: the JAX kernel without normalize) or after it
    (the XLA order), the JAX kernel's ``_demap_tile``."""
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.mode == "aqam" and spec.is_sc and not spec.normalize
    n = spec.n
    lanes = [np.asarray(c)[0, :n] for c in pk._consts_for(jr, spec)[-5:]]
    row = lanes[4].astype(np.float64)  # 0.5/scale of lane k's order
    h = np.asarray(jr.setup.h_freq, np.complex128)
    if spec.method == jcfg.EqualizationMethod.ZF:
        e = y / np.where(h == 0, 1e-10, h)
    else:
        snr = 10.0 ** (kw.get("snr_db", 20.0) / 10.0)
        nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
        e = y * np.conj(h) / (np.abs(h) ** 2 + nv)
    dr, di = jdft.dft_matrix(n, inverse=True)
    idft = np.asarray(dr, np.float64) + 1j * np.asarray(di, np.float64)
    e = (e * row) @ idft if pre_idft else (e @ idft) * row
    rx = pk._demap_tile(spec, jnp.asarray(e.real, jnp.float32), jnp.asarray(e.imag, jnp.float32),
                        (jnp.asarray(lanes[1]), jnp.asarray(lanes[2])))
    return e, np.asarray(rx).astype(np.int64)


def _counts(tx, rx):
    tx, rx = torch.as_tensor(np.asarray(tx)), torch.from_numpy(rx)
    return int(tmt.index_bit_errors(tx, rx)), int(tmt.symbol_errors(tx, rx))


@pytest.mark.parametrize("method", ["MMSE", "ZF"])
def test_pre_idft_oracle_reproduces_jax_kernel(method, monkeypatch):
    # the JAX kernel without normalize: its zero-word counts are those of the
    # lane row folded in before the IDFT, not the port's (the XLA order)
    kw = dict(equalization_method=method)
    want = _jax_zero_words(kw, 1024)
    assert want == (6144, 4096)
    link = _port_link("fold", kw)
    seen = _capture_equalizer_input(monkeypatch)
    z = np.zeros((1024, 64), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    fk.fold_chunk_plain(link, (0, 0), 0, 1024, lk.snr_linear(20.0), acc, psum, words=(z, z, z))
    tx = lk.encode(torch.zeros((1024, 64), dtype=torch.int64), link.q)[0]
    pre_e, pre_rx = _oracle(kw, seen["y"], 1024, pre_idft=True)
    post_e, post_rx = _oracle(kw, seen["y"], 1024, pre_idft=False)
    for e in (pre_e, post_e):
        assert _decision_margin(e.real, e.imag, link.q).min() > 1e-3
    assert _counts(tx, pre_rx) == want
    assert _counts(tx, post_rx) == tuple(acc.tolist()[:2]) == (7168, 6144)


@pytest.mark.parametrize("name", list(ORACLE_LINKS))
def test_post_idft_oracle_matches_plain_chain(name, monkeypatch):
    chain, kw, chunk, post, pre = ORACLE_LINKS[name]
    link = _port_link(chain, kw)
    assert link.q.mode == "aqam" and link.is_sc and (name.endswith("_wide") == (link.n > 256))
    rng = np.random.default_rng(2026)
    w = _width(chain, link)
    words = [rng.integers(0, 1 << 32, size=(chunk + 1, w), dtype=np.uint64).astype(np.int64) for _ in range(3)]
    sym0 = 3 * chunk + 5
    snr_lin = lk.snr_linear(20.0)
    seen = _capture_equalizer_input(monkeypatch)
    tx, er, ei, _, _ = _planes(chain, link)(link, (0, 0), sym0, chunk, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    PLAIN[chain][1](link, (0, 0), sym0, chunk, snr_lin, acc, psum, words=words)
    e, jrx = _oracle(kw, seen["y"], chunk, pre_idft=False)
    # f32 products and transforms against f64 (largest gap seen ~2e-5)
    np.testing.assert_allclose(er.numpy() + 1j * ei.numpy(), e, rtol=1e-4, atol=1e-4)
    got, want = tuple(acc.tolist()[:2]), _counts(tx, jrx)
    if got != want:
        # only points within 1e-4 of a decision boundary may decode apart
        rx = lk.demap(er, ei, link.q).numpy()
        assert np.all(_decision_margin(e.real, e.imag, link.q)[rx != jrx] < 1e-4)
    assert got == post
    # the JAX kernel's un-normalized order is another link on the same draws
    _, pre_rx = _oracle(kw, seen["y"], chunk, pre_idft=True)
    assert _counts(tx, pre_rx) == pre


# The eager chain's adaptive SC-FDE link (test_torch_eager.py, adaptive_scfde):
# the headline with waterfilling and CAPACITY_BASED loading on SC-FDE, 20 dB.
EAGER_BASE = dict(num_symbols=64 * 1024, num_subcarriers=64, constellation_order=64, channel_type="CUSTOM",
                  channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                  equalization_method="MMSE", modulation_type="SC-OFDM", snr_db=20.0,
                  adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING")
# fold adds its noise per frequency bin and the eager chain per time sample,
# so its case runs without noise (the MMSE bias and the mixed orders still
# err); mm adds it per time sample from the same words, at one tile a chunk
EAGER_CASES = {"fold": dict(noise_type="NONE"), "mm": dict(prefix_type="ZERO")}


@pytest.mark.parametrize("chain", list(EAGER_CASES))
def test_plain_chain_matches_eager_chain_and_chunk_body(chain, monkeypatch):
    kw = dict(EAGER_BASE, **EAGER_CASES[chain])
    B = 128
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    link = PLAIN[chain][0](setup, "cpu")
    assert tpl.kernel_mode(setup) == chain and lk.tile_for(B, link.tile_cap) == B
    rng = np.random.default_rng(7)
    words = [rng.integers(0, 1 << 32, size=(B, _width(chain, link)), dtype=np.uint64).astype(np.int64)
             for _ in range(3)]
    snr_lin = lk.snr_linear(20.0)
    tx, er, ei, _, _ = PLAIN[chain][2](link, (0, 0), 0, B, snr_lin, "cpu", words)
    acc, psum = lk.new_accumulators("cpu")
    PLAIN[chain][1](link, (0, 0), 0, B, snr_lin, acc, psum, words=words)
    dr, di = lk.dump_points(link, er, ei)
    points = dr.numpy() + 1j * di.numpy()

    z0, z1 = (t.numpy() for t in lk.box_muller(torch.from_numpy(words[1]), torch.from_numpy(words[2])))
    draws = (tx.numpy().astype(np.int32), z0, z1)
    elink = tpl.eager_link(setup, "cpu")
    eacc, epsum = lk.new_accumulators("cpu")
    _, data = tpl.eager_chunk(elink, (0, 0), 0, B, 20.0, eacc, epsum, tpl.eager_carry(elink), draws=draws)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="xla")))
    monkeypatch.setattr(jprng, "uniform_indices", lambda key, shape, mask: jnp.asarray(draws[0]))
    monkeypatch.setattr(jprng, "normal_planes", lambda key, shape: (jnp.asarray(z0), jnp.asarray(z1)))
    stats, _ = jr.chunk_body(jax.random.PRNGKey(0), jr._init_carry(), B, return_symbols=True)
    jdata = cplx.to_numpy(stats["received_symbols"]).reshape(B, -1)

    # f32 matrix chains against torch.fft and the JAX planar DFTs, data units
    np.testing.assert_allclose(points, data.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(points, jdata, rtol=1e-4, atol=1e-4)
    got = tuple(acc.tolist()[:2])
    assert got[0] > 0
    for other in (tuple(eacc.tolist()[:2]), (int(stats["bit_errors"]), int(stats["symbol_errors"]))):
        if got != other:
            # only points within 1e-4 of a decision boundary may decode apart
            near = _decision_margin(er.numpy(), ei.numpy(), link.q) < 1e-4
            assert near.any() and abs(got[1] - other[1]) <= near.sum()


@pytest.mark.parametrize("prefix,channel", list(itertools.product(
    ["CYCLIC", "ZERO", "NONE"], ["severe_multipath", "flat_fading", "Lin-Phoong_P2"])))
def test_routing_mirrors_jax_plan(prefix, channel):
    # every adaptive SC-FDE link the JAX plan admits (and supports() takes)
    # runs on fold or mm, narrow or wide; past its budget (2048 sc) eager
    for n, kind in itertools.product((16, 32, 64, 128, 256, 512, 1024, 2048), ("QAM", "PSK")):
        kw = dict(num_subcarriers=n, prefix_type=prefix, channel_model=channel, constellation_type=kind)
        jr = jpl.LinkRunner(jpl.prepare(_reference(jcfg, 16, engine="planar", **kw)))
        plan = pk.plan_for(jr)
        jax_mode = "eager" if plan is None or not pk.supports(jr, interpret=True) else (
            "mm" if prefix == "ZERO" else "fold")
        assert plan is None or plan[1] in ("mm", "mm4")
        assert tpl.kernel_mode(tpl.prepare(_reference(tcfg, 16, **kw))) == jax_mode
        assert (jax_mode == "eager") == (n == 2048)


def test_adaptive_codec_refusals_route_eager():
    # no active lane, or orders past the codec's static width: the JAX
    # package's supports() refuses the first; the port's codec the second
    setup = tpl.prepare(_reference(tcfg, 16))
    assert tpl.kernel_mode(setup) == "fold" and lk.adaptive_supported(setup)
    none = dataclasses.replace(setup.amap, orders=np.zeros_like(setup.amap.orders))
    assert not lk.adaptive_supported(dataclasses.replace(setup, amap=none))
    orders = setup.amap.orders.copy()
    orders[0] = 1 << 14  # 128 x 128 QAM, square
    wide = dataclasses.replace(setup, amap=dataclasses.replace(setup.amap, orders=orders))
    assert lk.adaptive_bits(wide) == 14 and tpl.kernel_mode(wide) == "eager"


# Carry and shards: a link whose previous-symbol tail reaches the kept
# samples (no prefix, Lin-Phoong P2), narrow and wide.
CARRY_LINKS = {"narrow": dict(prefix_type="NONE", channel_model="Lin-Phoong_P2"),
               "wide": dict(prefix_type="NONE", channel_model="Lin-Phoong_P2", num_subcarriers=300)}


@pytest.mark.parametrize("name", list(CARRY_LINKS))
def test_carry_in_and_probe_match_one_chunk(name):
    link = _port_link("fold", CARRY_LINKS[name])
    assert link.E > 0 and link.q.mode == "aqam" and fk.is_wide(link) == (name == "wide")
    snr_lin, key, sym0, C = lk.snr_linear(20.0), (11, 12), 4096 + 5, 128
    runs = {}
    for run, s, prev in (("a", sym0, None), ("b", sym0 + C, None),
                         ("b_prev", sym0 + C, fk.fold_probe(link, key, sym0, C)[2:])):
        acc, psum = lk.new_accumulators("cpu")
        runs[run] = (acc, fk.fold_chunk(link, key, s, C, snr_lin, acc, psum, prev=prev))
    # the probe gives chunk a's carry row, and its tail as a carry-in gives
    # chunk b exactly what b's own recomputed predecessor gives
    pr, pi, _, _ = fk.fold_probe(link, key, sym0, C)
    assert torch.equal(pr, runs["a"][1][0]) and torch.equal(pi, runs["a"][1][1])
    assert runs["b"][0].tolist() == runs["b_prev"][0].tolist() and runs["b"][0][0] > 0


@pytest.mark.parametrize("name", list(CARRY_LINKS))
def test_one_rank_halo_mesh_equals_link_runner(name):
    setup = tpl.prepare(_reference(tcfg, 512, symbols_per_chunk=128, **CARRY_LINKS[name]))
    runner = ShardedLinkRunner(setup, mesh=make_mesh("cpu"), stream_mode="halo")
    assert runner.mode == "fold" and runner.link.E > 0 and runner.kernel.probe is not None
    r = runner.run(21)
    want = tpl.LinkRunner(setup, device="cpu").run(prng.fold_in(21, 0))
    assert r["bit_errors"] > 0
    assert (r["bit_errors"], r["symbol_errors"], r["papr_db"]) == (want["bit_errors"], want["symbol_errors"],
                                                                    want["papr_db"])


@pytest.mark.parametrize("prefix", ["CYCLIC", "ZERO"])
def test_slice_end_to_end_matches_jax_xla_runner(prefix):
    B = 1 << 12
    setup = tpl.prepare(_reference(tcfg, B, prefix_type=prefix))
    port_runner = tpl.LinkRunner(setup, device="cpu")
    assert port_runner.mode == ("mm" if prefix == "ZERO" else "fold")
    port = port_runner.run(0)
    ref = jpl.LinkRunner(jpl.prepare(_reference(jcfg, B, prefix_type=prefix, hotpath="xla"))).run(
        jax.random.PRNGKey(0))
    assert ref["hotpath_used"] == "xla" and port["hotpath_used"] == "torch"
    assert port["bit_errors"] > 100 and port["total_bits"] == ref["total_bits"]
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"], ref["total_bits"], z=5)


def test_setup_carries_across_and_needs_cuda_or_an_explicit_cpu():
    js = jpl.prepare(_reference(jcfg, 16))
    ts = tpl.prepare(_reference(tcfg, 16))
    back = convert.setup_from_arrays(ts.cfg, convert.setup_to_arrays(js))
    a, b = fk.fold_link(ts, "cpu"), fk.fold_link(back, "cpu")
    assert a.q.mode == b.q.mode == "aqam" and a.is_sc and b.is_sc
    assert torch.equal(a.q.irows, b.q.irows) and torch.equal(a.q.frows, b.q.frows)
    assert torch.equal(a.gr, b.gr) and torch.equal(a.hr, b.hr)
    if torch.cuda.is_available():
        assert tpl.LinkRunner(ts).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(ts)
    with pytest.raises(ValueError):
        fk.fold_chunk(a, (0, 0), 0, 64, 1.0, torch.zeros(3, dtype=torch.int64, device="meta"),
                      torch.zeros(1, dtype=torch.float64, device="meta"))
