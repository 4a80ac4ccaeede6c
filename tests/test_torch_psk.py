"""PSK, adaptive QAM and adaptive PSK on each chunk chain against the JAX package.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros; matmul_passes=3 for f32-grade products): the port's plain chunk
  on all-zero words counts the same errors, on diag, fold, lr and mm in
  psk and one adaptive mode each.
* On seeded random words, sym0 > 0: the port's plain chunk against an
  oracle of the codec's part of the chain built from the JAX kernel's own
  helpers and ``_consts_for`` rows: ``_encode_tile`` on the words, the
  kernel's equalizer forms (the slicer gain per mode: scalar 1 for PSK,
  the per-lane row for aqam, raw ZF rows for PSK) on the port's channel
  output, ``_demap_tile``.  The channel itself is held against the JAX
  builders in test_torch_{link,fold,lr,mm}.py.
* The slice end to end: 8-PSK through the port's runner on the CPU against
  the JAX runner's XLA path, statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import metrics as tmt
from ofdm_tpu_torch.ops import mm_kernel as mmk

# The JAX package's audit link (tools/shape_audit.py:38-50), 64 sc.
BASE = dict(num_subcarriers=64, constellation_order=64, channel_type="CUSTOM", channel_model="severe_multipath",
            prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="MMSE", snr_db=30.0)
PSK8 = dict(constellation_type="PSK", constellation_order=8)
ADAPT = dict(power_allocation_type="WATERFILLING", adaptive_modulation_mode="CAPACITY_BASED", snr_db=20.0)
APSK = dict(ADAPT, constellation_type="PSK")
ZP05_128 = dict(num_subcarriers=128, prefix_type="ZERO", prefix_length_ratio=0.5)
CHAINS = {
    "diag": (lk.diag_link, lk.diag_chunk_plain),
    "fold": (fk.fold_link, fk.fold_chunk_plain),
    "lr": (lrk.lr_link, lrk.lr_chunk_plain),
    "mm": (mmk.mm_link, mmk.mm_chunk_plain),
}
# (chain, codec mode, link)
LINKS = {
    "diag_psk8": ("diag", "psk", PSK8),
    "diag_aqam": ("diag", "aqam", ADAPT),
    "diag_apsk_p1_10db": ("diag", "apsk", dict(APSK, channel_model="Lin-Phoong_P1", snr_db=10.0)),
    "fold_psk8_cp034": ("fold", "psk", dict(PSK8, prefix_length_ratio=0.34)),
    "fold_apsk_cp034": ("fold", "apsk", dict(APSK, prefix_length_ratio=0.34)),
    "fold_aqam_p1_15db_zf": ("fold", "aqam", dict(ADAPT, channel_model="Lin-Phoong_P1", snr_db=15.0,
                                                   prefix_length_ratio=0.34, equalization_method="ZF")),
    "lr_psk8_zp05": ("lr", "psk", dict(PSK8, **ZP05_128)),
    "lr_aqam_zp05": ("lr", "aqam", dict(ADAPT, **ZP05_128)),
    "mm_psk8_zp_zf": ("mm", "psk", dict(PSK8, prefix_type="ZERO", equalization_method="ZF")),
    "mm_aqam_zp": ("mm", "aqam", dict(ADAPT, prefix_type="ZERO")),
    "mm_apsk_zp_none": ("mm", "apsk", dict(APSK, prefix_type="ZERO", equalization_method="NONE", snr_db=25.0)),
}
ZERO_WORD_LINKS = ["diag_psk8", "diag_aqam", "fold_psk8_cp034", "fold_apsk_cp034", "lr_psk8_zp05",
                   "lr_aqam_zp05", "mm_psk8_zp_zf", "mm_aqam_zp"]


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(name, num_ofdm):
    kw = {**BASE, **LINKS[name][2]}
    adaptive = kw.get("adaptive_modulation_mode") == "CAPACITY_BASED"
    kw["num_symbols"] = num_ofdm if adaptive else num_ofdm * kw["num_subcarriers"]
    return kw


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra)))


def _port_link(name, kw):
    chain = LINKS[name][0]
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    assert tpl.kernel_mode(setup) == chain
    link = CHAINS[chain][0](setup, "cpu")
    assert link.q.mode == LINKS[name][1]
    return link


def _width(name, link):
    return link.T if LINKS[name][0] == "mm" else link.n


def _decision_margin(er, ei, codec):
    """Distance of each point to its nearest decision boundary: slicer units
    for aqam, radians for PSK (inf on inactive lanes)."""
    er, ei = np.asarray(er, np.float64), np.asarray(ei, np.float64)
    if codec.mode == "psk":
        M = np.full(er.shape[-1], codec.order)
    else:
        M = codec.irows[1].numpy().astype(np.float64)
    if codec.mode == "aqam":
        c0 = (M - 1) * 0.5
        d = np.full(er.shape, np.inf)
        for v in (er + c0, c0 - ei):
            inside = (v > 0.5) & (v < M - 1.5)
            frac = np.abs(v - np.floor(v) - 0.5)
            d = np.minimum(d, np.where(inside, frac, np.inf))
        return np.where(M > 1, d, np.inf)
    sec = np.angle(er + 1j * ei) * M / (2 * np.pi)
    return np.where(M > 1, np.abs(sec - np.floor(sec) - 0.5) * 2 * np.pi / M, np.inf)


def _zero_words(name, link, chunk):
    z = np.zeros((chunk, _width(name, link)), np.int64)
    words = [z, z, z]
    if LINKS[name][0] == "lr" and link.add_noise and link.rank:
        words += [np.zeros((chunk, link.rank), np.int64)] * 2
    return words


def _capture_equalizer_input(monkeypatch):
    seen = {}
    real = lk.equalize

    def equalize(link, yr, yi, *a, **k):
        seen["y"] = (yr.clone(), yi.clone())
        return real(link, yr, yi, *a, **k)

    monkeypatch.setattr(lk, "equalize", equalize)
    return seen


@pytest.mark.parametrize("name", ZERO_WORD_LINKS)
def test_zero_words_match_pallas_kernel(name, monkeypatch):
    chunk = 256
    kw = _kw(name, chunk)
    jr = _jax_runner(kw, matmul_passes=3)
    spec = pk._spec_for(jr, chunk, True)
    assert (spec.conv if spec.conv != "mm" or not spec.fold else "fold") in (LINKS[name][0], "mm")
    assert spec.mode == LINKS[name][1]
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                  jnp.ones(spec.n, jnp.float32))
    link = _port_link(name, kw)
    seen = _capture_equalizer_input(monkeypatch)
    acc, psum = lk.new_accumulators("cpu")
    CHAINS[LINKS[name][0]][1](link, (0, 0), 0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum,
                              words=_zero_words(name, link, chunk))
    # zero words make every symbol alike: one flipped decision moves a count
    # by up to 256, so no point may sit near a boundary
    er, ei = lk.equalize(link, *seen["y"], lk.snr_linear(kw["snr_db"]),
                         lrk.THREADS if LINKS[name][0] == "lr" else 32)
    assert _decision_margin(er.numpy(), ei.numpy(), link.q).min() > 1e-3
    be, se, peak = acc.tolist()
    assert (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    # the JAX diag kernel's PAPR plane is one bf16 pass; the others f32-grade
    rel = 2e-2 if LINKS[name][0] == "diag" else 1e-4
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=rel)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=rel)


def _jax_rows(jr, spec):
    """(h re, h im, |h|^2, ZF gain re, im, mean |h|^2, lane rows) of
    pallas_link._consts_for, unpacked."""
    consts = list(pk._consts_for(jr, spec))
    k = {"aqam": 5, "apsk": 6}.get(spec.mode, 0)
    lanes = [np.asarray(c)[0, : spec.n] for c in consts[len(consts) - k :]]
    rest = consts[: len(consts) - k]
    if pk._mseg_for(spec.method, spec.pack):
        rest = rest[:-1]
    eq = [np.asarray(c, np.float32)[0, : spec.n] for c in rest[-5:]]
    return (*eq, np.float32(np.asarray(consts[0])[0]), lanes)


def _codec_oracle(jr, spec, raw, yr, yi, snr_db):
    """tx and rx indices of the JAX kernel's codec stages: _encode_tile on
    the raw words, the equalizer in its mode's slicer form on y, _demap_tile."""
    hre, him, habs2, gr, gi, cg, lanes = _jax_rows(jr, spec)
    aq_enc = aq_dec = None
    if spec.mode == "aqam":
        aq_enc, aq_dec = tuple(lanes[:4]), (lanes[1], lanes[2])
    elif spec.mode == "apsk":
        aq_enc, aq_dec = (lanes[0], lanes[2], lanes[3]), (lanes[1], lanes[4], lanes[5])
    tx, _, _ = pk._encode_tile(spec, jnp.asarray(np.asarray(raw, np.uint32).view(np.int32)),
                               None if aq_enc is None else tuple(map(jnp.asarray, aq_enc)))
    yr, yi = jnp.asarray(yr), jnp.asarray(yi)
    snr_lin = jnp.exp(jnp.float32(snr_db) * np.float32(np.log(10.0) / 10.0))
    slicer = lanes[4] if spec.mode == "aqam" else np.float32(1.0)
    if spec.method == jcfg.EqualizationMethod.ZF:
        er, ei = yr * gr - yi * gi, yi * gr + yr * gi
    elif spec.method == jcfg.EqualizationMethod.MMSE:
        nv = jnp.mean(yr * yr + yi * yi, axis=1, keepdims=True) / snr_lin / cg
        g = slicer / (habs2 + nv)
        er, ei = (yr * hre + yi * him) * g, (yi * hre - yr * him) * g
    elif spec.mode == "aqam":
        er, ei = yr * slicer, yi * slicer
    else:
        er, ei = yr, yi
    rx = pk._demap_tile(spec, er, ei, None if aq_dec is None else tuple(map(jnp.asarray, aq_dec)))
    return np.asarray(tx).astype(np.int64), np.asarray(rx).astype(np.int64)


@pytest.mark.parametrize("name", list(LINKS))
def test_random_words_match_jax_oracle(name, monkeypatch):
    chunk = 1024
    kw = _kw(name, 4 * chunk)
    if LINKS[name][1] == "psk":
        kw["snr_db"] = 12.0  # 8-PSK at 30 dB makes no errors
    link = _port_link(name, kw)
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)
    assert (spec.mode, spec.bits, spec.is_gray) == (link.q.mode, link.q.bits, link.q.gray)
    rng = np.random.default_rng(2026)
    # the chains with a previous-symbol tail read symbol sym0 - 1's words too
    prev = 0 if LINKS[name][0] == "diag" else 1
    w = _width(name, link)
    words = [rng.integers(0, 1 << 32, size=(chunk + prev, w), dtype=np.uint64).astype(np.int64)
             for _ in range(3)]
    if LINKS[name][0] == "lr" and link.add_noise and link.rank:
        words += [rng.integers(0, 1 << 32, size=(chunk, link.rank), dtype=np.uint64).astype(np.int64)
                  for _ in range(2)]
    seen = _capture_equalizer_input(monkeypatch)
    acc, psum = lk.new_accumulators("cpu")
    sym0 = 3 * chunk + 5
    CHAINS[LINKS[name][0]][1](link, (0, 0), sym0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=words)
    tx, rx = _codec_oracle(jr, spec, words[0][prev:, : link.n], *(t.numpy() for t in seen["y"]), kw["snr_db"])
    be, se, _ = acc.tolist()
    assert be > 0 and (be, se) == (int(tmt.index_bit_errors(torch.from_numpy(tx), torch.from_numpy(rx))),
                                   int(tmt.symbol_errors(torch.from_numpy(tx), torch.from_numpy(rx))))


def test_psk_slice_end_to_end_matches_jax_runner():
    B = 1 << 12
    kw = dict(BASE, **PSK8, snr_db=15.0, num_symbols=64 * B)
    port = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu").run(0)
    ref = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw))).run(jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and ref["hotpath_used"] == "xla"
    assert port["constellation_scheme"] == ref["constellation_scheme"] == "PSK"
    assert port["bit_errors"] > 100
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"], ref["total_bits"], z=4)
    # one run's PAPR peak spreads by ~0.4 dB sd: the means of 32 noiseless
    # runs a side (PAPR is TX-side) differ by ~0.1 dB sd
    quiet = dict(kw, num_symbols=64 * (1 << 10), noise_type="NONE")
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**quiet)), device="cpu")
    jax_runner = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**quiet)))
    port_db = np.mean([runner.run(s)["papr_db"] for s in range(32)])
    ref_db = np.mean([jax_runner.run(jax.random.PRNGKey(s))["papr_db"] for s in range(32)])
    assert abs(port_db - ref_db) < 0.3
