"""Symbol capture: the dump stage's plain version on every chain and the eager chain's capture.

* The plain dump of each chain (diag qam, aqam and 8-PSK, fold, lr, mm in
  qam and adaptive PSK, and a normalized link) against the JAX package's ``make_pallas_dump_chunk`` in
  interpret mode, whose PRNG emits zeros, on zero words.
* The same dumps on seeded random words against the float64 oracles that
  ``tests/test_torch_{fold,lr,mm}.py`` build from the JAX helpers (and one
  for diag here), in data units.
* ``LinkRunner.run(collect_symbols=k)``: chunk 0's points, bitwise, on a
  kernel path and on the eager chain; the counts are untouched;
  ``received_symbols_exact`` is True; ``render_constellation=True`` gives
  a PIL image on fixed and adaptive links.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fold import _kw as fold_kw
from test_torch_fold import _oracle as fold_oracle
from test_torch_lr import _kw as lr_kw
from test_torch_lr import _oracle as lr_oracle
from test_torch_mm import _kw as mm_kw
from test_torch_mm import _oracle as mm_oracle

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import cplx
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import mm_kernel as mmk

HEADLINE = dict(num_symbols=64 * 1024, num_subcarriers=64, constellation_order=64, channel_type="CUSTOM",
                channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                equalization_method="MMSE", snr_db=30.0)
_WF = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True, normalize_before_demap=True)
_ADAPT = dict(adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING", snr_db=20.0)
PLAIN = {"diag": lk.diag_chunk_plain, "fold": fk.fold_chunk_plain, "lr": lrk.lr_chunk_plain,
         "mm": mmk.mm_chunk_plain}
# (chain, config): one link a chain and mode (PSK and adaptive PSK dump raw
# points), and a normalized link
DUMP_LINKS = {
    "diag_qam": ("diag", HEADLINE),
    "diag_aqam": ("diag", dict(HEADLINE, **_ADAPT)),
    "fold_scfde": ("fold", fold_kw("scfde_default")),
    "lr_cp034": ("lr", lr_kw("d_cp034_mmse_noise", snr_db=30.0)),
    "mm_zp": ("mm", mm_kw("c_zp034_mmse_noise")),
    "diag_normalized": ("diag", dict(HEADLINE, **_WF)),
    "diag_psk8": ("diag", dict(HEADLINE, constellation_type="PSK", constellation_order=8,
                               channel_model="severe_multipath", snr_db=15.0)),
    "mm_apsk": ("mm", mm_kw("c_zp034_mmse_noise", **_ADAPT, constellation_type="PSK")),
}
CHUNK = 512


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _route(monkeypatch, chain):
    """The lr link at 64 subcarriers: both packages route ISI OFDM links to
    lr from 64 subcarriers for the test."""
    if chain == "lr":
        monkeypatch.setattr(pk, "_LR_MIN_N", 64)
        monkeypatch.setattr(tpl, "LR_MIN_N", 64)


def _rows(setup):
    if not setup.cfg.apply_power_allocation:
        return None
    return torch.tensor(np.sqrt(setup.power_allocation)[None], dtype=torch.float32)


def _plain_dump(chain, kw, words, sym0=0, rows=None):
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    runner = tpl.LinkRunner(setup, device="cpu")
    assert runner.mode == chain
    link = runner.link
    dump = lk.new_dump(CHUNK, link.n, "cpu")
    acc, psum = lk.new_accumulators("cpu")
    PLAIN[chain](link, (0, 0), sym0, CHUNK, lk.snr_linear(kw["snr_db"]), acc, psum, words=words,
                 rows=_rows(setup) if rows is None else rows, dump=dump)
    return link, torch.complex(*dump).numpy(), acc


def _zero_words(chain, link):
    z = np.zeros((CHUNK, link.T if chain == "mm" else link.n), np.int64)
    words = (z, z, z)
    if chain == "lr" and link.add_noise and link.rank:
        g = np.zeros((CHUNK, link.rank), np.int64)
        words += (g, g)
    return words


def _tolerance(chain, passes):
    """Points' agreement with the JAX kernel's: the diag chain has no
    product on the data path (f32 against f32, a few ulps); the product
    chains agree to f32 rounding at three bf16 passes (bf16x3) and to the
    single pass's ~6e-3 relative error (2% of the largest point) at one."""
    if chain == "diag":
        return 1e-5
    return 1e-4 if passes == 3 else 2e-2


@pytest.mark.parametrize("name", list(DUMP_LINKS))
def test_zero_word_dump_matches_pallas_dump(monkeypatch, name):
    chain, kw = DUMP_LINKS[name]
    _route(monkeypatch, chain)
    passes = 3 if chain != "diag" else "auto"
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas",
                                                          matmul_passes=passes)))
    spec = pk._spec_for(jr, CHUNK, True)
    fn = pk.make_pallas_dump_chunk(jr, CHUNK, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                  jnp.asarray(np.sqrt(jr.setup.power_allocation), jnp.float32))
    ref = cplx.to_numpy(stats["received_symbols"]).reshape(spec.tile, -1)
    link = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu").link
    _, got, acc = _plain_dump(chain, kw, _zero_words(chain, link))
    assert got.shape == ref.shape == (CHUNK, 64)
    tol = _tolerance(chain, spec.passes) * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol
    # the dump changes nothing the chunk counts
    assert (int(acc[0]), int(acc[1])) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))


def _diag_oracle(kw, words):
    """The diag chain in float64: table points, y = s h, the tile's measured
    power over its slice, the link's Box-Muller noise, MMSE; data units."""
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    spec = pk._spec_for(jr, CHUNK, True)
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    _, sr, si = pk._encode_tile(spec, i32[0], None)
    s = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    h = np.asarray(jr.setup.h_freq, np.complex128)
    y = s * h
    snr = 10.0 ** (kw["snr_db"] / 10.0)
    S = lk.slice_symbols(64)
    sigma = np.concatenate([np.full((min(spec.tile, CHUNK - t0), 1),
                                    np.sqrt(np.mean(np.abs(y[t0 : t0 + min(S, spec.tile)]) ** 2) / snr / 2.0))
                            for t0 in range(0, CHUNK, spec.tile)])
    u1 = np.maximum(((np.asarray(words[1], np.int64) >> 8) & 0xFFFFFF) * 2.0 ** -24, 2.0 ** -24)
    co, sn = pk._cossin_u24((i32[2] >> 8) & 0xFFFFFF)
    y = y + sigma * np.sqrt(-2.0 * np.log(u1)) * (np.asarray(co, np.float64) + 1j * np.asarray(sn, np.float64))
    nv = np.mean(np.abs(y) ** 2, axis=1, keepdims=True) / snr / np.mean(np.abs(h) ** 2)
    return y * np.conj(h) / (np.abs(h) ** 2 + nv)


@pytest.mark.parametrize("name", ["diag_qam", "fold_scfde", "lr_cp034", "mm_zp"])
def test_random_word_dump_matches_float64_oracle(monkeypatch, name):
    chain, kw = DUMP_LINKS[name]
    _route(monkeypatch, chain)
    setup = tpl.prepare(tcfg.SimulationConfig(**kw))
    link = tpl.LinkRunner(setup, device="cpu").link
    rng = np.random.default_rng(99)
    sym0 = 0 if chain == "diag" else 5 * CHUNK + 3
    rows = CHUNK + (sym0 > 0)
    width = link.T if chain == "mm" else link.n
    words = tuple(rng.integers(0, 1 << 32, size=(rows, width), dtype=np.uint64).astype(np.int64) for _ in range(3))
    if chain == "lr" and link.rank:
        words += tuple(rng.integers(0, 1 << 32, size=(CHUNK, link.rank), dtype=np.uint64).astype(np.int64)
                       for _ in range(2))
    _, got, _ = _plain_dump(chain, kw, words, sym0)
    if chain == "diag":
        want = _diag_oracle(kw, words)
    else:
        oracle = {"fold": fold_oracle, "lr": lr_oracle, "mm": mm_oracle}[chain]
        want = oracle(kw, words, CHUNK)[2] / (0.5 / setup.const.scale)  # slicer units -> data units
    # f32 against f64: the chains' own oracle tests hold slicer units at 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _runner(**kw):
    return tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**dict(HEADLINE, **kw))), device="cpu")


@pytest.mark.parametrize("extra", [dict(num_symbols=64 * 3000, symbols_per_chunk=1024),
                                   dict(_WF, num_symbols=64 * 2048)], ids=["headline_3_chunks", "normalized"])
def test_kernel_path_capture_is_chunk_zero(extra):
    runner = _runner(**extra)
    plain = runner.run(4)
    r = runner.run(4, collect_symbols=1000)
    assert r["received_symbols_exact"] is True and plain["received_symbols_exact"] is None
    assert (r["bit_errors"], r["symbol_errors"]) == (plain["bit_errors"], plain["symbol_errors"])
    got = r["received_symbols"]
    assert got.dtype == np.complex64 and got.shape == (1000,)
    link = runner.link
    chunk = runner._chunk_plan()[0]
    _, er, ei, _, _ = lk.diag_planes(link, (4, 0), 0, chunk, lk.snr_linear(30.0), "cpu", rows=_rows(runner.setup))
    dr, di = lk.dump_points(link, er, ei)
    assert np.array_equal(got, torch.complex(dr, di).reshape(-1)[:1000].numpy())


def test_eager_capture_is_chunk_zero_data():
    runner = _runner(hotpath="xla", num_symbols=64 * 600, symbols_per_chunk=256)
    plain = runner.run(2)
    r = runner.run(2, collect_symbols=20000)  # more than chunk 0 holds: its 16384 points
    assert runner.mode == "eager" and r["received_symbols_exact"] is True
    assert (r["bit_errors"], r["symbol_errors"]) == (plain["bit_errors"], plain["symbol_errors"])
    link = runner.link
    acc, psum = lk.new_accumulators("cpu")
    _, data = tpl.eager_chunk(link, (2, 0), 0, 256, 30.0, acc, psum, tpl.eager_carry(link))
    assert np.array_equal(r["received_symbols"], data.reshape(-1).numpy())


@pytest.mark.parametrize("extra", [dict(num_symbols=64 * 256), dict(_ADAPT, num_symbols=256),
                                   dict(hotpath="xla", num_symbols=64 * 256)], ids=["fixed", "adaptive", "eager"])
def test_render_constellation_gives_an_image(extra):
    from PIL import Image

    r = _runner(**extra).run(0, render_constellation=True)
    assert isinstance(r["constellation_plot"], Image.Image) and r["constellation_plot"].size[0] > 100
    assert r["received_symbols"].shape == (4096,) and r["received_symbols_exact"] is True
