"""The premises of the diag kernels' one-pass redesign, on the CPU.

* The cyclic prefix's columns: at a width that is not a power of two the
  in-run PAPR product of ``diag_main`` and ``diag_staged`` computes F_tx's
  n distinct columns only, because ``cmatmul`` over a prefix column
  equals, bit for bit, its tail column (x, |x|^2, the peak).
* The IDFT: the plain diag chunk's in-run PAPR (``papr_plane``:
  ``wide_tx``'s block IDFT and prefix, the order of diag_main's in-warp
  radix-2 at a power-of-two width and of ``diag_wide`` past 256 sc)
  against the dense ``cmatmul`` over F_tx it replaced, on small chunks
  with ragged last tiles, at 64 and 128 sc (in-warp), 300 (the split) and
  512 sc (radix-2): the same counts, the PAPR statistic and carry row
  within f32 rounding.
* Against the JAX package: the same links' PAPR statistics against the
  Pallas diag kernel in interpret mode (all-zero words), as
  tests/test_torch_link.py does (rel 2e-2: JAX's plane is bf16).
* The one-pass scratch: ``onepass_slab`` and ``onepass_scratch`` give the
  sizes their docstrings state, under the 1 GB cap at any width.
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
from ofdm_tpu_torch.experiments import noise_bump as nb
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import linops

BASE = dict(constellation_order=64, channel_type="CUSTOM", channel_model="Lin-Phoong_P2", prefix_type="CYCLIC",
            prefix_length_ratio=1.0, equalization_method="MMSE", snr_db=20.0)
_WF = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True, normalize_before_demap=True)
_ADAPT = dict(power_allocation_type="WATERFILLING", adaptive_modulation_mode="CAPACITY_BASED")
# The reference's custom-channel demo IR (energy 1.22): channel rows of its own.
DEMO_IR = np.asarray((1.0, 0.4 - 0.2j, 0.1 + 0.1j))
# Relative tolerance of the block IDFT's PAPR statistic and carry row
# against the dense product's: both are f32, the transform rounds over its
# log2 n (or two split) stages, the product over n rounded terms a sample.
IDFT_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n, num_ofdm=64, **extra):
    kw = {**BASE, **extra, "num_subcarriers": n}
    adaptive = kw.get("adaptive_modulation_mode") == "CAPACITY_BASED"
    kw["num_symbols"] = num_ofdm if adaptive else num_ofdm * n
    return kw


def _link(kw, ir=None):
    setup = tpl.prepare(tcfg.SimulationConfig(**kw), channel_ir=ir)
    assert tpl.kernel_mode(setup) == "diag"
    return setup, lk.diag_link(setup, "cpu")


@pytest.mark.parametrize("n,ratio", [(64, 1.0), (128, 0.34), (96, 1.0), (200, 0.5)],
                         ids=["64sc_cp1.0", "128sc_cp0.34", "96sc_cp1.0", "200sc_cp0.5"])
def test_prefix_columns_repeat_the_tail_bitwise(n, ratio):
    setup = tpl.prepare(tcfg.SimulationConfig(**_cfg(n, prefix_length_ratio=ratio, channel_model="severe_multipath")))
    L = setup.prefix_length
    ftx = linops.tx_matrix(n, tcfg.PrefixType.CYCLIC, L, tcfg.ModulationType.OFDM)
    fr, fi = lk.f32_tensor(ftx[0], "cpu"), lk.f32_tensor(ftx[1], "cpu")
    assert 0 < L <= n and fr.shape == (n, n + L)
    if tpl.kernel_mode(setup) == "diag":
        # the kernels take F_tx where n is not a power of two, the IDFT where it is
        link = lk.diag_link(setup, "cpu")
        assert (link.fr is None) == (link.plan is not None) == (n & (n - 1) == 0)
    rng = np.random.default_rng(n)
    sr = torch.tensor(rng.standard_normal((32, n)).astype(np.float32))
    si = torch.tensor(rng.standard_normal((32, n)).astype(np.float32))
    xr, xi = lk.cmatmul(fr, fi, sr, si)
    assert torch.equal(xr[:, :L], xr[:, n:]) and torch.equal(xi[:, :L], xi[:, n:])
    pw = xr * xr + xi * xi
    assert torch.equal(pw[:, :L], pw[:, n:])
    # the kernels' statistic over the n distinct columns, the repeated ones twice
    distinct = pw[:, L:].double()
    peak = float(distinct.max())
    total = float(distinct.sum() + distinct[:, n - L :].sum())
    acc, psum = lk.new_accumulators("cpu")
    lk.add_papr(xr, xi, acc, psum)
    assert lk.bits_f32(int(acc[2])) == peak == float(pw.max())
    assert float(psum) == pytest.approx(total, rel=1e-12)


def _ftx(link):
    ftx = linops.tx_matrix(link.n, tcfg.PrefixType.CYCLIC, link.T - link.n, tcfg.ModulationType.OFDM)
    return lk.f32_tensor(ftx[0], "cpu"), lk.f32_tensor(ftx[1], "cpu")


def _dense_papr_plane(monkeypatch, link):
    fr, fi = _ftx(link)
    monkeypatch.setattr(lk, "papr_plane", lambda link_, sr, si: lk.cmatmul(fr, fi, sr, si))


def _chunk_stats(link, chunk, snr_db, rows=None, sym0=3):
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = lk.diag_chunk_plain(link, (5, 6), sym0, chunk, lk.snr_linear(snr_db), acc, psum, rows=rows)
    be, se, peak = acc.tolist()
    return be, se, lk.bits_f32(peak), float(psum), cr, ci


def _bump_rows(setup, n):
    scen = nb.SCENARIOS[1]
    rows = nb.point_rows(np.abs(setup.h_freq) ** 2, scen, nb.create_noise_profile(n, scen.noise_bump_db), 15.0)
    return torch.tensor(rows, dtype=torch.float32)


@pytest.mark.parametrize("case", ["64sc", "64sc_noise_bump", "128sc_power_normalize", "300sc", "512sc_stride1",
                                  "300sc_power_normalize", "512sc_power_normalize", "300sc_noise_bump",
                                  "300sc_demo_ir", "300sc_aqam"])
def test_block_idft_papr_against_dense(case, monkeypatch):
    n = int(case.split("sc")[0])
    extra, ir, bump = {}, None, case.endswith("noise_bump")
    if case == "512sc_stride1":
        extra = dict(papr_stride=1)
    elif case.endswith("power_normalize"):
        extra = _WF
    elif bump:
        extra = dict(apply_power_allocation=True, normalize_before_demap=True, noise_type="NONE")
    elif case.endswith("demo_ir"):
        ir = DEMO_IR
    elif case.endswith("aqam"):
        extra = _ADAPT
    setup, link = _link(_cfg(n, **extra), ir)
    assert link.fr is None and link.plan is not None and not link.txext
    if bump:
        link = lk.noise_bump_link(link)
        rows = _bump_rows(setup, n)
    elif setup.cfg.apply_power_allocation:
        rows = torch.tensor(np.sqrt(np.asarray(setup.power_allocation, np.float64))[None], dtype=torch.float32)
    else:
        rows = None
    assert (link.q.mode == "aqam") == case.endswith("aqam") and lk.own_channel_rows(link) == (ir is not None)
    # a ragged last tile: 100 symbols in tiles of 64 (at stride 1 every tile is sampled)
    chunk = 100
    assert chunk % lk.tile_for(chunk, link.tile_cap) != 0
    got = _chunk_stats(link, chunk, setup.cfg.snr_db, rows)
    _dense_papr_plane(monkeypatch, link)
    want = _chunk_stats(link, chunk, setup.cfg.snr_db, rows)
    assert got[:2] == want[:2] and got[0] > 0
    assert got[2] == pytest.approx(want[2], rel=IDFT_REL)
    assert got[3] == pytest.approx(want[3], rel=IDFT_REL)
    scale = float(max(want[4].abs().max(), want[5].abs().max()))
    for g, w in zip(got[4:], want[4:]):
        assert torch.allclose(g, w, rtol=IDFT_REL, atol=IDFT_REL * scale)


@pytest.mark.parametrize("case", ["300sc", "512sc_stride1", "300sc_power_normalize"])
def test_idft_papr_against_pallas_kernel(case):
    n = 512 if case.startswith("512") else 300
    extra = dict(papr_stride=1) if case == "512sc_stride1" else (_WF if case.endswith("normalize") else {})
    kw = _cfg(n, num_ofdm=256, **extra)
    chunk = 128
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    spec = pk._spec_for(jr, chunk, True)
    assert spec.conv == "diag" and not spec.txext
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.ones(n, jnp.float32))
    setup, link = _link(kw)
    assert lk.tile_for(chunk, link.tile_cap) == spec.tile
    z = np.zeros((chunk, n), np.int64)
    rows = torch.ones((1, n), dtype=torch.float32) if setup.cfg.apply_power_allocation else None
    acc, psum = lk.new_accumulators("cpu")
    lk.diag_chunk_plain(link, (0, 0), 0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=(z, z, z), rows=rows)
    be, se, peak = acc.tolist()
    assert (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    assert lk.papr_samples(link, chunk) == int(stats["papr_count"])
    # JAX runs the PAPR plane in one bf16 pass, the port in f32
    assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=2e-2)
    assert float(psum) == pytest.approx(float(stats["papr_sum"]), rel=2e-2)


@pytest.mark.parametrize("n,tile,slab", [(64, 8192, 1 << 17), (512, 2048, 1 << 17), (4096, 32, 16384)])
def test_onepass_slab_sizes(n, tile, slab):
    chunk = 1 << 17
    assert lk.onepass_slab(n, chunk, tile) == slab
    assert slab % tile == 0 and slab * n <= lk.ONEPASS_SLAB_BINS
    assert slab * n * lk.ONEPASS_BYTES_PER_BIN == {64: 83_886_080, 512: 671_088_640, 4096: 671_088_640}[n]
    # at any width and tile the kernels take (the tiles the diag budget
    # admits there, tile_cap), whole tiles under 1 GB
    for w, txext in ((lk.WARP_MAX_N, False), (4096, True), (lk.MAX_N, True)):
        for t in (t for t in lk.TILE_LADDER if t <= lk.tile_cap(w, w, 1, txext)):
            s = lk.onepass_slab(w, chunk, t)
            assert s % t == 0 and s * w * lk.ONEPASS_BYTES_PER_BIN < 1 << 30


def test_onepass_scratch_follows_normalize():
    _, plain = _link(_cfg(64, num_ofdm=1024))
    _, norm = _link(_cfg(64, num_ofdm=1024, **_WF))
    chunk = 1024
    assert all(t.numel() == 0 for t in lk.onepass_scratch(plain, chunk, "cpu"))
    er, ei, tx = lk.onepass_scratch(norm, chunk, "cpu")
    assert er.numel() == ei.numel() == tx.numel() == chunk * 64
    assert (er.dtype, ei.dtype, tx.dtype) == (torch.float32, torch.float32, torch.int16)
    work = lk.chunk_workspace(norm, chunk, "cpu")
    assert len(work) == 8 and work[5].numel() == chunk * 64
