"""The diag chain past 256 subcarriers (the plain version of diag_wide) against the JAX package.

* The plain diag chunk against the JAX package's diag kernel in interpret
  mode (whose PRNG emits zeros) at 300 and 512 subcarriers over an
  ISI-free link, and over a single-tap channel at 1024 subcarriers, where
  the PAPR statistic is external (txext): the same counts.
* The block order: past 256 subcarriers a symbol's MMSE mean and
  normalization energy are block sums over 256 threads (diag_layout).
* The tile rule past 256 sc: ``link_kernel.tile_cap`` against ``_spec_for``
  at 2^17 symbols, and ``diag_fits`` where the JAX plan refuses diag.
* Routing: the audit's ``OFDM-CY1.0-512`` and ``flat_fading_cp_1024sc``
  route to diag, as the JAX package's plan does.
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
from ofdm_tpu_torch.ops import link_kernel as lk

BASE = dict(num_subcarriers=512, constellation_order=64, channel_type="CUSTOM", channel_model="Lin-Phoong_P2",
            prefix_type="CYCLIC", prefix_length_ratio=1.0, equalization_method="MMSE", snr_db=20.0)
# the audit's base (tools/shape_audit.py): severe_multipath, 30 dB
AUDIT = dict(BASE, channel_model="severe_multipath", snr_db=30.0)
LINKS = {
    "isi_free_300sc": dict(num_subcarriers=300),
    "isi_free_512sc_zf": dict(equalization_method="ZF"),
    "flat_fading_1024sc": dict(num_subcarriers=1024, channel_model="flat_fading"),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(extra, num_ofdm=256):
    kw = {**BASE, **extra}
    kw["num_symbols"] = num_ofdm * kw["num_subcarriers"]
    return kw


def _jax_runner(kw, **extra):
    return jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas", **extra)))


def _setup(kw):
    return tpl.prepare(tcfg.SimulationConfig(**kw))


@pytest.mark.parametrize("name", list(LINKS))
def test_zero_words_match_pallas_diag_kernel(name):
    kw = _kw(LINKS[name])
    n, chunk = kw["num_subcarriers"], 256
    jr = _jax_runner(kw)
    spec = pk._spec_for(jr, chunk, True)
    assert spec.conv == "diag" and spec.txext == (n >= 512)
    fn = pk.make_pallas_chunk(jr, chunk, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]), jnp.ones(n, jnp.float32))
    setup = _setup(kw)
    assert tpl.kernel_mode(setup) == "diag"
    link = lk.diag_link(setup, "cpu")
    assert link.txext == spec.txext and lk.tile_for(chunk, link.tile_cap) == spec.tile
    z = np.zeros((chunk, n), np.int64)
    acc, psum = lk.new_accumulators("cpu")
    carry = lk.diag_chunk_plain(link, (0, 0), 0, chunk, lk.snr_linear(kw["snr_db"]), acc, psum, words=(z, z, z))
    be, se, peak = acc.tolist()
    assert be > 0 and (be, se) == (int(stats["bit_errors"]), int(stats["symbol_errors"]))
    assert lk.papr_samples(link, chunk) == int(stats["papr_count"])
    if link.txext:
        # no time plane in the chunk: no PAPR sample, a zero carry row
        assert (peak, float(psum)) == (0, 0.0) and not carry[0].any() and not carry[1].any()
    else:
        # JAX runs the PAPR plane in one bf16 pass, the port in f32
        assert lk.bits_f32(peak) == pytest.approx(float(stats["papr_peak"]), rel=2e-2)


def test_wide_sums_run_in_block_order():
    """Past 256 subcarriers the MMSE mean and the normalization energy are
    block_sum's over 256 threads: diag_planes equals the chain with those
    sums written out."""
    kw = _kw(dict(num_subcarriers=300, apply_power_allocation=True, normalize_before_demap=True), num_ofdm=64)
    link = lk.diag_link(_setup(kw), "cpu")
    assert lk.diag_layout(link.n) == (lk.WIDE_RUN, lk.WIDE_THREADS)
    rng = np.random.default_rng(4)
    words = [rng.integers(0, 1 << 32, size=(64, 300), dtype=np.uint64).astype(np.int64) for _ in range(3)]
    rows = torch.tensor(rng.uniform(0.5, 1.5, (1, 300)).astype(np.float32))
    snr_lin = lk.snr_linear(kw["snr_db"])
    tx, er, ei, sr, si = lk.diag_planes(link, (0, 0), 0, 64, snr_lin, "cpu", words, rows)
    planes = [torch.as_tensor(w) for w in words]
    yr, yi = sr * link.cr - si * link.ci, sr * link.ci + si * link.cr
    tile = lk.tile_for(64, link.tile_cap)
    groups = -(-min(link.slice, tile) * 300 // lk.POWER_BLOCK)
    yr, yi = lk.awgn(yr, yi, planes[1], planes[2], 64, tile, 1, groups, snr_lin, link.slice)
    nv = lk.block_sum(yr * yr + yi * yi, 256)[:, None]
    nv = nv / lk._f32(300, nv) / lk._f32(snr_lin, nv) / lk._f32(link.cg, nv)
    g = lk._f32(1.0, nv) / (link.habs2 + nv)
    wr, wi = (yr * link.hr + yi * link.hi) * g, (yi * link.hr - yr * link.hi) * g
    f = lk.tile_norm(wr, wi, 64, tile, lk.WIDE_RUN, 256)
    wr, wi = lk.normalize_points(link, wr, wi, f)
    assert torch.equal(er, wr) and torch.equal(ei, wi)


@pytest.mark.parametrize(
    "extra,tile",
    [
        (dict(num_subcarriers=300), 4096),
        (dict(num_subcarriers=512), 2048),
        (dict(num_subcarriers=1024, channel_model="flat_fading"), 1024),
        (dict(num_subcarriers=2048, channel_model="flat_fading"), 512),
        (dict(num_subcarriers=1024, channel_model="flat_fading", apply_power_allocation=True,
              power_allocation_type="WATERFILLING"), 1024),
        (dict(num_subcarriers=2048, channel_model="flat_fading", apply_power_allocation=True,
              power_allocation_type="WATERFILLING"), 256),
    ],
    ids=["isi_free_300sc", "isi_free_512sc", "flat_1024sc_txext", "flat_2048sc_txext", "flat_1024sc_power",
         "flat_2048sc_power"],
)
def test_tile_cap_matches_jax_spec(extra, tile):
    kw = _kw(extra, num_ofdm=1024)
    spec = pk._spec_for(_jax_runner(kw), 1 << 17, True)
    setup = _setup(kw)
    link = lk.diag_link(setup, "cpu")
    assert spec.conv == "diag" and link.txext == spec.txext
    assert tpl.kernel_mode(setup) == "diag"
    assert lk.tile_for(1 << 17, link.tile_cap) == spec.tile == tile


def test_diag_budget_refuses_what_jax_refuses():
    # a single-tap 4096-sc link with the power applied stages its (n, T) TX
    # matrix: past the JAX package's staged limit, so no fused kernel takes
    # it there and the port runs it eager; under txext it fits
    kw = _kw(dict(num_subcarriers=4096, channel_model="flat_fading", apply_power_allocation=True), num_ofdm=16)
    assert pk.plan_for(_jax_runner(kw)) is None
    assert not lk.diag_fits(4096, 4096, 1, False) and lk.diag_fits(4096, 4096, 1, True)
    assert tpl.kernel_mode(_setup(kw)) == "eager"
    kw = _kw(dict(num_subcarriers=4096, channel_model="flat_fading"), num_ofdm=16)
    assert pk.plan_for(_jax_runner(kw))[1] == "diag"
    assert tpl.kernel_mode(_setup(kw)) == "diag"


@pytest.mark.parametrize("name,extra,tile", [
    ("OFDM-CY1.0-512", dict(num_subcarriers=512), 2048),
    ("flat_fading_cp_1024sc", dict(num_subcarriers=1024, channel_model="flat_fading", snr_db=20.0), 1024),
])
def test_audit_shapes_route_to_diag(name, extra, tile):
    kw = dict(AUDIT, **extra, num_symbols=extra["num_subcarriers"] * (1 << 17), symbols_per_chunk=1 << 17)
    assert pk._spec_for(_jax_runner(kw), 1 << 17, True).tile == tile
    setup = _setup(kw)
    assert tpl.kernel_mode(setup) == "diag"
    runner = tpl.LinkRunner(setup, device="cpu")
    assert runner.mode == "diag" and runner.link.txext and lk.papr_samples(runner.link, 1 << 17) == 0
    assert lk.tile_for(1 << 17, runner.link.tile_cap) == tile
