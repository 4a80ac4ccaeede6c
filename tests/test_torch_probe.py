"""K3, the carry probe, and the chunks' carry-in: plain versions against the chunks and the JAX package.

* ``{fold,lr,mm}_probe_plain`` equal the plain chunk's carry row bit for
  bit, on each chain in qam, psk, aqam and apsk, with and without
  ``apply_power``, at sym0 = 0, > 0 and > 2^32; and a chunk given its own
  predecessor's tail (the probe of the one-symbol chunk before it; zeros
  at sym0 = 0) computes the same planes and counts as without it, while a
  foreign tail changes its first symbol's points.
* The plain probe against the JAX package's ``make_carry_probe`` in
  interpret mode (whose PRNG emits zero words) on zero words: within
  1e-5, f32 against the JAX kernel's three-pass bf16 product; lr's t, zero
  there, also on seeded words against the JAX package's float64 TailM.
* Diag links have no probe in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fold import _kw as fold_kw
from test_torch_lr import _kw as lr_kw
from test_torch_mm import _kw as mm_kw

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import mm_kernel as mmk
from ofdm_tpu_torch.ops import prng

CHUNK = 64
SYM0 = (0, 1000, (1 << 32) + 5)
_ADAPT = dict(adaptive_modulation_mode="CAPACITY_BASED", power_allocation_type="WATERFILLING", snr_db=20.0)
_PSK = dict(constellation_type="PSK", constellation_order=8)
MODES = {"qam": {}, "psk": _PSK, "aqam": _ADAPT, "apsk": dict(_ADAPT, **_PSK)}
_POWER = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True)
# chain: (base config, chunk, plain chunk, plain probe, planes)
CHAINS = {
    "fold": (fold_kw("ofdm_short_cp"), fk.fold_chunk_plain, fk.fold_probe_plain, fk.fold_planes),
    "lr": (lr_kw("d_cp034_mmse_noise"), lrk.lr_chunk_plain, lrk.lr_probe_plain, lrk.lr_planes),
    "mm": (mm_kw("c_zp034_mmse_noise"), mmk.mm_chunk_plain, mmk.mm_probe_plain, mmk.mm_planes),
}


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


def _runner(chain, kw):
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    assert runner.mode == chain
    rows = None
    if kw.get("apply_power_allocation"):
        rows = torch.tensor(np.sqrt(runner.point_params(kw["snr_db"])[0])[None], dtype=torch.float32)
    return runner.link, rows


def _chunk(plain, link, key, sym0, rows, prev=None, snr_db=20.0):
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = plain(link, key, sym0, CHUNK, lk.snr_linear(snr_db), acc, psum, rows=rows, prev=prev)
    return acc[:2].tolist(), cr, ci


@pytest.mark.parametrize("power", [False, True], ids=["plain", "apply_power"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("chain", list(CHAINS))
def test_probe_is_the_chunk_carry_and_its_tail_the_carry_in(monkeypatch, chain, mode, power):
    _route(monkeypatch, chain)
    base, plain, probe, planes = CHAINS[chain]
    kw = {**base, **MODES[mode], **(_POWER if power else {})}
    link, rows = _runner(chain, kw)
    assert link.q.mode == mode and link.apply_power == power
    key = prng.fold_in(7, 3)
    for sym0 in SYM0:
        counts, cr, ci = _chunk(plain, link, key, sym0, rows, snr_db=kw["snr_db"])
        pr, pi, tr, ti = probe(link, key, sym0, CHUNK, rows)
        assert torch.equal(pr, cr) and torch.equal(pi, ci)
        assert tr.shape == ti.shape == (link.E,) and link.E > 0
        if sym0 == 0:
            own = (torch.zeros(link.E), torch.zeros(link.E))
        else:
            own = probe(link, key, sym0 - 1, 1, rows)[2:]
        counts2, cr2, ci2 = _chunk(plain, link, key, sym0, rows, prev=own, snr_db=kw["snr_db"])
        assert counts2 == counts and torch.equal(cr2, cr) and torch.equal(ci2, ci)
        snr_lin = lk.snr_linear(kw["snr_db"])
        a = planes(link, key, sym0, CHUNK, snr_lin, "cpu", rows=rows)
        b = planes(link, key, sym0, CHUNK, snr_lin, "cpu", rows=rows, prev=own)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # a foreign tail reaches the first symbol's points
    foreign = probe(link, prng.fold_in(key, 1), 99, 1, rows)[2:]
    a = planes(link, key, SYM0[1], CHUNK, snr_lin, "cpu", rows=rows)
    b = planes(link, key, SYM0[1], CHUNK, snr_lin, "cpu", rows=rows, prev=foreign)
    assert not torch.equal(a[1][0], b[1][0])


def _jax_probe_row(kw):
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas",
                                                          matmul_passes=3)))
    jr._interpret = True
    probe = pk.make_carry_probe(jr, 1024, interpret=True)
    assert probe is not None
    pfn, pconsts = probe
    row = pfn(jax.random.PRNGKey(0), jnp.ones(kw["num_subcarriers"], jnp.float32), pconsts)
    return np.asarray(row.re), np.asarray(row.im)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_zero_word_probe_matches_pallas_probe(monkeypatch, chain):
    _route(monkeypatch, chain)
    base, _, probe, _ = CHAINS[chain]
    link, rows = _runner(chain, base)
    words = np.zeros((1, link.n), np.int64)
    pr, pi, _, _ = probe(link, (0, 0), 0, CHUNK, rows, words=words)
    jre, jim = _jax_probe_row(base)
    assert jre.shape == (link.T,)
    assert np.abs(pr.numpy() - jre).max() <= 1e-5 and np.abs(pi.numpy() - jim).max() <= 1e-5
    if chain != "lr":
        assert np.abs(jre).max() > 0.01  # zero words send a real row, not zeros
        return
    # lr: one point on every bin is an impulse at time 0, whose last E
    # samples (t) are zero in both packages; seeded words against the JAX
    # package's float64 TailM
    from ofdm_tpu.ops import lowrank as jlr

    js = jpl.prepare(jcfg.SimulationConfig(**base))
    jf = jlr.factor(np.asarray(js.taps), link.n, js.cfg.prefix_type, js.prefix_length, js.cfg.modulation_type)
    words = np.random.default_rng(4).integers(0, 1 << 32, (1, link.n), dtype=np.int64)
    _, _, tr, ti = probe(link, (0, 0), 0, CHUNK, rows, words=words)
    _, sr, si = lk.encode(torch.as_tensor(words), link.q)
    want = (sr.double().numpy() + 1j * si.double().numpy()) @ jf.tail
    assert np.abs(tr.numpy() - want.real).max() <= 1e-5 and np.abs(ti.numpy() - want.imag).max() <= 1e-5
    assert np.abs(want).max() > 0.01


def test_diag_has_no_probe():
    kw = dict(num_symbols=64 * 1024, num_subcarriers=64, constellation_order=16, channel_type="CUSTOM",
              channel_model="Lin-Phoong_P2", prefix_type="CYCLIC", prefix_length_ratio=1.0,
              equalization_method="MMSE", snr_db=20.0)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    assert pk.make_carry_probe(jr, 1024, interpret=True) is None
    runner = tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")
    assert runner.mode == "diag" and runner.kernel.probe is None
