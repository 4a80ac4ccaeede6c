"""The lr kernel's factor rows and group geometry.

* The rows ``lr_link`` lists for the kernel (``tail_rows``, ``cc_rows``,
  ``bh_rows``) on the bench cells, the 128-subcarrier short-CP and ZP 0.5
  links and a 64-tap ZP link, against the zero rows of the JAX package's
  own factors (``ofdm_tpu.ops.lowrank.factor``, rounded to f32).
* The plain chunk over the listed rows only is bit-identical to the plain
  chunk over all rows (counters, PAPR sum, carry row): the rows the kernel
  skips add +-0 to every sum.
* The link check refuses row lists the kernel's table cannot hold, and
  every tile an lr link can take holds whole runs of ``RUN`` symbols (a
  run lies in one tile).  lr_main's group layout and shared memory are the
  kernel's own (``lr_kernel.geometry``); ``chip_smoke.py`` checks them at
  every width on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import lowrank as jlr
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import lr_kernel as lrk
from ofdm_tpu_torch.ops import prng

# bench.py's wide_1024sc link and its variants (chip_smoke.py's LR_LINKS)
WIDE = dict(num_symbols=1024 * 64, num_subcarriers=1024, constellation_order=64, channel_type="CUSTOM",
            channel_model="severe_multipath", prefix_type="CYCLIC", prefix_length_ratio=1.0,
            equalization_method="MMSE", noise_type="AWGN", snr_db=30.0)
_128 = dict(WIDE, num_symbols=128 * 64, num_subcarriers=128, constellation_order=16, snr_db=20.0)
LINKS = {
    "wide_1024sc": (WIDE, None),
    "lr_1024sc_zp": (dict(WIDE, prefix_type="ZERO"), None),
    "zp05_128sc": (dict(_128, prefix_type="ZERO", prefix_length_ratio=0.5), None),
    "cp034_128sc": (dict(_128, prefix_length_ratio=0.34), None),
    "custom64_256sc_zp": (dict(WIDE, num_symbols=256 * 64, num_subcarriers=256, prefix_type="ZERO"), "custom64"),
}
# name: (TailM's nonzero rows, [Cr; Cp]'s nonzero rows, B^H's nonzero rows,
# the [Cr; Cp] rows the kernel reads): E = 7 on the severe_multipath links,
# 63 on the 64-tap one.  A zero prefix covering the channel has TailM = 0,
# so t = 0 and neither correction runs; ZP 0.5 leaves TailM rows 0-3, so
# Cp's rows 11-13 multiply zero lanes of t_prev.
R = lambda a, b: tuple(range(a, b))  # noqa: E731
EXPECTED = {
    "wide_1024sc": (R(0, 7), R(0, 7), (), R(0, 7)),
    "lr_1024sc_zp": ((), R(7, 14), R(0, 7), ()),
    "zp05_128sc": (R(0, 4), R(0, 4) + R(7, 14), R(0, 3), R(0, 4) + R(7, 11)),
    "cp034_128sc": (R(0, 7), R(0, 7) + R(9, 14), (), R(0, 7) + R(9, 14)),
    "custom64_256sc_zp": ((), R(63, 126), R(0, 63), ()),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_lr.py: counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _custom_64_taps():
    rng = np.random.default_rng(11)
    ir = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    return ir / np.linalg.norm(ir)


def _ir(name):
    return _custom_64_taps() if LINKS[name][1] else None


def _link(name, **kw):
    setup = tpl.prepare(tcfg.SimulationConfig(**{**LINKS[name][0], **kw}), channel_ir=_ir(name))
    assert tpl.kernel_mode(setup) == "lr"
    return lrk.lr_link(setup, "cpu")


def _nonzero(m):
    m = m.astype(np.complex64)
    return tuple(int(i) for i in np.flatnonzero((m != 0).any(axis=1)))


@pytest.mark.parametrize("name", list(LINKS))
def test_listed_rows_match_the_jax_factors(name):
    kw, _ = LINKS[name]
    js = jpl.prepare(jcfg.SimulationConfig(**kw), channel_ir=_ir(name))
    jf = jlr.factor(np.asarray(js.taps), js.cfg.num_subcarriers, js.cfg.prefix_type, js.prefix_length,
                    js.cfg.modulation_type)
    tail, cc, bh, read = EXPECTED[name]
    assert _nonzero(jf.tail.T) == tail
    assert _nonzero(np.concatenate([jf.cr, jf.cp])) == cc
    assert (() if jf.bnoise is None else _nonzero(jf.bnoise.conj().T)) == bh
    link = _link(name)
    assert (link.tail_rows, link.cc_rows, link.bh_rows) == (tail, read, bh)
    # the port's own f32 matrices hold nothing outside the listed rows
    assert lrk.nonzero_rows(link.tail_r, link.tail_i) == tail
    assert lrk.nonzero_rows(link.cc_r, link.cc_i) == cc
    if link.rank:
        assert lrk.nonzero_rows(link.bh_r, link.bh_i) == bh


def _listed_only(monkeypatch, link):
    """Make the plain chunk's products run over the listed rows only: t's
    unlisted lanes stay +0, [Cr; Cp] and B^H skip their unlisted rows (the
    listed ones in their order).  Returns the count of patched calls."""
    tails, cmatmul = lrk.tails, lk.cmatmul
    listed = {id(link.cc_r): list(link.cc_rows), id(link.bh_r): list(link.bh_rows)}
    calls = []

    def tails_listed(lnk, sr, si):
        calls.append("tails")
        rows = list(lnk.tail_rows)
        out_r = torch.zeros((sr.shape[0], lnk.E), dtype=torch.float32)
        out_i = torch.zeros_like(out_r)
        if rows:
            sub = dataclasses.replace(lnk, E=len(rows), tail_r=lnk.tail_r[rows], tail_i=lnk.tail_i[rows])
            out_r[:, rows], out_i[:, rows] = tails(sub, sr, si)
        return out_r, out_i

    def cmatmul_listed(fr, fi, sr, si):
        rows = listed.get(id(fr))
        if rows is None:
            return cmatmul(fr, fi, sr, si)
        calls.append("cmatmul")
        if not rows:
            zero = torch.zeros((sr.shape[0], fr.shape[1]), dtype=torch.float32)
            return zero, zero.clone()
        return cmatmul(fr[rows], fi[rows], sr[:, rows], si[:, rows])

    monkeypatch.setattr(lrk, "tails", tails_listed)
    monkeypatch.setattr(lk, "cmatmul", cmatmul_listed)
    return calls


def _bits(t):
    return t.contiguous().view(torch.int32)


def _chunk(link, sym0, chunk, snr_db, prev=None):
    acc, psum = lk.new_accumulators("cpu")
    cr, ci = lrk.lr_chunk_plain(link, prng.key_words(7), sym0, chunk, lk.snr_linear(snr_db), acc, psum,
                                prev=prev)
    return acc.clone(), psum.clone(), cr.clone(), ci.clone()


@pytest.mark.parametrize("name", list(LINKS))
def test_plain_chunk_over_listed_rows_is_bit_identical(monkeypatch, name):
    # 6 dB so every link counts errors; sym0 > 0 so the first symbol's
    # t_prev is recomputed; a ragged chunk
    link = _link(name, snr_db=6.0)
    full = _chunk(link, 1000, 24, 6.0)
    assert int(full[0][0]) > 0
    with monkeypatch.context() as m:
        calls = _listed_only(m, link)
        listed = _chunk(link, 1000, 24, 6.0)
    assert calls.count("tails") == 1 and calls.count("cmatmul") == 1 + (link.rank > 0)
    assert torch.equal(full[0], listed[0])
    assert torch.equal(full[1], listed[1])
    assert torch.equal(_bits(full[2]), _bits(listed[2])) and torch.equal(_bits(full[3]), _bits(listed[3]))


@pytest.mark.parametrize("name", ["wide_1024sc", "zp05_128sc"])
def test_plain_chunk_over_listed_rows_with_carry_in(monkeypatch, name):
    # the carry-in: a t of this link (the probe's), read by Cp's listed rows
    link = _link(name, snr_db=6.0)
    prev = tuple(t.clone() for t in lrk.lr_probe_plain(link, prng.key_words(7), 499, 1)[2:])
    full = _chunk(link, 500, 16, 6.0, prev)
    with monkeypatch.context() as m:
        calls = _listed_only(m, link)
        listed = _chunk(link, 500, 16, 6.0, prev)
    assert "tails" in calls and "cmatmul" in calls
    assert torch.equal(full[0], listed[0])
    assert torch.equal(_bits(full[2]), _bits(listed[2])) and torch.equal(_bits(full[3]), _bits(listed[3]))


def test_row_mask():
    # the kernel's row table: TailM's rows, each lane's place among them,
    # [Cr; Cp]'s rows with their t offsets (nt + place for Cr, place for
    # Cp), B^H's rows
    zp = _link("zp05_128sc")
    assert list(lrk.row_table(zp)) == [0, 1, 2, 3, 0, 1, 2, 3, -1, -1, -1, 0, 1, 2, 3, 7, 8, 9, 10,
                                       4, 5, 6, 7, 0, 1, 2, 3, 0, 1, 2]
    assert lrk.row_table(_link("lr_1024sc_zp")).tolist() == [-1] * 7 + list(range(7))


@pytest.mark.parametrize("field, rows", [("tail_rows", (3, 1)), ("cc_rows", (0, 14)), ("bh_rows", (2, 2))])
def test_check_link_refuses_bad_row_lists(field, rows):
    # unsorted, past [Cr; Cp]'s 2E = 14 rows, repeated
    link = _link("zp05_128sc")
    lrk._check_link(link, torch.device("cpu"))
    with pytest.raises(ValueError, match=field):
        lrk._check_link(dataclasses.replace(link, **{field: rows}), torch.device("cpu"))


@pytest.mark.parametrize("n", [64, 128, 512, 1024, 2048, 4096])
def test_tiles_hold_whole_runs(n):
    # lr_main's runs never straddle a tile, whatever tile the chunk takes
    assert all(t % lrk.RUN == 0 for t in lk.TILE_LADDER)
    for rank in (0, 7, 128, 159):
        for txext in (False, True):
            cap = lk.lr_tile_cap(n, n + 7, 7, rank, txext)
            for chunk in (1 << 17, 3 * 1000, 16, 40):
                assert lk.tile_for(chunk, cap) % lrk.RUN == 0
