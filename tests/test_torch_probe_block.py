"""K3's one-block probes (fold_probe, mm_probe) and K2's one-wave sampler (ofdm_boxmuller), on the CPU.

* The one-block probe's walk (``csrc/group_product.cuh::probe_block``):
  the n points encoded as the chunk encodes them, then each output column
  over the link's listed TX terms (``ops/terms.py::term_list``) in the
  chunk kernels' order, each term rounded in f32 before it is added
  (``terms.group_product_plain``, which ``test_torch_mm_fold_terms.py``
  holds bit-equal to ``cmatmul``), and as ``probe_column`` batches them
  (a segment's terms in groups of 4 and batches of 32, the slots past its
  trip a zero element times its last input: +-0 terms).  Both equal
  ``fold_probe_plain`` / ``mm_probe_plain`` bit for bit: on a fold link at every width fold
  instantiates (32-256 subcarriers, SC-FDE with a cyclic prefix and OFDM
  whose prefix is shorter than the channel), on mm links at 64 sc, 256-sc
  SC-FDE ZP (T = 259) and flat ZP (E = 0), in qam and aqam, with and
  without apply_power, at sym0 = 0 and > 2^32.
* ``probe_outputs``: the four outputs are views of one new buffer a call.
* ofdm_boxmuller's thread -> element mapping (``link_kernel.boxmuller_cover``:
  one wave, a quad of 4 elements a thread a step, the scalar tail) covers
  each index of [0, count) once, at a few grid sizes; a quad's counters are
  its elements' own.
* ``boxmuller_sample_plain`` evaluated quad by quad, in the kernel's order,
  equals its whole evaluation.

The JAX comparisons of the plain probe (``test_torch_probe.py``) and of the
Box-Muller chain (``test_torch_codec.py``) stay where they are.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import mm_kernel as mmk
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.ops import terms

CHUNK = 64
BATCH = 32  # matrix elements a probe thread loads at a time (group_product.cuh: kProbeBatch)
GROUP = 4  # terms a step outside the full batches
SYM0 = (0, (1 << 32) + 77)
_POWER = dict(power_allocation_type="WATERFILLING", apply_power_allocation=True, snr_db=20.0)
MODES = {"qam": _POWER, "aqam": dict(_POWER, adaptive_modulation_mode="CAPACITY_BASED")}
WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)
# name: (chain, SimulationConfig keywords without the mode)
LINKS = {
    **{f"fold_scfde_cp_{n}sc": ("fold", dict(cs.SCFDE_KW, num_subcarriers=n)) for n in WIDTHS},
    **{f"fold_ofdm_isi_cp_{n}sc": ("fold", dict(cs.SCFDE_KW, **cs._SHORT_CP, num_subcarriers=n)) for n in WIDTHS},
    **{f"mm_{name}": ("mm", dict(cs.HEADLINE_KW, prefix_type="ZERO", **cs.MM_LINKS[name]))
       for name in ("zp_64sc", "scfde_zp_256sc", "flat_zp_256sc")},
}
CHAINS = {"fold": (fk.fold_link, fk.fold_probe_plain), "mm": (mmk.mm_link, mmk.mm_probe_plain)}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # bitwise comparisons: one thread, as the port's other exact tests
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _link(name, mode):
    """The link with apply_power (its dense and listed matrices built
    directly: past 96 sc the OFDM links route to lr) and a seeded sqrt(P) row."""
    chain, kw = LINKS[name]
    kw = dict(kw, **MODES[mode])
    cfg = tcfg.SimulationConfig(**kw, num_symbols=kw["num_subcarriers"] * CHUNK, symbols_per_chunk=CHUNK)
    link = CHAINS[chain][0](tpl.prepare(cfg), "cpu")
    rng = np.random.default_rng(link.n)
    rows = torch.from_numpy(rng.uniform(0.25, 1.75, (1, link.n)).astype(np.float32))
    return link, rows


def _walk(link, points):
    """probe_block on the CPU for each (sr, si) of ``points`` (a symbol's
    encoded points, x sqrt(P) under apply_power): every column of x over the
    listed TX terms in the kernels' order (the symbols as a batch; each
    column's sum is a row's own)."""
    xr, xi = terms.group_product_plain(link.tx_terms, torch.cat([p[0] for p in points]),
                                       torch.cat([p[1] for p in points]))
    T = link.T
    return [(xr[b, :T], xi[b, :T], xr[b, T:], xi[b, T:]) for b in range(len(points))]


def _slots(trip, first):
    """The term slots probe_column runs for a segment of ``trip`` terms, in
    order: with ``first`` (a column's first segment, its first BATCH
    elements loaded ahead) groups of GROUP up to min(trip, BATCH), then full
    batches of BATCH, then groups of GROUP, the last group padded past trip."""
    up = lambda k: -(-k // GROUP) * GROUP  # noqa: E731
    i0 = BATCH if first else 0
    out = list(range(up(min(trip, BATCH)))) if first else []
    while i0 + BATCH <= trip:
        out += range(i0, i0 + BATCH)
        i0 += BATCH
    if i0 < trip:
        out += range(i0, up(trip))
    return out


def _batched_walk(link, points):
    """probe_column's walk on the CPU, term slot by term slot: a slot past
    its segment's trip multiplies a zero element by the segment's last input."""
    t = link.tx_terms
    sr, si = torch.cat([p[0] for p in points]), torch.cat([p[1] for p in points])
    acc = {}
    for j, trip, lo, el in t.segments():
        first = j not in acc
        xr, xi = acc.get(j, (torch.zeros((sr.shape[0], 32)), torch.zeros((sr.shape[0], 32))))
        lo_t = torch.as_tensor(lo.astype(np.int64))
        zero = torch.zeros(32)
        for i in _slots(trip, first):
            a, c = sr[:, lo_t + min(i, trip - 1)], si[:, lo_t + min(i, trip - 1)]
            w_r = torch.from_numpy(el[i].real.copy()) if i < trip else zero
            w_i = torch.from_numpy(el[i].imag.copy()) if i < trip else zero
            xr = xr + (a * w_r - c * w_i)
            xi = xi + (a * w_i + c * w_r)
        acc[j] = (xr, xi)
    outr = torch.zeros((sr.shape[0], 32 * t.chunks))
    outi = torch.zeros_like(outr)
    for j, (xr, xi) in acc.items():
        outr[:, 32 * j : 32 * j + 32], outi[:, 32 * j : 32 * j + 32] = xr, xi
    T = link.T
    return [(outr[b, :T], outi[b, :T], outr[b, T : t.cols], outi[b, T : t.cols]) for b in range(len(points))]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(LINKS))
def test_probe_walk_equals_the_plain_probe(name, mode):
    chain = LINKS[name][0]
    link, rows = _link(name, mode)
    assert link.q.mode == mode and link.apply_power and link.tx_terms.cols == link.T + link.E
    if name == "mm_flat_zp_256sc":
        assert link.E == 0
    if name == "mm_scfde_zp_256sc":
        assert link.T == 259
    plain = CHAINS[chain][1]
    key = prng.fold_in(11, 5)
    cases = [(dataclasses.replace(link, apply_power=False), None, sym0) for sym0 in SYM0]
    cases += [(link, rows, sym0) for sym0 in SYM0]
    points = [lk.probe_symbol_tx(lnk, key, sym0 + CHUNK - 1, lnk.n, r, "cpu") for lnk, r, sym0 in cases]
    for (lnk, r, sym0), got, batched in zip(cases, _walk(link, points), _batched_walk(link, points)):
        want = plain(lnk, key, sym0, CHUNK, r)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, mode, lnk.apply_power, sym0)
        assert all(torch.equal(a, b) for a, b in zip(batched, want)), (name, mode, lnk.apply_power, sym0)


def test_batched_slots():
    # a copy column; a segment inside the first batch; one past it; two full batches and a tail
    assert _slots(1, True) == [0, 1, 2, 3]
    assert _slots(30, True) == list(range(32))
    assert _slots(40, True) == list(range(40))
    assert _slots(70, True) == list(range(72))
    assert _slots(70, False) == list(range(72))
    assert _slots(5, False) == list(range(8))


def test_probe_outputs_are_views_of_one_new_buffer():
    a = lk.probe_outputs(67, 3, "cpu")
    b = lk.probe_outputs(67, 3, "cpu")
    assert [tuple(t.shape) for t in a] == [(67,), (67,), (3,), (3,)]
    base = a[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in a)
    assert [t.data_ptr() - base for t in a] == [0, 4 * 67, 8 * 67, 8 * 67 + 12]
    assert b[0].untyped_storage().data_ptr() != base
    for t in a:
        t.fill_(1.0)
    for t in b:
        t.fill_(2.0)
    assert all(bool((t == 1.0).all()) for t in a)


@pytest.mark.parametrize("count", [1, 3, 4, 5, 4194301, 4194304])
def test_boxmuller_cover_takes_each_element_once(count):
    # one block, a partial wave, the grid one wave of 4 and 8 blocks an SM gives
    for grid in (1, 7, lk.boxmuller_grid(count, 132 * 4), lk.boxmuller_grid(count, 132 * 8)):
        cover = lk.boxmuller_cover(count, grid)
        assert cover.size == count
        assert (np.bincount(cover, minlength=count) == 1).all()
    assert lk.boxmuller_grid(count, 528) == max(1, min(528, -(-(count // 4) // 256)))


def test_boxmuller_quad_counters_are_the_elements():
    # the kernel forms a quad's counters from its first index: (lo + e, hi)
    for first in (0, 4, (1 << 32) - 4, 1 << 32, (1 << 34) + 8):
        i = np.arange(first, first + lk.BOXMULLER_STEP, dtype=np.uint64)
        lo = (np.uint64(first) & np.uint64(0xFFFFFFFF)) + np.arange(lk.BOXMULLER_STEP, dtype=np.uint64)
        hi = np.full(lk.BOXMULLER_STEP, np.uint64(first) >> np.uint64(32))
        assert (lo == (i & np.uint64(0xFFFFFFFF))).all() and (hi == (i >> np.uint64(32))).all()


def test_boxmuller_plain_by_quads_equals_whole():
    count = 4 * 300 + 3
    z0, z1 = lk.boxmuller_sample_plain(987654321, 123456789, (count,))
    cover = lk.boxmuller_cover(count, 1)
    q0, q1 = torch.empty(count), torch.empty(count)
    quads = count // lk.BOXMULLER_STEP
    steps = [cover[s : s + 4] for s in range(0, 4 * quads, 4)] + [cover[4 * quads + t : 4 * quads + t + 1]
                                                                   for t in range(count - 4 * quads)]
    for idx in steps:
        i = torch.from_numpy(idx.astype(np.int64))
        q0[i], q1[i] = lk.boxmuller_elements(987654321, 123456789, i)
    assert torch.equal(q0, z0) and torch.equal(q1, z1)
