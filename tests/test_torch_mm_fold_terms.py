"""The fold and mm kernels' listed terms, grouped products and layout.

* The listed terms ``fold_link`` / ``mm_link`` pack for the kernels
  (``ops/terms.py``) describe the port's matrices exactly, and their
  nonzero elements are those of the JAX package's own matrices (rounded to
  f32), on every link of ``chip_smoke.py``'s ``FOLD_LINKS`` and
  ``MM_LINKS`` (64-256 subcarriers; cyclic, zero and no prefix; OFDM and
  SC-FDE).
* The grouped product over the listed terms, in the kernels' order
  (``terms.group_product_plain``), equals ``link_kernel.cmatmul`` bit for
  bit on seeded inputs that hold +-0 (a row scaled by a zero sqrt(P),
  exact PSK zeros, zero words' points), so the kernels' products keep the
  plain versions' bits.
* Every width the parent's kernels admitted fits the new layout's shared
  memory (227 KB a block) with at least one warp a block, in every build
  (the plain, staged and noise-bump builds share the layout); the card's
  own readout is ``chip_smoke.py``'s.
* ``kernel_mode`` routes these links, the published campaign's cells and
  the adaptive SC-FDE links as before.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import dft as jdft
from ofdm_tpu.ops import linops as jl
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import mm_kernel as mmk
from ofdm_tpu_torch.ops import terms


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # bitwise comparisons: one thread, as the port's other exact tests
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(chain, name):
    if chain == "fold":
        kw = dict(cs.SCFDE_KW, **cs.FOLD_LINKS[name])
    else:
        kw = dict(cs.HEADLINE_KW, prefix_type="ZERO", **cs.MM_LINKS[name])
    return dict(kw, num_symbols=kw["num_subcarriers"] * 64, symbols_per_chunk=64)


LINKS = [("fold", n) for n in cs.FOLD_LINKS] + [("mm", n) for n in cs.MM_LINKS]
# the matrices of each chain, (field, JAX builder of the complex matrix)
MATS = {"fold": ("tx", "cm", "id"), "mm": ("tx", "cv", "rx", "id")}


def _link(chain, name):
    setup = tpl.prepare(tcfg.SimulationConfig(**_kw(chain, name)))
    return (fk.fold_link if chain == "fold" else mmk.mm_link)(setup, "cpu")


def _jax_mats(chain, name):
    """{field: complex128 matrix} from the JAX package's own builders."""
    js = jpl.prepare(jcfg.SimulationConfig(**_kw(chain, name)))
    cfg, taps, L = js.cfg, np.asarray(js.taps), js.prefix_length
    n = cfg.num_subcarriers
    fr, fi = jl.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    T = fr.shape[1]
    E = jl.ext_width(len(taps), T)
    tx = fr + 1j * fi
    out = {"tx": np.concatenate([tx, tx[:, T - E :]], axis=1)}
    if chain == "fold":
        out["cm"] = jl.conv_rx_merged(taps, n, cfg.prefix_type, L)
    else:
        rr, ri = jl.rx_matrix(n, cfg.prefix_type, L)
        out.update(cv=jl.conv_matrix_merged(taps, T), rx=rr + 1j * ri)
    if cfg.modulation_type.value == "SC-OFDM":
        dr, di = jdft.dft_matrix(n, inverse=True)
        out["id"] = dr + 1j * di
    return out


@pytest.mark.parametrize("chain, name", LINKS)
def test_term_lists_match_the_matrices(chain, name):
    link = _link(chain, name)
    jax = _jax_mats(chain, name)
    assert link.id_terms is None if not link.is_sc else link.id_terms is not None
    for m in MATS[chain]:
        t = getattr(link, f"{m}_terms")
        if m == "id" and not link.is_sc:
            continue
        mr, mi = getattr(link, f"{m}r"), getattr(link, f"{m}i")
        dr, di = terms.dense(t)
        assert torch.equal(dr, mr) and torch.equal(di, mi), m
        j = jax[m].astype(np.complex64)
        assert ((j.real != 0) | (j.imag != 0)).tolist() == ((mr != 0) | (mi != 0)).tolist(), m
        np.testing.assert_allclose(mr.numpy(), j.real, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mi.numpy(), j.imag, rtol=1e-6, atol=1e-7)
        assert t.nonzero == int(((mr != 0) | (mi != 0)).sum())
        # the kernel's argument checks: a chunk a 32 output columns
        assert t.chunks == -(-t.cols // 32) and tuple(t.args())[2] == t.chunks


def _inputs(rows, batch=7, seed=0):
    """Seeded (batch, rows) f32 inputs holding +-0: a row scaled by a zero
    sqrt(P) (its signs kept), exact PSK zeros and the points of zero words."""
    rng = np.random.default_rng(seed)
    sr = torch.tensor(rng.standard_normal((batch, rows)), dtype=torch.float32)
    si = torch.tensor(rng.standard_normal((batch, rows)), dtype=torch.float32)
    sr[0] = sr[0] * 0.0
    si[0] = si[0] * 0.0
    psk = lk.Codec(mode="psk", order=8, m=8, logm=3, bits=3, gray=1, scale=1.0)
    _, pr, pi = lk.encode(torch.tensor(rng.integers(0, 8, (2, rows)), dtype=torch.int64), psk)
    sr[1:3], si[1:3] = pr, pi
    qam = lk.Codec(mode="qam", order=16, m=4, logm=2, bits=4, gray=1, scale=float(1 / np.sqrt(10)))
    _, qr, qi = lk.encode(torch.zeros((1, rows), dtype=torch.int64), qam)
    sr[3], si[3] = qr[0], qi[0]
    sr[4, ::3] = -0.0
    si[4, 1::3] = -0.0
    return sr, si


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("chain, name", LINKS)
def test_grouped_product_is_cmatmul_bit_for_bit(chain, name):
    link = _link(chain, name)
    for k, m in enumerate(MATS[chain]):
        t = getattr(link, f"{m}_terms")
        if t is None:
            continue
        sr, si = _inputs(t.rows, seed=k)
        assert bool(((sr == 0) & torch.signbit(sr)).any()) and bool(((si == 0) & ~torch.signbit(si)).any())
        gr, gi = terms.group_product_plain(t, sr, si)
        pr, pi = lk.cmatmul(getattr(link, f"{m}r"), getattr(link, f"{m}i"), sr, si)
        assert torch.equal(_bits(gr), _bits(pr)) and torch.equal(_bits(gi), _bits(pi)), m


def test_headline_cells_skip_the_zero_and_copy_terms():
    # scfde_default: F_tx,ext only copies (one term a column, 1 + 0i);
    # zp_64sc: the zero guard has no terms, C runs its 4-tap band (and its
    # tail rows apart) instead of all 70 rows
    fold = _link("fold", "scfde_default")
    assert fold.tx_terms.nonzero == fold.T + fold.E
    assert all(trip == 1 for _, trip, _, _ in fold.tx_terms.segments())
    assert all(np.all(el[el != 0] == 1) for _, _, _, el in fold.tx_terms.segments())
    mm = _link("mm", "zp_64sc")
    assert (mm.n, mm.T, mm.E) == (64, 67, 3)
    assert [j for j, _, _, _ in mm.tx_terms.segments()] == [0, 1]  # columns 64-69 are guard
    assert [trip for _, trip, _, _ in mm.cv_terms.segments()] == [4, 3, 4, 4]
    assert (mm.tx_terms.nonzero, mm.cv_terms.nonzero, mm.rx_terms.nonzero) == (4096, 268, 4288)
    assert terms.lane_terms(mm.cv_terms) == 32 * 15


def test_term_list_clusters_and_empty_columns():
    # column 0: rows 0-1 and, past a gap of 16 zero rows, rows 18-19 (two
    # segments); column 1: rows 3-5 (one cluster, the gap of 1 inside it);
    # column 2: none; column 3: a copy of row 39 (its window ends at row 39)
    m = np.zeros((40, 4), np.complex64)
    m[[0, 1, 18, 19], 0] = [1 + 1j, 2, -3j, 4]
    m[[3, 5], 1] = [5, 6 - 1j]
    m[39, 3] = 1.0
    t = terms.term_list(torch.tensor(m.real), torch.tensor(m.imag), "cpu")
    segs = t.segments()
    assert [(j, trip) for j, trip, _, _ in segs] == [(0, 3), (0, 2)]
    assert list(segs[0][2][:4]) == [0, 3, 0, 37] and segs[1][2][0] == 18
    # the kernels load AHEAD rows past a segment's last term: zero rows end the array
    assert t.p.numel() == 2 * terms.LANES * (3 + 2 + terms.AHEAD) and not t.p[-2 * terms.LANES * terms.AHEAD :].any()
    dr, di = terms.dense(t)
    assert torch.equal(dr, torch.tensor(m.real)) and torch.equal(di, torch.tensor(m.imag))
    sr, si = _inputs(40, seed=5)
    gr, gi = terms.group_product_plain(t, sr, si)
    pr, pi = lk.cmatmul(torch.tensor(m.real), torch.tensor(m.imag), sr, si)
    assert torch.equal(_bits(gr), _bits(pr)) and torch.equal(_bits(gi), _bits(pi))
    assert torch.equal(_bits(gr[:, 2]), _bits(torch.zeros(7)))


def _parent_fold_fits(n, T, E):
    # the parent's fold_power: 16 KB of |y|^2 and 8 warps of 2 (n + T + 2E) floats
    return 4 * (4096 + 8 * 2 * (n + T + 2 * E)) <= 227 * 1024


def _edges(n, T_max, fits):
    """(T, E) at the edges of what a check admits at width n."""
    out = []
    for T in sorted({n, 2 * n, T_max}):
        if T < n or not fits(n, T, 0):
            continue
        E_max = max(e for e in range(0, T + 1, max(1, T // 64)) if fits(n, T, e))
        out += [(T, 0), (T, E_max)]
    return out


@pytest.mark.parametrize("chain", ["fold", "mm"])
def test_every_parent_width_fits_the_layout(chain):
    for n in range(1, 257):
        if chain == "fold":
            T_max = max(T for T in range(n, 4 * 3376) if _parent_fold_fits(n, T, 0))
            cases = _edges(n, T_max, _parent_fold_fits)
        else:
            cases = [(T, E) for T in sorted({n, min(2 * n, mmk.MAX_T), mmk.MAX_T}) if T >= n for E in (0, T)]
        for T, E in cases:
            g = (fk if chain == "fold" else mmk).layout(n, T, E)
            assert g["main_warps"] >= 1 and g["main_bytes"] <= terms.MAX_BLOCK_SMEM, (n, T, E, g)
            if chain == "fold":
                assert g["power_warps"] >= 1 and g["power_bytes"] <= terms.MAX_BLOCK_SMEM, (n, T, E, g)
            # the headline widths keep a full block of 8 warps
            if T <= 2 * n and E <= T and n + T + 2 * E <= 1216:
                assert g["main_warps"] == 8, (n, T, E, g)


def test_widths_and_groups():
    assert [mmk.bins_class(n) for n in (1, 64, 65, 96, 97, 128, 129, 192, 193, 256)] == [2, 2, 3, 3, 4, 4, 6, 6, 8, 8]
    assert [terms.group_of(j) for j in range(1, 9)] == [4, 4, 2, 2, 2, 2, 2, 2]
    g = fk.layout(64, 67, 3)
    assert (g["J"], g["S"], g["main_warps"], g["main_bytes"], g["power_bytes"]) == (2, 4, 8, 34560, 50944)
    assert mmk.layout(64, 67, 3)["main_bytes"] == 34560


def test_links_route_as_before():
    for name in cs.FOLD_LINKS:
        assert tpl.kernel_mode(tpl.prepare(tcfg.SimulationConfig(**_kw("fold", name)))) == "fold", name
    for name in cs.MM_LINKS:
        assert tpl.kernel_mode(tpl.prepare(tcfg.SimulationConfig(**_kw("mm", name)))) == "mm", name
    # the published campaign (CP / ZP x ZF / MMSE x guard 0.34-1.34 at 64 sc):
    # ZP on mm, a CP shorter than the channel on fold, the rest on diag
    for (prefix, eq, ratio) in cs.CAMPAIGN:
        setup = tpl.prepare(cs.headline_cfg(64, 64, prefix_type=prefix, prefix_length_ratio=ratio,
                                            equalization_method=eq))
        want = "mm" if prefix == "ZERO" else ("fold" if ratio < 1.0 else "diag")
        assert tpl.kernel_mode(setup) == want, (prefix, eq, ratio)
    for name, (chain, kw) in cs.ASC_LINKS.items():
        assert tpl.kernel_mode(tpl.prepare(cs.asc_cfg(20.0, 64, 64, **kw))) == chain, name
