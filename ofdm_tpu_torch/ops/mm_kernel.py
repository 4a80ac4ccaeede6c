"""The fused zero-prefix mm chunk: host constants, kernel wrapper and plain version.

Counterpart of ``ofdm_tpu/ops/pallas_link.py``'s ``kernel`` in conv="mm",
fold=False form (``csrc/mm_kernel.cu``), in each constellation mode
(``link_kernel.Codec``; on SC-FDE lane t's order demaps time sample t,
aqam's slicer row riding the time sample: ``link_kernel.sc_slicer``):
zero-prefix OFDM below 128 subcarriers, zero-prefix SC-FDE, single-tap
zero-prefix links, and zero-prefix OFDM whose lr factorization fails its
certification, at n <= 256 and T <= 320 (past them, the wide chain
below).  A zero prefix
does not fold the conv into the receiver, so the noise is added per time
sample and a symbol costs three complex products (four for SC-FDE).

A chunk, per OFDM symbol b (the semantics of pallas_link.py:1428-1937 in
its non-fold "mm" branches, not its lane-packed TPU layout): Philox words
-> encode s_b -> [x sqrt(P)] -> x_b = s_b @ F_tx,ext (E duplicated tail columns) ->
PAPR max and sum over x_b[:T] -> act = [x_b[:T] | x_{b-1}[T:T+E]] -> y =
act @ C (the merged conv, T+E -> T) -> AWGN per time sample with sigma =
sqrt(mp / snr_lin / 2), mp the mean |y|^2 over the whole tile (all its
tile * T samples, before noise) -> Y = y @ R (overlap-add + DFT, T -> n) ->
ZF / MMSE / none -> (SC-FDE) e @ IDFT -> [post-EQ noise, x 1/sqrt(P)]
-> [x the tile's unit-power factor] -> (aqam on SC-FDE without
normalize) x lane t's slicer row -> slicer -> popcount into int64
counters (``link_kernel``'s stages).  The noise of time sample j comes from counter (b, j, 0)
(``prng``).  The chunk returns its last symbol's x[:T], the JAX package's
carry contract.  The previous symbol's tail is recomputed from its Philox
words, so a chunk reads no carry: the run's symbol 0 sees zeros.  A
sharded contiguous stream passes ``prev``, the tail of the symbol before
the chunk's first, which another shard computed: the first symbol reads it.

``mm_probe`` is K3, the carry probe (pallas_link.py::_probe_fn_for_spec): a
chunk's carry row and tail, from its last symbol's Philox words alone,
through the chunk's own TX stage.

Past MAX_N subcarriers or MAX_T time samples (up to WIDE_MAX_T, wherever
the JAX package's dense budget admits the link: ``link_kernel.mm_fits``)
the chunk and the probe run the same semantics on the block-per-symbol
chain (``csrc/mm_wide_kernel.cu``; plain version ``mm_wide_chunk_plain``):
the TX block with its zero guard, the direct K-tap stream convolution,
the overlap-add r[i] = y[i] + y[n + i], the block DFT (``ops/dft.py``)
and the per-bin chain with its sums in a block of 256 threads' order, in
place of the dense products, which such a link does not build; its second
kernel recomputes y instead of reading a scratch plane.

``mm_chunk`` launches the kernels for CUDA tensors and runs
``mm_chunk_plain`` only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import ModulationType, PrefixType
from ofdm_tpu_torch.ops import dft, linops, prng, terms
from ofdm_tpu_torch.ops import link_kernel as lk

MAX_N = 256  # bins a lane of mm_main holds: up to 8
MAX_T = 320  # time samples a warp's group buffers hold
WIDE_MAX_T = 2048  # mm_wide holds up to 8 head samples a thread, each with its guard sample
# Consecutive symbols one warp of mm_front and mm_main walks (in groups of
# terms.group_of(J)).
RUN = 8
WIDE_RUN = 16  # consecutive symbols a block of mm_wide_main walks
WIDE_THREADS = 256  # mm_wide's block, one symbol


@dataclasses.dataclass(frozen=True)
class MmLink:
    """Everything the mm chunk reads: f32 matrices and rows on one device."""

    n: int
    T: int
    E: int  # previous-symbol tail lanes (linops.ext_width)
    q: lk.Codec
    slicer: float
    cg: float
    method: int
    add_noise: bool
    apply_power: bool
    normalize: bool
    is_sc: bool
    tile_cap: int
    pstride: int  # 1: every symbol feeds the PAPR statistic
    txr: Optional[torch.Tensor]  # (n, T+E) F_tx,ext; None on a wide link
    txi: Optional[torch.Tensor]
    cvr: Optional[torch.Tensor]  # (T+E, T) merged conv; None on a wide link
    cvi: Optional[torch.Tensor]
    rxr: Optional[torch.Tensor]  # (T, n) overlap-add + DFT; None on a wide link
    rxi: Optional[torch.Tensor]
    idr: Optional[torch.Tensor]  # (n, n) SC-FDE IDFT; None for OFDM and on a wide link
    idi: Optional[torch.Tensor]
    hr: torch.Tensor  # (n,)
    hi: torch.Tensor
    habs2: torch.Tensor
    gr: torch.Tensor  # ZF gain rows, slicer folded in
    gi: torch.Tensor
    # The wide chain's constants (link_kernel.wide_link_fields): the guard
    # offset T - n, the (K,) unit-energy taps, the block DFT plan.
    L: int
    tpr: torch.Tensor
    tpi: torch.Tensor
    plan: dft.DftPlan
    # The noise-bump study's stages (link_kernel.noise_bump_link): post-EQ
    # noise of sigma rows[2], then x rows[1] (1/sqrt(P)).
    post_noise: bool = False
    compensate: bool = False
    # The kernel's listed terms (ops/terms.py) of F_tx,ext, C, R and the SC-FDE
    # IDFT; None on a wide link (and the IDFT's for OFDM).
    tx_terms: Optional[terms.Terms] = None
    cv_terms: Optional[terms.Terms] = None
    rx_terms: Optional[terms.Terms] = None
    id_terms: Optional[terms.Terms] = None
    # What the wrappers derive from the link alone (link_kernel.link_cached):
    # a new link, dataclasses.replace's too, starts it empty.
    cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)


def mm_link(setup, device) -> MmLink:
    """Host constants of a zero-prefix mm link (pallas_link._consts_for,
    non-fold branch, unpacked): F_tx,ext, the merged conv, the overlap-add +
    DFT matrix, the SC-FDE IDFT and the equalizer rows, f32 on ``device``,
    with the kernel's listed terms of each matrix; past MAX_N subcarriers or
    MAX_T time samples only the wide chain's taps and DFT plan (no dense
    matrix), which every link carries."""
    cfg = setup.cfg
    if cfg.prefix_type != PrefixType.ZERO:
        raise ValueError("mm link: only zero-prefix links keep the conv apart from the receiver")
    n, L = cfg.num_subcarriers, setup.prefix_length
    T = n + L
    taps = np.asarray(setup.taps)
    E = linops.ext_width(len(taps), T)
    is_sc = cfg.modulation_type == ModulationType.SC_OFDM
    dense = dict.fromkeys(("txr", "txi", "cvr", "cvi", "rxr", "rxi", "idr", "idi"))
    if n <= MAX_N and T <= MAX_T:
        txr, txi = linops.tx_ext_matrix(linops.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type), E)
        cv = linops.conv_matrix_merged(taps, T)
        rxr, rxi = linops.rx_matrix(n, cfg.prefix_type, L)
        dense.update(txr=lk.f32_tensor(txr, device), txi=lk.f32_tensor(txi, device),
                     cvr=lk.f32_tensor(cv.real, device), cvi=lk.f32_tensor(cv.imag, device),
                     rxr=lk.f32_tensor(rxr, device), rxi=lk.f32_tensor(rxi, device))
        if is_sc:
            dr, di = linops.dft_matrix(n, inverse=True)
            dense.update(idr=lk.f32_tensor(dr, device), idi=lk.f32_tensor(di, device))
        dense.update({f"{m}_terms": terms.term_list(dense[f"{m}r"], dense[f"{m}i"], device)
                      for m in ("tx", "cv", "rx", "id") if dense[f"{m}r"] is not None})
    fields = lk.equalizer_fields(setup, device)
    del fields["slice"]  # the measured power covers the whole tile
    passes = lk.selected_passes(setup)
    tile_cap = lk.mm_tile_cap(n, T, E, is_sc, passes)
    if cfg.hotpath == "pallas" and not lk.mm_fits(n, T, E, is_sc, passes):
        # the JAX package's "taps" kernel: the same unfolded chain, at its tile
        tile_cap = lk.taps_tile(n, T, len(taps), is_sc, passes) or tile_cap
    return MmLink(
        T=T,
        E=E,
        tile_cap=tile_cap,
        pstride=1,
        **dense,
        **fields,
        **lk.wide_link_fields(setup, device),
    )


def is_wide(link: MmLink) -> bool:
    """Whether the link runs on the block-per-symbol chain (mm_wide)."""
    return link.n > MAX_N or link.T > MAX_T


def bins_class(n: int) -> int:
    """Bins a lane of mm_main, rounded up to a compiled width (2, 3, 4, 6, 8)."""
    J = -(-n // 32)
    return 2 if J <= 2 else J if J <= 4 else 6 if J <= 6 else 8


def layout(n: int, T: int, E: int) -> dict:
    """mm_front's and mm_main's layout at (n, T, E) as the launcher picks
    it (csrc/mm_kernel.cu): bins a lane J, symbols a group S, the warps a
    block (both kernels) and their dynamic shared memory a block (bytes).  A
    warp count of 0 means no block fits."""
    J = bins_class(n)
    wb = terms.group_bytes(J, n, T, E)
    w = terms.group_warps(wb)
    return {"J": J, "S": terms.group_of(J), "main_warps": w, "main_bytes": w * wb}


def _chunk_geometry(link: MmLink, chunk: int):
    tile = lk.tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    groups = -(-tile * link.T // lk.POWER_BLOCK)
    return tile, tiles, groups


def papr_samples(link: MmLink, chunk: int) -> int:
    """Time samples one chunk contributes to the PAPR statistic: all of them."""
    return chunk * link.T


# --- plain version of the chunk ----------------------------------------------


def mm_planes(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
              device, words=None, rows=None, prev=None):
    """(tx, er, ei, xr, xi): the chunk's TX indices (chunk, n), equalized points
    in slicer units (chunk, n) and TX rows x (chunk, T+E) — the plain chain
    up to the slicer, the stages included (``rows``: the chunk's per-lane
    rows).

    ``words`` = (raw, u1 word, u2 word) injects integer planes in place of
    the Philox draw, each (chunk, T) for sym0 == 0 or with ``prev``, else
    (chunk + 1, T) whose first row is symbol sym0 - 1: the raw word is read
    below column n (and on the first row), the noise words on the chunk's
    rows; with ``post_noise`` two more, the post-EQ draws' (u1 word, u2
    word), (chunk, n).  ``prev``: the (E,) tail pair the first symbol reads."""
    n, T = link.n, link.T
    rows = lk.stage_rows(link, rows, lk.rows_needed(link))
    tile, tiles, groups = _chunk_geometry(link, chunk)
    before = 1 if sym0 > 0 and prev is None else 0
    words, pwords = lk.split_words(link, words, 3, key, sym0, chunk, device)
    if words is None:
        words = prng.link_words(key, sym0 - before, chunk + before, T, device)
    raw, w1, w2 = (torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words)
    if not raw.shape == w1.shape == w2.shape == (chunk + before, T):
        raise ValueError(f"words must be ({chunk + before}, {T}) planes, got {tuple(raw.shape)}")
    tx, sr, si = lk.encode(raw[:, :n], link.q)
    if link.apply_power:
        sr, si = lk.scale_tx(sr, si, rows)
    xr, xi = lk.cmatmul(link.txr, link.txi, sr, si)
    if prev is not None:
        tail_r, tail_i = lk.plain_prev(prev, link.E, device)
    elif before:
        tail_r, tail_i = xr[:1, T:], xi[:1, T:]
        xr, xi, tx, w1, w2 = xr[1:], xi[1:], tx[1:], w1[1:], w2[1:]
    else:
        tail_r = tail_i = torch.zeros((1, link.E), dtype=torch.float32, device=device)
    act_r = torch.cat([xr[:, :T], torch.cat([tail_r, xr[:-1, T:]])], dim=1)
    act_i = torch.cat([xi[:, :T], torch.cat([tail_i, xi[:-1, T:]])], dim=1)
    yr, yi = lk.cmatmul(link.cvr, link.cvi, act_r, act_i)
    if link.add_noise:
        yr, yi = lk.awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, tile)
    fr, fi = lk.cmatmul(link.rxr, link.rxi, yr, yi)
    er, ei = lk.equalize(link, fr, fi, snr_lin)
    if link.is_sc:
        er, ei = lk.cmatmul(link.idr, link.idi, er, ei)
    er, ei = lk.bump_stages(link, er, ei, rows, pwords)
    er, ei = lk.sc_slicer(link, er, ei)
    if link.normalize:
        er, ei = lk.normalize_points(link, er, ei, lk.tile_norm(er, ei, chunk, tile, RUN))
    return tx, er, ei, xr, xi


def mm_chunk_plain(
    link: MmLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    words=None,
    rows=None,
    dump=None,
    prev=None,
):
    """Plain version of ``mm_chunk`` (same arguments, same effects);
    ``words`` as in ``mm_planes``; on a wide link ``mm_wide_chunk_plain``."""
    if is_wide(link):
        return mm_wide_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, words, rows, dump, prev)
    T = link.T
    tx, er, ei, xr, xi = mm_planes(link, key, sym0, chunk, snr_lin, acc.device, words, rows, prev)
    if dump is not None:
        lk.write_dump(link, dump, er, ei)
    lk.count_errors(link, tx, er, ei, acc)
    lk.add_papr(xr[:, :T], xi[:, :T], acc, psum)
    return xr[-1, :T].clone(), xi[-1, :T].clone()


def mm_probe_plain(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None, words=None):
    """Plain version of ``mm_probe``: the last symbol's x = s @ F_tx,ext as
    ``mm_planes`` computes it (``words``: its raw words injected, as
    ``link_kernel.probe_symbol_tx`` takes them); on a wide link
    ``mm_wide_probe_plain``."""
    if is_wide(link):
        return mm_wide_probe_plain(link, key, sym0, chunk, rows, words)
    T = link.T
    sr, si = lk.probe_symbol_tx(link, key, sym0 + chunk - 1, T, rows, link.txr.device, words)
    xr, xi = lk.cmatmul(link.txr, link.txi, sr, si)
    return xr[0, :T].clone(), xi[0, :T].clone(), xr[0, T:].clone(), xi[0, T:].clone()


# --- plain version of the wide chain (csrc/mm_wide_kernel.cu) ------------------


def mm_wide_planes(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                   device, words=None, rows=None, prev=None):
    """(tx, er, ei, xr, xi): ``mm_planes``' outputs (x (chunk, T)) as the
    block-per-symbol chain computes them: the TX block by copies or the
    block IDFT with its zero guard (``link_kernel.wide_tx``), the direct
    K-tap stream convolution over [previous tail | x] at all T samples
    (``link_kernel.stream_conv``), AWGN per time sample with the tile's
    full-plane measured power, the overlap-add r[i] = y[i] + y[n + i] (i <
    T - n), the block DFT, the per-bin chain with the MMSE mean and the
    normalization energy summed in a block of 256 threads' order, the
    SC-FDE block IDFT.  ``words`` and ``prev`` as in ``mm_planes``."""
    n, T = link.n, link.T
    rows = lk.stage_rows(link, rows, lk.rows_needed(link))
    tile, tiles, groups = _chunk_geometry(link, chunk)
    before = 1 if sym0 > 0 and prev is None else 0
    words, pwords = lk.split_words(link, words, 3, key, sym0, chunk, device)
    if words is None:
        words = prng.link_words(key, sym0 - before, chunk + before, T, device)
    raw, w1, w2 = (torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words)
    if not raw.shape == w1.shape == w2.shape == (chunk + before, T):
        raise ValueError(f"words must be ({chunk + before}, {T}) planes, got {tuple(raw.shape)}")
    tx, sr, si = lk.encode(raw[:, :n], link.q)
    if link.apply_power:
        sr, si = lk.scale_tx(sr, si, rows)
    xr, xi = lk.wide_tx(sr, si, T, link.is_sc, True, link.plan)
    tail, xr, xi = lk.wide_prev(link, xr, xi, prev, before, device)
    if before:
        tx, w1, w2 = tx[1:], w1[1:], w2[1:]
    zr, zi = lk.wide_stream(xr, xi, link.E, tail)
    yr, yi = lk.stream_conv(zr, zi, link.tpr, link.tpi, 0, T)
    if link.add_noise:
        yr, yi = lk.awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, tile)
    L = T - n
    rr = torch.cat([yr[:, :L] + yr[:, n:], yr[:, L:n]], dim=1)
    ri = torch.cat([yi[:, :L] + yi[:, n:], yi[:, L:n]], dim=1)
    fr, fi = dft.block_dft(rr, ri, link.plan)
    er, ei = lk.equalize(link, fr, fi, snr_lin, WIDE_THREADS)
    if link.is_sc:
        er, ei = dft.block_dft(er, ei, link.plan, inverse=True)
    er, ei = lk.bump_stages(link, er, ei, rows, pwords)
    er, ei = lk.sc_slicer(link, er, ei)
    if link.normalize:
        er, ei = lk.normalize_points(link, er, ei, lk.tile_norm(er, ei, chunk, tile, WIDE_RUN, WIDE_THREADS))
    return tx, er, ei, xr, xi


def mm_wide_chunk_plain(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                        acc: torch.Tensor, psum: torch.Tensor, words=None, rows=None, dump=None, prev=None):
    """Plain version of ``mm_chunk`` on the wide chain (any n and T; the
    chunk past MAX_N or MAX_T); ``words`` as in ``mm_planes``."""
    tx, er, ei, xr, xi = mm_wide_planes(link, key, sym0, chunk, snr_lin, acc.device, words, rows, prev)
    if dump is not None:
        lk.write_dump(link, dump, er, ei)
    lk.count_errors(link, tx, er, ei, acc)
    lk.add_papr(xr, xi, acc, psum)
    return xr[-1].clone(), xi[-1].clone()


def mm_wide_probe_plain(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None, words=None):
    """Plain version of ``mm_probe`` on the wide chain: the last symbol's TX
    block (``link_kernel.wide_tx``), its x[:T] and tail x[T-E:T]."""
    T = link.T
    sr, si = lk.probe_symbol_tx(link, key, sym0 + chunk - 1, T, rows, link.tpr.device, words)
    xr, xi = lk.wide_tx(sr, si, T, link.is_sc, True, link.plan)
    return xr[0].clone(), xi[0].clone(), xr[0, T - link.E :].clone(), xi[0, T - link.E :].clone()


# --- kernel wrapper -------------------------------------------------------------


def _check_wide_link(link: MmLink, device):
    n, T, K = link.n, link.T, link.E + 1
    shapes = {"tpr": (K,), "tpi": (K,), "hr": (n,), "hi": (n,), "habs2": (n,), "gr": (n,), "gi": (n,)}
    for name, shape in shapes.items():
        t = getattr(link, name)
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"link.{name} must be contiguous f32 {shape} on {device}")
    p = link.plan
    if p.n != n or p.twr.device != device or p.twi.device != device:
        raise ValueError(f"link.plan must be the {n}-point DFT plan on {device}")
    if not (1 <= n <= T <= WIDE_MAX_T and T == n + link.L and link.L <= n and 0 <= link.E <= T):
        raise ValueError(f"mm_wide takes n <= T <= {WIDE_MAX_T}, T - n <= n; got n={n}, T={T}")
    lk.check_codec(link.q, n, device)


def _check_link(link: MmLink, device):
    if is_wide(link):
        return _check_wide_link(link, device)
    n, T, TE = link.n, link.T, link.T + link.E
    shapes = {"txr": (n, TE), "txi": (n, TE), "cvr": (TE, T), "cvi": (TE, T), "rxr": (T, n), "rxi": (T, n),
              "hr": (n,), "hi": (n,), "habs2": (n,), "gr": (n,), "gi": (n,)}
    if link.is_sc:
        shapes.update(idr=(n, n), idi=(n, n))
    for name, shape in shapes.items():
        t = getattr(link, name)
        if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"link.{name} must be contiguous f32 on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"link.{name} must be {shape}, got {tuple(t.shape)}")
    listed = {"tx_terms": (n, TE), "cv_terms": (TE, T), "rx_terms": (T, n)} | (
        {"id_terms": (n, n)} if link.is_sc else {})
    for name, shape in listed.items():
        t = getattr(link, name)
        if t is None or t.p.device != device or t.idx.device != device or (t.rows, t.cols) != shape:
            raise ValueError(f"link.{name} must be the listed terms of a {shape} matrix on {device}")
    if not (1 <= n <= MAX_N and n <= T <= MAX_T and 0 <= link.E <= T):
        raise ValueError(f"mm kernel takes n <= {MAX_N}, n <= T <= {MAX_T}; got n={n}, T={T}")
    lk.check_codec(link.q, n, device)


GEOMETRY_KEYS = ("bins_a_lane", "group_symbols", "warps", "dynamic_smem_bytes", "registers", "local_bytes",
                 "static_smem_bytes", "blocks_an_sm", "front_warps", "front_dynamic_smem_bytes", "front_registers",
                 "front_local_bytes", "front_blocks_an_sm")


def geometry(n: int, T: int, E: int, library: str = "mm_kernel") -> dict:
    """mm_main's and mm_front's layout at (n, T, E), read from the loaded
    ``library`` (csrc/mm_kernel.cu::ofdm_mm_geometry, the qam entry points
    as a chunk without a dump launches them): bins a lane, symbols a group,
    and for each kernel its warps a block and dynamic shared memory a block
    and, from the loaded kernel, registers, local bytes a thread, static
    shared memory (mm_main) and resident blocks an SM.  Raises if the card
    cannot give a block that shared memory."""
    import ctypes

    from ofdm_tpu_torch import build

    lib = build.load(library)
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    build.check(lib, lib.ofdm_mm_geometry(n, T, E, out), "ofdm_mm_geometry")
    return dict(zip(GEOMETRY_KEYS, out))


def chunk_workspace(link: MmLink, chunk: int, device):
    """(y_r, y_i, partials, carry_r, carry_i, norm partials, norm factors):
    the scratch ``mm_chunk`` needs for chunks of ``chunk`` symbols, so that
    a run allocates it once.  y holds the chunk's time samples before
    noise, chunk * T of each plane; a wide link recomputes them and needs
    none (empty y planes)."""
    tile, tiles, groups = _chunk_geometry(link, chunk)
    f32 = dict(dtype=torch.float32, device=device)
    ys = 0 if is_wide(link) else chunk * link.T
    run = WIDE_RUN if is_wide(link) else RUN
    return (torch.empty(ys, **f32), torch.empty(ys, **f32),
            torch.empty(tiles * groups, **f32), torch.empty(link.T, **f32), torch.empty(link.T, **f32),
            *lk.norm_workspace(chunk, tile, run, device))


def mm_chunk(
    link: MmLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    work=None,
    rows=None,
    dump=None,
    prev=None,
):
    """One chunk of run symbols [sym0, sym0 + chunk): adds its bit errors,
    symbol errors and PAPR peak bits into ``acc`` and its PAPR power sum
    into ``psum``.  Returns the carry row (re, im): the last symbol's TX time
    row x[:T], written into ``work`` (a ``chunk_workspace``) when given.
    ``prev``: the (E,) tail pair the first symbol reads (the carry-in),
    instead of recomputing its predecessor's.
    ``rows``: the stages' per-lane rows (``link_kernel.stage_rows``).  ``dump``: the dump stage's
    planes (``link_kernel.new_dump``; counted in ``mm_chunk.dump_launches``).

    CUDA tensors launch the fused kernels (csrc/mm_kernel.cu, over the
    link's listed terms, their warps in groups of symbols: ``layout``):
    ``mm_front`` (TX, PAPR, conv, y before noise), with noise on
    ``mm_power`` (the tile power partials, from y), and then ``mm_main``
    (noise, RX, equalizer, slicer, counts; for a link with
    stages their OFDM_STAGED build, with the noise-bump stages their
    OFDM_BUMP build, ``mm_main`` under ``normalize`` twice
    around ``norm_factors``), counted in ``mm_chunk.front_launches``,
    ``.power_launches``, ``.launches`` and ``.norm_launches``.  Past MAX_N subcarriers or MAX_T
    time samples the block-per-symbol chain (csrc/mm_wide_kernel.cu, its
    staged and bump builds alike): ``mm_wide_front`` (the tiles' measured
    power) with noise on, then ``mm_wide_main``, which recomputes y,
    counted in ``.wide_front_launches`` and ``.wide_launches``.  CPU
    tensors run ``mm_chunk_plain``."""
    dev = acc.device
    if dev.type == "cpu":
        return mm_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows, dump=dump, prev=prev)
    if dev.type != "cuda":
        raise ValueError(f"mm_chunk runs on cpu or cuda, not {dev}")
    lk.check_accumulators(acc, psum)
    _check_link(link, dev)
    if not 1 <= chunk <= (2**31 - 1) // link.T:
        raise ValueError(f"chunk out of range: {chunk}")
    if dump is not None:
        lk.check_dump(dump, chunk, link.n, dev)
    prev_ptrs = lk.check_prev(prev, link.E, dev)
    tile, tiles, groups = _chunk_geometry(link, chunk)
    work = chunk_workspace(link, chunk, dev) if work is None else work
    wide = is_wide(link)
    ys = 0 if wide else chunk * link.T
    lk.check_work(work, (ys, ys, tiles * groups, link.T, link.T, -(-chunk // (WIDE_RUN if wide else RUN)), tiles),
                  f"chunk_workspace(link, {chunk}, {dev})")
    y_r, y_i, partials, carry_r, carry_i, norm_part, norm_f = work
    from ofdm_tpu_torch import build

    if wide:
        lib = build.load(lk.staged_library(link, dump, "mm_wide"))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.ofdm_mm_wide_chunk(
                link.tpr.data_ptr(), link.tpi.data_ptr(), link.plan.twr.data_ptr(), link.plan.twi.data_ptr(),
                link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(), link.gr.data_ptr(),
                link.gi.data_ptr(), *lk.wide_args(link), *lk.codec_args(link.q), link.slicer, snr_lin, link.cg,
                link.method, int(link.add_noise), int(link.is_sc), sym0, chunk, tile, tile, groups,
                WIDE_RUN, key[0], key[1], partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
                carry_r.data_ptr(), carry_i.data_ptr(), *lk.stage_args(link, rows, norm_part, norm_f, dump),
                *prev_ptrs, stream,
            )
        build.check(lib, code, "ofdm_mm_wide_chunk")
        mm_chunk.wide_front_launches += int(link.add_noise)
        mm_chunk.norm_launches += int(link.normalize)
        mm_chunk.dump_launches += int(dump is not None)
        mm_chunk.wide_launches += 1
        return carry_r, carry_i

    lib = build.load(lk.staged_library(link, dump, "mm"))
    sc = link.is_sc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ofdm_mm_chunk(
            *link.tx_terms.args(), *link.cv_terms.args(), *link.rx_terms.args(),
            *(link.id_terms.args() if sc else (None, None, 0)),
            link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(),
            link.gr.data_ptr(), link.gi.data_ptr(),
            link.n, link.T, link.E, *lk.codec_args(link.q), link.slicer, snr_lin, link.cg,
            link.method, int(link.add_noise), int(sc),
            sym0,
            chunk, tile, groups, RUN,
            key[0], key[1],
            y_r.data_ptr(), y_i.data_ptr(), partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
            carry_r.data_ptr(), carry_i.data_ptr(),
            *lk.stage_args(link, rows, norm_part, norm_f, dump), *prev_ptrs, stream,
        )
    build.check(lib, code, "ofdm_mm_chunk")
    mm_chunk.front_launches += 1
    mm_chunk.power_launches += int(link.add_noise)
    mm_chunk.norm_launches += int(link.normalize)
    mm_chunk.dump_launches += int(dump is not None)
    mm_chunk.launches += 1
    return carry_r, carry_i


def mm_probe(link: MmLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None):
    """K3: (carry_r, carry_i, tail_r, tail_i) of the chunk of run symbols
    [sym0, sym0 + chunk) without running it: its last symbol's x[:T] (the
    carry row ``mm_chunk`` returns, bitwise) and x[T:T+E] (the tail the
    next symbol reads).  CUDA links launch ``mm_probe`` (csrc/mm_kernel.cu;
    one block over the chunk's listed TX terms, in the library the chunk
    runs from; the link checked and its arguments built once,
    ``link_kernel.link_cached``), counted in ``mm_probe.launches``, a wide
    link ``mm_wide_probe`` (csrc/mm_wide_kernel.cu; one block), counted in
    ``mm_probe.wide_launches``; CPU links run ``mm_probe_plain``.  The four
    outputs are views of one new buffer a call."""
    dev = link.hr.device
    if dev.type == "cpu":
        return mm_probe_plain(link, key, sym0, chunk, rows)
    from ofdm_tpu_torch import build

    if is_wide(link):
        _check_link(link, dev)
        lib = build.load(lk.staged_library(link, None, "mm_wide"))
        out = lk.wide_probe_launch(lib, "ofdm_mm_wide_probe", link, key, sym0 + chunk - 1, rows, dev)
        mm_probe.wide_launches += 1
        return out

    def head():
        _check_link(link, dev)
        return build.load(lk.staged_library(link, None, "mm")), (*link.tx_terms.args(), *lk.probe_args(link))

    lib, args = lk.link_cached(link, "probe", head)
    out = lk.probe_launch(lib, "ofdm_mm_probe", link, args, key, sym0 + chunk - 1, rows, dev)
    mm_probe.launches += 1
    return out


mm_probe.launches = 0  # mm_probe kernels launched
mm_probe.wide_launches = 0  # mm_wide_probe kernels launched
mm_chunk.launches = 0  # mm_main kernels launched (the pass that counts errors)
mm_chunk.front_launches = 0  # mm_front kernels launched
mm_chunk.power_launches = 0  # mm_power kernels launched
mm_chunk.wide_launches = 0  # mm_wide_main kernels launched (the pass that counts errors)
mm_chunk.wide_front_launches = 0  # mm_wide_front kernels launched
mm_chunk.norm_launches = 0  # normalization passes (each with its norm_factors) launched
mm_chunk.dump_launches = 0  # counting passes that ran the dump stage
