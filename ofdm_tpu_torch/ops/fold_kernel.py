"""The fused fold-mode chunk: kernel wrapper and plain version.

Counterpart of ``ofdm_tpu/ops/pallas_link.py``'s ``kernel`` in conv="mm",
fold=True form (``csrc/fold_kernel.cu``), in each constellation mode
(``link_kernel.Codec``; on SC-FDE lane t's order demaps time sample t,
aqam's slicer row riding the time sample: ``link_kernel.sc_slicer``):
SC-FDE with a cyclic prefix or none, and OFDM whose guard is shorter than
the channel order.
The conv folds into the guard strip + DFT, so a symbol costs two complex
products (three for SC-FDE) and the noise is added per frequency bin.

A chunk, per OFDM symbol b (the semantics of pallas_link.py:1428-1937 in
its fold branches, not its lane-packed TPU layout): Philox words -> encode
s_b -> [x sqrt(P)] -> x_b = s_b @ F_tx,ext (E duplicated tail columns) ->
PAPR max and sum over x_b[:T] -> act = [x_b[:T] | x_{b-1}[T:T+E]] -> y =
act @ CM -> AWGN with the diag chunk's per-tile measured power -> ZF /
MMSE / none -> (SC-FDE) e @ IDFT -> [post-EQ noise, x 1/sqrt(P), per
time sample on SC-FDE] -> [x the tile's unit-power factor, in the time
domain on SC-FDE as chunk_body's normalize] -> (aqam on SC-FDE without
normalize) x lane t's slicer row -> slicer ->
popcount into int64 counters (``link_kernel``'s stages).  The
chunk returns its last symbol's x[:T], the JAX package's carry contract.
The previous symbol's tail is recomputed from its Philox words, so a chunk
reads no carry: the run's symbol 0 sees zeros (the JAX runner's zero
initial carry), every other symbol its predecessor's tail.  A sharded
contiguous stream passes ``prev``, the tail of the symbol before the
chunk's first, which another shard computed: the first symbol reads it.

``fold_probe`` is K3, the carry probe (pallas_link.py::_probe_fn_for_spec):
a chunk's carry row and tail, from its last symbol's Philox words alone,
through the chunk's own TX stage.

Past MAX_N subcarriers (up to WIDE_MAX_N, wherever the JAX package's dense
budget admits the link: ``link_kernel.fold_fits``) the chunk and the probe
run the same semantics on the block-per-symbol chain
(``csrc/fold_wide_kernel.cu``; plain version ``fold_wide_chunk_plain``):
the TX block by copies or the block IDFT, the direct K-tap stream
convolution, the block DFT (``ops/dft.py``) and the per-bin chain with
its sums in a block of 256 threads' order, in place of the dense
products, which such a link does not build.

``fold_chunk`` launches the kernel for CUDA tensors and runs
``fold_chunk_plain`` only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import ModulationType, PrefixType
from ofdm_tpu_torch.ops import dft, linops, prng, terms
from ofdm_tpu_torch.ops import link_kernel as lk

MAX_N = 256  # the kernel's layout holds up to 8 bins a lane
WIDE_MAX_N = 2048  # fold_wide's block-per-symbol layout holds up to 8 bins a thread
# Consecutive symbols one warp of fold_main walks (in groups of
# terms.group_of(J)); it recomputes the tail of the symbol before its
# first, so one tail in RUN is extra work.
RUN = 8
POWER_FIXED = 4 * lk.POWER_BLOCK  # fold_power's |y|^2 block beside its warps' buffers
WIDE_RUN = 16  # consecutive symbols a block of fold_wide_main walks
WIDE_THREADS = 256  # fold_wide's block, one symbol


@dataclasses.dataclass(frozen=True)
class FoldLink:
    """Everything the fold chunk reads: f32 matrices and rows on one device."""

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
    slice: int
    txr: Optional[torch.Tensor]  # (n, T+E) F_tx,ext; None past MAX_N
    txi: Optional[torch.Tensor]
    cmr: Optional[torch.Tensor]  # (T+E, n) conv + guard strip + DFT; None past MAX_N
    cmi: Optional[torch.Tensor]
    idr: Optional[torch.Tensor]  # (n, n) SC-FDE IDFT; None for OFDM and past MAX_N
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
    # The kernel's listed terms (ops/terms.py) of F_tx,ext, CM and the SC-FDE
    # IDFT; None past MAX_N (and the IDFT's for OFDM).
    tx_terms: Optional[terms.Terms] = None
    cm_terms: Optional[terms.Terms] = None
    id_terms: Optional[terms.Terms] = None
    # What the wrappers derive from the link alone (link_kernel.link_cached):
    # a new link, dataclasses.replace's too, starts it empty.
    cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)


def fold_link(setup, device) -> FoldLink:
    """Host constants of a fold link (pallas_link._consts_for, fold branch,
    unpacked): F_tx,ext, the merged conv+RX matrix, the SC-FDE IDFT and the
    equalizer rows, f32 on ``device``, with the kernel's listed terms of each
    matrix; past MAX_N subcarriers only the wide chain's taps and DFT plan
    (no dense matrix), which every link carries."""
    cfg = setup.cfg
    if cfg.prefix_type == PrefixType.ZERO:
        raise ValueError("fold link: zero-prefix links do not fold the conv into RX")
    n, L = cfg.num_subcarriers, setup.prefix_length
    T = n + L
    taps = np.asarray(setup.taps)
    E = linops.ext_width(len(taps), T)
    is_sc = cfg.modulation_type == ModulationType.SC_OFDM
    dense = dict.fromkeys(("txr", "txi", "cmr", "cmi", "idr", "idi"))
    if n <= MAX_N:
        txr, txi = linops.tx_ext_matrix(linops.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type), E)
        cm = linops.conv_rx_merged(taps, n, cfg.prefix_type, L)
        dense.update(txr=lk.f32_tensor(txr, device), txi=lk.f32_tensor(txi, device),
                     cmr=lk.f32_tensor(cm.real, device), cmi=lk.f32_tensor(cm.imag, device))
        if is_sc:
            dr, di = linops.dft_matrix(n, inverse=True)
            dense.update(idr=lk.f32_tensor(dr, device), idi=lk.f32_tensor(di, device))
        dense.update({f"{m}_terms": terms.term_list(dense[f"{m}r"], dense[f"{m}i"], device)
                      for m in ("tx", "cm", "id") if dense[f"{m}r"] is not None})
    return FoldLink(
        T=T,
        E=E,
        tile_cap=lk.fold_tile_cap(n, T, E, is_sc, lk.selected_passes(setup)),
        **dense,
        **lk.equalizer_fields(setup, device),
        **lk.wide_link_fields(setup, device),
    )


def is_wide(link: FoldLink) -> bool:
    """Whether the link runs on the block-per-symbol chain (fold_wide)."""
    return link.n > MAX_N


def layout(n: int, T: int, E: int) -> dict:
    """fold_main's and fold_power's layout at (n, T, E) as the launcher
    picks it (csrc/fold_kernel.cu): bins a lane J, symbols a group S, the
    warps a block of each kernel and their dynamic shared memory a block
    (bytes).  A warp count of 0 means no block fits."""
    J = -(-n // 32)
    wb = terms.group_bytes(J, n, T, E)
    mw, pw = terms.group_warps(wb), terms.group_warps(wb, POWER_FIXED)
    return {"J": J, "S": terms.group_of(J), "main_warps": mw, "main_bytes": mw * wb, "power_warps": pw,
            "power_bytes": POWER_FIXED + pw * wb}


def _chunk_geometry(link: FoldLink, chunk: int):
    tile = lk.tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    groups = -(-min(link.slice, tile) * link.n // lk.POWER_BLOCK)
    return tile, tiles, groups


def papr_samples(link: FoldLink, chunk: int) -> int:
    """Time samples one chunk contributes to the PAPR statistic: all of them."""
    return chunk * link.T


# --- plain version of the chunk ----------------------------------------------


def fold_planes(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                device, words=None, rows=None, prev=None):
    """(tx, er, ei, xr, xi): the chunk's TX indices (chunk, n), equalized points
    in slicer units (chunk, n) and TX rows x (chunk, T+E) — the plain chain
    up to the slicer, the stages included (``rows``: the chunk's per-lane
    rows).

    ``words`` = (raw, u1 word, u2 word) injects integer planes in place of
    the Philox draw: (chunk, n) for sym0 == 0 or with ``prev``, else
    (chunk + 1, n) whose first row is symbol sym0 - 1 (only its raw word is
    read); with ``post_noise`` two more, the post-EQ draws' (u1 word, u2
    word), (chunk, n).  ``prev``: the (E,) tail pair the first symbol reads."""
    n, T = link.n, link.T
    rows = lk.stage_rows(link, rows, lk.rows_needed(link))
    tile, tiles, groups = _chunk_geometry(link, chunk)
    before = 1 if sym0 > 0 and prev is None else 0
    words, pwords = lk.split_words(link, words, 3, key, sym0, chunk, device)
    if words is None:
        words = prng.link_words(key, sym0 - before, chunk + before, n, device)
    raw, w1, w2 = (torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words)
    if raw.shape != (chunk + before, n):
        raise ValueError(f"words must be ({chunk + before}, {n}) planes, got {tuple(raw.shape)}")
    tx, sr, si = lk.encode(raw, link.q)
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
    yr, yi = lk.cmatmul(link.cmr, link.cmi, act_r, act_i)
    if link.add_noise:
        yr, yi = lk.awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, link.slice)
    er, ei = lk.equalize(link, yr, yi, snr_lin)
    if link.is_sc:
        er, ei = lk.cmatmul(link.idr, link.idi, er, ei)
    er, ei = lk.bump_stages(link, er, ei, rows, pwords)
    er, ei = lk.sc_slicer(link, er, ei)
    if link.normalize:
        er, ei = lk.normalize_points(link, er, ei, lk.tile_norm(er, ei, chunk, tile, RUN))
    return tx, er, ei, xr, xi


def fold_chunk_plain(
    link: FoldLink,
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
    """Plain version of ``fold_chunk`` (same arguments, same effects);
    ``words`` as in ``fold_planes``; past MAX_N ``fold_wide_chunk_plain``."""
    if is_wide(link):
        return fold_wide_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, words, rows, dump, prev)
    T = link.T
    tx, er, ei, xr, xi = fold_planes(link, key, sym0, chunk, snr_lin, acc.device, words, rows, prev)
    if dump is not None:
        lk.write_dump(link, dump, er, ei)
    lk.count_errors(link, tx, er, ei, acc)
    lk.add_papr(xr[:, :T], xi[:, :T], acc, psum)
    return xr[-1, :T].clone(), xi[-1, :T].clone()


def fold_probe_plain(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None, words=None):
    """Plain version of ``fold_probe``: the last symbol's x = s @ F_tx,ext as
    ``fold_planes`` computes it (``words``: its raw words injected, as
    ``link_kernel.probe_symbol_tx`` takes them); past MAX_N
    ``fold_wide_probe_plain``."""
    if is_wide(link):
        return fold_wide_probe_plain(link, key, sym0, chunk, rows, words)
    T = link.T
    sr, si = lk.probe_symbol_tx(link, key, sym0 + chunk - 1, link.n, rows, link.txr.device, words)
    xr, xi = lk.cmatmul(link.txr, link.txi, sr, si)
    return xr[0, :T].clone(), xi[0, :T].clone(), xr[0, T:].clone(), xi[0, T:].clone()


# --- plain version of the wide chain (csrc/fold_wide_kernel.cu) ----------------


def fold_wide_planes(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                     device, words=None, rows=None, prev=None):
    """(tx, er, ei, xr, xi): ``fold_planes``' outputs (x (chunk, T)) as the
    block-per-symbol chain computes them: the TX block by copies or the
    block IDFT (``link_kernel.wide_tx``), the direct K-tap stream
    convolution over [previous tail | x] at the n post-guard samples
    (``link_kernel.stream_conv``), the block DFT, the per-bin chain with
    the MMSE mean and the normalization energy summed in a block of 256
    threads' order, the SC-FDE block IDFT (``dft.block_dft``).  ``words``
    and ``prev`` as in ``fold_planes``."""
    n, T = link.n, link.T
    rows = lk.stage_rows(link, rows, lk.rows_needed(link))
    tile, tiles, groups = _chunk_geometry(link, chunk)
    before = 1 if sym0 > 0 and prev is None else 0
    words, pwords = lk.split_words(link, words, 3, key, sym0, chunk, device)
    if words is None:
        words = prng.link_words(key, sym0 - before, chunk + before, n, device)
    raw, w1, w2 = (torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words)
    if raw.shape != (chunk + before, n):
        raise ValueError(f"words must be ({chunk + before}, {n}) planes, got {tuple(raw.shape)}")
    tx, sr, si = lk.encode(raw, link.q)
    if link.apply_power:
        sr, si = lk.scale_tx(sr, si, rows)
    xr, xi = lk.wide_tx(sr, si, T, link.is_sc, False, link.plan)
    tail, xr, xi = lk.wide_prev(link, xr, xi, prev, before, device)
    if before:
        tx, w1, w2 = tx[1:], w1[1:], w2[1:]
    zr, zi = lk.wide_stream(xr, xi, link.E, tail)
    rr, ri = lk.stream_conv(zr, zi, link.tpr, link.tpi, link.L, n)
    yr, yi = dft.block_dft(rr, ri, link.plan)
    if link.add_noise:
        yr, yi = lk.awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, link.slice)
    er, ei = lk.equalize(link, yr, yi, snr_lin, WIDE_THREADS)
    if link.is_sc:
        er, ei = dft.block_dft(er, ei, link.plan, inverse=True)
    er, ei = lk.bump_stages(link, er, ei, rows, pwords)
    er, ei = lk.sc_slicer(link, er, ei)
    if link.normalize:
        er, ei = lk.normalize_points(link, er, ei, lk.tile_norm(er, ei, chunk, tile, WIDE_RUN, WIDE_THREADS))
    return tx, er, ei, xr, xi


def fold_wide_chunk_plain(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                          acc: torch.Tensor, psum: torch.Tensor, words=None, rows=None, dump=None, prev=None):
    """Plain version of ``fold_chunk`` on the wide chain (any n; the chunk
    past MAX_N); ``words`` as in ``fold_planes``."""
    tx, er, ei, xr, xi = fold_wide_planes(link, key, sym0, chunk, snr_lin, acc.device, words, rows, prev)
    if dump is not None:
        lk.write_dump(link, dump, er, ei)
    lk.count_errors(link, tx, er, ei, acc)
    lk.add_papr(xr, xi, acc, psum)
    return xr[-1].clone(), xi[-1].clone()


def fold_wide_probe_plain(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None, words=None):
    """Plain version of ``fold_probe`` on the wide chain: the last symbol's
    TX block (``link_kernel.wide_tx``), its x[:T] and tail x[T-E:T]."""
    T = link.T
    sr, si = lk.probe_symbol_tx(link, key, sym0 + chunk - 1, link.n, rows, link.tpr.device, words)
    xr, xi = lk.wide_tx(sr, si, T, link.is_sc, False, link.plan)
    return xr[0].clone(), xi[0].clone(), xr[0, T - link.E :].clone(), xi[0, T - link.E :].clone()


# --- kernel wrapper -------------------------------------------------------------


def _check_wide_link(link: FoldLink, device):
    n, K = link.n, link.E + 1
    shapes = {"tpr": (K,), "tpi": (K,), "hr": (n,), "hi": (n,), "habs2": (n,), "gr": (n,), "gi": (n,)}
    for name, shape in shapes.items():
        t = getattr(link, name)
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"link.{name} must be contiguous f32 {shape} on {device}")
    p = link.plan
    if p.n != n or p.twr.device != device or p.twi.device != device:
        raise ValueError(f"link.plan must be the {n}-point DFT plan on {device}")
    if not (MAX_N < n <= WIDE_MAX_N and link.T == n + link.L and 0 <= link.E <= link.T):
        raise ValueError(f"fold_wide takes {MAX_N} < n <= {WIDE_MAX_N}, T = n + L; got n={n}, T={link.T}")
    lk.check_codec(link.q, n, device)


def _check_link(link: FoldLink, device):
    if is_wide(link):
        return _check_wide_link(link, device)
    names = ["txr", "txi", "cmr", "cmi", "hr", "hi", "habs2", "gr", "gi"]
    names += ["idr", "idi"] if link.is_sc else []
    for name in names:
        t = getattr(link, name)
        if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"link.{name} must be contiguous f32 on {device}")
    TE, n = link.T + link.E, link.n
    shapes = {"tx_terms": (n, TE), "cm_terms": (TE, n)} | ({"id_terms": (n, n)} if link.is_sc else {})
    for name, shape in shapes.items():
        t = getattr(link, name)
        if t is None or t.p.device != device or t.idx.device != device or (t.rows, t.cols) != shape:
            raise ValueError(f"link.{name} must be the listed terms of a {shape} matrix on {device}")
    if link.txr.shape != (n, TE) or link.cmr.shape != (TE, n) or link.hr.shape != (n,):
        raise ValueError("link matrices have the wrong shape")
    if link.is_sc and link.idr.shape != (n, n):
        raise ValueError("link.idr must be (n, n)")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fold kernel takes 1 <= n <= {MAX_N}, got {n}")
    lk.check_codec(link.q, n, device)


def chunk_workspace(link: FoldLink, chunk: int, device):
    """(partials, carry_r, carry_i, norm partials, norm factors): the scratch
    ``fold_chunk`` needs for chunks of ``chunk`` symbols, so that a run
    allocates it once."""
    tile, tiles, groups = _chunk_geometry(link, chunk)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(tiles * groups, **f32), torch.empty(link.T, **f32), torch.empty(link.T, **f32),
            *lk.norm_workspace(chunk, tile, _run(link), device))


GEOMETRY_KEYS = ("bins_a_lane", "group_symbols", "warps", "dynamic_smem_bytes", "registers", "local_bytes",
                 "static_smem_bytes", "blocks_an_sm", "power_warps", "power_dynamic_smem_bytes", "power_registers",
                 "power_local_bytes", "power_blocks_an_sm")


def geometry(n: int, T: int, E: int, library: str = "fold_kernel") -> dict:
    """fold_main's and fold_power's layout at (n, T, E), read from the
    loaded ``library`` (csrc/fold_kernel.cu::ofdm_fold_geometry, the qam
    entry points as a chunk without a carry-in or dump launches them): bins
    a lane, symbols a group, and for each kernel its warps a block and
    dynamic shared memory a block and, from the loaded kernel, registers,
    local bytes a thread (spills and stack), static shared memory (fold_main)
    and resident blocks an SM.  Raises if the card cannot give a block that
    shared memory."""
    import ctypes

    from ofdm_tpu_torch import build

    lib = build.load(library)
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    build.check(lib, lib.ofdm_fold_geometry(n, T, E, out), "ofdm_fold_geometry")
    return dict(zip(GEOMETRY_KEYS, out))


def _run(link: FoldLink) -> int:
    return WIDE_RUN if is_wide(link) else RUN


def fold_chunk(
    link: FoldLink,
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
    ``rows``: the stages' per-lane rows (``link_kernel.stage_rows``; all
    five stages).  ``dump``: the dump stage's planes
    (``link_kernel.new_dump``; counted in ``fold_chunk.dump_launches``).

    CUDA tensors launch the fused kernel (csrc/fold_kernel.cu, over the
    link's listed terms, its warps in groups of symbols: ``layout``): with
    noise on, ``fold_power``; then ``fold_main`` (for a link with stages its
    OFDM_STAGED build, with the noise-bump stages its OFDM_BUMP build,
    under ``normalize`` twice around ``norm_factors``),
    counted in ``fold_chunk.power_launches``, ``.launches`` and
    ``.norm_launches``.  Past MAX_N the block-per-symbol chain
    (csrc/fold_wide_kernel.cu, its staged and bump builds alike):
    ``fold_wide_power`` with noise on, then ``fold_wide_main``, counted in
    ``.wide_power_launches`` and ``.wide_launches``.  CPU tensors run
    ``fold_chunk_plain``."""
    dev = acc.device
    if dev.type == "cpu":
        return fold_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows, dump=dump, prev=prev)
    if dev.type != "cuda":
        raise ValueError(f"fold_chunk runs on cpu or cuda, not {dev}")
    lk.check_accumulators(acc, psum)
    _check_link(link, dev)
    if not 1 <= chunk <= (2**31 - 1) // link.n:
        raise ValueError(f"chunk out of range: {chunk}")
    if dump is not None:
        lk.check_dump(dump, chunk, link.n, dev)
    prev_ptrs = lk.check_prev(prev, link.E, dev)
    tile, tiles, groups = _chunk_geometry(link, chunk)
    work = chunk_workspace(link, chunk, dev) if work is None else work
    lk.check_work(work, (tiles * groups, link.T, link.T, -(-chunk // _run(link)), tiles),
                  f"chunk_workspace(link, {chunk}, {dev})")
    partials, carry_r, carry_i, norm_part, norm_f = work
    from ofdm_tpu_torch import build

    if is_wide(link):
        lib = build.load(lk.staged_library(link, dump, "fold_wide"))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.ofdm_fold_wide_chunk(
                link.tpr.data_ptr(), link.tpi.data_ptr(), link.plan.twr.data_ptr(), link.plan.twi.data_ptr(),
                link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(), link.gr.data_ptr(),
                link.gi.data_ptr(), *lk.wide_args(link), *lk.codec_args(link.q), link.slicer, snr_lin, link.cg,
                link.method, int(link.add_noise), int(link.is_sc), sym0, chunk, tile, link.slice, groups,
                WIDE_RUN, key[0], key[1], partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
                carry_r.data_ptr(), carry_i.data_ptr(), *lk.stage_args(link, rows, norm_part, norm_f, dump),
                *prev_ptrs, stream,
            )
        build.check(lib, code, "ofdm_fold_wide_chunk")
        fold_chunk.wide_power_launches += int(link.add_noise)
        fold_chunk.norm_launches += int(link.normalize)
        fold_chunk.dump_launches += int(dump is not None)
        fold_chunk.wide_launches += 1
        return carry_r, carry_i
    lib = build.load(lk.staged_library(link, dump, "fold"))
    sc = link.is_sc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ofdm_fold_chunk(
            *link.tx_terms.args(), *link.cm_terms.args(), *(link.id_terms.args() if sc else (None, None, 0)),
            link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(),
            link.gr.data_ptr(), link.gi.data_ptr(),
            link.n, link.T, link.E, *lk.codec_args(link.q), link.slicer, snr_lin, link.cg,
            link.method, int(link.add_noise), int(sc),
            sym0,
            chunk, tile, link.slice, groups, RUN,
            key[0], key[1],
            partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
            carry_r.data_ptr(), carry_i.data_ptr(),
            *lk.stage_args(link, rows, norm_part, norm_f, dump), *prev_ptrs, stream,
        )
    build.check(lib, code, "ofdm_fold_chunk")
    if link.add_noise:
        fold_chunk.power_launches += 1
    fold_chunk.norm_launches += int(link.normalize)
    fold_chunk.dump_launches += int(dump is not None)
    fold_chunk.launches += 1
    return carry_r, carry_i


def fold_probe(link: FoldLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None):
    """K3: (carry_r, carry_i, tail_r, tail_i) of the chunk of run symbols
    [sym0, sym0 + chunk) without running it: its last symbol's x[:T] (the
    carry row ``fold_chunk`` returns, bitwise) and x[T:T+E] (the tail the
    next symbol reads).  CUDA links launch ``fold_probe`` (csrc/fold_kernel.cu;
    one block over the chunk's listed TX terms, in the library the chunk
    runs from; the link checked and its arguments built once,
    ``link_kernel.link_cached``), counted in ``fold_probe.launches``, past
    MAX_N ``fold_wide_probe`` (csrc/fold_wide_kernel.cu; one block), counted
    in ``fold_probe.wide_launches``; CPU links run ``fold_probe_plain``.
    The four outputs are views of one new buffer a call."""
    dev = link.hr.device
    if dev.type == "cpu":
        return fold_probe_plain(link, key, sym0, chunk, rows)
    from ofdm_tpu_torch import build

    if is_wide(link):
        _check_link(link, dev)
        lib = build.load(lk.staged_library(link, None, "fold_wide"))
        out = lk.wide_probe_launch(lib, "ofdm_fold_wide_probe", link, key, sym0 + chunk - 1, rows, dev)
        fold_probe.wide_launches += 1
        return out

    def head():
        _check_link(link, dev)
        return build.load(lk.staged_library(link, None, "fold")), (*link.tx_terms.args(), *lk.probe_args(link))

    lib, args = lk.link_cached(link, "probe", head)
    out = lk.probe_launch(lib, "ofdm_fold_probe", link, args, key, sym0 + chunk - 1, rows, dev)
    fold_probe.launches += 1
    return out


fold_probe.launches = 0  # fold_probe kernels launched
fold_probe.wide_launches = 0  # fold_wide_probe kernels launched
fold_chunk.launches = 0  # fold_main kernels launched (the pass that counts errors)
fold_chunk.power_launches = 0  # fold_power kernels launched
fold_chunk.wide_launches = 0  # fold_wide_main kernels launched (the pass that counts errors)
fold_chunk.wide_power_launches = 0  # fold_wide_power kernels launched
fold_chunk.norm_launches = 0  # normalization passes (each with its norm_factors) launched
fold_chunk.dump_launches = 0  # counting passes that ran the dump stage
