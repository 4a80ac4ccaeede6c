"""The fused lr-mode chunk: host constants, kernel wrapper and plain version.

Counterpart of ``ofdm_tpu/ops/pallas_link.py``'s ``kernel`` in conv="lr"
form (``csrc/lr_kernel.cu``), in each constellation mode
(``link_kernel.Codec``): OFDM links whose TX -> channel ->
RX composite is factored by ``ops.lowrank`` into a diagonal D and two
rank-E corrections.  The routing sends them here from 128 subcarriers when
the guard does not cover the channel (short CP, no prefix, ZP) and past 512
subcarriers when it does.

A chunk, per OFDM symbol b (the semantics of the lr branches of
pallas_link.py:1428-1937, not its TPU layout): Philox words -> encode
s_b -> [x sqrt(P)] -> t_b = s_b @ TailM (the block's last E time samples)
-> y_b = s_b * D + t_b @ Cr + t_{b-1} @ Cp -> AWGN per bin with sigma =
sqrt(mp / snr_lin / 2), mp the mean |y|^2 over the first ``slice``
symbols of b's tile times ``pw_scale`` (n/T for ZP), plus for ZP the
colored part sigma * g2 @ B^H -> ZF / MMSE / none -> [post-EQ noise, x
1/sqrt(P)] -> [x the tile's unit-power factor] -> slicer -> popcount into
int64 counters
(``link_kernel``'s stages).  Below 512 subcarriers every ``pstride``-th
tile also runs x = s @ F_tx for the PAPR statistic; from 512 (``txext``)
the runner supplies it from a sampled TX batch, unless the link applies
the power allocation: the sampled batch is unscaled, so such a link takes
its PAPR in the run from the scaled symbols (pallas_link.py:876-887).  The chunk returns the JAX carry contract: a (T,) row, zero but for
its last E lanes, which hold the last symbol's t.

Every block-wide sum (t, the MMSE mean) runs in a fixed order that the
plain version repeats step by step (``link_kernel.block_sum``): each
symbol's sums run over a kernel block of ``THREADS`` threads, thread
k % THREADS sums its bins in k order, warps reduce by an xor butterfly,
then the warps in order.  Past ``link_kernel.CLUSTER_BINS`` (4096)
subcarriers a symbol spans C = ceil(n / 4096) blocks of one thread-block
cluster, each holding one 4096-bin slice (the last may be short): each
block sums its slice so, and every block adds the C slices' sums in slice
order (``block_sum``'s ``slice``); lr_power's partials then hold one slice
of one symbol each (``link_kernel.cluster_width``).  The kernel block walks its run of ``RUN``
symbols in groups of M (``geometry``), reading each factor element
once a group, and only the factor rows ``lr_link`` lists (``tail_rows``,
``cc_rows``, ``bh_rows``, handed to the kernel as one int32 table,
``row_table``): a skipped row is identically zero, or multiplies
a lane of t that is, so its terms are +-0 and every sum is bit-equal to the
product over all rows that the plain version takes.  Any number of tail
lanes and any noise rank: t's block sums run in passes of at most
``TAIL_PASS`` listed lanes and the g2 draws in rounds of at most
``G2_ROUND`` listed rows, neither of which changes an order of summation.
The previous symbol's t is recomputed from its Philox words, so nothing
depends on block order or chunking: the run's symbol 0 sees t_prev = 0.  A sharded contiguous stream
passes ``prev``, the t of the symbol before the chunk's first, which
another shard computed (a t of this link: zero on TailM's zero rows): the
first symbol reads it.

``lr_probe`` is K3, the carry probe (pallas_link.py::_probe_fn_for_spec):
a chunk's carry row and t, from its last symbol's Philox words alone,
through the chunk's own encode and block sums.

``lr_chunk`` launches the kernel for CUDA tensors and runs
``lr_chunk_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import PrefixType
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import linops, lowrank, prng

MAX_N = 32768  # up to 4096 bins a block (16 a thread), past it a cluster of up to 8 blocks a symbol
THREADS = 256  # a kernel block's threads; each symbol's block sums run over them
TAIL_PASS = 64  # listed tail lanes whose block sums share one pass (csrc/lr_kernel.cu: kTailPass)
G2_ROUND = 128  # listed noise-factor rows whose g2 draws share one round (kG2Round)
# Consecutive symbols one block of lr_main walks; it recomputes t of the
# symbol before its first, so one t in RUN + 1 is extra work.
RUN = 16


GEOMETRY_KEYS = ("bins_a_thread", "group_symbols", "power_group_symbols", "dynamic_smem_bytes", "registers",
                 "local_bytes", "static_smem_bytes", "blocks_an_sm")


def geometry(link: LrLink) -> dict:
    """lr_main's layout on a CUDA link, read from the library its chunk runs
    from (csrc/lr_kernel.cu::ofdm_lr_geometry, the qam entry point as the
    chunk launches it): bins a thread (J), the symbols a group of lr_main
    and of lr_power (M), its dynamic shared memory a block, and from the
    loaded kernel its registers, local bytes a thread (spills and stack),
    static shared memory and resident blocks an SM.  Raises if the card
    cannot give a block that shared memory."""
    from ofdm_tpu_torch import build

    lib = build.load(lk.staged_library(link, None, "lr"))
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    code = lib.ofdm_lr_geometry(link.n, len(link.tail_rows), len(link.bh_rows) if link.add_noise else 0,
                                int(link.txext), out)
    build.check(lib, code, "ofdm_lr_geometry")
    return dict(zip(GEOMETRY_KEYS, out))


def nonzero_rows(re: torch.Tensor, im: torch.Tensor) -> Tuple[int, ...]:
    """Indices of the rows of a complex (rows, n) pair that hold a nonzero."""
    return tuple(int(r) for r in torch.nonzero((re != 0).any(1) | (im != 0).any(1)).flatten())


def row_table(link) -> np.ndarray:
    """The rows the kernels read, as one int32 table: TailM's listed rows
    (nt), each tail lane's place among them or -1 (E), the listed rows of
    [Cr; Cp] (ncc), the offset of each one's t value from its symbol's
    t_prev slots (ncc: nt + the lane's place for a row of Cr, the lane's
    place for a row of Cp), and B^H's listed rows.  The kernel keeps t in
    the listed lanes' places only."""
    place = {e: i for i, e in enumerate(link.tail_rows)}
    nt, E = len(link.tail_rows), link.E
    slots = [place.get(e, -1) for e in range(E)]
    offs = [(nt if r < E else 0) + place[r % E] for r in link.cc_rows]
    return np.asarray([*link.tail_rows, *slots, *link.cc_rows, *offs, *link.bh_rows], np.int32)


@dataclasses.dataclass(frozen=True)
class LrLink:
    """Everything the lr chunk reads: f32 matrices and rows on one device."""

    n: int
    T: int
    E: int  # tail lanes
    rank: int  # ZP noise-factor rank (0: iid bin noise)
    q: lk.Codec
    slicer: float
    cg: float
    method: int
    add_noise: bool
    apply_power: bool
    normalize: bool
    is_sc: bool  # SC-FDE (never on the lr chain)
    txext: bool  # the PAPR statistic comes from the runner's sampled TX batch
    pstride: int
    tile_cap: int
    slice: int
    pw_scale: float  # f32 measured-power scale: n/T for ZP, 1 otherwise
    tail_r: torch.Tensor  # (E, n) TailM transposed, so a warp reads consecutive words
    tail_i: torch.Tensor
    cc_r: torch.Tensor  # (2E, n) [Cr; Cp]
    cc_i: torch.Tensor
    bh_r: Optional[torch.Tensor]  # (rank, n) B^H; None for iid noise
    bh_i: Optional[torch.Tensor]
    dr: torch.Tensor  # (n,) D
    di: torch.Tensor
    hr: torch.Tensor  # (n,)
    hi: torch.Tensor
    habs2: torch.Tensor
    gr: torch.Tensor  # ZF gain rows, slicer folded in
    gi: torch.Tensor
    fr: Optional[torch.Tensor]  # (n, T) TX matrix; None under txext
    fi: Optional[torch.Tensor]
    # The rows the kernel reads, ascending: TailM's nonzero rows, the rows of
    # [Cr; Cp] that are nonzero and multiply a lane of t in tail_rows, and
    # B^H's nonzero rows.
    tail_rows: Tuple[int, ...]
    cc_rows: Tuple[int, ...]
    bh_rows: Tuple[int, ...]
    # The noise-bump study's stages (link_kernel.noise_bump_link): post-EQ
    # noise of sigma rows[2], then x rows[1] (1/sqrt(P)).
    post_noise: bool = False
    compensate: bool = False
    # What the wrappers derive from the link alone (link_kernel.link_cached):
    # a new link, dataclasses.replace's too, starts it empty.
    cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)


@functools.lru_cache(maxsize=16)
def _factor(taps: bytes, n: int, prefix, L: int, modulation) -> Optional[lowrank.LRFactors]:
    return lowrank.factor(np.frombuffer(taps, np.complex128), n, prefix, L, modulation)


def lr_factors(setup) -> Optional[lowrank.LRFactors]:
    """``lowrank.factor`` of a setup's link (cached: routing and the link
    constants both read it), or None when its certification fails."""
    cfg = setup.cfg
    taps = np.ascontiguousarray(setup.taps, np.complex128).tobytes()
    return _factor(taps, cfg.num_subcarriers, cfg.prefix_type, setup.prefix_length, cfg.modulation_type)


def lr_link(setup, device, factors: Optional[lowrank.LRFactors] = None) -> LrLink:
    """Host constants of an lr link (pallas_link._consts_for, lr branch,
    without its 8-lane padding and zero noise factor): from ``factors`` when
    given, else from ``lr_factors(setup)``."""
    cfg = setup.cfg
    n, L = cfg.num_subcarriers, setup.prefix_length
    T = n + L
    f = lr_factors(setup) if factors is None else factors
    if f is None:
        raise ValueError("lr link: the low-rank factorization failed its certification")
    if f.n != n or f.tail.shape != (n, f.E):
        raise ValueError("lr link: factors of another width")
    txext = lk.txext_for(cfg)
    rank = f.noise_rank
    f32 = functools.partial(lk.f32_tensor, device=device)
    tail = np.ascontiguousarray(f.tail.T)
    cc = np.concatenate([f.cr, f.cp])
    bh = np.ascontiguousarray(f.bnoise.conj().T) if rank else None
    ftx = None if txext else linops.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    tail_r, tail_i, cc_r, cc_i = f32(tail.real), f32(tail.imag), f32(cc.real), f32(cc.imag)
    bh_r, bh_i = (None, None) if bh is None else (f32(bh.real), f32(bh.imag))
    tail_rows = nonzero_rows(tail_r, tail_i)
    return LrLink(
        T=T,
        E=f.E,
        rank=rank,
        txext=txext,
        pstride=cfg.papr_stride or 32,
        tile_cap=lk.lr_tile_cap(n, T, f.E, rank, txext, lk.selected_passes(setup)),
        pw_scale=float(np.float32(f.pw_scale)) if cfg.prefix_type == PrefixType.ZERO else 1.0,
        tail_r=tail_r,
        tail_i=tail_i,
        cc_r=cc_r,
        cc_i=cc_i,
        bh_r=bh_r,
        bh_i=bh_i,
        dr=f32(f.d.real),
        di=f32(f.d.imag),
        fr=None if ftx is None else f32(ftx[0]),
        fi=None if ftx is None else f32(ftx[1]),
        tail_rows=tail_rows,
        cc_rows=tuple(r for r in nonzero_rows(cc_r, cc_i) if r % f.E in tail_rows),
        bh_rows=() if bh is None else nonzero_rows(bh_r, bh_i),
        **lk.equalizer_fields(setup, device),
    )


def _chunk_geometry(link: LrLink, chunk: int):
    tile = lk.tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    groups = -(-min(link.slice, tile) * lk.cluster_width(link.n) // lk.POWER_BLOCK)
    return tile, tiles, groups


def papr_samples(link: LrLink, chunk: int) -> int:
    """Time samples one chunk contributes to the PAPR statistic (0 under txext)."""
    if link.txext:
        return 0
    return lk.sampled_symbols(chunk, lk.tile_for(chunk, link.tile_cap), link.pstride) * link.T


# --- plain version of the chunk ----------------------------------------------


def tails(link: LrLink, sr: torch.Tensor, si: torch.Tensor):
    """t = s @ TailM, (count, E) re and im, summed in lr_main's block order."""
    step = max(1, (1 << 24) // (link.E * link.n))  # symbols a pass, to bound memory
    out_r, out_i = [], []
    fr, fi = link.tail_r[None], link.tail_i[None]
    for b0 in range(0, sr.shape[0], step):
        a, c = sr[b0 : b0 + step, None, :], si[b0 : b0 + step, None, :]
        out_r.append(lk.block_sum(a * fr - c * fi, THREADS, lk.CLUSTER_BINS))
        out_i.append(lk.block_sum(a * fi + c * fr, THREADS, lk.CLUSTER_BINS))
    return torch.cat(out_r), torch.cat(out_i)


def lr_planes(link: LrLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
              device, words=None, rows=None, prev=None):
    """(tx, er, ei, tr, ti, sr, si): the chunk's TX indices, equalized points
    in slicer units, tails t and symbols, each (chunk, n) or (chunk, E) —
    the plain chain up to the slicer, the stages included (``rows``: the
    chunk's per-lane rows).

    ``words`` injects integer planes in place of the Philox draw: (raw,
    u1 word, u2 word), (chunk, n) for sym0 == 0 or with ``prev``, else
    (chunk + 1, n) whose first row is symbol sym0 - 1 (only its raw word is
    read); a colored-noise link (ZP, noise on) takes two more, the g2
    draws' (u1 word, u2 word), each (chunk, rank); with ``post_noise`` two
    more, the post-EQ draws' (u1 word, u2 word), (chunk, n).  ``prev``: the
    (E,) t pair the first symbol reads as t_prev."""
    n, E = link.n, link.E
    rows = lk.stage_rows(link, rows, lk.rows_needed(link))
    tile, tiles, groups = _chunk_geometry(link, chunk)
    colored = link.add_noise and link.rank > 0
    before = 1 if sym0 > 0 and prev is None else 0
    words, pwords = lk.split_words(link, words, 5 if colored else 3, key, sym0, chunk, device)
    if words is None:
        words = prng.link_words(key, sym0 - before, chunk + before, n, device)
        if colored:
            words += prng.noise_words(key, sym0, chunk, link.rank, device)
    planes = [torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words]
    raw, w1, w2 = planes[:3]
    if raw.shape != (chunk + before, n) or len(planes) != (5 if colored else 3):
        raise ValueError(f"words must be 3 ({chunk + before}, {n}) planes (+2 (chunk, rank) for colored noise)")
    tx, sr, si = lk.encode(raw, link.q)
    if link.apply_power:
        sr, si = lk.scale_tx(sr, si, rows)
    tr, ti = tails(link, sr, si)
    if before:
        tpr, tpi = tr[:-1], ti[:-1]
        tr, ti, tx, sr, si, w1, w2 = tr[1:], ti[1:], tx[1:], sr[1:], si[1:], w1[1:], w2[1:]
    else:
        zero = torch.zeros((1, E), dtype=torch.float32, device=device)
        head_r, head_i = (zero, zero) if prev is None else lk.plain_prev(prev, E, device)
        tpr, tpi = torch.cat([head_r, tr[:-1]]), torch.cat([head_i, ti[:-1]])
    cyr, cyi = lk.cmatmul(link.cc_r, link.cc_i, torch.cat([tr, tpr], 1), torch.cat([ti, tpi], 1))
    yr = (sr * link.dr - si * link.di) + cyr
    yi = (sr * link.di + si * link.dr) + cyi
    if link.add_noise:
        extra = None
        if colored:
            extra = lk.cmatmul(link.bh_r, link.bh_i, *lk.box_muller(planes[3], planes[4]))
        yr, yi = lk.awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, link.slice,
                          link.pw_scale, extra, lk.cluster_width(n))
    er, ei = lk.equalize(link, yr, yi, snr_lin, THREADS, lk.CLUSTER_BINS)
    er, ei = lk.bump_stages(link, er, ei, rows, pwords)
    if link.normalize:
        f = lk.tile_norm(er, ei, chunk, tile, RUN, THREADS, lk.CLUSTER_BINS)
        er, ei = lk.normalize_points(link, er, ei, f)
    return tx, er, ei, tr, ti, sr, si


def lr_chunk_plain(
    link: LrLink,
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
    """Plain version of ``lr_chunk`` (same arguments, same effects);
    ``words`` as in ``lr_planes``."""
    dev = acc.device
    tx, er, ei, tr, ti, sr, si = lr_planes(link, key, sym0, chunk, snr_lin, dev, words, rows, prev)
    if dump is not None:
        lk.write_dump(link, dump, er, ei)
    lk.count_errors(link, tx, er, ei, acc)
    if not link.txext:
        tile = lk.tile_for(chunk, link.tile_cap)
        sampled = (torch.arange(chunk, device=dev) // tile) % link.pstride == 0
        lk.add_papr(*lk.cmatmul(link.fr, link.fi, sr[sampled], si[sampled]), acc, psum)
    carry_r = torch.zeros(link.T, dtype=torch.float32, device=dev)
    carry_i = torch.zeros_like(carry_r)
    carry_r[link.T - link.E :] = tr[-1]
    carry_i[link.T - link.E :] = ti[-1]
    return carry_r, carry_i


def lr_probe_plain(link: LrLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None, words=None):
    """Plain version of ``lr_probe``: the last symbol's t as ``lr_planes``
    computes it, and the carry row ``lr_chunk_plain`` builds from it
    (``words``: its raw words injected, as ``link_kernel.probe_symbol_tx``
    takes them)."""
    T, E = link.T, link.E
    sr, si = lk.probe_symbol_tx(link, key, sym0 + chunk - 1, link.n, rows, link.dr.device, words)
    tr, ti = tails(link, sr, si)
    carry_r = torch.zeros(T, dtype=torch.float32, device=sr.device)
    carry_i = torch.zeros_like(carry_r)
    carry_r[T - E :] = tr[0]
    carry_i[T - E :] = ti[0]
    return carry_r, carry_i, tr[0].clone(), ti[0].clone()


# --- kernel wrapper -------------------------------------------------------------


def _check_link(link: LrLink, device):
    n, E, r = link.n, link.E, link.rank
    shapes = {"tail_r": (E, n), "tail_i": (E, n), "cc_r": (2 * E, n), "cc_i": (2 * E, n),
              "dr": (n,), "di": (n,), "hr": (n,), "hi": (n,), "habs2": (n,), "gr": (n,), "gi": (n,)}
    if r:
        shapes.update(bh_r=(r, n), bh_i=(r, n))
    if not link.txext:
        shapes.update(fr=(n, link.T), fi=(n, link.T))
    for name, shape in shapes.items():
        t = getattr(link, name)
        if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"link.{name} must be contiguous f32 on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"link.{name} must be {shape}, got {tuple(t.shape)}")
    if not (1 <= n <= MAX_N and 1 <= E <= link.T and r >= 0 and link.T >= n):
        raise ValueError(f"lr kernel takes n <= {MAX_N}, 1 <= E <= T; got n={n}, E={E}, T={link.T}")
    if n > lk.CLUSTER_BINS and not link.txext:
        # the in-kernel PAPR holds a symbol a block
        raise ValueError(f"past {lk.CLUSTER_BINS} subcarriers the lr kernel takes txext links; got n={n}")
    for name, rows, bound in (("tail_rows", link.tail_rows, E), ("cc_rows", link.cc_rows, 2 * E),
                              ("bh_rows", link.bh_rows, r)):
        if list(rows) != sorted(set(rows)) or any(not 0 <= i < bound for i in rows):
            raise ValueError(f"link.{name} must be ascending distinct rows below {bound}, got {rows}")
    lk.check_codec(link.q, n, device)


def _table_args(link: LrLink, device) -> tuple:
    """(table pointer, nt, ncc, nbh): ``row_table`` on the device (made once
    a link, ``link_kernel.link_cached``) and its three row counts."""
    table = lk.link_cached(link, "row_table", lambda: torch.tensor(row_table(link), device=device))
    return table.data_ptr(), len(link.tail_rows), len(link.cc_rows), len(link.bh_rows)


def chunk_workspace(link: LrLink, chunk: int, device):
    """(partials, carry_r, carry_i, norm partials, norm factors): the scratch
    ``lr_chunk`` needs for chunks of ``chunk`` symbols, so that a run
    allocates it once."""
    tile, tiles, groups = _chunk_geometry(link, chunk)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(tiles * groups, **f32), torch.empty(link.T, **f32), torch.empty(link.T, **f32),
            *lk.norm_workspace(chunk, tile, RUN, device))


def lr_chunk(
    link: LrLink,
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
    symbol errors and (below ``txext``) PAPR peak bits into ``acc`` and its
    PAPR power sum into ``psum``.  Returns the carry row (re, im): (T,),
    zero but for the last E lanes, the last symbol's t; written into
    ``work`` (a ``chunk_workspace``) when given.  ``prev``: the (E,) t pair
    the first symbol reads as t_prev (the carry-in), instead of recomputing
    its predecessor's.  ``rows``: the stages'
    per-lane rows (``link_kernel.stage_rows``).  ``dump``: the dump stage's
    planes (``link_kernel.new_dump``; counted in ``lr_chunk.dump_launches``).

    CUDA tensors launch the fused kernel (csrc/lr_kernel.cu): with noise on,
    ``lr_power``; then ``lr_main`` (for a link with stages its OFDM_STAGED
    build, with the noise-bump stages its OFDM_BUMP build, under
    ``normalize`` twice around ``norm_factors``), counted in
    ``lr_chunk.power_launches``, ``.launches`` and ``.norm_launches``.  CPU
    tensors run ``lr_chunk_plain``."""
    dev = acc.device
    if dev.type == "cpu":
        return lr_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows, dump=dump, prev=prev)
    if dev.type != "cuda":
        raise ValueError(f"lr_chunk runs on cpu or cuda, not {dev}")
    lk.check_accumulators(acc, psum)
    _check_link(link, dev)
    if not 1 <= chunk <= (2**31 - 1) // link.n:
        raise ValueError(f"chunk out of range: {chunk}")
    if dump is not None:
        lk.check_dump(dump, chunk, link.n, dev)
    prev_ptrs = lk.check_prev(prev, link.E, dev)
    tile, tiles, groups = _chunk_geometry(link, chunk)
    work = chunk_workspace(link, chunk, dev) if work is None else work
    lk.check_work(work, (tiles * groups, link.T, link.T, -(-chunk // RUN), tiles),
                  f"chunk_workspace(link, {chunk}, {dev})")
    partials, carry_r, carry_i, norm_part, norm_f = work
    from ofdm_tpu_torch import build

    lib = build.load(lk.staged_library(link, dump, "lr"))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ofdm_lr_chunk(
            ptr(link.tail_r), ptr(link.tail_i), ptr(link.cc_r), ptr(link.cc_i),
            ptr(link.bh_r), ptr(link.bh_i), ptr(link.dr), ptr(link.di),
            ptr(link.fr), ptr(link.fi), ptr(link.hr), ptr(link.hi), ptr(link.habs2),
            ptr(link.gr), ptr(link.gi),
            link.n, link.T, link.E, link.rank, *lk.codec_args(link.q),
            link.slicer, snr_lin, link.cg, link.pw_scale,
            link.method, int(link.add_noise), int(link.txext), link.pstride,
            sym0,
            chunk, tile, link.slice, groups, RUN,
            key[0], key[1],
            partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
            carry_r.data_ptr(), carry_i.data_ptr(),
            *lk.stage_args(link, rows, norm_part, norm_f, dump), *prev_ptrs,
            *_table_args(link, dev), stream,
        )
    build.check(lib, code, "ofdm_lr_chunk")
    if link.add_noise:
        lr_chunk.power_launches += 1
    lr_chunk.norm_launches += int(link.normalize)
    lr_chunk.dump_launches += int(dump is not None)
    lr_chunk.launches += 1
    return carry_r, carry_i


def lr_probe(link: LrLink, key: Tuple[int, int], sym0: int, chunk: int, rows=None):
    """K3: (carry_r, carry_i, tail_r, tail_i) of the chunk of run symbols
    [sym0, sym0 + chunk) without running it: the (T,) carry row ``lr_chunk``
    returns (bitwise: zeros but for the last E lanes) and the last symbol's
    t (the t_prev the next symbol reads).  CUDA links launch ``lr_probe``
    (csrc/lr_kernel.cu; one block of lr_main's shape through the chunk's
    encode and tail pass over ``tail_rows``, in the library the chunk runs
    from), counted in
    ``lr_probe.launches``; CPU links run ``lr_probe_plain``.  The link is
    checked and its arguments built once (``link_kernel.link_cached``); the
    four outputs are views of one new buffer a call."""
    dev = link.dr.device
    if dev.type == "cpu":
        return lr_probe_plain(link, key, sym0, chunk, rows)
    from ofdm_tpu_torch import build

    def head():
        _check_link(link, dev)
        return (build.load(lk.staged_library(link, None, "lr")),
                (link.tail_r.data_ptr(), link.tail_i.data_ptr(), *lk.probe_args(link)),
                _table_args(link, dev)[:2])

    lib, args, mask = lk.link_cached(link, "probe", head)
    out = lk.probe_launch(lib, "ofdm_lr_probe", link, args, key, sym0 + chunk - 1, rows, dev, mask)
    lr_probe.launches += 1
    return out


lr_probe.launches = 0  # lr_probe kernels launched
lr_chunk.launches = 0  # lr_main kernels launched (the pass that counts errors)
lr_chunk.power_launches = 0  # lr_power kernels launched
lr_chunk.norm_launches = 0  # normalization passes (each with its norm_factors) launched
lr_chunk.dump_launches = 0  # counting passes that ran the dump stage
