"""The fused diag-mode chunk, the constellation codec and the Box-Muller sampler.

Counterpart of ``ofdm_tpu/ops/pallas_link.py`` for the diag chain: its
``kernel`` in conv="diag" form (``csrc/link_kernel.cu``), in each
constellation mode — qam, psk, aqam and apsk (``Codec``: fixed square QAM,
fixed M-PSK, and their per-subcarrier CAPACITY_BASED forms) — and
``boxmuller_sample`` (``csrc/boxmuller.cu``).  Beside each kernel sits its
plain PyTorch version with the same operations in the same order, f32
arithmetic and int64 integer ops; the wrappers ``diag_chunk`` and
``boxmuller_sample`` launch the kernel for CUDA tensors and run the plain
version only for CPU tensors.  The plain codec (``encode``, ``demap``),
the pieces after the channel (``awgn``, ``equalize``, ``count_errors``,
``add_papr``, ``cmatmul``) and the shared host fields
(``equalizer_fields``) serve the fold, lr and mm chunks
(``ops.fold_kernel``, ``ops.lr_kernel``, ``ops.mm_kernel``) too.

A chunk of a diag link, per bin (the semantics of pallas_link.py:1428-1937,
not its TPU layout): Philox words -> encode (Gray/zig-zag QAM or the PSK
cos/sin lattice, per-subcarrier rows under adaptive loading) -> y = s * h
(h is the raw-IR ``h_freq``; the diagonal identity is checked here) ->
AWGN with sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2 over the
first ``slice`` symbols of the bin's tile -> ZF / MMSE / none with the
slicer gain folded in (QAM only) -> float-clipped slicer or PSK sector ->
popcount of tx ^ rx into int64 counters.  Every ``pstride``-th tile of a
chunk also computes the IDFT+CP time plane for the PAPR max and sum.

Host constants and rules kept from the reference: ``_consts_for``'s diag
and codec rows (:1049-1161), ``_spec_for``'s tile rule (:795-799) with
``_plan``'s diag tile cap and its static codec width (:821-847), and the
measured-power slice (:1691-1694).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import EqualizationMethod, NoiseType
from ofdm_tpu_torch.ops import linops, metrics, prng
from ofdm_tpu_torch.ops.mapping import make_constellation

_INV_2_24 = 1.0 / 16777216.0
_INV_2_22 = 1.0 / 4194304.0
# Quarter-range minimax coefficients of cos and sin(t*pi/2)/t in z = t^2
# (pallas_link.py:450-455), rounded to f32 at use.
_COS_Z = (0.9999999997799593, -1.2337005342705918, 0.253669322476019,
          -0.020862687553451876, 0.0009177238850913491,
          -2.3824535570835603e-05)
_SINC_Z = (1.5707963267681528, -0.6459640955781804, 0.0796926037175787,
           -0.004681657796259286, 0.0001602546914451647,
           -3.4318293237942273e-06)

TILE_LADDER = (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32)
MAX_N = 256  # the kernel's warp-per-symbol layout holds up to 8 bins a lane
POWER_BLOCK = 16 * 256  # slice elements per power_partials block
METHOD_CODE = {EqualizationMethod.ZF: 0, EqualizationMethod.MMSE: 1, EqualizationMethod.NONE: 2}


# --- plain forms of the device functions (csrc/link_common.cuh) -------------


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device.  Scalars enter every division
    as tensors: PyTorch turns ``t / python_scalar`` into a reciprocal
    multiply on CUDA and ``python_scalar / t`` into one everywhere, which
    would not round like the kernel's division."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def uniform24_floored(w: torch.Tensor) -> torch.Tensor:
    """max(((w >> 8) & 0xFFFFFF) * 2^-24, 2^-24) in f32."""
    u = ((w >> 8) & 0xFFFFFF).to(torch.float32) * _INV_2_24
    return torch.clamp(u, min=_INV_2_24)


def _horner(z: torch.Tensor, coefs) -> torch.Tensor:
    acc = torch.full_like(z, float(np.float32(coefs[-1])))
    for c in coefs[-2::-1]:
        acc = acc * z + float(np.float32(c))
    return acc


def cossin_u24(u: torch.Tensor):
    """(cos, sin) of 2*pi*u/2^24 for integer u in [0, 2^24) (f32)."""
    q = u >> 22
    t = (u & 0x3FFFFF).to(torch.float32) * _INV_2_22
    z = t * t
    c = _horner(z, _COS_Z)
    s = t * _horner(z, _SINC_Z)
    swap = (q & 1) == 1
    c0 = torch.where(swap, s, c)
    s0 = torch.where(swap, c, s)
    c0 = torch.where(((q ^ (q >> 1)) & 1) == 1, -c0, c0)
    s0 = torch.where(q >= 2, -s0, s0)
    return c0, s0


@dataclasses.dataclass(frozen=True)
class Qam:
    """Square-QAM geometry: order M, side m, log2 m, log2 M, coding, f32 scale."""

    order: int
    m: int
    logm: int
    bits: int
    gray: bool
    scale: float

    @classmethod
    def of(cls, order: int, coding: str = "gray") -> "Qam":
        m = int(round(math.sqrt(order)))
        if m * m != order or order < 4:
            raise ValueError(f"not a square QAM order: {order}")
        scale = float(np.float32(make_constellation("QAM", order, coding).scale))
        return cls(order, m, m.bit_length() - 1, order.bit_length() - 1, coding == "gray", scale)


def qam_encode(raw: torch.Tensor, q: Qam):
    """raw words -> (tx index, re, im): the table point, computed arithmetically
    (pallas_link.py::_encode_tile, qam)."""
    tx = raw & (q.order - 1)
    if q.gray:
        row = tx >> q.logm
        col = tx & (q.m - 1)
        colz = torch.where((row & 1) == 1, q.m - 1 - col, col)
        g = (row << q.logm) | colz
        p = g ^ (g >> 1)
    else:
        p = tx
    c2 = (p & (q.m - 1)).to(torch.float32)
    r2 = (p >> q.logm).to(torch.float32)
    mm1 = float(q.m - 1)
    return tx, (2.0 * c2 - mm1) * q.scale, (mm1 - 2.0 * r2) * q.scale


def qam_demap(er: torch.Tensor, ei: torch.Tensor, q: Qam) -> torch.Tensor:
    """Slicer-unit points -> indices (pallas_link.py::_demap_tile, qam): round,
    clip in float, then convert, inverse Gray and zig-zag."""
    c0 = float(np.float32(q.m - 1) * np.float32(0.5))
    mf1 = float(q.m - 1)
    cc = torch.clamp(torch.round(er + c0), 0.0, mf1).to(torch.int64)
    rr = torch.clamp(torch.round(c0 - ei), 0.0, mf1).to(torch.int64)
    pp = rr * q.m + cc
    if not q.gray:
        return pp
    j = pp
    shift = 1
    while shift < q.bits:
        j = j ^ (j >> shift)
        shift <<= 1
    rowj = j >> q.logm
    colj = j & (q.m - 1)
    colzj = torch.where((rowj & 1) == 1, q.m - 1 - colj, colj)
    return (rowj << q.logm) | colzj


def inverse_gray(g: torch.Tensor, width: int) -> torch.Tensor:
    """Prefix-XOR inverse Gray code unrolled to a static ``width`` of bits
    (pallas_link._inv_gray_static): exact for any word narrower than it."""
    shift = 1
    while shift < width:
        g = g ^ (g >> shift)
        shift <<= 1
    return g


MODE_CODE = {"qam": 0, "psk": 1, "aqam": 2, "apsk": 3}
MAX_BITS = 12  # the codec's static width: orders up to 4096
# f32 cos and sin of pi / 2^(i+1), i < MAX_BITS: the PSK sector search's
# rotation constants and its half-sector test at order 2^(i+1), rounded from
# the same doubles as pallas_link.psk_sector_arith (np.float32(np.cos(ang)));
# csrc/link_common.cuh holds the same values.
ROT_COS = tuple(float(np.float32(np.cos(np.pi / 2.0 ** (i + 1)))) for i in range(MAX_BITS))
ROT_SIN = tuple(float(np.float32(np.sin(np.pi / 2.0 ** (i + 1)))) for i in range(MAX_BITS))


def psk_sector(er: torch.Tensor, ei: torch.Tensor, order: int) -> torch.Tensor:
    """round(angle(e) * M / 2pi) mod M by the reference's rotation search
    (pallas_link.psk_sector_arith): sign tests, then a binary search that
    rotates the point back by a constant phasor at each step, in f32 with
    the same constants and operation order."""
    m = order
    neg = ei < 0.0
    s = torch.where(neg, m // 2, 0)
    er, ei = torch.where(neg, -er, er), torch.where(neg, -ei, ei)
    if m >= 4:
        c = er < 0.0
        s = s + torch.where(c, m // 4, 0)
        er, ei = torch.where(c, ei, er), torch.where(c, -er, ei)
    i, step = 1, m // 8
    while step >= 1:
        ca, sa = ROT_COS[i], ROT_SIN[i]
        ni = ei * ca - er * sa
        t = ni >= 0.0
        s = s + torch.where(t, step, 0)
        nr = er * ca + ei * sa
        er, ei = torch.where(t, nr, er), torch.where(t, ni, ei)
        i, step = i + 1, step // 2
    b = m.bit_length() - 2
    t = ei * ROT_COS[b] - er * ROT_SIN[b] >= 0.0
    return (s + t.to(torch.int64)) & (m - 1)


def psk_sector_vec(er, ei, mrow, cpm, spm, bits: int) -> torch.Tensor:
    """``psk_sector`` at a per-lane order ``mrow`` (1 on inactive lanes, whose
    sector masks to 0), with the half-sector rows ``cpm``/``spm`` and a loop
    bound of the static width ``bits`` (pallas_link.psk_sector_arith_vec):
    a lane whose step has reached 0 stops accumulating and rotating."""
    neg = ei < 0.0
    s = torch.where(neg, mrow >> 1, 0)
    er, ei = torch.where(neg, -er, er), torch.where(neg, -ei, ei)
    if bits >= 2:
        c = (er < 0.0) & (mrow >= 4)
        s = s + torch.where(c, mrow >> 2, 0)
        er, ei = torch.where(c, ei, er), torch.where(c, -er, ei)
    for shift in range(3, bits + 1):
        step = mrow >> shift
        ca, sa = ROT_COS[shift - 2], ROT_SIN[shift - 2]
        ni = ei * ca - er * sa
        t = (ni >= 0.0) & (step >= 1)
        s = s + torch.where(t, step, 0)
        nr = er * ca + ei * sa
        er, ei = torch.where(t, nr, er), torch.where(t, ni, ei)
    t = ei * cpm - er * spm >= 0.0
    return (s + t.to(torch.int64)) & (mrow - 1)


@dataclasses.dataclass(frozen=True)
class Codec(Qam):
    """The constellation codec a chunk kernel runs: pallas_link._Spec's
    ``mode`` and ``bits`` with _consts_for's lane rows.

    * "qam": the Qam fields.
    * "psk": fixed M-PSK; ``order``, ``bits`` = log2 M and ``gray`` are read.
    * "aqam", "apsk": per-subcarrier orders (0 = inactive), always Gray;
      ``bits`` is the static width of the inverse-Gray unroll, at least
      log2 of the largest loaded order, and the orders ride int32 and f32
      lane rows read by bin index: aqam ``irows`` = [mask = order - 1,
      m = sqrt(order), log2 m], ``frows`` = [scale, slicer 0.5/scale] (an
      inactive lane has 0, 1, 0, 0, 0.5); apsk ``irows`` = [mask, order,
      log2 order], ``frows`` = [amplitude 0/1, cos(pi/M), sin(pi/M)] (an
      inactive lane has 0, 1, 0, 0, cos pi, sin pi)."""

    mode: str = "qam"
    irows: Optional[torch.Tensor] = None  # (3, n) int32
    frows: Optional[torch.Tensor] = None  # (2, n) or (3, n) f32

    @classmethod
    def qam(cls, order: int, coding: str = "gray") -> "Codec":
        return cls(**dataclasses.asdict(Qam.of(order, coding)))

    @classmethod
    def psk(cls, order: int, coding: str = "gray") -> "Codec":
        bits = order.bit_length() - 1
        if order < 2 or 1 << bits != order or bits > MAX_BITS:
            raise ValueError(f"not a PSK order the codec takes: {order}")
        return cls(order, 0, 0, bits, coding == "gray", 1.0, mode="psk")


def codec_for(setup, device):
    """(codec, slicer): a setup's codec on ``device`` and the f64 slicer-units
    gain folded into its ZF rows — a scalar for qam, a per-lane row for
    aqam, None for PSK, whose slicer is scale-free (pallas_link._consts_for
    :1059-1076, 1124-1153; _spec_for :821-847 for the static width)."""
    cfg = setup.cfg
    if setup.amap is None:
        const = setup.const
        if const.kind == "PSK":
            return Codec.psk(const.order, const.coding), None
        return Codec.qam(const.order, const.coding), 0.5 / const.scale
    orders = np.asarray(setup.amap.orders, np.int64)
    active = orders > 0
    bits = max(int(np.log2(cfg.max_constellation_order)), max(1, int(np.log2(max(int(orders.max()), 2)))))
    if bits > MAX_BITS:
        raise ValueError(f"adaptive orders above 2^{MAX_BITS}: {int(orders.max())}")
    mask = np.where(active, orders - 1, 0)
    if setup.amap.kind == "QAM":
        scales = np.zeros(len(orders), np.float64)
        for k, o in enumerate(orders):
            if o > 0:
                scales[k] = make_constellation("QAM", int(o)).scale
        slicer = 0.5 * np.where(active, 1.0 / np.where(scales == 0, 1.0, scales), 1.0)
        m_side = np.where(active, np.round(np.sqrt(np.maximum(orders, 1))), 1).astype(np.int64)
        logm = np.where(active, np.round(np.log2(np.maximum(m_side, 1))), 0).astype(np.int64)
        irows, frows, mode = [mask, m_side, logm], [scales, slicer], "aqam"
    else:
        slicer = None
        m_eff = np.where(active, np.maximum(orders, 1), 1).astype(np.int64)
        irows = [mask, m_eff, np.where(active, np.round(np.log2(m_eff)), 0)]
        frows = [active.astype(np.float64), np.cos(np.pi / m_eff), np.sin(np.pi / m_eff)]
        mode = "apsk"
    codec = Codec(0, 0, 0, bits, True, 0.0, mode=mode,
                  irows=torch.tensor(np.asarray(irows, np.int32), device=device),
                  frows=f32_tensor(np.asarray(frows), device))
    return codec, slicer


def _lane_rows(c: Codec):
    i = c.irows.to(torch.int64)
    return i[0], i[1], i[2]


def encode(raw: torch.Tensor, c: Codec):
    """raw words (..., n) -> (tx index, re, im) in the codec's mode
    (pallas_link._encode_tile).  PSK points come from ``cossin_u24`` at
    angle p << (24 - log2 M): the same polynomial pair as the noise phase."""
    if c.mode == "qam":
        return qam_encode(raw, c)
    if c.mode == "psk":
        tx = raw & (c.order - 1)
        p = inverse_gray(tx, c.bits) if c.gray else tx
        co, sn = cossin_u24(p << (24 - c.bits))
        return tx, co, sn
    mask, mrow, lrow = _lane_rows(c)
    tx = raw & mask
    if c.mode == "apsk":
        co, sn = cossin_u24(inverse_gray(tx, c.bits) << (24 - lrow))
        amp = c.frows[0]
        return tx, co * amp, sn * amp
    row = tx >> lrow
    col = tx & (mrow - 1)
    colz = torch.where((row & 1) == 1, mrow - 1 - col, col)
    g = (row << lrow) | colz
    p = g ^ (g >> 1)
    mf = mrow.to(torch.float32)
    c2 = (p & (mrow - 1)).to(torch.float32)
    r2 = (p >> lrow).to(torch.float32)
    scale = c.frows[0]
    return tx, (2.0 * c2 - (mf - 1.0)) * scale, ((mf - 1.0) - 2.0 * r2) * scale


def demap(er: torch.Tensor, ei: torch.Tensor, c: Codec) -> torch.Tensor:
    """Equalized points (..., n) -> indices in the codec's mode
    (pallas_link._demap_tile): QAM in slicer units, PSK scale-free."""
    if c.mode == "qam":
        return qam_demap(er, ei, c)
    if c.mode == "psk":
        sector = psk_sector(er, ei, c.order)
        return sector ^ (sector >> 1) if c.gray else sector
    _, mrow, lrow = _lane_rows(c)
    if c.mode == "apsk":
        sector = psk_sector_vec(er, ei, mrow, c.frows[1], c.frows[2], c.bits)
        return sector ^ (sector >> 1)
    mf = mrow.to(torch.float32)
    c0 = (mf - 1.0) * 0.5
    cc = torch.minimum(torch.clamp(torch.round(er + c0), min=0.0), mf - 1.0).to(torch.int64)
    rr = torch.minimum(torch.clamp(torch.round(c0 - ei), min=0.0), mf - 1.0).to(torch.int64)
    j = inverse_gray(rr * mrow + cc, c.bits)
    rowj = j >> lrow
    colj = j & (mrow - 1)
    colzj = torch.where((rowj & 1) == 1, mrow - 1 - colj, colj)
    return (rowj << lrow) | colzj


def check_codec(c: Codec, n: int, device):
    """Raise unless an adaptive codec's lane rows are contiguous (3, n) int32
    and (2 or 3, n) f32 rows on ``device``."""
    if c.mode not in MODE_CODE:
        raise ValueError(f"unknown codec mode {c.mode!r}")
    if c.mode not in ("aqam", "apsk"):
        return
    fr = 2 if c.mode == "aqam" else 3
    for t, dtype, shape in ((c.irows, torch.int32, (3, n)), (c.frows, torch.float32, (fr, n))):
        if t is None or t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"codec lane rows must be contiguous {dtype} {shape} on {device}")


def codec_args(c: Codec):
    """The codec's arguments of the kernels' C entry points: mode, order, m,
    log2 m, bits, gray, scale and the two lane-row pointers (null for qam
    and psk)."""
    return (MODE_CODE[c.mode], c.order, c.m, c.logm, c.bits, int(c.gray), c.scale,
            None if c.irows is None else c.irows.data_ptr(),
            None if c.frows is None else c.frows.data_ptr())


# --- host constants -----------------------------------------------------------


def slice_symbols(n: int) -> int:
    """Symbols per tile in the measured-power slice: >= 2^16 samples, >= 64 rows."""
    return max(64, -(-65536 // n))


def tile_cap(n: int, T: int) -> int:
    """Largest tile the reference admits for a diag link (pallas_link._plan's
    diag budget).  Kept so the per-tile power estimator sees the same tiles
    as the JAX package.  The budget's staging factor is fixed at its
    single-pass value: the port ignores ``matmul_passes``.  The JAX
    package's cap differs from this one only where it stages three bf16
    passes (1024-QAM, or matmul_passes=3) and T lies just below a tile
    step (T in 155-156, 309-312 or 610-621 for n <= 256)."""
    return _budget_tile(max(1, 128 // n) ** 2 * n * T + 128 * 128, T)


def fold_tile_cap(n: int, T: int, E: int, is_sc: bool) -> int:
    """Largest tile the reference admits for a fold link (pallas_link._plan's
    "mm" budget with fold staging: F_tx,ext, the merged conv+RX matrix and,
    for SC-FDE, the IDFT; activation planes T+E wide).  Same fixed staging
    factor as ``tile_cap``."""
    TE = T + E
    return _budget_tile(n * TE + TE * n + (n * n if is_sc else 0), TE)


def mm_tile_cap(n: int, T: int, E: int, is_sc: bool) -> int:
    """Largest tile the reference admits for a zero-prefix mm link
    (pallas_link._plan's "mm" budget without fold: F_tx,ext, the merged
    conv, the overlap-add + DFT matrix and, for SC-FDE, the IDFT;
    activation planes T+E wide).  Same fixed staging factor as
    ``tile_cap``."""
    TE = T + E
    return _budget_tile(TE * T + n * TE + n * T + (n * n if is_sc else 0), TE)


def lr_tile_cap(n: int, T: int, E: int, rank: int, txext: bool) -> int:
    """Largest tile the reference admits for an lr link (pallas_link._plan's
    lr budget): TailM, the stacked [Cr; Cp], the noise factor (at least one
    group of 8 rows, zero for iid noise) and, unless the PAPR statistic is
    external, the TX matrix; activation planes T wide.  From 4096
    subcarriers the reference raises the scoped budget
    (_VMEM_SCOPED_GIANT_LR).  Same fixed staging factor as ``tile_cap``."""
    ep = max(8, -(-E // 8) * 8)
    rp = max(8, -(-max(rank, 1) // 8) * 8)
    staged = n * ep + 2 * ep * n + rp * n + (128 * 128 if txext else n * T)
    return _budget_tile(staged, T, 119_000_000 if n >= 4096 else 72_000_000)


def _budget_tile(staged: int, width: int, scoped: int = 72_000_000) -> int:
    """_plan's scoped-VMEM rule: staged matrices at 3 bf16 splits x 2 buffers,
    plus 14 live (tile, width) f32 planes, within ``scoped`` bytes."""
    fixed = 2 * 3 * staged
    for tile in TILE_LADDER:
        if fixed + 4 * 14 * tile * width <= scoped:
            return tile
    return TILE_LADDER[-1]


def tile_for(chunk: int, cap: int) -> int:
    """The largest ladder tile <= cap that divides the chunk; failing that, the
    largest that fits in it (the last tile is then ragged)."""
    for t in TILE_LADDER:
        if t <= cap and chunk % t == 0:
            return t
    return next((t for t in TILE_LADDER if t <= min(cap, chunk)), TILE_LADDER[-1])


def sampled_symbols(chunk: int, tile: int, pstride: int) -> int:
    """Symbols of a chunk whose tiles feed the PAPR statistic."""
    return sum(min(tile, chunk - t * tile) for t in range(0, -(-chunk // tile), pstride))


def snr_linear(snr_db: float) -> float:
    """exp(snr_db * f32(ln 10 / 10)) in f32 (pallas_link.py:1426)."""
    s = torch.tensor(snr_db, dtype=torch.float32)
    return float(torch.exp(s * float(np.float32(np.log(10.0) / 10.0))))


@dataclasses.dataclass(frozen=True)
class DiagLink:
    """Everything the diag chunk reads: f32 rows on one device plus scalars."""

    n: int
    T: int
    q: Codec
    slicer: float  # f32(0.5) / f32(scale) for qam, else 1
    cg: float  # f32 mean |h|^2
    method: int  # METHOD_CODE
    add_noise: bool
    pstride: int
    tile_cap: int
    slice: int
    hr: torch.Tensor  # (n,)
    hi: torch.Tensor
    habs2: torch.Tensor
    gr: torch.Tensor  # ZF gain rows, slicer folded in
    gi: torch.Tensor
    fr: torch.Tensor  # (n, T) IDFT + CP
    fi: torch.Tensor


def f32_tensor(a, device) -> torch.Tensor:
    """A contiguous f32 tensor of a host float64 array, on ``device``."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def equalizer_fields(setup, device) -> dict:
    """The fields every chunk kernel shares (pallas_link._consts_for's rows,
    :1049-1106 and :1155): the codec, the scalar slicer gain (0.5/scale for
    qam; 1 for PSK, whose demap is scale-free, and for aqam, whose gain is
    the codec's per-lane row), mean |h|^2, method and noise switches, the
    measured-power slice, and the f32 rows h, |h|^2 and the ZF gain with
    the slicer gain folded in (qam and aqam; raw for PSK)."""
    cfg = setup.cfg
    n = cfg.num_subcarriers
    h = np.asarray(setup.h_freq, np.complex128)
    codec, slicer = codec_for(setup, device)
    h_z = np.where(h == 0, np.complex128(1e-10), h)
    zf_g = 1.0 / h_z
    if cfg.equalization_method == EqualizationMethod.ZF and slicer is not None:
        zf_g = zf_g * slicer
    return dict(
        n=n,
        q=codec,
        slicer=float(np.float32(0.5) / np.float32(codec.scale)) if codec.mode == "qam" else 1.0,
        cg=float(np.float32(np.mean(np.abs(h) ** 2))),
        method=METHOD_CODE[cfg.equalization_method],
        add_noise=cfg.noise_type == NoiseType.AWGN,
        slice=slice_symbols(n),
        hr=f32_tensor(h.real, device),
        hi=f32_tensor(h.imag, device),
        habs2=f32_tensor(np.abs(h) ** 2, device),
        gr=f32_tensor(zf_g.real, device),
        gi=f32_tensor(zf_g.imag, device),
    )


def diag_link(setup, device) -> DiagLink:
    """Host constants of a diag link (pallas_link._consts_for, diag branch).

    Checks that TX -> channel -> RX is exactly diag(h_freq) before anything
    runs on it."""
    cfg = setup.cfg
    n, L = cfg.num_subcarriers, setup.prefix_length
    T = n + L
    d = linops.diag_response(np.asarray(setup.taps), n, cfg.prefix_type, L)
    if not np.allclose(d, np.asarray(setup.h_freq, np.complex128), rtol=1e-5, atol=1e-7):
        raise ValueError("diag link: diag(F_tx C R) != h_freq")
    ftx_r, ftx_i = linops.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    return DiagLink(
        T=T,
        pstride=cfg.papr_stride or 32,
        tile_cap=tile_cap(n, T),
        fr=f32_tensor(ftx_r, device),
        fi=f32_tensor(ftx_i, device),
        **equalizer_fields(setup, device),
    )


def _chunk_geometry(link: DiagLink, chunk: int):
    tile = tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    groups = -(-min(link.slice, tile) * link.n // POWER_BLOCK)
    last_sampled_tile = ((tiles - 1) // link.pstride) * link.pstride
    carry_sym = min((last_sampled_tile + 1) * tile, chunk) - 1
    return tile, tiles, groups, carry_sym


def papr_samples(link: DiagLink, chunk: int) -> int:
    """Time samples one chunk contributes to the PAPR statistic."""
    tile = tile_for(chunk, link.tile_cap)
    return sampled_symbols(chunk, tile, link.pstride) * link.T


# --- plain version of the chunk ----------------------------------------------


def _tile_sigma(pw: torch.Tensor, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale=1.0):
    """Per-tile sigma from |y|^2 (chunk, width): the mean over the first
    ``slice_syms`` symbols (all ``width`` samples of each) of every tile,
    summed in power_partials' order: 16 sequential steps per thread, a
    256-way tree per block, then the tile's blocks in order; the mean is
    scaled by ``pw_scale``."""
    flat = pw.reshape(-1)
    width = pw.shape[1]
    seg = torch.zeros((tiles, groups * POWER_BLOCK), dtype=torch.float32, device=pw.device)
    counts = []
    for t in range(tiles):
        b0 = t * tile
        count = min(slice_syms, min(tile, chunk - b0)) * width
        seg[t, :count] = flat[b0 * width : b0 * width + count]
        counts.append(count)
    v = seg.view(tiles, groups, 16, 256)
    acc = torch.zeros((tiles, groups, 256), dtype=torch.float32, device=pw.device)
    for j in range(16):
        acc = acc + v[:, :, j, :]
    s = 128
    while s >= 1:
        acc = acc[..., :s] + acc[..., s : 2 * s]
        s >>= 1
    parts = acc[..., 0]
    tot = torch.zeros((tiles,), dtype=torch.float32, device=pw.device)
    for g in range(groups):
        tot = tot + parts[:, g]
    cnt = torch.tensor(counts, dtype=torch.float32, device=pw.device)
    mp = (tot / cnt) * _f32(pw_scale, tot)
    return torch.sqrt(mp / _f32(snr_lin, mp) / _f32(2.0, mp))


def block_sum(v: torch.Tensor, threads: int) -> torch.Tensor:
    """Sum over the last axis in a kernel block's order (link_common.cuh):
    element k belongs to thread k % threads, which sums its elements in k
    order; each warp sums its 32 threads by an xor butterfly; then the warps
    are summed in order.  threads = 32 is the one-warp case."""
    n = v.shape[-1]
    J = -(-n // threads)
    v = torch.nn.functional.pad(v, (0, threads * J - n)).reshape(*v.shape[:-1], J, threads)
    p = torch.zeros(v.shape[:-2] + (threads,), dtype=v.dtype, device=v.device)
    for j in range(J):
        p = p + v[..., j, :]
    p = p.reshape(*p.shape[:-1], threads // 32, 32)
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ off]
    tot = torch.zeros(p.shape[:-2], dtype=v.dtype, device=v.device)
    for w in range(threads // 32):
        tot = tot + p[..., w, 0]
    return tot


def _mmse_nv(link: DiagLink, yr, yi, snr_lin, threads=32):
    """Per-symbol noise variance, |y|^2 summed in the order of a kernel
    whose ``threads`` threads share a symbol (a warp for diag and fold, a
    block for lr)."""
    sp = block_sum(yr * yr + yi * yi, threads)[:, None]
    sp = sp / _f32(link.n, sp)
    return sp / _f32(snr_lin, sp) / _f32(link.cg, sp)


def box_muller(w1, w2):
    """(z0, z1) of the link's noise chain: radius sqrt(-2 ln u1) with u1 from
    w1's 24 bits floored at 2^-24, phase from w2's 24 bits."""
    rad = torch.sqrt(-2.0 * torch.log(uniform24_floored(w1)))
    co, sn = cossin_u24((w2 >> 8) & 0xFFFFFF)
    return rad * co, rad * sn


def awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale=1.0, extra=None):
    """y + sigma * z, z = Box-Muller(w1, w2) (+ ``extra``, the colored part),
    sigma per tile from |y|^2 of its first ``slice_syms`` symbols times
    ``pw_scale``; y is (chunk, width) of bins or time samples."""
    sig = _tile_sigma(yr * yr + yi * yi, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale)
    sigma = sig.repeat_interleave(tile)[:chunk, None]
    zr, zi = box_muller(w1, w2)
    if extra is not None:
        zr, zi = zr + extra[0], zi + extra[1]
    return yr + sigma * zr, yi + sigma * zi


def equalize(link, yr, yi, snr_lin, threads=32):
    """ZF / MMSE / no equalizer, in slicer units (the slicer gain folded in:
    the scalar for qam, the codec's per-lane row for aqam, none for PSK);
    MMSE sums |y|^2 in the order of ``threads`` threads a symbol."""
    hr, hi = link.hr, link.hi
    lane_slicer = link.q.frows[1] if link.q.mode == "aqam" else None
    if link.method == 0:
        gr, gi = link.gr, link.gi
        return yr * gr - yi * gi, yi * gr + yr * gi
    if link.method == 1:
        nv = _mmse_nv(link, yr, yi, snr_lin, threads)
        g = (_f32(link.slicer, nv) if lane_slicer is None else lane_slicer) / (link.habs2 + nv)
        return (yr * hr + yi * hi) * g, (yi * hr - yr * hi) * g
    if lane_slicer is not None:
        return yr * lane_slicer, yi * lane_slicer
    if link.q.mode != "qam":
        return yr, yi
    return yr * link.slicer, yi * link.slicer


def count_errors(link, tx, er, ei, acc):
    """Slice (er, ei) and add the bit and symbol errors against tx into acc."""
    rx = demap(er, ei, link.q)
    acc[0] += metrics.index_bit_errors(tx, rx)
    acc[1] += metrics.symbol_errors(tx, rx)


def cmatmul(fr, fi, sr, si):
    """x = s @ F, complex, in the kernels' per-output accumulation order: k
    ascending, each term (a*f_r - c*f_i) / (a*f_i + c*f_r) rounded before
    it is added."""
    xr = torch.zeros((sr.shape[0], fr.shape[1]), dtype=torch.float32, device=sr.device)
    xi = torch.zeros_like(xr)
    for k in range(fr.shape[0]):
        a = sr[:, k : k + 1]
        c = si[:, k : k + 1]
        f_r = fr[k]
        f_i = fi[k]
        xr = xr + (a * f_r - c * f_i)
        xi = xi + (a * f_i + c * f_r)
    return xr, xi


def add_papr(xr, xi, acc, psum):
    """Fold a time plane's PAPR peak (f32 bits, max) and power sum into acc/psum."""
    peak, total, _ = metrics.papr_stats(xr, xi)
    acc[2] = max(int(acc[2]), f32_bits(float(peak)))
    psum += total


def f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def bits_f32(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", int(b) & 0xFFFFFFFF))[0]


def diag_chunk_plain(
    link: DiagLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    words=None,
):
    """Plain version of ``diag_chunk`` (same arguments, same effects).

    ``words`` = (raw, u1 word, u2 word) injects (chunk, n) integer planes in
    place of the Philox draw (tests feed zeros or numpy words)."""
    dev = acc.device
    n = link.n
    tile, tiles, groups, carry_sym = _chunk_geometry(link, chunk)
    if words is None:
        words = prng.link_words(key, sym0, chunk, n, dev)
    raw, w1, w2 = (torch.as_tensor(w).to(device=dev, dtype=torch.int64) & prng.M32 for w in words)
    if raw.shape != (chunk, n):
        raise ValueError(f"words must be ({chunk}, {n}) planes, got {tuple(raw.shape)}")
    tx, sr, si = encode(raw, link.q)
    hr, hi = link.hr, link.hi
    yr = sr * hr - si * hi
    yi = sr * hi + si * hr
    if link.add_noise:
        yr, yi = awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, link.slice)
    er, ei = equalize(link, yr, yi, snr_lin)
    count_errors(link, tx, er, ei, acc)

    rows = (torch.arange(chunk, device=dev) // tile) % link.pstride == 0
    xr, xi = cmatmul(link.fr, link.fi, sr[rows], si[rows])
    add_papr(xr, xi, acc, psum)
    # sampled rows are in symbol order: the last one is symbol carry_sym
    return xr[-1].clone(), xi[-1].clone()


# --- kernel wrappers ----------------------------------------------------------


def new_accumulators(device):
    """(acc, psum): int64 [bit errors, symbol errors, PAPR peak f32 bits] and
    the float64 PAPR power sum, zeroed on ``device``."""
    return (
        torch.zeros(3, dtype=torch.int64, device=device),
        torch.zeros(1, dtype=torch.float64, device=device),
    )


def _check_link_tensors(link: DiagLink, device):
    for name in ("hr", "hi", "habs2", "gr", "gi", "fr", "fi"):
        t = getattr(link, name)
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"link.{name} must be contiguous f32 on {device}")
    if link.hr.shape != (link.n,) or link.fr.shape != (link.n, link.T):
        raise ValueError("link rows have the wrong shape")
    if not 1 <= link.n <= MAX_N:
        raise ValueError(f"diag kernel takes 1 <= n <= {MAX_N}, got {link.n}")
    check_codec(link.q, link.n, device)


def chunk_workspace(link: DiagLink, chunk: int, device):
    """(partials, carry_r, carry_i): the scratch ``diag_chunk`` needs for
    chunks of ``chunk`` symbols, so that a run allocates it once."""
    _, tiles, groups, _ = _chunk_geometry(link, chunk)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty(tiles * groups, **f32), torch.empty(link.T, **f32), torch.empty(link.T, **f32)


def diag_chunk(
    link: DiagLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    work=None,
):
    """One chunk of run symbols [sym0, sym0 + chunk): adds its bit errors,
    symbol errors and PAPR peak bits into ``acc`` and its PAPR power sum
    into ``psum``, on the accumulators' device.  Returns the carry row
    (re, im): the TX time row of the chunk's last sampled symbol, written
    into ``work`` (a ``chunk_workspace`` for this chunk size) when given.

    CUDA tensors launch the fused kernel (csrc/link_kernel.cu): with noise
    on, ``power_partials`` and then ``diag_main``, counted apart in
    ``diag_chunk.power_launches`` and ``diag_chunk.launches``.  CPU tensors
    run ``diag_chunk_plain``."""
    dev = acc.device
    if dev.type == "cpu":
        return diag_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum)
    if dev.type != "cuda":
        raise ValueError(f"diag_chunk runs on cpu or cuda, not {dev}")
    if acc.dtype != torch.int64 or acc.shape != (3,) or psum.dtype != torch.float64 or psum.shape != (1,):
        raise ValueError("acc must be int64 (3,) and psum float64 (1,)")
    if psum.device != dev or not (acc.is_contiguous() and psum.is_contiguous()):
        raise ValueError("acc and psum must be contiguous on one device")
    _check_link_tensors(link, dev)
    if not 1 <= chunk <= (2**31 - 1) // link.n:
        raise ValueError(f"chunk out of range: {chunk}")
    tile, tiles, groups, carry_sym = _chunk_geometry(link, chunk)
    partials, carry_r, carry_i = chunk_workspace(link, chunk, dev) if work is None else work
    for t, size in ((partials, tiles * groups), (carry_r, link.T), (carry_i, link.T)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() < size:
            raise ValueError(f"work must be chunk_workspace(link, {chunk}, {dev})")
    from ofdm_tpu_torch import build

    lib = build.load("link_kernel")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ofdm_diag_chunk(
            link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(),
            link.gr.data_ptr(), link.gi.data_ptr(), link.fr.data_ptr(), link.fi.data_ptr(),
            link.n, link.T, *codec_args(link.q), link.slicer, snr_lin, link.cg,
            link.method, int(link.add_noise),
            sym0,
            chunk, tile, link.slice, groups, link.pstride,
            carry_sym,
            key[0], key[1],
            partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
            carry_r.data_ptr(), carry_i.data_ptr(), stream,
        )
    build.check(lib, code, "ofdm_diag_chunk")
    if link.add_noise:
        diag_chunk.power_launches += 1
    diag_chunk.launches += 1
    return carry_r, carry_i


diag_chunk.launches = 0  # diag_main kernels launched
diag_chunk.power_launches = 0  # power_partials kernels launched


def boxmuller_sample_plain(seed0: int, seed1: int, shape, device="cpu"):
    """Plain version of ``boxmuller_sample``."""
    count = int(np.prod(shape))
    key = (int(seed0) & prng.M32, int(seed1) & prng.M32)
    i = torch.arange(count, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    _, w1, w2, _ = prng.philox4x32_10(i & prng.M32, i >> 32, zero, zero, key)
    z0, z1 = box_muller(w1, w2)
    return z0.view(shape), z1.view(shape)


def boxmuller_sample(seed0: int, seed1: int, shape, device="cuda"):
    """(z0, z1) N(0,1) f32 planes of ``shape`` from the link's exact noise
    chain (pallas_link.py::boxmuller_sample): the ``ofdm_boxmuller`` kernel
    on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return boxmuller_sample_plain(seed0, seed1, shape, device)
    if device.type != "cuda":
        raise ValueError(f"boxmuller_sample runs on cpu or cuda, not {device}")
    count = int(np.prod(shape))
    if count < 1:
        raise ValueError(f"empty shape {shape}")
    from ofdm_tpu_torch import build

    lib = build.load("boxmuller")
    z0 = torch.empty(shape, dtype=torch.float32, device=device)
    z1 = torch.empty(shape, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ofdm_boxmuller(z0.data_ptr(), z1.data_ptr(), count,
                  int(seed0) & prng.M32, int(seed1) & prng.M32, stream)
    build.check(lib, code, "ofdm_boxmuller")
    boxmuller_sample.launches += 1
    return z0, z1


boxmuller_sample.launches = 0
