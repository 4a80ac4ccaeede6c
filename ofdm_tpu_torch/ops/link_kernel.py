"""The fused diag-mode chunk, the constellation codec and the Box-Muller sampler.

Counterpart of ``ofdm_tpu/ops/pallas_link.py`` for the diag chain: its
``kernel`` in conv="diag" form (``csrc/link_kernel.cu`` up to 256
subcarriers, a warp a symbol; ``csrc/diag_wide_kernel.cu`` past them, a
block a symbol up to 4096 and a thread-block cluster of one block a
``CLUSTER_BINS`` slice past that, up to 32768), in each constellation mode — qam, psk, aqam
and apsk (``Codec``: fixed square QAM, fixed M-PSK, and their
per-subcarrier CAPACITY_BASED forms) — and ``boxmuller_sample``
(``csrc/boxmuller.cu``).  Beside each kernel sits its
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
cos/sin lattice, per-subcarrier rows under adaptive loading) -> [x sqrt(P)]
-> y = s * d (d = ``linops.diag_response`` of the unit-energy taps, which
is the raw-IR ``h_freq`` wherever the IR has unit energy) -> AWGN with
sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2 over the first
``slice`` symbols of the bin's tile -> ZF / MMSE / none against the raw
``h_freq`` with the slicer gain folded in (QAM only) -> [post-EQ noise]
-> [x 1/sqrt(P)] -> [x f, the tile's unit-power factor, with the slicer
gain] -> float-clipped slicer or PSK sector -> popcount of tx ^ rx into
int64 counters.  Every ``pstride``-th tile of a chunk also computes the
IDFT+CP time plane for the PAPR max and sum, but under ``txext`` (from 512
subcarriers without ``apply_power``; pallas_link.py:882-887), where the
runner's sampled TX batch supplies the statistic.

The bracketed stages are ``_Spec``'s (pallas_link.py:709-731):
``apply_power`` and ``normalize`` follow ``SimulationConfig``'s
``apply_power_allocation`` and ``normalize_before_demap`` on every chain;
``post_noise`` and ``compensate`` are the noise-bump study's
(``noise_bump_link``), on every chain, after the SC-FDE IDFT where there
is one (so indexed by time sample there).  Their per-lane rows (sqrt(P),
1/sqrt(P), the post-EQ sigma) are an argument of the chunk, not link
constants, so one link serves every SNR point and scenario.  A fifth,
``dump`` (every chain; a chunk's ``dump`` argument), writes the first
symbols' points of the pass that counts, in data units, for symbol
capture (``dump_points``; ``pipeline.LinkRunner.capture``).  The
normalization mean covers every symbol of a tile, so it is summed in a
fixed order (``tile_norm``) that the kernels repeat: per symbol as the
MMSE mean is, per run of consecutive symbols in order, then a tile's runs
by ``norm_factors``' tree.  A diag symbol is summed by a warp up to 256
subcarriers and by a block of 256 threads past them (``diag_layout``);
past ``CLUSTER_BINS`` each block of a cluster sums its slice so, and the
slices' sums are added in slice order (``block_sum``'s ``slice``).
The diag kernels run a normalized chunk's chain once, into a scratch
plane of whole-tile slabs (``onepass_slab``), and count in a demap kernel
(csrc/diag_common.cuh); the plain version builds e once as well.

Host constants and rules kept from the reference: ``_consts_for``'s diag
and codec rows (:1049-1161), ``_spec_for``'s tile rule (:795-799) with
``_plan``'s diag tile cap and staged limit (its staging factor from
``selected_passes``; ``diag_fits``), its lr budget (``lr_fits``,
``lr_tile_cap``), its dense "mm" / "mm4" rule (``fold_fits``,
``mm_fits``, whose tiles ``fold_tile_cap`` and ``mm_tile_cap`` give) and
its "taps" rule (``taps_tile``), its static codec width (:821-847), and the
measured-power slice (:1691-1694).  The wide fold and mm chains' TX
block and stream convolution (``wide_tx``, ``stream_conv``) live here
too, shared by ``ops.fold_kernel`` and ``ops.mm_kernel``.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import EqualizationMethod, ModulationType, NoiseType
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
MAX_N = 32768  # diag_wide: 16 bins a thread, a cluster of up to 8 blocks a symbol
# Bins one block of diag_wide and lr_main holds (16 a thread of 256); a wider
# symbol spans ceil(n / CLUSTER_BINS) blocks of one thread-block cluster,
# each summing its slice, the slices' sums then added in slice order.
CLUSTER_BINS = 4096
# The one-pass normalize's scratch (csrc/diag_common.cuh): e (2 x f32) and
# the TX index (u16) a bin, for a slab of whole tiles of at most
# ONEPASS_SLAB_BINS bins (671 MB; a slab of one tile past it).
ONEPASS_BYTES_PER_BIN = 10
ONEPASS_SLAB_BINS = 1 << 26
WARP_MAX_N = 256  # diag_main's warp-per-symbol layout holds up to 8 bins a lane
POWER_BLOCK = 16 * 256  # slice elements per power_partials block
RUN = 8  # consecutive symbols a warp of the staged diag kernel walks
WIDE_RUN = 16  # consecutive symbols a block of diag_wide walks
WIDE_THREADS = 256  # diag_wide's block, one symbol
NORM_THREADS = 256  # threads of norm_factors, one block a tile
# Stage bits of the kernels' C entry points (pallas_link._Spec's switches).
STAGE_POWER, STAGE_NORMALIZE, STAGE_POST_NOISE, STAGE_COMPENSATE, STAGE_DUMP = 1, 2, 4, 8, 16
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


def adaptive_bits(setup) -> int:
    """The static codec width of an adaptive setup (_spec_for :821-847): log2
    of the config's largest order or of the largest loaded one, whichever
    is wider; the kernels take up to MAX_BITS."""
    top = max(int(np.max(setup.amap.orders)), 2)
    return max(int(np.log2(setup.cfg.max_constellation_order)), max(1, int(np.log2(top))))


def adaptive_supported(setup) -> bool:
    """Whether the kernels' codec takes an adaptive setup's orders: the JAX
    package's rule (pallas_link._adaptive_supported: some lane active, every
    active order square QAM or a power-of-2 PSK) within the codec's width."""
    orders = np.asarray(setup.amap.orders, np.int64)
    active = orders[orders > 0]
    if active.size == 0 or adaptive_bits(setup) > MAX_BITS:
        return False
    if setup.amap.kind == "QAM":
        roots = np.round(np.sqrt(active.astype(np.float64)))
        return bool(np.all(roots * roots == active))
    return bool(np.all(2 ** np.round(np.log2(active.astype(np.float64))) == active))


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
    bits = adaptive_bits(setup)
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


def selected_passes(setup) -> int:
    """The bf16 passes the JAX kernel stages for a setup's link
    (pallas_link.selected_passes, host f64): ``matmul_passes`` when set,
    else 1 when the constellation's decision half-distance (the QAM scale,
    or sin(pi/M) for PSK; the largest loaded order under adaptive loading)
    is at least 0.07, else 3.  The port computes in f32 either way; the
    count feeds only the tile rule, so that the per-tile estimators see
    the JAX package's tiles."""
    cfg = setup.cfg
    if cfg.matmul_passes != "auto":
        return int(cfg.matmul_passes)
    is_qam = cfg.constellation_type.value == "QAM"
    if setup.amap is not None:
        active = np.asarray(setup.amap.orders)
        active = active[active > 0]
        if active.size == 0:
            return 1
        worst = int(active.max())
    else:
        worst = cfg.constellation_order
    if is_qam:
        half_d = float(make_constellation("QAM", worst).scale)
    else:
        half_d = float(np.sin(np.pi / worst))
    return 1 if half_d >= 0.07 else 3


def _diag_staged(n: int, T: int, txext: bool) -> int:
    """pallas_link._plan's staged diag elements: the lane-packed TX matrix
    and the MMSE segment matrix, or only the latter under ``txext``."""
    return 128 * 128 if txext else max(1, 128 // n) ** 2 * n * T + 128 * 128


def diag_fits(n: int, T: int, passes: int = 1, txext: bool = False) -> bool:
    """Whether the reference admits a diag link at all: its staged matrices
    within _VMEM_STAGED_LIMIT (40e6 bytes; pallas_link.py:201).  Where they
    are not, no fused kernel of the JAX package takes the link."""
    return 2 * (3 if passes == 1 else 6) * _diag_staged(n, T, txext) <= 40_000_000


def tile_cap(n: int, T: int, passes: int = 1, txext: bool = False) -> int:
    """Largest tile the reference admits for a diag link (pallas_link._plan's
    diag budget) at ``passes`` bf16 passes (``selected_passes``).  Kept so
    the per-tile power estimator sees the same tiles as the JAX package."""
    return _budget_tile(_diag_staged(n, T, txext), T, passes)


def txext_for(cfg) -> bool:
    """Whether a diag or lr link takes its PAPR statistic from the runner's
    sampled TX batch (pallas_link.py:882-887): from 512 subcarriers, unless
    papr_stride is 1 or the power allocation is applied (the sampled batch
    is unscaled)."""
    return cfg.num_subcarriers >= 512 and cfg.papr_stride != 1 and not cfg.apply_power_allocation


def _fold_staged(n: int, T: int, E: int, is_sc: bool) -> int:
    """pallas_link._plan's staged "mm" elements with fold: F_tx,ext, the
    merged conv+RX matrix and, for SC-FDE, the IDFT."""
    TE = T + E
    return n * TE + TE * n + (n * n if is_sc else 0)


def _mm_staged(n: int, T: int, E: int, is_sc: bool) -> int:
    """pallas_link._plan's staged "mm" elements without fold: F_tx,ext, the
    merged conv, the overlap-add + DFT matrix and, for SC-FDE, the IDFT."""
    TE = T + E
    return TE * T + n * TE + n * T + (n * n if is_sc else 0)


def _dense_tile(staged: int, width: int, passes: int) -> Optional[int]:
    """pallas_link._plan's rule for the dense chains: "mm" at u = 3 (6 at
    three passes) bf16 splits, then, at one pass only, "mm4" at u = 2; the
    first whose staged matrices x 2 buffers stay within
    _VMEM_STAGED_LIMIT (40e6 bytes) and whose stack of 14 live (tile,
    width) f32 planes fits the 72e6-byte scoped budget at some ladder tile
    gives the tile.  None: no fused kernel of the JAX package takes the
    link (its XLA path runs it)."""
    for u in ((3,) if passes == 1 else (6,)) + ((2,) if passes == 1 else ()):
        fixed = 2 * u * staged
        if fixed > 40_000_000:
            continue
        for tile in TILE_LADDER:
            if fixed + 4 * 14 * tile * width <= 72_000_000:
                return tile
    return None


def fold_fits(n: int, T: int, E: int, is_sc: bool, passes: int = 1) -> bool:
    """Whether the reference admits a fold link at all ("mm" or "mm4" with
    fold staging, ``_dense_tile``)."""
    return _dense_tile(_fold_staged(n, T, E, is_sc), T + E, passes) is not None


def mm_fits(n: int, T: int, E: int, is_sc: bool, passes: int = 1) -> bool:
    """Whether the reference admits a zero-prefix mm link at all ("mm" or
    "mm4" without fold, ``_dense_tile``)."""
    return _dense_tile(_mm_staged(n, T, E, is_sc), T + E, passes) is not None


def fold_tile_cap(n: int, T: int, E: int, is_sc: bool, passes: int = 1) -> int:
    """Largest tile the reference admits for a fold link (``_dense_tile``
    with fold staging; activation planes T+E wide), the ladder's smallest
    where it admits none."""
    return _dense_tile(_fold_staged(n, T, E, is_sc), T + E, passes) or TILE_LADDER[-1]


def mm_tile_cap(n: int, T: int, E: int, is_sc: bool, passes: int = 1) -> int:
    """Largest tile the reference admits for a zero-prefix mm link
    (``_dense_tile`` without fold; activation planes T+E wide), the
    ladder's smallest where it admits none."""
    return _dense_tile(_mm_staged(n, T, E, is_sc), T + E, passes) or TILE_LADDER[-1]


def _lr_staged(n: int, T: int, E: int, rank: int, txext: bool) -> int:
    """pallas_link._plan's staged lr elements: TailM, the stacked [Cr; Cp],
    the noise factor (at least one group of 8 rows, zero for iid noise)
    and, unless the PAPR statistic is external, the (n, T) TX matrix."""
    ep = max(8, -(-E // 8) * 8)
    rp = max(8, -(-max(rank, 1) // 8) * 8)
    return n * ep + 2 * ep * n + rp * n + (128 * 128 if txext else n * T)


def _lr_scoped(n: int) -> int:
    """The lr row's scoped budget: raised from 4096 subcarriers
    (_VMEM_SCOPED_GIANT_LR, pallas_link.py:93-94)."""
    return 119_000_000 if n >= 4096 else 72_000_000


def lr_fits(n: int, T: int, E: int, rank: int, txext: bool, passes: int = 1) -> bool:
    """Whether the reference admits an lr link at all (pallas_link._plan's
    lr row): its staged matrices x 2 buffers within _VMEM_STAGED_LIMIT
    (40e6 bytes) and some ladder tile's 14 live (tile, T) f32 planes
    within the scoped budget.  The boundary is a TPU VMEM budget, kept so
    the port routes as the JAX package does: a link it refuses (the in-run
    PAPR's TX matrix from about 3000 subcarriers, for one) runs the dense
    chains where they fit, else the eager chain."""
    fixed = 2 * (3 if passes == 1 else 6) * _lr_staged(n, T, E, rank, txext)
    return fixed <= 40_000_000 and fixed + 4 * 14 * TILE_LADDER[-1] * T <= _lr_scoped(n)


def lr_tile_cap(n: int, T: int, E: int, rank: int, txext: bool, passes: int = 1) -> int:
    """Largest tile the reference admits for an lr link (pallas_link._plan's
    lr budget, ``_lr_staged``; activation planes T wide): 64-128 at 8192
    subcarriers, 32-64 at 16384 and 32 at 32768, from 4096 under the raised
    scoped budget (``_lr_scoped``)."""
    return _budget_tile(_lr_staged(n, T, E, rank, txext), T, passes, _lr_scoped(n))


MAX_KERNEL_TAPS = 16  # pallas_link._MAX_KERNEL_TAPS: the taps kernel's static tap loop


def taps_tile(n: int, T: int, n_taps: int, is_sc: bool, passes: int = 1) -> Optional[int]:
    """pallas_link._plan's "taps" row, tried under hotpath="pallas" only and
    after every other: the tile whose stack of 4 live (tile, T) f32 planes
    fits the scoped budget beside the staged TX and RX DFT matrices (and
    the SC-FDE IDFT), or None where the channel has more than
    ``MAX_KERNEL_TAPS`` taps or the matrices exceed the staged limit."""
    if not 0 < n_taps <= MAX_KERNEL_TAPS:
        return None
    fixed = 2 * (3 if passes == 1 else 6) * (2 * n * T + (n * n if is_sc else 0))
    if fixed > 40_000_000:
        return None
    return next((t for t in TILE_LADDER if fixed + 4 * 4 * t * T <= 72_000_000), None)


def _budget_tile(staged: int, width: int, passes: int, scoped: int = 72_000_000) -> int:
    """_plan's scoped-VMEM rule: staged matrices at u bf16 splits x 2
    buffers (u = 3 for one pass, 6 for three), plus 14 live (tile, width)
    f32 planes, within ``scoped`` bytes."""
    fixed = 2 * (3 if passes == 1 else 6) * staged
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
    apply_power: bool  # x sqrt(P) at TX (the chunk's rows[0])
    normalize: bool  # per-tile unit power before the demap
    is_sc: bool  # SC-FDE (never on the diag chain)
    txext: bool  # the PAPR statistic comes from the runner's sampled TX batch
    pstride: int
    tile_cap: int
    slice: int
    hr: torch.Tensor  # (n,) raw-IR h_freq: the equalizer's
    hi: torch.Tensor
    habs2: torch.Tensor
    gr: torch.Tensor  # ZF gain rows, slicer folded in unless normalize
    gi: torch.Tensor
    cr: torch.Tensor  # (n,) the channel multiply's diag_response rows
    ci: torch.Tensor
    fr: Optional[torch.Tensor]  # (n, T) IDFT + CP where there is no ``plan``; None under txext
    fi: Optional[torch.Tensor]
    # The noise-bump study's stages (noise_bump_link): post-EQ noise of
    # sigma rows[2], then x rows[1] (1/sqrt(P)).
    post_noise: bool = False
    compensate: bool = False
    # The in-run PAPR's n-point IDFT (``dft.dft_plan``) in place of F_tx:
    # past 256 sc without txext, and up to 256 sc where n is a power of two.
    plan: Optional[object] = None


def f32_tensor(a, device) -> torch.Tensor:
    """A contiguous f32 tensor of a host float64 array, on ``device``."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def equalizer_fields(setup, device) -> dict:
    """The fields every chunk kernel shares (pallas_link._consts_for's rows,
    :1049-1106 and :1155): the codec, the scalar slicer gain (0.5/scale for
    qam; 1 for PSK, whose demap is scale-free, and for aqam, whose gain is
    the codec's per-lane row), mean |h|^2, method, noise and power-stage
    switches, SC-FDE or not, the measured-power slice, and the f32 rows h,
    |h|^2 and the ZF gain with the slicer gain folded in (qam and aqam,
    unless it is deferred: ``deferred_lane_slicer``; raw for PSK)."""
    cfg = setup.cfg
    n = cfg.num_subcarriers
    h = np.asarray(setup.h_freq, np.complex128)
    codec, slicer = codec_for(setup, device)
    is_sc = cfg.modulation_type == ModulationType.SC_OFDM
    h_z = np.where(h == 0, np.complex128(1e-10), h)
    zf_g = 1.0 / h_z
    defer = cfg.normalize_before_demap or (is_sc and codec.mode == "aqam")
    if cfg.equalization_method == EqualizationMethod.ZF and slicer is not None and not defer:
        zf_g = zf_g * slicer
    return dict(
        n=n,
        q=codec,
        slicer=float(np.float32(0.5) / np.float32(codec.scale)) if codec.mode == "qam" else 1.0,
        cg=float(np.float32(np.mean(np.abs(h) ** 2))),
        method=METHOD_CODE[cfg.equalization_method],
        add_noise=cfg.noise_type == NoiseType.AWGN,
        apply_power=bool(cfg.apply_power_allocation),
        normalize=bool(cfg.normalize_before_demap),
        is_sc=is_sc,
        slice=slice_symbols(n),
        hr=f32_tensor(h.real, device),
        hi=f32_tensor(h.imag, device),
        habs2=f32_tensor(np.abs(h) ** 2, device),
        gr=f32_tensor(zf_g.real, device),
        gi=f32_tensor(zf_g.imag, device),
    )


def diag_link(setup, device) -> DiagLink:
    """Host constants of a diag link (pallas_link._consts_for, diag branch).

    ``linops.diag_response`` checks that TX -> channel -> RX is diagonal
    and gives its diagonal d, the FFT of the unit-energy taps: the channel
    multiply's rows.  The equalizer keeps the raw-IR ``h_freq``, as the
    reference does (docs/PARITY.md quirk 1), so on an IR without unit
    energy d = h_freq / ||ir||.  Where d equals h_freq within f32 (unit
    energy) the channel rows are the h rows, bit for bit, as the JAX
    kernel's.  The in-run PAPR takes the n-point IDFT (``plan``,
    ``wide_tx``) where n is a power of two or past 256 subcarriers, and
    multiplies by the dense F_tx elsewhere (``papr_plane``)."""
    cfg = setup.cfg
    n, L = cfg.num_subcarriers, setup.prefix_length
    T = n + L
    d = linops.diag_response(np.asarray(setup.taps), n, cfg.prefix_type, L)
    fields = equalizer_fields(setup, device)
    if np.allclose(d, np.asarray(setup.h_freq, np.complex128), rtol=1e-5, atol=1e-7):
        cr, ci = fields["hr"], fields["hi"]
    else:
        cr, ci = f32_tensor(d.real, device), f32_tensor(d.imag, device)
    txext = txext_for(cfg)
    idft = n > WARP_MAX_N or n & (n - 1) == 0
    ftx = None if txext or idft else linops.tx_matrix(n, cfg.prefix_type, L, cfg.modulation_type)
    if idft and not txext:
        from ofdm_tpu_torch.ops import dft

        fields["plan"] = dft.dft_plan(n, device)
    return DiagLink(
        T=T,
        txext=txext,
        pstride=cfg.papr_stride or 32,
        tile_cap=tile_cap(n, T, selected_passes(setup), txext),
        cr=cr,
        ci=ci,
        fr=None if ftx is None else f32_tensor(ftx[0], device),
        fi=None if ftx is None else f32_tensor(ftx[1], device),
        **fields,
    )


def own_channel_rows(link: DiagLink) -> bool:
    """Whether the channel multiply has rows of its own (an IR without
    unit energy); else they are the equalizer's h rows, one tensor."""
    return link.cr is not link.hr or link.ci is not link.hi


def noise_bump_link(link):
    """A chunk link (any chain) with the noise-bump study's two stages on:
    post-EQ noise of sigma ``rows[2]``, then x ``rows[1]`` (1/sqrt(P))
    (pallas_link.make_noise_bump_chunk).  The link must apply the power
    allocation, normalize before the demap and add no channel noise."""
    if not (link.apply_power and link.normalize) or link.add_noise:
        raise ValueError("the noise-bump chunk needs apply_power_allocation=True, "
                         "normalize_before_demap=True and noise_type=NONE")
    return dataclasses.replace(link, post_noise=True, compensate=True)


def diag_layout(n: int):
    """(run, threads): the consecutive symbols a warp (a block past 256
    subcarriers) of the diag kernels walks, and the threads that sum one
    symbol's bins (the MMSE mean, the normalization energy)."""
    return (RUN, 32) if n <= WARP_MAX_N else (WIDE_RUN, WIDE_THREADS)


def _chunk_geometry(link: DiagLink, chunk: int):
    tile = tile_for(chunk, link.tile_cap)
    tiles = -(-chunk // tile)
    groups = -(-min(link.slice, tile) * link.n // POWER_BLOCK)
    last_sampled_tile = ((tiles - 1) // link.pstride) * link.pstride
    carry_sym = min((last_sampled_tile + 1) * tile, chunk) - 1
    return tile, tiles, groups, carry_sym


def papr_samples(link: DiagLink, chunk: int) -> int:
    """Time samples one chunk contributes to the PAPR statistic (0 under txext)."""
    if link.txext:
        return 0
    tile = tile_for(chunk, link.tile_cap)
    return sampled_symbols(chunk, tile, link.pstride) * link.T


# --- plain version of the chunk ----------------------------------------------


def tree_sum(v: torch.Tensor, threads: int = NORM_THREADS) -> torch.Tensor:
    """Sum over the last axis in a power kernel's order (power_partials,
    norm_factors): thread t sums elements t, t + threads, ... in order,
    then the block's halving tree."""
    n = v.shape[-1]
    J = max(1, -(-n // threads))
    v = torch.nn.functional.pad(v, (0, threads * J - n)).reshape(*v.shape[:-1], J, threads)
    acc = torch.zeros(v.shape[:-2] + (threads,), dtype=v.dtype, device=v.device)
    for j in range(J):
        acc = acc + v[..., j, :]
    s = threads // 2
    while s >= 1:
        acc = acc[..., :s] + acc[..., s : 2 * s]
        s >>= 1
    return acc[..., 0]


def cluster_width(n: int) -> int:
    """Elements a symbol spans in lr_power's blocks: n up to CLUSTER_BINS,
    past it its cluster's whole slices, a short last one padded with zeros."""
    return n if n <= CLUSTER_BINS else -(-n // CLUSTER_BINS) * CLUSTER_BINS


def _tile_sigma(pw: torch.Tensor, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale=1.0, row=0):
    """Per-tile sigma from |y|^2 (chunk, width): the mean over the first
    ``slice_syms`` symbols (all ``width`` samples of each) of every tile,
    summed in power_partials' order: 16 sequential steps per thread, a
    256-way tree per block, then the tile's blocks in order; the mean is
    scaled by ``pw_scale``.  ``row`` > width: each symbol's samples are
    padded with zeros to ``row`` elements first (``cluster_width``)."""
    width = pw.shape[1]
    if row > width:
        pw = torch.nn.functional.pad(pw, (0, row - width))
    flat = pw.reshape(-1)
    padded = pw.shape[1]
    seg = torch.zeros((tiles, groups * POWER_BLOCK), dtype=torch.float32, device=pw.device)
    counts = []
    for t in range(tiles):
        b0 = t * tile
        syms = min(slice_syms, min(tile, chunk - b0))
        seg[t, : syms * padded] = flat[b0 * padded : (b0 + syms) * padded]
        counts.append(syms * width)
    parts = tree_sum(seg.view(tiles, groups, POWER_BLOCK))
    tot = torch.zeros((tiles,), dtype=torch.float32, device=pw.device)
    for g in range(groups):
        tot = tot + parts[:, g]
    cnt = torch.tensor(counts, dtype=torch.float32, device=pw.device)
    mp = (tot / cnt) * _f32(pw_scale, tot)
    return torch.sqrt(mp / _f32(snr_lin, mp) / _f32(2.0, mp))


def block_sum(v: torch.Tensor, threads: int, slice: int = 0) -> torch.Tensor:
    """Sum over the last axis in a kernel block's order (link_common.cuh):
    element k belongs to thread k % threads, which sums its elements in k
    order; each warp sums its 32 threads by an xor butterfly; then the warps
    are summed in order.  threads = 32 is the one-warp case.  With ``slice``
    (a cluster's blocks, each holding ``slice`` bins) and more elements than
    that, each slice is summed so and the slices' sums are added in order."""
    n = v.shape[-1]
    if slice and n > slice:
        C = -(-n // slice)
        v = torch.nn.functional.pad(v, (0, C * slice - n)).reshape(*v.shape[:-1], C, slice)
        parts = block_sum(v, threads)
        tot = torch.zeros(parts.shape[:-1], dtype=v.dtype, device=v.device)
        for c in range(C):
            tot = tot + parts[..., c]
        return tot
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


def _mmse_nv(link: DiagLink, yr, yi, snr_lin, threads=32, slice=0):
    """Per-symbol noise variance, |y|^2 summed in the order of a kernel
    whose ``threads`` threads share a symbol (a warp for diag and fold, a
    block for lr; ``slice`` as in ``block_sum``)."""
    sp = block_sum(yr * yr + yi * yi, threads, slice)[:, None]
    sp = sp / _f32(link.n, sp)
    return sp / _f32(snr_lin, sp) / _f32(link.cg, sp)


def box_muller(w1, w2):
    """(z0, z1) of the link's noise chain: radius sqrt(-2 ln u1) with u1 from
    w1's 24 bits floored at 2^-24, phase from w2's 24 bits."""
    rad = torch.sqrt(-2.0 * torch.log(uniform24_floored(w1)))
    co, sn = cossin_u24((w2 >> 8) & 0xFFFFFF)
    return rad * co, rad * sn


def awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale=1.0, extra=None, row=0):
    """y + sigma * z, z = Box-Muller(w1, w2) (+ ``extra``, the colored part),
    sigma per tile from |y|^2 of its first ``slice_syms`` symbols times
    ``pw_scale`` (``row`` as in ``_tile_sigma``); y is (chunk, width) of
    bins or time samples."""
    sig = _tile_sigma(yr * yr + yi * yi, chunk, tile, tiles, groups, snr_lin, slice_syms, pw_scale, row)
    sigma = sig.repeat_interleave(tile)[:chunk, None]
    zr, zi = box_muller(w1, w2)
    if extra is not None:
        zr, zi = zr + extra[0], zi + extra[1]
    return yr + sigma * zr, yi + sigma * zi


def deferred_lane_slicer(link) -> bool:
    """Whether aqam's per-lane slicer row waits for the SC IDFT: on SC-FDE
    lane t's order demaps time sample t, so the row multiplies the time
    sample (``sc_slicer``), as the JAX XLA path demaps after the IDFT
    (ofdm_tpu/pipeline.py:533-549), and not the frequency bin."""
    return link.q.mode == "aqam" and link.is_sc


def equalize(link, yr, yi, snr_lin, threads=32, slice=0):
    """ZF / MMSE / no equalizer, in slicer units (the slicer gain folded in:
    the scalar for qam, the codec's per-lane row for aqam, none for PSK);
    MMSE sums |y|^2 in the order of ``threads`` threads a symbol (``slice``
    as in ``block_sum``).  Under
    ``normalize`` the slicer gain is deferred to ``normalize_points``
    (pallas_link.py:1772, defer_slicer): the points stay in data units;
    aqam on SC-FDE defers its lane row past the IDFT in any case
    (``deferred_lane_slicer``)."""
    hr, hi = link.hr, link.hi
    defer = link.normalize or deferred_lane_slicer(link)
    lane_slicer = link.q.frows[1] if link.q.mode == "aqam" and not defer else None
    if link.method == 0:
        gr, gi = link.gr, link.gi
        return yr * gr - yi * gi, yi * gr + yr * gi
    if link.method == 1:
        nv = _mmse_nv(link, yr, yi, snr_lin, threads, slice)
        num = _f32(1.0 if defer else link.slicer, nv) if lane_slicer is None else lane_slicer
        g = num / (link.habs2 + nv)
        return (yr * hr + yi * hi) * g, (yi * hr - yr * hi) * g
    if lane_slicer is not None:
        return yr * lane_slicer, yi * lane_slicer
    if link.q.mode != "qam" or defer:
        return yr, yi
    return yr * link.slicer, yi * link.slicer


# --- the _Spec stages (pallas_link.py:1437-1443, 1826-1862) -------------------


def stage_rows(link, rows, need: int) -> Optional[torch.Tensor]:
    """The chunk's per-lane rows, checked: None when no stage reads them,
    else an f32 (R, n) tensor on the link's device with R >= ``need``
    (rows[0] = sqrt(P), rows[1] = 1/sqrt(P), rows[2] = the post-EQ
    sigma)."""
    if need == 0:
        return None
    dev = link.hr.device
    if rows is None:
        raise ValueError(f"this link's stages read {need} per-lane row(s): pass rows")
    if (rows.dtype != torch.float32 or rows.device != dev or rows.ndim != 2 or rows.shape[0] < need
            or rows.shape[1] != link.n or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous f32 ({need}, {link.n}) tensor on {dev}")
    return rows


def link_stages(link) -> int:
    """The STAGE_* bits of a chunk link (any chain)."""
    return (STAGE_POWER * link.apply_power + STAGE_NORMALIZE * link.normalize
            + STAGE_POST_NOISE * link.post_noise + STAGE_COMPENSATE * link.compensate)


def rows_needed(link) -> int:
    """Per-lane rows a link's stages read: 3 with the noise-bump stages, 1
    for sqrt(P) alone, else 0."""
    stages = link_stages(link)
    if stages & (STAGE_POST_NOISE | STAGE_COMPENSATE):
        return 3
    return 1 if stages & STAGE_POWER else 0


def scale_tx(sr, si, rows):
    """x sqrt(P) per lane, right after encode (the apply_power stage)."""
    return sr * rows[0], si * rows[0]


def split_words(link, words, own: int, key, sym0: int, chunk: int, device):
    """(the chain's own injected word planes, the post-EQ noise's (u1 word,
    u2 word) planes): ``words`` holds the chain's ``own`` planes, then,
    with ``post_noise``, two (chunk, n) planes; without ``words`` the chain
    draws its own (None) and the post-EQ words are
    ``prng.post_noise_words``'s.  The second is None without
    ``post_noise``."""
    if words is None:
        return None, prng.post_noise_words(key, sym0, chunk, link.n, device) if link.post_noise else None
    if len(words) != own + 2 * link.post_noise:
        raise ValueError(f"words must be {own} planes of the chain's draws (+2 with post_noise)")
    if not link.post_noise:
        return words, None
    planes = tuple(torch.as_tensor(w).to(device=device, dtype=torch.int64) & prng.M32 for w in words[own:])
    if any(tuple(p.shape) != (chunk, link.n) for p in planes):
        raise ValueError(f"the post-EQ noise words must be ({chunk}, {link.n}) planes")
    return words[:own], planes


def bump_stages(link, er, ei, rows, pwords):
    """The noise-bump stages on equalized points (chunk, n), at the JAX
    position: after the SC-FDE IDFT, before the normalization.  post_noise
    adds sigma ``rows[2]`` x Box-Muller of ``pwords`` (``split_words``),
    compensate multiplies by ``rows[1]``."""
    if link.post_noise:
        er, ei = post_noise(er, ei, rows[2], *pwords)
    if link.compensate:
        er, ei = er * rows[1], ei * rows[1]
    return er, ei


def post_noise(er, ei, sigma, w1, w2):
    """e + sigma * Box-Muller(w1, w2) per lane, in the reference kernel's
    order: (sigma * radius) * cos, (sigma * radius) * sin."""
    rad = torch.sqrt(-2.0 * torch.log(uniform24_floored(w1)))
    co, sn = cossin_u24((w2 >> 8) & 0xFFFFFF)
    sr = sigma * rad
    return er + sr * co, ei + sr * sn


def tile_norm(er, ei, chunk: int, tile: int, run: int, threads: int = 32, slice: int = 0) -> torch.Tensor:
    """(chunk, 1) f32: each symbol's tile factor f = 1/sqrt(mean |e|^2) over
    all of the tile's points, or 1 where that mean is <= 1e-10
    (pallas_link.py:1853-1854), summed in the kernels' order: each symbol
    by ``block_sum`` over ``threads`` threads (and ``slice``), each run of ``run``
    consecutive symbols in order (one partial a warp or block), then a
    tile's partials by ``norm_factors``' tree."""
    n = er.shape[1]
    dev = er.device
    sym = block_sum(er * er + ei * ei, threads, slice)
    runs = -(-chunk // run)
    sym = torch.nn.functional.pad(sym, (0, runs * run - chunk)).view(runs, run)
    part = torch.zeros(runs, dtype=torch.float32, device=dev)
    for r in range(run):
        part = part + sym[:, r]
    tiles = -(-chunk // tile)
    rpt = tile // run
    part = torch.nn.functional.pad(part, (0, tiles * rpt - runs)).view(tiles, rpt)
    tot = tree_sum(part)
    cnt = torch.tensor([min(tile, chunk - t * tile) * n for t in range(tiles)], dtype=torch.float32, device=dev)
    avg = tot / cnt
    f = torch.where(avg > _f32(1e-10, avg), _f32(1.0, avg) / torch.sqrt(avg), _f32(1.0, avg))
    return f.repeat_interleave(tile)[:chunk, None]


def normalize_points(link, er, ei, f):
    """e x f, the tile's unit-power factor, with the deferred slicer gain
    riding the same multiply (f x 0.5/scale for qam, f x the lane row for
    aqam, f alone for PSK; pallas_link.py:1855-1861)."""
    if link.q.mode == "qam":
        m = f * _f32(link.slicer, f)
    elif link.q.mode == "aqam":
        m = f * link.q.frows[1]
    else:
        m = f
    return er * m, ei * m


def sc_slicer(link, er, ei):
    """aqam on SC-FDE without ``normalize``: time sample t x the lane row
    0.5/scale of lane t's order, after the IDFT and the noise-bump stages
    (under ``normalize`` ``normalize_points`` carries the row); every
    other link unchanged."""
    if link.normalize or not deferred_lane_slicer(link):
        return er, ei
    return er * link.q.frows[1], ei * link.q.frows[1]


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


# --- the wide dense chains' TX block and stream convolution (csrc/wide_chain.cuh) ---


def wide_tx(sr, si, T: int, is_sc: bool, zp: bool, plan):
    """x (rows, T): symbols (rows, n) -> the time block with its guard of L
    = T - n samples, as ``linops.tx_matrix``'s rows define it: SC-FDE
    copies s, OFDM takes the block IDFT (``dft.block_dft``); a cyclic
    prefix prepends the last L samples, a zero prefix appends L zeros (no
    prefix: L = 0).  Copies only, so bit-equal to the product with F_tx's
    0 / 1 rows on SC-FDE."""
    from ofdm_tpu_torch.ops import dft

    n = sr.shape[-1]
    L = T - n
    tr, ti = (sr, si) if is_sc else dft.block_dft(sr, si, plan, inverse=True)
    if L == 0:
        return tr, ti
    if zp:
        pad = torch.zeros((*tr.shape[:-1], L), dtype=torch.float32, device=tr.device)
        return torch.cat([tr, pad], dim=-1), torch.cat([ti, pad], dim=-1)
    return torch.cat([tr[..., n - L :], tr], dim=-1), torch.cat([ti[..., n - L :], ti], dim=-1)


def wide_stream(xr, xi, E: int, tail):
    """z (chunk, E+T): each symbol's block x (chunk, T) behind the tail
    x[T-E:T) of the symbol before it, the first symbol behind ``tail`` (a
    (1, E) pair)."""
    T = xr.shape[1]
    prev_r = torch.cat([tail[0], xr[:-1, T - E :]])
    prev_i = torch.cat([tail[1], xi[:-1, T - E :]])
    return torch.cat([prev_r, xr], dim=1), torch.cat([prev_i, xi], dim=1)


def stream_conv(zr, zi, tpr, tpi, m0: int, count: int):
    """y[:, i] = sum_k h[k] z[:, E + m0 + i - k] (i < count) over the K = E + 1
    unit-energy taps, k ascending, each term (a*h_r - c*h_i) / (a*h_i +
    c*h_r) rounded before it is added: the direct K-tap form of
    ``linops.conv_matrix_merged`` (time samples m0 .. m0 + count)."""
    K = tpr.shape[0]
    E = K - 1
    yr = torch.zeros((zr.shape[0], count), dtype=torch.float32, device=zr.device)
    yi = torch.zeros_like(yr)
    for k in range(K):
        a = zr[:, E + m0 - k : E + m0 - k + count]
        c = zi[:, E + m0 - k : E + m0 - k + count]
        yr = yr + (a * tpr[k] - c * tpi[k])
        yi = yi + (a * tpi[k] + c * tpr[k])
    return yr, yi


def wide_prev(link, xr, xi, prev, before: int, device):
    """(tail, x rows of the chunk): the (1, E) tail the chunk's first symbol
    reads (``prev``; else the recomputed predecessor's, row 0 of x when
    ``before``; else zeros, the run's symbol 0) and x without that row."""
    T, E = link.T, link.E
    if prev is not None:
        return plain_prev(prev, E, device), xr, xi
    if before:
        return (xr[:1, T - E :], xi[:1, T - E :]), xr[1:], xi[1:]
    zero = torch.zeros((1, E), dtype=torch.float32, device=device)
    return (zero, zero), xr, xi


def wide_link_fields(setup, device) -> dict:
    """The wide chains' own constants: the guard offset L = T - n, the f32
    unit-energy taps (K = E + 1; the merged conv's) and the block DFT plan
    of n points."""
    from ofdm_tpu_torch.ops import dft

    taps = np.asarray(setup.taps, np.complex128)
    return dict(L=setup.block_length - setup.cfg.num_subcarriers,
                tpr=f32_tensor(taps.real, device), tpi=f32_tensor(taps.imag, device),
                plan=dft.dft_plan(setup.cfg.num_subcarriers, device))


def wide_args(link):
    """The wide chunk and probe entry points' link arguments after the twiddle
    pair: n, T, E, the DFT split (n1, n2, log2 n) and its f32 scale."""
    p = link.plan
    return link.n, link.T, link.E, p.n1, p.n2, p.log2n, p.scale


def wide_probe_launch(lib, fn: str, link, key, sym: int, rows, device):
    """Launch ``fn`` (``ofdm_{fold,mm}_wide_probe``) of ``lib`` for run
    symbol ``sym`` of a wide link; returns (carry_r, carry_i, tail_r,
    tail_i)."""
    from ofdm_tpu_torch import build

    rows = stage_rows(link, rows, rows_needed(link))
    out = probe_outputs(link.T, link.E, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(
            link.plan.twr.data_ptr(), link.plan.twi.data_ptr(), *wide_args(link), int(link.is_sc),
            *codec_args(link.q), sym, key[0], key[1], None if rows is None else rows.data_ptr(),
            STAGE_POWER if link.apply_power else 0, *(t.data_ptr() for t in out), stream)
    build.check(lib, code, fn)
    return out


def add_papr(xr, xi, acc, psum):
    """Fold a time plane's PAPR peak (f32 bits, max) and power sum into acc/psum."""
    peak, total, _ = metrics.papr_stats(xr, xi)
    acc[2] = max(int(acc[2]), f32_bits(float(peak)))
    psum += total


def f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def bits_f32(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", int(b) & 0xFFFFFFFF))[0]


def diag_planes(link: DiagLink, key: Tuple[int, int], sym0: int, chunk: int, snr_lin: float,
                device, words=None, rows=None):
    """(tx, er, ei, sr, si): the chunk's TX indices, points ready for the
    slicer and TX symbols, each (chunk, n) — the plain chain up to the
    slicer, the stages included (``rows``: the chunk's per-lane rows).

    ``words`` = (raw, u1 word, u2 word) injects (chunk, n) integer planes in
    place of the Philox draw (tests feed zeros or numpy words); with
    ``post_noise`` two more, the post-EQ draws' (u1 word, u2 word).  Past
    256 subcarriers the per-symbol sums run in ``diag_wide``'s block order
    (``diag_layout``), and past ``CLUSTER_BINS`` in its cluster's."""
    dev = device
    n = link.n
    run, threads = diag_layout(n)
    rows = stage_rows(link, rows, rows_needed(link))
    tile, tiles, groups, _ = _chunk_geometry(link, chunk)
    words, pwords = split_words(link, words, 3, key, sym0, chunk, dev)
    if words is None:
        words = prng.link_words(key, sym0, chunk, n, dev)
    raw, w1, w2 = (torch.as_tensor(w).to(device=dev, dtype=torch.int64) & prng.M32 for w in words)
    if raw.shape != (chunk, n):
        raise ValueError(f"words must be 3 ({chunk}, {n}) planes (5 with post_noise)")
    tx, sr, si = encode(raw, link.q)
    if link.apply_power:
        sr, si = scale_tx(sr, si, rows)
    cr, ci = link.cr, link.ci
    yr = sr * cr - si * ci
    yi = sr * ci + si * cr
    if link.add_noise:
        yr, yi = awgn(yr, yi, w1, w2, chunk, tile, tiles, groups, snr_lin, link.slice)
    slice = CLUSTER_BINS if n > WARP_MAX_N else 0
    er, ei = equalize(link, yr, yi, snr_lin, threads, slice)
    er, ei = bump_stages(link, er, ei, rows, pwords)
    if link.normalize:
        er, ei = normalize_points(link, er, ei, tile_norm(er, ei, chunk, tile, run, threads, slice))
    return tx, er, ei, sr, si


def diag_chunk_plain(
    link: DiagLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    words=None,
    rows=None,
    dump=None,
):
    """Plain version of ``diag_chunk`` (same arguments, same effects);
    ``words`` as in ``diag_planes``."""
    dev = acc.device
    tile = tile_for(chunk, link.tile_cap)
    tx, er, ei, sr, si = diag_planes(link, key, sym0, chunk, snr_lin, dev, words, rows)
    if dump is not None:
        write_dump(link, dump, er, ei)
    count_errors(link, tx, er, ei, acc)
    if link.txext:
        # no time plane in the chunk: the carry row is zeros (no diag symbol reads it)
        return torch.zeros(link.T, dtype=torch.float32, device=dev), torch.zeros(link.T, dtype=torch.float32,
                                                                                    device=dev)
    sampled = (torch.arange(chunk, device=dev) // tile) % link.pstride == 0
    xr, xi = papr_plane(link, sr[sampled], si[sampled])
    add_papr(xr, xi, acc, psum)
    # sampled rows are in symbol order: the last one is symbol carry_sym
    return xr[-1].clone(), xi[-1].clone()


def papr_plane(link: DiagLink, sr, si):
    """The time blocks (rows, T) of TX symbols (rows, n), as the kernels
    compute them for the PAPR statistic: the block IDFT with its cyclic
    prefix where the link has a ``plan`` (``wide_tx``; the order of
    diag_main's in-warp radix-2 and of diag_wide's block transform), else
    ``cmatmul`` over F_tx."""
    if link.plan is None:
        return cmatmul(link.fr, link.fi, sr, si)
    return wide_tx(sr, si, link.T, False, False, link.plan)


# --- kernel wrappers ----------------------------------------------------------


def new_accumulators(device):
    """(acc, psum): int64 [bit errors, symbol errors, PAPR peak f32 bits] and
    the float64 PAPR power sum, zeroed on ``device``."""
    return (
        torch.zeros(3, dtype=torch.int64, device=device),
        torch.zeros(1, dtype=torch.float64, device=device),
    )


def _check_link_tensors(link: DiagLink, device):
    rows = {name: getattr(link, name) for name in ("hr", "hi", "habs2", "gr", "gi", "cr", "ci")}
    if link.txext:
        papr = {}
    elif link.plan is None:
        papr = {"fr": link.fr, "fi": link.fi}
    else:
        papr = {"plan.twr": link.plan.twr, "plan.twi": link.plan.twi}
    for name, t in {**rows, **papr}.items():
        if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"link.{name} must be contiguous f32 on {device}")
    if link.hr.shape != (link.n,) or ("fr" in papr and link.fr.shape != (link.n, link.T)):
        raise ValueError("link rows have the wrong shape")
    if not 1 <= link.n <= MAX_N:
        raise ValueError(f"diag kernels take 1 <= n <= {MAX_N}, got {link.n}")
    if link.n > CLUSTER_BINS and not link.txext:
        raise ValueError(f"past {CLUSTER_BINS} subcarriers diag_wide takes txext links (no in-run transform)")
    if not link.n <= link.T <= 2 * link.n:
        raise ValueError(f"the diag kernels take a prefix of at most n samples: T = {link.T}, n = {link.n}")
    wide = link.n > WARP_MAX_N
    if link.txext and not wide:
        raise ValueError("diag_main computes its PAPR in the run: a txext link needs n > 256")
    if "fr" in papr and wide or link.plan is not None and (link.plan.n != link.n or not wide and link.plan.log2n < 0):
        raise ValueError(f"the in-run PAPR takes the {link.n}-point IDFT plan past 256 subcarriers and at a "
                         f"power-of-two width, F_tx elsewhere")
    check_codec(link.q, link.n, device)


def norm_workspace(chunk: int, tile: int, run: int, device):
    """(run partials, tile factors): the scratch of a chunk's normalization,
    one float a run of ``run`` symbols and one a tile."""
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty(-(-chunk // run), **f32), torch.empty(-(-chunk // tile), **f32)


def check_work(work, sizes, what):
    """Raise unless each tensor of ``work`` is contiguous f32 with room for
    its size, on the device of the first."""
    dev = work[0].device
    for t, size in zip(work, sizes):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() < size:
            raise ValueError(f"work must be {what}")


def onepass_slab(n: int, chunk: int, tile: int) -> int:
    """Symbols a slab of a normalized diag chunk: whole tiles, as many as
    keep slab x n within ONEPASS_SLAB_BINS bins (at least one tile), the
    whole chunk where it fits.  The scratch holds one slab, slab x n x
    ONEPASS_BYTES_PER_BIN bytes: 84 MB at 64 sc (a 2^17-symbol chunk, 8.4M
    bins), 671 MB at 512 sc (67M bins, the cap), and past the cap whole tiles
    (4096 sc at a single-tap link's tile of 32: 512 tiles, 16,384 symbols,
    671 MB); a tile the diag budget admits (``tile_cap``) holds at most
    1.3M bins (13 MB, at ~20,000 sc), so the scratch stays below 1 GB at
    any width."""
    if chunk * n <= ONEPASS_SLAB_BINS:
        return chunk
    return max(1, ONEPASS_SLAB_BINS // (tile * n)) * tile


def onepass_scratch(link: DiagLink, chunk: int, device):
    """(e re, e im, TX index): the scratch planes of a normalized chunk's
    slab (``onepass_slab`` x n bins: two f32 and one int16 plane, the
    index's bits read as u16), or empty planes for a link without
    normalize."""
    bins = onepass_slab(link.n, chunk, tile_for(chunk, link.tile_cap)) * link.n if link.normalize else 0
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty(bins, **f32), torch.empty(bins, **f32), torch.empty(bins, dtype=torch.int16, device=device)


def chunk_workspace(link: DiagLink, chunk: int, device):
    """(partials, carry_r, carry_i, norm partials, norm factors, e re, e im,
    TX index): the scratch ``diag_chunk`` needs for chunks of ``chunk``
    symbols (``onepass_scratch`` last), so that a run allocates it once."""
    tile, tiles, groups, _ = _chunk_geometry(link, chunk)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(tiles * groups, **f32), torch.empty(link.T, **f32), torch.empty(link.T, **f32),
            *norm_workspace(chunk, tile, diag_layout(link.n)[0], device), *onepass_scratch(link, chunk, device))


def check_accumulators(acc, psum):
    """Raise unless acc is int64 (3,) and psum float64 (1,), contiguous, on one device."""
    if acc.dtype != torch.int64 or acc.shape != (3,) or psum.dtype != torch.float64 or psum.shape != (1,):
        raise ValueError("acc must be int64 (3,) and psum float64 (1,)")
    if psum.device != acc.device or not (acc.is_contiguous() and psum.is_contiguous()):
        raise ValueError("acc and psum must be contiguous on one device")


def stage_args(link, rows, norm_part, norm_f, dump=None):
    """The stage arguments of a chunk kernel's C entry point: the rows
    pointer, the STAGE_* bits, the normalization scratch and the dump
    stage's planes and their rows."""
    rows = stage_rows(link, rows, rows_needed(link))
    bits = link_stages(link) | (STAGE_DUMP if dump is not None else 0)
    planes = (None, None, 0) if dump is None else (dump[0].data_ptr(), dump[1].data_ptr(), dump[0].shape[0])
    return (None if rows is None else rows.data_ptr(), bits, norm_part.data_ptr(), norm_f.data_ptr(),
            *planes)


def staged_library(link, dump, chain: str) -> str:
    """The library a chunk of ``chain`` ("diag_wide", "fold", "fold_wide",
    "lr", "mm", "mm_wide") runs from: the OFDM_BUMP build with the
    noise-bump stages, else the OFDM_STAGED build when the link has stages
    or a dump is asked for (the plain build takes no stage bit)."""
    plain = chain if chain.endswith("_wide") else f"{chain}_kernel"
    if link.post_noise or link.compensate:
        return f"{chain}_bump"
    return f"{chain}_staged" if link_stages(link) or dump is not None else plain


# --- the carry-in and the carry probe (K3) ----------------------------------------


def check_prev(prev, E: int, device):
    """The tail pair a chunk's first symbol reads (``prev``): two contiguous
    f32 (E,) tensors on ``device``; returns their pointers, or (None, None)
    without one."""
    if prev is None:
        return None, None
    ok = len(prev) == 2 and all(
        t.device == device and t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == (E,)
        for t in prev)
    if not ok:
        raise ValueError(f"prev must be two contiguous f32 ({E},) tensors on {device}")
    return prev[0].data_ptr(), prev[1].data_ptr()


def plain_prev(prev, E: int, device):
    """The carry-in as the plain versions read it: a (1, E) pair."""
    return tuple(torch.as_tensor(t, dtype=torch.float32, device=device).reshape(1, E) for t in prev)


def probe_outputs(T: int, E: int, device):
    """(carry_r, carry_i, tail_r, tail_i): (T,) and (E,) f32 views of one
    new (2T + 2E,) buffer for a probe.  Each call allocates anew: callers
    keep a probe's tails past the next probe (a carry, a prev)."""
    return torch.empty(2 * (T + E), dtype=torch.float32, device=device).split((T, T, E, E))


def link_cached(link, name: str, make):
    """``make()``, computed at the first call for ``link`` and kept in its
    ``cache`` (a field that ``dataclasses.replace`` starts empty): what a
    wrapper derives from the link alone, its checks passed once."""
    got = link.cache.get(name)
    if got is None:
        got = link.cache[name] = make()
    return got


def probe_args(link) -> tuple:
    """K3's link arguments after its matrix arguments: n, T, E and the codec."""
    return (link.n, link.T, link.E, *codec_args(link.q))


def probe_symbol_tx(link, key: Tuple[int, int], sym: int, words_n: int, rows, device, words=None):
    """(sr, si): run symbol ``sym``'s TX points (1, n) as a chunk's plain
    version makes them (encode, x sqrt(P) under apply_power); the raw words
    are word 0 of ``words_n`` columns, the first n read, or ``words`` (a
    (1, >= n) integer plane) when given."""
    rows = stage_rows(link, rows, rows_needed(link))
    if words is None:
        raw, _, _ = prng.link_words(key, sym, 1, words_n, device)
    else:
        raw = torch.as_tensor(words).to(device=device, dtype=torch.int64).reshape(1, -1) & prng.M32
    _, sr, si = encode(raw[:, : link.n], link.q)
    if link.apply_power:
        sr, si = scale_tx(sr, si, rows)
    return sr, si


def probe_launch(lib, fn: str, link, head: tuple, key, sym: int, rows, device, extra=()):
    """Launch ``fn`` (``ofdm_{fold,lr,mm}_probe``) of ``lib`` for run symbol
    ``sym`` of ``link``: ``head`` is the entry point's link arguments up to
    the symbol (its matrix arguments, then ``probe_args``; built once a link,
    ``link_cached``), ``extra`` the arguments after the outputs (lr's row
    table and its tail rows).  Returns (carry_r, carry_i, tail_r, tail_i), views of one new
    buffer."""
    from ofdm_tpu_torch import build

    rows = stage_rows(link, rows, rows_needed(link))
    T, E = link.T, link.E
    out = probe_outputs(T, E, device)
    base = out[0].data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(
            *head, sym, key[0], key[1], None if rows is None else rows.data_ptr(),
            STAGE_POWER if link.apply_power else 0, base, base + 4 * T, base + 8 * T, base + 8 * T + 4 * E,
            *extra, stream)
    build.check(lib, code, fn)
    return out


# --- the dump stage (pallas_link.py:1863-1879) ----------------------------------


def dump_points(link, er, ei):
    """Points ready for the slicer back in data units, as the dump stage
    writes them: qam x f32(1/slicer), aqam / the lane's slicer row, PSK raw.
    The reciprocal is one f32 division, as on the card; it equals the JAX
    stage's f64 reciprocal rounded to f32."""
    if link.q.mode == "qam":
        u = _f32(1.0, er) / _f32(link.slicer, er)
        return er * u, ei * u
    if link.q.mode == "aqam":
        return er / link.q.frows[1], ei / link.q.frows[1]
    return er, ei


def dump_rows(collect: int, n: int, chunk: int) -> int:
    """D = ceil(collect / n) symbols, capped at the chunk: the rows a dump
    of ``collect`` points needs."""
    return max(1, min(-(-int(collect) // n), chunk))


def new_dump(rows: int, n: int, device):
    """A (re, im) pair of (rows, n) f32 planes for the dump stage."""
    f32 = dict(dtype=torch.float32, device=device)
    return torch.zeros((rows, n), **f32), torch.zeros((rows, n), **f32)


def check_dump(dump, chunk: int, n: int, device):
    """Raise unless ``dump`` is a pair of contiguous f32 (D, n) planes on
    ``device`` with 1 <= D <= chunk."""
    ok = dump is not None and len(dump) == 2 and all(
        t.device == device and t.dtype == torch.float32 and t.is_contiguous() and t.ndim == 2
        and t.shape == dump[0].shape for t in dump)
    if not ok or dump[0].shape[1] != n or not 1 <= dump[0].shape[0] <= chunk:
        raise ValueError(f"dump must be two contiguous f32 (D, {n}) planes on {device}, 1 <= D <= {chunk}")


def write_dump(link, dump, er, ei):
    """The plain dump stage: the first D symbols' points (``dump_points``)
    into the planes."""
    check_dump(dump, er.shape[0], link.n, er.device)
    d = dump[0].shape[0]
    dr, di = dump_points(link, er[:d], ei[:d])
    dump[0].copy_(dr)
    dump[1].copy_(di)


def diag_chunk(
    link: DiagLink,
    key: Tuple[int, int],
    sym0: int,
    chunk: int,
    snr_lin: float,
    acc: torch.Tensor,
    psum: torch.Tensor,
    work=None,
    rows=None,
    dump=None,
):
    """One chunk of run symbols [sym0, sym0 + chunk): adds its bit errors,
    symbol errors and PAPR peak bits into ``acc`` and its PAPR power sum
    into ``psum``, on the accumulators' device.  Returns the carry row
    (re, im): the TX time row of the chunk's last sampled symbol, written
    into ``work`` (a ``chunk_workspace`` for this chunk size) when given.
    ``rows`` are the stages' per-lane rows (``stage_rows``), read only
    when the link has stages.  ``dump`` (``new_dump``'s planes of D <=
    chunk rows) turns the dump stage on: the pass that counts writes the
    first D symbols' points in data units (``dump_points``) into it,
    counted in ``diag_chunk.dump_launches``.

    CUDA tensors launch the fused kernels.  Up to 256 subcarriers
    (csrc/link_kernel.cu): with noise on, ``power_partials``; then
    ``diag_main``, or for a link with stages or channel rows of its own
    (``own_channel_rows``; the library built with OFDM_STAGED)
    ``diag_staged``.  Past 256 (csrc/diag_wide_kernel.cu): ``wide_power``
    with noise on, then ``diag_wide`` (its OFDM_STAGED build for a link
    with stages, its OFDM_BUMP build with the noise-bump stages).  Under
    ``normalize`` each slab of ``onepass_slab`` symbols runs the chain
    kernel's front variant once (e into ``work``'s scratch), then
    ``norm_factors`` and ``diag_demap``.  Counted in
    ``diag_chunk.power_launches``, ``.launches`` (``diag_main`` or
    ``diag_staged``: the chain), ``.wide_launches`` (the same of
    ``diag_wide``), ``.norm_launches`` (``norm_factors``) and
    ``.demap_launches`` (``diag_demap``), one a slab each under
    ``normalize``.  CPU tensors run ``diag_chunk_plain``."""
    dev = acc.device
    if dev.type == "cpu":
        return diag_chunk_plain(link, key, sym0, chunk, snr_lin, acc, psum, rows=rows, dump=dump)
    if dev.type != "cuda":
        raise ValueError(f"diag_chunk runs on cpu or cuda, not {dev}")
    check_accumulators(acc, psum)
    _check_link_tensors(link, dev)
    if not 1 <= chunk <= (2**31 - 1) // link.n:
        raise ValueError(f"chunk out of range: {chunk}")
    if dump is not None:
        check_dump(dump, chunk, link.n, dev)
    tile, tiles, groups, carry_sym = _chunk_geometry(link, chunk)
    run = diag_layout(link.n)[0]
    slab = onepass_slab(link.n, chunk, tile)
    slabs = -(-chunk // slab) if link.normalize else 0
    work = chunk_workspace(link, chunk, dev) if work is None else work
    what = f"chunk_workspace(link, {chunk}, {dev})"
    bins = slab * link.n if link.normalize else 0
    check_work(work[:7], (tiles * groups, link.T, link.T, -(-chunk // run), tiles, bins, bins), what)
    if len(work) != 8 or work[7].device != dev or work[7].dtype != torch.int16 or work[7].numel() < bins:
        raise ValueError(f"work must be {what}")
    partials, carry_r, carry_i, norm_part, norm_f, scr_r, scr_i, scr_tx = work
    from ofdm_tpu_torch import build

    wide = link.n > WARP_MAX_N
    if wide:
        fn, lib = "ofdm_diag_wide_chunk", build.load(staged_library(link, dump, "diag_wide"))
    else:
        fn = "ofdm_diag_chunk"
        staged = own_channel_rows(link) or link_stages(link) or dump is not None
        lib = build.load("link_staged" if staged else "link_kernel")
    p = link.plan
    ftx = (None, None) if link.fr is None else (link.fr.data_ptr(), link.fi.data_ptr())
    plan = (None, None, 1, link.n, -1, 1.0) if p is None else (p.twr.data_ptr(), p.twi.data_ptr(), p.n1, p.n2,
                                                                p.log2n, p.scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(
            link.hr.data_ptr(), link.hi.data_ptr(), link.habs2.data_ptr(),
            link.gr.data_ptr(), link.gi.data_ptr(), link.cr.data_ptr(), link.ci.data_ptr(), *ftx,
            link.n, link.T, *codec_args(link.q), link.slicer, snr_lin, link.cg,
            link.method, int(link.add_noise),
            sym0,
            chunk, tile, link.slice, groups, link.pstride,
            carry_sym, run,
            key[0], key[1],
            partials.data_ptr(), acc.data_ptr(), psum.data_ptr(),
            carry_r.data_ptr(), carry_i.data_ptr(),
            *stage_args(link, rows, norm_part, norm_f, dump), scr_r.data_ptr(), scr_i.data_ptr(),
            scr_tx.data_ptr(), slab, *plan, int(link.txext), stream,
        )
    build.check(lib, code, fn)
    if link.add_noise:
        diag_chunk.power_launches += 1
    diag_chunk.norm_launches += slabs
    diag_chunk.demap_launches += slabs
    diag_chunk.dump_launches += int(dump is not None)
    if wide:
        diag_chunk.wide_launches += max(1, slabs)
    else:
        diag_chunk.launches += max(1, slabs)
    return carry_r, carry_i


diag_chunk.launches = 0  # diag_main / diag_staged kernels launched (the chain; one a slab under normalize)
diag_chunk.wide_launches = 0  # diag_wide kernels launched (the same)
diag_chunk.dump_launches = 0  # chunks that ran the dump stage
diag_chunk.power_launches = 0  # power_partials / wide_power kernels launched
diag_chunk.norm_launches = 0  # norm_factors kernels launched (one a slab of a normalized chunk)
diag_chunk.demap_launches = 0  # diag_demap kernels launched (the same)


DIAG_GEOMETRY_KERNELS = ("power", "main", "front", "demap")
DIAG_GEOMETRY_KEYS = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")


def geometry(n: int, library: str, log2n: int = -1) -> dict:
    """The layout of a diag library's qam kernels at width n, read from the
    loaded ``library`` (csrc/link_kernel.cu::ofdm_diag_geometry up to 256
    subcarriers, csrc/diag_wide_kernel.cu::ofdm_diag_wide_geometry past
    them, with the in-run PAPR's plane: radix-2 for log2n >= 0, else the
    split): for power_partials / wide_power, the main kernel (diag_main,
    or the staged builds' counting variant), the front variant and
    diag_demap, its registers, local bytes a thread, static shared memory
    and resident blocks an SM; None where the build has no such kernel."""
    import ctypes

    from ofdm_tpu_torch import build

    lib = build.load(library)
    out = (ctypes.c_int * 16)()
    if n > WARP_MAX_N:
        build.check(lib, lib.ofdm_diag_wide_geometry(n, log2n, out), "ofdm_diag_wide_geometry")
    else:
        build.check(lib, lib.ofdm_diag_geometry(n, out), "ofdm_diag_geometry")
    vals = list(out)
    return {k: None if vals[4 * i] < 0 else dict(zip(DIAG_GEOMETRY_KEYS, vals[4 * i : 4 * i + 4]))
            for i, k in enumerate(DIAG_GEOMETRY_KERNELS)}


WIDE_GEOMETRY_KEYS = ("registers", "local_bytes", "shared_bytes", "blocks_an_sm")


def wide_geometry(chain: str, n: int, T: int, E: int, log2n: int, library: Optional[str] = None) -> dict:
    """The layout of ``chain``'s ("fold" or "mm") wide qam kernels at (n, T,
    E) and the DFT plan's log2 n (-1: the split), read from the loaded
    ``library`` (its plain build by default;
    csrc/{fold,mm}_wide_kernel.cu::ofdm_{fold,mm}_wide_geometry): ``J``, the
    slots a thread, and for the main kernel, the power pass (fold) or front
    (mm) and the probe their registers, local bytes a thread, shared bytes
    a block (static and dynamic) and resident blocks an SM."""
    import ctypes

    from ofdm_tpu_torch import build

    lib = build.load(library or f"{chain}_wide")
    out = (ctypes.c_int * 13)()
    fn = f"ofdm_{chain}_wide_geometry"
    build.check(lib, getattr(lib, fn)(n, T, E, log2n, out), fn)
    vals = list(out)
    kernels = ("main", "power" if chain == "fold" else "front", "probe")
    return {"J": vals[0], **{k: dict(zip(WIDE_GEOMETRY_KEYS, vals[1 + 4 * i : 5 + 4 * i]))
                             for i, k in enumerate(kernels)}}


BOXMULLER_THREADS = 256  # ofdm_boxmuller's block (csrc/boxmuller.cu: kBmThreads)
BOXMULLER_STEP = 4  # consecutive elements a thread takes a step, one float4 store a plane (kBmStep)
BOXMULLER_GEOMETRY_KEYS = ("grid", "threads", "step", "registers", "local_bytes", "blocks_an_sm")


def boxmuller_elements(seed0: int, seed1: int, i: torch.Tensor):
    """(z0, z1) of elements ``i`` (an int64 tensor) of ``boxmuller_sample``:
    words 1 and 2 of Philox counter (i lo, i hi, 0, 0)."""
    key = (int(seed0) & prng.M32, int(seed1) & prng.M32)
    zero = torch.zeros((), dtype=torch.int64, device=i.device)
    _, w1, w2, _ = prng.philox4x32_10(i & prng.M32, i >> 32, zero, zero, key)
    return box_muller(w1, w2)


def boxmuller_sample_plain(seed0: int, seed1: int, shape, device="cpu"):
    """Plain version of ``boxmuller_sample``."""
    count = int(np.prod(shape))
    z0, z1 = boxmuller_elements(seed0, seed1, torch.arange(count, dtype=torch.int64, device=device))
    return z0.view(shape), z1.view(shape)


def boxmuller_grid(count: int, resident: int) -> int:
    """ofdm_boxmuller's blocks for ``count`` elements on a card that holds
    ``resident`` of its blocks at once: its quads' blocks, at most one wave."""
    want = -(-(count // BOXMULLER_STEP) // BOXMULLER_THREADS)
    return max(1, min(want, resident))


def boxmuller_cover(count: int, grid: int) -> np.ndarray:
    """The element indices ofdm_boxmuller's threads write at ``grid`` blocks,
    thread by thread and step by step, as its loop walks them: thread g of
    the P = grid x BOXMULLER_THREADS takes quads q = g, g + P, ... below
    count // 4 (elements 4q ... 4q + 3), then element 4 (count // 4) + g
    when that is below count (the scalar tail)."""
    P = grid * BOXMULLER_THREADS
    quads = count // BOXMULLER_STEP
    q = np.arange(P)[:, None] + P * np.arange(-(-quads // P))[None, :]
    q = q[q < quads]
    tail = BOXMULLER_STEP * quads + np.arange(P)
    return np.concatenate([(BOXMULLER_STEP * q[:, None] + np.arange(BOXMULLER_STEP)).reshape(-1), tail[tail < count]])


def boxmuller_geometry(count: int) -> dict:
    """ofdm_boxmuller's launch for ``count`` elements on the current card, as
    the loaded kernel reports it (csrc/boxmuller.cu::ofdm_boxmuller_geometry):
    BOXMULLER_GEOMETRY_KEYS."""
    import ctypes

    from ofdm_tpu_torch import build

    lib = build.load("boxmuller")
    out = (ctypes.c_int * len(BOXMULLER_GEOMETRY_KEYS))()
    build.check(lib, lib.ofdm_boxmuller_geometry(count, out), "ofdm_boxmuller_geometry")
    return dict(zip(BOXMULLER_GEOMETRY_KEYS, out))


def boxmuller_sample(seed0: int, seed1: int, shape, device="cuda"):
    """(z0, z1) N(0,1) f32 planes of ``shape`` from the link's exact noise
    chain (pallas_link.py::boxmuller_sample): the ``ofdm_boxmuller`` kernel
    on a CUDA device (one wave, 4 elements a thread a step:
    ``boxmuller_cover``), the plain version on the CPU."""
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
