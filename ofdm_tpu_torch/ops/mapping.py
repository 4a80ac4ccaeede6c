"""Constellation tables and gap-function bit loading.

Host-side float64 tables and ``scale``, point for point the same as
``ofdm_tpu.ops.mapping`` (reference constellation/models.py:180-218 for QAM,
:356-380 for PSK).  The chunk kernels never read a table: they encode and
slice arithmetically (``ops.link_kernel``); the table here fixes ``scale``
and is what the tests hold the arithmetic codec against.  The eager chain
encodes by the table (``encode_indices``) and demaps with the JAX
package's complex-path slicer (``decode_hard``: round and clip to the QAM
grid, then the ``inv_index`` gather; the PSK sector by arctan2).  The bit
loading (``bit_loading_orders``) picks each subcarrier's order for
adaptive modulation, as ``ofdm_tpu.ops.mapping`` does.  The bit-level
functions (``bits_to_indices``, ``indices_to_bits``, ``encode``,
``decode_nn``, ``decode_bits``) are the JAX package's, for callers that
build a link from bits by hand.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
from numpy.typing import NDArray
from scipy.stats import norm


def gray_code(i):
    """Binary-reflected Gray code, g = i ^ (i >> 1)."""
    return i ^ (i >> 1)


def inverse_gray_code(g: NDArray[np.int64]) -> NDArray[np.int64]:
    """Invert the Gray code by prefix-XOR over bit shifts."""
    g = np.asarray(g).copy()
    shift = 1
    while (g >> shift).any():
        g = g ^ (g >> shift)
        shift <<= 1
    return g


@dataclasses.dataclass(frozen=True)
class Constellation:
    """``table[i]`` is the point sent for bit word ``i`` (MSB first).

    ``inv_index`` maps a QAM grid position row*m+col back to its index
    (empty for PSK).  ``coding`` is "gray" or "none" (natural order)."""

    kind: str
    order: int
    table: NDArray[np.complex128]
    inv_index: NDArray[np.int32]
    scale: float
    coding: str = "gray"

    @property
    def bits_per_symbol(self) -> int:
        return self.order.bit_length() - 1

    @property
    def name(self) -> str:
        return f"{self.order}-{self.kind}"


@lru_cache(maxsize=None)
def qam_constellation(order: int, coding: str = "gray") -> Constellation:
    """Square QAM with the reference's Gray + zig-zag layout, unit avg power."""
    m = int(np.sqrt(order))
    if m * m != order:
        raise ValueError("Order must be a perfect square (e.g., 4, 16, 64).")
    levels = np.arange(-m + 1, m, 2, dtype=np.float64)
    grid = (levels[None, :] + 1j * levels[::-1, None]).reshape(-1)
    idx = np.arange(order, dtype=np.int64)
    if coding == "gray":
        table = grid[gray_code(idx)].reshape(m, m)
        table[1::2] = table[1::2, ::-1]
        table = table.reshape(-1)
    elif coding == "none":
        table = grid.copy()
    else:
        raise ValueError(f"Unknown word coding: {coding}")
    scale = 1.0 / np.sqrt(np.mean(np.abs(table) ** 2))
    table = table * scale
    inv = np.empty(order, dtype=np.int32)
    for i in range(order):
        c = table[i] / scale
        col = int(round((c.real + (m - 1)) / 2))
        row = int(round(((m - 1) - c.imag) / 2))
        inv[row * m + col] = i
    return Constellation("QAM", order, table, inv, float(scale), coding)


@lru_cache(maxsize=None)
def psk_constellation(order: int, coding: str = "gray") -> Constellation:
    """M-PSK on the unit circle, table[gray(p)] = exp(2j*pi*p/M)."""
    bits = np.log2(order)
    if bits != int(bits) or order < 2:
        raise ValueError("PSK order must be a power of 2 (e.g., 2, 4, 8, 16).")
    p = np.arange(order, dtype=np.int64)
    points = np.exp(2j * np.pi * p / order)
    table = np.zeros(order, dtype=np.complex128)
    if coding == "gray":
        table[gray_code(p)] = points
    elif coding == "none":
        table[:] = points
    else:
        raise ValueError(f"Unknown word coding: {coding}")
    return Constellation("PSK", order, table, np.zeros(0, dtype=np.int32), 1.0, coding)


def make_constellation(kind: str, order: int, coding: str = "gray") -> Constellation:
    if kind == "QAM":
        return qam_constellation(order, coding)
    if kind == "PSK":
        return psk_constellation(order, coding)
    raise ValueError(f"Unknown constellation kind: {kind}")


# --- table encode and hard-decision demap (the eager chain) ------------------


def encode_indices(idx: torch.Tensor, const: Constellation, dtype=torch.complex64) -> torch.Tensor:
    """Table points of indices (...,), on the indices' device."""
    table = torch.tensor(const.table, dtype=dtype, device=idx.device)
    return table[idx.to(torch.int64)]


def decode_hard(symbols: torch.Tensor, const: Constellation) -> torch.Tensor:
    """O(1) hard-decision demap of complex points (...,) to int64 table
    indices (ofdm_tpu.ops.mapping.decode_hard): QAM rounds each axis to the
    grid in f32, clips, and looks the position up in ``inv_index``; PSK
    rounds the phase to its sector, Gray-coded unless ``coding`` is "none"."""
    dev = symbols.device
    if const.kind == "QAM":
        m = int(np.sqrt(const.order))
        scale = torch.tensor(const.scale, dtype=torch.float32, device=dev)
        x = symbols.real / scale
        y = symbols.imag / scale
        col = torch.clamp(torch.round((x + (m - 1)) * 0.5), 0, m - 1).to(torch.int64)
        row = torch.clamp(torch.round(((m - 1) - y) * 0.5), 0, m - 1).to(torch.int64)
        inv = torch.tensor(const.inv_index.astype(np.int64), device=dev)
        return inv[row * m + col]
    M = const.order
    ang = torch.atan2(symbols.imag, symbols.real)
    sector = torch.remainder(torch.round(ang * (M / (2.0 * np.pi))).to(torch.int64), M)
    if const.coding == "none":
        return sector
    return sector ^ (sector >> 1)


# --- bit-level encode / decode (ofdm_tpu.ops.mapping) ----------------------------


def bits_to_indices(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Pack bit groups (..., bits_per_symbol) MSB-first into int32 indices."""
    weights = torch.tensor(1 << np.arange(bits_per_symbol - 1, -1, -1), dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def indices_to_bits(indices: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Unpack integer indices into (..., bits_per_symbol) uint8 bits, MSB-first."""
    shifts = torch.arange(bits_per_symbol - 1, -1, -1, dtype=indices.dtype, device=indices.device)
    return ((indices[..., None] >> shifts) & 1).to(torch.uint8)


def encode(bits: torch.Tensor, const: Constellation, dtype=torch.complex64) -> torch.Tensor:
    """Map bits (..., bits_per_symbol) to constellation symbols (...,)."""
    return encode_indices(bits_to_indices(bits, const.bits_per_symbol), const, dtype)


# Symbols a block of ``decode_nn``: at M = 1024 a (2^16, M) f32 score plane
# is 256 MB, so a 2^26-symbol plane never forms its whole score matrix.
NN_ROWS = 1 << 16


def decode_nn(symbols: torch.Tensor, const: Constellation, rows: int = NN_ROWS) -> torch.Tensor:
    """Nearest-neighbour demap to int64 table indices: argmax_j of
    2 Re(y conj(c_j)) - |c_j|^2 in f32 (argmin_j |y - c_j|^2), the first
    maximum on a tie, as the JAX package's ``decode_nn`` scores each point
    (its (S, 2) @ (2, M) product plus the bias row).  Runs ``rows`` symbols
    at a time; each score depends on its own symbol only, so the result
    does not depend on ``rows``."""
    dev = symbols.device
    c = const.table
    cr = torch.tensor((2.0 * c.real).astype(np.float32), device=dev)
    ci = torch.tensor((2.0 * c.imag).astype(np.float32), device=dev)
    bias = torch.tensor((-np.abs(c) ** 2).astype(np.float32), device=dev)
    y = symbols.reshape(-1)
    out = torch.empty(y.shape, dtype=torch.int64, device=dev)
    for r0 in range(0, y.shape[0], rows):
        b = y[r0 : r0 + rows]
        scores = b.real.to(torch.float32)[:, None] * cr + b.imag.to(torch.float32)[:, None] * ci + bias
        out[r0 : r0 + rows] = torch.argmax(scores, dim=-1)
    return out.reshape(symbols.shape)


def decode_bits(symbols: torch.Tensor, const: Constellation, hard: bool = True) -> torch.Tensor:
    """Demap symbols (...,) to bits (..., bits_per_symbol) uint8: by the
    O(1) slicer (``decode_hard``) or, with ``hard=False``, by ``decode_nn``."""
    idx = decode_hard(symbols, const) if hard else decode_nn(symbols, const)
    return indices_to_bits(idx, const.bits_per_symbol)


# --- gap-function bit loading (host, float64) -----------------------------------


def qam_bit_loading_orders(ser: float, snr: NDArray[np.float64]) -> NDArray[np.int64]:
    """QAM gap-function order per subcarrier (reference constellation/models.py:297-321).

    Gamma = (1/3) Qinv(SER/4)^2; b = round(log2(1 + SNR/Gamma)) forced even
    (square QAM); order 2^b, or 0 when b <= 0.  Not clamped to the config's
    maximum order, as in the reference."""
    snr = np.asarray(snr, dtype=np.float64)
    q_inv = norm.isf(ser / 4)
    gamma = (1.0 / 3.0) * q_inv**2
    b = np.round(np.log2(1.0 + snr / gamma)).astype(np.int64)
    b = np.where(b % 2 != 0, b - 1, b)
    return np.where(b > 0, np.int64(1) << np.maximum(b, 0), 0).astype(np.int64)


def psk_bit_loading_orders(ser: float, snr: NDArray[np.float64]) -> NDArray[np.int64]:
    """PSK gap-function order per subcarrier (reference constellation/models.py:459-474)."""
    snr = np.asarray(snr, dtype=np.float64)
    q_inv = norm.isf(ser / 2)
    gamma_star = q_inv**2 / (2.0 * np.pi**2)
    with np.errstate(invalid="ignore", divide="ignore"):
        gamma = np.sqrt(snr * gamma_star) / (1.0 - np.sqrt(gamma_star / (snr + 1e-10)))
        b = np.floor(np.log2(1.0 + snr / (gamma + 1e-10)) + 1e-10).astype(np.int64)
    return np.where(b > 0, np.int64(1) << np.maximum(b, 0), 0).astype(np.int64)


def bit_loading_orders(kind: str, ser: float, snr: NDArray[np.float64]) -> NDArray[np.int64]:
    """Orders per subcarrier for ``kind`` ("QAM" or "PSK") at per-subcarrier ``snr``."""
    if kind == "QAM":
        return qam_bit_loading_orders(ser, snr)
    if kind == "PSK":
        return psk_bit_loading_orders(ser, snr)
    raise ValueError(f"Unknown constellation kind: {kind}")
