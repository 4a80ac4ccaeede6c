"""Adaptive per-subcarrier constellations: the host tables of CAPACITY_BASED loading.

The port's copy of ``ofdm_tpu.ops.adaptive`` on complex tensors: the
mapper's per-subcarrier orders, padded constellation tables and bit
gather / scatter tables, the per-subcarrier index mask, a table encode
(the sampled TX batch and the eager chain), the complex path's
nearest-neighbour demap (``decode_to_indices``, the eager chain's), the
bit-level ``encode`` / ``decode`` and the host order helpers
(``calculate_requirements``, ``calculate_constellation_orders``).
The chunk kernels never read a table: they encode and slice each
subcarrier arithmetically from lane rows (``ops.link_kernel.Codec``).

Layout contract (the reference's): one OFDM symbol carries
sum(log2 order_k) bits; a subcarrier of order 0 sends the zero symbol and
carries no bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from numpy.typing import NDArray

from ofdm_tpu_torch.ops.mapping import make_constellation


@dataclasses.dataclass(frozen=True)
class AdaptiveMapper:
    """Host tables of one order layout (``ofdm_tpu.ops.adaptive.AdaptiveMapper``'s
    fields, built the same way)."""

    kind: str  # "QAM" or "PSK"
    orders: NDArray[np.int64]  # (N,) constellation order per subcarrier, 0 inactive
    bits_per_subcarrier: NDArray[np.int64]  # (N,)
    num_subcarriers: int
    # One padded table row per distinct active order, plus a zero row for
    # inactive subcarriers: (G + 1, max_order) complex128.
    tables: NDArray[np.complex128]
    group_id: NDArray[np.int32]  # (N,) row of ``tables`` per subcarrier
    # The bit gather / scatter tables of ``encode`` and ``decode``:
    gather_idx: NDArray[np.int32]  # (N, max_bits): position in the S-bit word
    bit_mask: NDArray[np.bool_]  # (N, max_bits): j < bits_per_subcarrier[k]
    weights: NDArray[np.int32]  # (N, max_bits): 2^(b_k-1-j), 0 when masked
    src_k: NDArray[np.int32]  # (S,): subcarrier owning bit position p
    src_j: NDArray[np.int32]  # (S,): bit-within-subcarrier for position p
    max_bits: int
    max_order: int

    @property
    def bits_per_ofdm_symbol(self) -> int:
        return int(self.bits_per_subcarrier.sum())

    @property
    def active(self) -> NDArray[np.bool_]:
        return self.orders > 0

    @property
    def name(self) -> str:
        """Reference naming (constellation/adaptive.py:101-111)."""
        uniq = np.unique(self.orders[self.orders > 0])
        if uniq.size == 0:
            return "No-Transmission"
        if uniq.size == 1:
            return f"{int(uniq[0])}-{self.kind}"
        return f"Adaptive-{int(uniq.min())}-to-{int(uniq.max())}-{self.kind}"

    @property
    def composite_constellation(self) -> NDArray[np.complex128]:
        """The distinct points of every active order (constellation/adaptive.py:84-90)."""
        pts = []
        for order in np.unique(self.orders[self.orders > 0]):
            pts.extend(make_constellation(self.kind, int(order)).table.tolist())
        return np.unique(np.asarray(pts, dtype=np.complex128))


def make_adaptive_mapper(kind: str, orders: NDArray[np.int64]) -> AdaptiveMapper:
    """The mapper of an order layout; raises when no subcarrier is active."""
    orders = np.asarray(orders, dtype=np.int64)
    n = len(orders)
    bits = np.where(orders > 0, np.log2(np.maximum(orders, 1)).astype(np.int64), 0)
    S = int(bits.sum())
    if S == 0:
        raise ValueError("No active subcarriers (all orders are zero)")
    max_bits = int(bits.max())
    uniq = [int(o) for o in np.unique(orders) if o > 0]
    max_order = max(uniq)
    tables = np.zeros((len(uniq) + 1, max_order), dtype=np.complex128)
    for g, o in enumerate(uniq):
        tables[g, :o] = make_constellation(kind, o).table
    group_of_order = {o: g for g, o in enumerate(uniq)}
    group_id = np.array([group_of_order[int(o)] if o > 0 else len(uniq) for o in orders], dtype=np.int32)

    offsets = np.concatenate([[0], np.cumsum(bits)[:-1]])
    j = np.arange(max_bits)
    bit_mask = j[None, :] < bits[:, None]
    gather_idx = np.where(bit_mask, offsets[:, None] + j[None, :], 0).astype(np.int32)
    weights = np.where(bit_mask, 1 << np.maximum(bits[:, None] - 1 - j[None, :], 0), 0).astype(np.int32)
    src_k = np.repeat(np.arange(n), bits).astype(np.int32)
    src_j = (np.arange(S) - offsets[src_k]).astype(np.int32)
    return AdaptiveMapper(
        kind=kind,
        orders=orders,
        bits_per_subcarrier=bits,
        num_subcarriers=n,
        tables=tables,
        group_id=group_id,
        gather_idx=gather_idx,
        bit_mask=bit_mask,
        weights=weights,
        src_k=src_k,
        src_j=src_j,
        max_bits=max_bits,
        max_order=max_order,
    )


def calculate_requirements(constellation_orders: NDArray[np.int64], num_ofdm_symbols: int):
    """(total_bits, bits_per_subcarrier) for an order layout
    (bits_generation/models.py:130-163): bits a subcarrier log2(order), 0
    when inactive; total = their sum x num_ofdm_symbols."""
    orders = np.asarray(constellation_orders, dtype=np.int64)
    bits = np.where(orders > 0, np.log2(np.maximum(orders, 1)).astype(np.int64), 0)
    return int(bits.sum() * num_ofdm_symbols), bits


def calculate_constellation_orders(
    capacity: NDArray[np.float64],
    min_order: int,
    max_order: int,
    scaling_factor: float,
    kind: str = "QAM",
) -> NDArray[np.int64]:
    """Shannon-capacity-based order selection (constellation/adaptive.py:271-328):
    scale the capacity, clip to [0, log2(max_order)], even bits for QAM /
    floor for PSK, zero below log2(min_order), 2^bits."""
    bits = np.asarray(capacity, dtype=np.float64) * scaling_factor
    bits = np.clip(bits, 0, np.log2(max_order))
    if kind == "QAM":
        bits = bits // 2 * 2
    else:
        bits = np.floor(bits)
    bits = np.where(bits < np.log2(min_order), 0, bits)
    return np.where(bits > 0, 2 ** bits, 0).astype(np.int64)


def index_mask(m: AdaptiveMapper) -> NDArray[np.uint32]:
    """(N,) mask: order_k - 1 on active subcarriers, 0 on inactive ones, so
    uniform bits & mask is a uniform index of each subcarrier."""
    return np.where(m.orders > 0, m.orders - 1, 0).astype(np.uint32)


def encode_from_indices(idx: torch.Tensor, m: AdaptiveMapper):
    """(B, N) indices -> (re, im) f32 points from each subcarrier's table
    (inactive subcarriers send 0), on the indices' device."""
    flat = m.tables.reshape(-1)
    tr = torch.tensor(flat.real.astype(np.float32), device=idx.device)
    ti = torch.tensor(flat.imag.astype(np.float32), device=idx.device)
    base = torch.tensor(m.group_id.astype(np.int64) * m.max_order, device=idx.device)
    i = base + idx.to(torch.int64)
    return tr[i], ti[i]


def encode_complex(idx: torch.Tensor, m: AdaptiveMapper) -> torch.Tensor:
    """``encode_from_indices`` as one complex64 plane."""
    re, im = encode_from_indices(idx, m)
    return torch.complex(re, im)


def encode(bits: torch.Tensor, m: AdaptiveMapper, dtype=torch.complex64):
    """bits (B, S) -> (symbols (B, N), int32 indices (B, N)): subcarrier k's
    index packs its bits MSB-first through ``gather_idx`` / ``weights``, its
    point comes from its order's table (inactive subcarriers send 0)."""
    dev = bits.device
    gather = torch.tensor(m.gather_idx.astype(np.int64), device=dev)
    weights = torch.tensor(m.weights, device=dev)
    idx = (bits[:, gather].to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)
    flat = torch.tensor(m.tables.reshape(-1), dtype=dtype, device=dev)
    base = torch.tensor(m.group_id.astype(np.int64) * m.max_order, device=dev)
    return flat[base + idx.to(torch.int64)], idx


def _nn_rows(m: AdaptiveMapper, device):
    """(cre, cim, bias), each (N, max order) f32: subcarrier k's padded table
    row as 2 Re c, 2 Im c and -|c|^2, with -inf on padded entries (the
    inactive row keeps its single zero point)."""
    tab = m.tables
    valid = np.zeros(tab.shape, dtype=bool)
    uniq = [int(o) for o in np.unique(m.orders) if o > 0]
    for g, o in enumerate(uniq):
        valid[g, :o] = True
    valid[len(uniq), :1] = True
    gid = torch.tensor(m.group_id.astype(np.int64), device=device)
    cre = torch.tensor((2.0 * tab.real).astype(np.float32), device=device)[gid]
    cim = torch.tensor((2.0 * tab.imag).astype(np.float32), device=device)[gid]
    bias = torch.tensor(np.where(valid, -np.abs(tab) ** 2, -np.inf).astype(np.float32), device=device)[gid]
    return cre, cim, bias


def _nn_indices(y: torch.Tensor, rows) -> torch.Tensor:
    """argmax over the padded table of yr * cre + yi * cim + bias, in that
    order (the JAX package's), the first maximum on a tie."""
    cre, cim, bias = rows
    scores = y.real[..., None] * cre + y.imag[..., None] * cim + bias
    return torch.argmax(scores, dim=-1)


def decode_to_indices(symbols: torch.Tensor, m: AdaptiveMapper, rows: int = 4096) -> torch.Tensor:
    """Complex points (B, N) -> int64 hard-decision indices (B, N), each
    subcarrier against its own order's table: argmax over the padded
    table of 2 Re(y conj(c)) - |c|^2 in f32, padded entries at -inf (the
    index half of ofdm_tpu.ops.adaptive.decode, the complex path's demap).
    Runs ``rows`` symbols at a time to bound the (rows, N, max order)
    score plane."""
    nn = _nn_rows(m, symbols.device)
    out = torch.empty(symbols.shape, dtype=torch.int64, device=symbols.device)
    for r0 in range(0, symbols.shape[0], rows):
        out[r0 : r0 + rows] = _nn_indices(symbols[r0 : r0 + rows], nn)
    return out


def decode(symbols: torch.Tensor, m: AdaptiveMapper, rows: int = 4096):
    """symbols (B, N) -> (uint8 bits (B, S), int64 indices (B, N)): the
    indices of ``decode_to_indices``, each unpacked MSB-first into its
    subcarrier's bits and scattered into the S-bit layout through ``src_k``
    / ``src_j``.  ``rows`` symbols at a time, as ``decode_to_indices``."""
    dev = symbols.device
    nn = _nn_rows(m, dev)
    shifts = torch.tensor(np.maximum(m.bits_per_subcarrier[:, None] - 1 - np.arange(m.max_bits)[None, :], 0),
                          device=dev)
    src_k = torch.tensor(m.src_k.astype(np.int64), device=dev)
    src_j = torch.tensor(m.src_j.astype(np.int64), device=dev)
    idx = torch.empty(symbols.shape, dtype=torch.int64, device=dev)
    bits = torch.empty((symbols.shape[0], len(m.src_k)), dtype=torch.uint8, device=dev)
    for r0 in range(0, symbols.shape[0], rows):
        i = _nn_indices(symbols[r0 : r0 + rows], nn)
        idx[r0 : r0 + rows] = i
        bits[r0 : r0 + rows] = ((i[..., None] >> shifts) & 1).to(torch.uint8)[:, src_k, src_j]
    return bits, idx
