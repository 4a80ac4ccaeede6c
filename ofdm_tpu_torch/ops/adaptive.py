"""Adaptive per-subcarrier constellations: the host tables of CAPACITY_BASED loading.

The port's copy of what it needs from ``ofdm_tpu.ops.adaptive``: the
mapper's per-subcarrier orders and padded constellation tables, the
per-subcarrier index mask, a table encode (the sampled TX batch and the
eager chain) and the complex path's nearest-neighbour demap
(``decode_to_indices``, the eager chain's).
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
    """Host tables of one order layout."""

    kind: str  # "QAM" or "PSK"
    orders: NDArray[np.int64]  # (N,) constellation order per subcarrier, 0 inactive
    bits_per_subcarrier: NDArray[np.int64]  # (N,)
    # One padded table row per distinct active order, plus a zero row for
    # inactive subcarriers: (G + 1, max_order) complex128.
    tables: NDArray[np.complex128]
    group_id: NDArray[np.int32]  # (N,) row of ``tables`` per subcarrier
    max_order: int

    @property
    def bits_per_ofdm_symbol(self) -> int:
        return int(self.bits_per_subcarrier.sum())

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
    bits = np.where(orders > 0, np.log2(np.maximum(orders, 1)).astype(np.int64), 0)
    if int(bits.sum()) == 0:
        raise ValueError("No active subcarriers (all orders are zero)")
    uniq = [int(o) for o in np.unique(orders) if o > 0]
    max_order = max(uniq)
    tables = np.zeros((len(uniq) + 1, max_order), dtype=np.complex128)
    for g, o in enumerate(uniq):
        tables[g, :o] = make_constellation(kind, o).table
    group_of_order = {o: g for g, o in enumerate(uniq)}
    group_id = np.array([group_of_order[int(o)] if o > 0 else len(uniq) for o in orders], dtype=np.int32)
    return AdaptiveMapper(
        kind=kind,
        orders=orders,
        bits_per_subcarrier=bits,
        tables=tables,
        group_id=group_id,
        max_order=max_order,
    )


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


def decode_to_indices(symbols: torch.Tensor, m: AdaptiveMapper, rows: int = 4096) -> torch.Tensor:
    """Complex points (B, N) -> int64 hard-decision indices (B, N), each
    subcarrier against its own order's table: argmax over the padded
    table of 2 Re(y conj(c)) - |c|^2 in f32, padded entries at -inf (the
    index half of ofdm_tpu.ops.adaptive.decode, the complex path's demap).
    Runs ``rows`` symbols at a time to bound the (rows, N, max order)
    score plane."""
    dev = symbols.device
    tab = m.tables
    valid = np.zeros(tab.shape, dtype=bool)
    uniq = [int(o) for o in np.unique(m.orders) if o > 0]
    for g, o in enumerate(uniq):
        valid[g, :o] = True
    valid[len(uniq), :1] = True  # the inactive row: a single zero point
    gid = torch.tensor(m.group_id.astype(np.int64), device=dev)
    cre = torch.tensor((2.0 * tab.real).astype(np.float32), device=dev)[gid]  # (N, maxM)
    cim = torch.tensor((2.0 * tab.imag).astype(np.float32), device=dev)[gid]
    bias = torch.tensor(np.where(valid, -np.abs(tab) ** 2, -np.inf).astype(np.float32), device=dev)[gid]
    out = torch.empty(symbols.shape, dtype=torch.int64, device=dev)
    for r0 in range(0, symbols.shape[0], rows):
        y = symbols[r0 : r0 + rows]
        scores = y.real[..., None] * cre + y.imag[..., None] * cim + bias
        out[r0 : r0 + rows] = torch.argmax(scores, dim=-1)
    return out
