"""The listed terms of the narrow fold and mm kernels' complex products.

``csrc/group_product.cuh`` multiplies a group of symbols by a matrix M
(rows x cols) over M's listed terms only: lane l of a warp computes output
column c = 32 j + l of chunk j.  Each column's nonzero rows (an element is
nonzero when its real or imaginary part is) are split, at gaps of GAP rows
or more, into clusters; the q-th clusters of a chunk's columns form the
chunk's segment q, which runs ``trip`` (its longest cluster) terms a lane
from the lane's own first row lo = min(cluster start, rows - trip), so the
window stays inside the input and holds the cluster.  Elements of the
window outside the lane's cluster are packed as zero: their terms are +-0.

Each output is then the sum of its nonzero terms in ascending row order,
each (a*m_r - c*m_i), (a*m_i + c*m_r) rounded before it is added, from +0:
bit for bit ``link_kernel.cmatmul``, which adds the same terms and, for
each zero element, a +-0 that leaves a sum started at +0 unchanged
(``group_product_plain`` repeats the kernel's order; the CPU tests hold it
against cmatmul).  A copy column (one element, 1 + 0i) costs one term, a
zero column none.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

LANES = 32  # output columns a chunk: a warp's lanes
GAP = 16  # zero rows that split a column's nonzero rows into two clusters
AHEAD = 4  # zero rows after the packed elements: the kernels load that far ahead (kAhead)


@dataclasses.dataclass(frozen=True)
class Terms:
    """A matrix's listed terms as the kernels read them (group_product.cuh::Terms)."""

    rows: int
    cols: int
    p: torch.Tensor  # f32 (2 * 32 * (packed rows + AHEAD),): (re, im) at row off[q] + i, lane l
    idx: torch.Tensor  # int32: seg (chunks + 1) | off (segments + 1) | lo (32 * segments)
    chunks: int
    nonzero: int  # nonzero elements

    def args(self):
        """(p, idx, chunks): the entry points' arguments."""
        return self.p.data_ptr(), self.idx.data_ptr(), self.chunks

    def segments(self) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
        """(chunk, trip, lo (32,), elements (trip, 32) complex64) of each segment, in order."""
        idx = self.idx.cpu().numpy()
        seg = idx[: self.chunks + 1]
        nseg = int(seg[-1])
        off = idx[self.chunks + 1 : self.chunks + 2 + nseg]
        lo = idx[self.chunks + 2 + nseg :].reshape(nseg, LANES)
        p = self.p.cpu().numpy().reshape(-1, LANES, 2)
        out = []
        for j in range(self.chunks):
            for q in range(int(seg[j]), int(seg[j + 1])):
                rows = p[off[q] : off[q + 1]]
                out.append((j, int(off[q + 1] - off[q]), lo[q], (rows[..., 0] + 1j * rows[..., 1]).astype(np.complex64)))
        return out


def _clusters(rows: np.ndarray) -> List[Tuple[int, int]]:
    """[start, end) runs of ascending row indices, split at gaps of GAP or more."""
    if rows.size == 0:
        return []
    cuts = np.flatnonzero(np.diff(rows) > GAP) + 1
    return [(int(r[0]), int(r[-1]) + 1) for r in np.split(rows, cuts)]


def term_list(mr: torch.Tensor, mi: torch.Tensor, device) -> Terms:
    """The listed terms of the complex matrix (mr, mi) (f32, rows x cols), on ``device``."""
    re = mr.detach().cpu().numpy().astype(np.float32)
    im = mi.detach().cpu().numpy().astype(np.float32)
    K, C = re.shape
    nz = (re != 0) | (im != 0)
    chunks = -(-C // LANES)
    seg, off, lo, packed = [0], [0], [], []
    for j in range(chunks):
        cols = range(LANES * j, min(LANES * j + LANES, C))
        clusters = [_clusters(np.flatnonzero(nz[:, c])) for c in cols]
        clusters += [[]] * (LANES - len(clusters))
        for q in range(max(len(cl) for cl in clusters)):
            trip = max(b - a for cl in clusters if len(cl) > q for a, b in [cl[q]])
            block = np.zeros((trip, LANES, 2), np.float32)
            for lane, cl in enumerate(clusters):
                if len(cl) <= q:
                    lo.append(0)
                    continue
                a, b = cl[q]
                start = min(a, K - trip)
                c = LANES * j + lane
                block[a - start : b - start, lane, 0] = re[a:b, c]
                block[a - start : b - start, lane, 1] = im[a:b, c]
                lo.append(start)
            packed.append(block)
            off.append(off[-1] + trip)
        seg.append(len(off) - 1)
    p = np.concatenate(packed + [np.zeros((AHEAD, LANES, 2), np.float32)]).reshape(-1)
    idx = np.asarray(seg + off + lo, np.int32)
    return Terms(rows=K, cols=C, p=torch.from_numpy(p).to(device), idx=torch.from_numpy(idx).to(device),
                 chunks=chunks, nonzero=int(nz.sum()))


def dense(t: Terms) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (rows, cols) f32 matrix pair the listed terms describe."""
    m = np.zeros((t.rows, LANES * t.chunks), np.complex64)
    for j, trip, lo, el in t.segments():
        for lane in range(LANES):
            live = el[:, lane] != 0
            m[lo[lane] + np.flatnonzero(live), LANES * j + lane] = el[live, lane]
    m = m[:, : t.cols]
    return torch.from_numpy(m.real.copy()), torch.from_numpy(m.imag.copy())


def lane_terms(t: Terms) -> int:
    """Terms a lane runs over all columns (the segments' trips x 32 lanes)."""
    return sum(LANES * trip for _, trip, _, _ in t.segments())


def group_product_plain(t: Terms, sr: torch.Tensor, si: torch.Tensor):
    """x = s @ M (s (batch, rows) f32) in the kernels' order: for each chunk,
    each segment's terms i < trip at each lane's window row lo + i, added to
    a sum from +0, every term (a*m_r - c*m_i), (a*m_i + c*m_r) rounded."""
    B = sr.shape[0]
    outr = torch.zeros((B, LANES * t.chunks), dtype=torch.float32)
    outi = torch.zeros_like(outr)
    acc = {}
    for j, trip, lo, el in t.segments():
        xr, xi = acc.get(j, (torch.zeros((B, LANES)), torch.zeros((B, LANES))))
        lo_t = torch.as_tensor(lo.astype(np.int64))
        for i in range(trip):
            a = sr[:, lo_t + i]
            c = si[:, lo_t + i]
            w_r = torch.from_numpy(el[i].real.copy())
            w_i = torch.from_numpy(el[i].imag.copy())
            xr = xr + (a * w_r - c * w_i)
            xi = xi + (a * w_i + c * w_r)
        acc[j] = (xr, xi)
    for j, (xr, xi) in acc.items():
        outr[:, LANES * j : LANES * j + LANES] = xr
        outi[:, LANES * j : LANES * j + LANES] = xi
    return outr[:, : t.cols], outi[:, : t.cols]


# --- the group kernels' layout (csrc/group_product.cuh) ------------------------

MAX_BLOCK_SMEM = 227 * 1024  # bytes of shared memory a block may hold
GROUP_WARPS = 8  # warps a block at most


def group_of(J: int) -> int:
    """Symbols a group holds at J bins a lane (group_product.cuh::group_of)."""
    return 4 if J <= 2 else 2


def group_bytes(J: int, n: int, T: int, E: int) -> int:
    """Bytes of a warp's group buffers (group_product.cuh::group_bytes): act
    (T+E rows), sb (n rows) and nt (E) at group_of(J) symbols, rounded to 16
    bytes."""
    S = group_of(J)
    return 8 * ((S * (T + E) + S * n + E + 1) // 2 * 2)


def group_warps(pair_bytes: int, fixed: int = 0) -> int:
    """Warps a block whose warps take ``pair_bytes`` each beside ``fixed``
    bytes: 8, or as many as fit in 227 KB (0: not one)."""
    return min(GROUP_WARPS, (MAX_BLOCK_SMEM - fixed) // pair_bytes)
