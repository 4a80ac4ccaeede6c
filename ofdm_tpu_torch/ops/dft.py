"""The orthonormal DFT pair, and the block DFT of the wide chunk kernels.

``fft_ortho`` / ``ifft_ortho`` are the JAX package's functions of the same
names on complex tensors (the eager and bit-level chains).  The rest holds
the wide kernels' host twiddles and plain versions.

Counterpart of ``ofdm_tpu/ops/dft.py``, whose XLA path computes every DFT
past 256 points by a two-factor Cooley-Tukey split (``_split_factors``,
``_apply_ct``) instead of a dense matrix.  The port's wide fold and mm
chains (``csrc/block_dft.cuh``) transform one symbol in a block's shared
memory:

* n a power of two: radix-2 decimation in time, the input loaded in
  bit-reversed order, log2 n stages of n / 2 butterflies; the butterfly
  (i0, i1) of half-size h takes the twiddle W_n^(pos n / 2h):
  t = w * x[i1], x[i0] = x[i0] + t, x[i1] = x[i0] - t.
* any other n: the JAX package's split n = N1 * N2 (N1 the largest divisor
  up to sqrt n), both sub-DFTs direct: A[a, k2] = sum_b x[a + N1 b]
  W_N2^(b k2), times W_n^(a k2); X[N2 k1 + k2] = sum_a A[a, k2]
  W_N1^(a k1).  A prime n degenerates into one direct DFT (N1 = 1).

Every twiddle is one entry of a single host table W_n^k (k < n), computed
in float64 and rounded to f32; the inverse reads its conjugate.  Each sum
runs in ascending order of rounded products ((a*w_r - c*w_i), (a*w_i +
c*w_r)), and the orthonormal 1/sqrt(n) (f32 of the float64 value)
multiplies the unscaled result once, as it is read.  Kernel and plain
version therefore agree bit for bit under ``-fmad=false``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


def fft_ortho(x: torch.Tensor, n: int) -> torch.Tensor:
    """Orthonormal DFT over the last axis (``ofdm_tpu.ops.dft.fft_ortho`` on
    a complex array: ``torch.fft.fft``, norm "ortho", in the input's type)."""
    return torch.fft.fft(x, n=n, dim=-1, norm="ortho")


def ifft_ortho(x: torch.Tensor, n: int) -> torch.Tensor:
    """Orthonormal inverse DFT over the last axis."""
    return torch.fft.ifft(x, n=n, dim=-1, norm="ortho")


def split_factors(n: int):
    """Near-square factor pair (N1, N2), N1 * N2 == n, N1 the largest divisor
    of n up to sqrt(n) (ofdm_tpu/ops/dft.py::_split_factors)."""
    n1 = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            n1 = f
            break
    return n1, n // n1


@dataclasses.dataclass(frozen=True)
class DftPlan:
    """One block DFT's constants: the size, its split (log2 n for a power of
    two, else -1 and the factors), the f32 twiddle rows W_n^k and the f32
    orthonormal scale."""

    n: int
    log2n: int  # -1: the two-factor split
    n1: int
    n2: int
    scale: float
    twr: torch.Tensor  # (n,) f32 cos(2 pi k / n)
    twi: torch.Tensor  # (n,) f32 -sin(2 pi k / n)


def dft_plan(n: int, device) -> DftPlan:
    """The block DFT plan of size ``n`` on ``device``."""
    k = np.arange(n, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / n)
    log2n = n.bit_length() - 1 if n & (n - 1) == 0 else -1
    n1, n2 = split_factors(n)
    return DftPlan(n, log2n, n1, n2, float(np.float32(1.0 / math.sqrt(n))),
                   torch.tensor(w.real.astype(np.float32), device=device),
                   torch.tensor(w.imag.astype(np.float32), device=device))


def _bitrev(n: int, bits: int) -> np.ndarray:
    i = np.arange(n)
    r = np.zeros(n, np.int64)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def _radix2(xr, xi, plan: DftPlan, wr, wi):
    n = plan.n
    perm = torch.as_tensor(_bitrev(n, plan.log2n), device=xr.device)
    xr, xi = xr[..., perm], xi[..., perm]
    lead = xr.shape[:-1]
    h = 1
    while h < n:
        idx = torch.arange(h, device=xr.device) * (n // (2 * h))
        w_r, w_i = wr[idx], wi[idx]
        vr = xr.reshape(*lead, n // (2 * h), 2, h)
        vi = xi.reshape(*lead, n // (2 * h), 2, h)
        ar, ai, br, bi = vr[..., 0, :], vi[..., 0, :], vr[..., 1, :], vi[..., 1, :]
        tr = w_r * br - w_i * bi
        ti = w_r * bi + w_i * br
        xr = torch.stack([ar + tr, ar - tr], dim=-2).reshape(*lead, n)
        xi = torch.stack([ai + ti, ai - ti], dim=-2).reshape(*lead, n)
        h *= 2
    return xr, xi


def _split(xr, xi, plan: DftPlan, wr, wi):
    n, n1, n2 = plan.n, plan.n1, plan.n2
    dev = xr.device
    lead = xr.shape[:-1]
    # A[a, k2] = sum_b x[a + N1 b] W^((b k2 mod N2) N1), b ascending
    xv_r = xr.reshape(*lead, n2, n1)
    xv_i = xi.reshape(*lead, n2, n1)
    k2 = torch.arange(n2, device=dev)
    acc_r = torch.zeros((*lead, n1, n2), dtype=torch.float32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    for b in range(n2):
        idx = ((b * k2) % n2) * n1
        w_r, w_i = wr[idx], wi[idx]
        a = xv_r[..., b, :, None]
        c = xv_i[..., b, :, None]
        acc_r = acc_r + (a * w_r - c * w_i)
        acc_i = acc_i + (a * w_i + c * w_r)
    # x W_n^(a k2)
    tw = torch.arange(n1, device=dev)[:, None] * k2[None, :]
    t_r, t_i = wr[tw], wi[tw]
    br = acc_r * t_r - acc_i * t_i
    bi = acc_r * t_i + acc_i * t_r
    # X[N2 k1 + k2] = sum_a B[a, k2] W^((a k1 mod N1) N2), a ascending
    k1 = torch.arange(n1, device=dev)
    out_r = torch.zeros((*lead, n1, n2), dtype=torch.float32, device=dev)
    out_i = torch.zeros_like(out_r)
    for a in range(n1):
        idx = ((a * k1) % n1) * n2
        w_r, w_i = wr[idx][:, None], wi[idx][:, None]
        p = br[..., a : a + 1, :]
        q = bi[..., a : a + 1, :]
        out_r = out_r + (p * w_r - q * w_i)
        out_i = out_i + (p * w_i + q * w_r)
    return out_r.reshape(*lead, n), out_i.reshape(*lead, n)


def block_dft(xr: torch.Tensor, xi: torch.Tensor, plan: DftPlan, inverse: bool = False):
    """The orthonormal (I)DFT over the last axis (of size ``plan.n``) in the
    block kernel's operations and order: f32 in, f32 out."""
    if xr.shape[-1] != plan.n:
        raise ValueError(f"block_dft: last axis must be {plan.n}, got {xr.shape[-1]}")
    wr, wi = plan.twr, -plan.twi if inverse else plan.twi
    yr, yi = (_radix2 if plan.log2n >= 0 else _split)(xr, xi, plan, wr, wi)
    s = torch.tensor(plan.scale, dtype=torch.float32, device=xr.device)
    return yr * s, yi * s


# --- the staged schedule of the wide chains' radix-2 transform ------------------------
#
# csrc/wide_dft.cuh runs block_dft's radix-2 butterflies at n = 256 J (J = 2,
# 4, 8 slots a thread of a 256-thread block) in rounds.  In round r, bit b
# of q = t | (j << 8) (lane bits 0-4, warp bits 5-7, slot bits 8..) sets bit
# STAGE_PERMS[n][r][b] of the position (block_dft's storage index: input m
# at its bit-reversed index) that thread t holds in slot j.  A round runs,
# in registers, the stages h = 2^s whose position bit s is a slot bit, in
# order; between rounds the elements move through shared memory, inside the
# warp where the warp bits keep their position bits.  The kernel's tables
# (kStagePerm) are these.

STAGE_THREADS = 256
STAGE_PERMS = {
    512: ((1, 2, 3, 4, 5, 6, 7, 8, 0),
          (2, 3, 4, 5, 0, 6, 7, 8, 1),
          (0, 1, 3, 4, 5, 6, 7, 8, 2),
          (0, 1, 2, 4, 5, 6, 7, 8, 3),
          (0, 1, 2, 3, 5, 6, 7, 8, 4),
          (0, 1, 2, 3, 4, 6, 7, 8, 5),
          (3, 4, 5, 7, 8, 0, 1, 2, 6),
          (3, 4, 5, 6, 8, 0, 1, 2, 7),
          (0, 1, 2, 3, 4, 5, 6, 7, 8)),
    1024: ((2, 3, 4, 5, 6, 7, 8, 9, 0, 1),
           (4, 5, 6, 0, 1, 7, 8, 9, 2, 3),
           (0, 1, 2, 3, 6, 7, 8, 9, 4, 5),
           (0, 1, 2, 3, 4, 7, 8, 9, 5, 6),
           (0, 1, 2, 3, 4, 5, 6, 9, 7, 8),
           (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
    2048: ((3, 4, 5, 6, 7, 8, 9, 10, 0, 1, 2),
           (6, 7, 0, 1, 2, 8, 9, 10, 3, 4, 5),
           (0, 1, 2, 3, 4, 8, 9, 10, 5, 6, 7),
           (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)),
}


@dataclasses.dataclass(frozen=True)
class StageRound:
    """One round of the staged schedule: ``table[t, j]`` the position thread t
    holds in slot j, ``stages`` the butterfly stages s (h = 2^s) it runs in
    registers, ``warp_local`` whether the move to the next round stays inside
    each warp (None for the last round)."""

    table: np.ndarray
    stages: Tuple[int, ...]
    warp_local: Optional[bool]


def stage_rounds(n: int):
    """The rounds of the staged transform at ``n`` (a key of STAGE_PERMS)."""
    perms = STAGE_PERMS[n]
    log2n = n.bit_length() - 1
    J = n // STAGE_THREADS
    q = np.arange(STAGE_THREADS)[:, None] | (np.arange(J)[None, :] << 8)
    out, nxt = [], 0
    for r, perm in enumerate(perms):
        table = np.zeros_like(q)
        for b, d in enumerate(perm):
            table |= ((q >> b) & 1) << d
        slot_bits = set(perm[8:])
        stages = []
        while nxt < log2n and nxt in slot_bits:
            stages.append(nxt)
            nxt += 1
        local = None if r + 1 == len(perms) else perm[5:8] == perms[r + 1][5:8]
        out.append(StageRound(table, tuple(stages), local))
    return out


def staged_block_dft(xr: torch.Tensor, xi: torch.Tensor, plan: DftPlan, inverse: bool = False):
    """``block_dft`` at n = 256 J run round by round as csrc/wide_dft.cuh runs
    it: each round gathers the (..., 256, J) elements its table names, runs
    its stages on a thread's slots (the butterfly of the slot pair whose
    positions differ in bit s, twiddle W_n^(pos n / 2h)) and scatters them
    back; the scale multiplies the result once."""
    n = plan.n
    if n not in STAGE_PERMS or plan.log2n < 0:
        raise ValueError(f"staged_block_dft runs at n in {sorted(STAGE_PERMS)}, got {n}")
    wr, wi = plan.twr, -plan.twi if inverse else plan.twi
    lead = xr.shape[:-1]
    # positions hold the input in bit-reversed order
    perm = torch.as_tensor(_bitrev(n, plan.log2n), device=xr.device)
    pr, pi = xr[..., perm].clone(), xi[..., perm].clone()
    for rnd in stage_rounds(n):
        table = torch.as_tensor(rnd.table, device=xr.device)
        flat = table.reshape(-1)
        vr = pr[..., flat].reshape(*lead, *table.shape)
        vi = pi[..., flat].reshape(*lead, *table.shape)
        for s in rnd.stages:
            for j in range(table.shape[1]):
                j1 = int(np.flatnonzero((rnd.table[0] ^ rnd.table[0, j]) == (1 << s))[0]) \
                    if not rnd.table[0, j] >> s & 1 else None
                if j1 is None:
                    continue
                pos = table[:, j] & ((1 << s) - 1)
                k = pos * (n >> (s + 1))
                w_r, w_i = wr[k], wi[k]
                ar, ai, br, bi = (v[..., c].clone() for v, c in ((vr, j), (vi, j), (vr, j1), (vi, j1)))
                tr = w_r * br - w_i * bi
                ti = w_r * bi + w_i * br
                vr[..., j], vi[..., j] = ar + tr, ai + ti
                vr[..., j1], vi[..., j1] = ar - tr, ai - ti
        pr[..., flat] = vr.reshape(*lead, -1)
        pi[..., flat] = vi.reshape(*lead, -1)
    s = torch.tensor(plan.scale, dtype=torch.float32, device=xr.device)
    return pr * s, pi * s
