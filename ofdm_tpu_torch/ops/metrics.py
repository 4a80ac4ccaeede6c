"""Link metrics: bit and index-word bit/symbol errors, PAPR, BER intervals.

SER compares transmitted and received table indices, which equals the
reference's re-encode-and-compare (simulation/models.py:604-608).  PAPR is
10*log10(max|x|^2 / mean|x|^2) over the guarded time blocks
(simulation/models.py:519-524), finalized on the host from running stats.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits per element of a non-negative integer tensor (< 2^32)."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def bit_errors(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    """Count differing bits (uint8 tensors of any equal shape) -> int64 scalar.

    The JAX package counts in int32, exact below 2^31 bits a call; int64
    is the port's counter type (the chunk kernels' counters too), exact at
    any size a device holds."""
    return (tx_bits != rx_bits).sum(dtype=torch.int64)


def index_bit_errors(tx_idx: torch.Tensor, rx_idx: torch.Tensor, max_bits=None) -> torch.Tensor:
    """Bit errors between MSB-first index words: sum of popcount(tx ^ rx),
    over the low ``max_bits`` bits when given (ofdm_tpu.ops.metrics's fixed
    unroll; both indices below 2^max_bits make it the full popcount).

    The index IS the bit word, so this equals the per-bit comparison."""
    x = tx_idx.to(torch.int64) ^ rx_idx.to(torch.int64)
    if max_bits is not None:
        x = x & ((1 << int(max_bits)) - 1)
    return popcount(x).sum()


def symbol_errors(tx_idx: torch.Tensor, rx_idx: torch.Tensor) -> torch.Tensor:
    return (tx_idx != rx_idx).sum()


def papr_stats(xr: torch.Tensor, xi=None):
    """(peak power, power sum in float64, sample count) of a time plane:
    its (re, im) planes, or one complex plane."""
    if xi is None:
        xr, xi = xr.real, xr.imag
    p = xr * xr + xi * xi
    return p.max(), p.to(torch.float64).sum(), p.numel()


def papr_db(peak_power, power_sum, count) -> float:
    """Finalize PAPR in dB from accumulated stats."""
    avg = float(power_sum) / float(count)
    if avg <= 0:
        return float("inf")
    return 10.0 * math.log10(float(peak_power) / avg)


def ber_confidence_interval(errors: int, total_bits: int, z: float = 1.96):
    """(low, high) Wilson score interval for a BER estimate."""
    if total_bits <= 0:
        return (0.0, 1.0)
    p = errors / total_bits
    n = total_bits
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


def ber_equivalent(
    errors_a: int, bits_a: int, errors_b: int, bits_b: int, z: float = 1.96
) -> bool:
    """True when two BER estimates' confidence intervals overlap."""
    lo_a, hi_a = ber_confidence_interval(errors_a, bits_a, z)
    lo_b, hi_b = ber_confidence_interval(errors_b, bits_b, z)
    return hi_a >= lo_b and hi_b >= lo_a
