"""Bit-source ops: counter-based random bits, pack / unpack.

The port's copy of ``ofdm_tpu.ops.bits``.  The JAX package draws its bits
from ``jax.random.bits`` (threefry); the port has no threefry and draws
them from its own Philox stream (``prng.random_u32``, whose kernel is K4's
port ``ofdm_philox``), so parity is statistical (SURVEY §7.1) while seeded
runs of the port are reproducible and the kernel equals its plain version
bit for bit.  A key is a seed or a ``prng.key_words`` pair;
``prng.fold_in`` splits it into independent sub-streams.
"""

from __future__ import annotations

import math

import torch

from ofdm_tpu_torch.ops import prng


def random_bits(key, shape, device="cuda") -> torch.Tensor:
    """Uniform random bits of ``shape`` as uint8 zeros and ones.

    ceil(nbits / 32) words of ``prng.random_u32`` (the ``ofdm_philox``
    kernel on a CUDA device, its plain version on the CPU), unpacked as the
    JAX package's ``random_bits`` unpacks its words: bit j of word w is bit
    32 w + j, least significant first, truncated to nbits.  The words are
    int32 holding the uint32 bits; the arithmetic shift copies the sign bit
    only above bit 31, so ``(w >> j) & 1`` is bit j for every j < 32."""
    nbits = math.prod(shape) if shape else 1
    words = prng.random_u32(prng.key_words(key), (-(-nbits // 32),), device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, None] >> shifts) & 1).to(torch.uint8).reshape(-1)[:nbits]
    return bits.reshape(shape)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., 8k) uint8 bits MSB-first into (..., k) uint8 bytes."""
    *lead, n = bits.shape
    if n % 8:
        raise ValueError("Bit count must be a multiple of 8 to pack into bytes.")
    groups = bits.reshape(*lead, n // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device)
    return (groups * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """Unpack (..., k) uint8 bytes MSB-first into (..., 8k) uint8 bits."""
    shifts = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)
