"""Channel transmission of the eager chain: stream FIR convolution + AWGN.

The port's copy of ``ofdm_tpu.ops.channel`` on native complex tensors.
The reference convolves the whole serial sample stream with the channel
impulse response (channel/models.py:46-62), so block k's first ``order``
samples depend on block k-1's tail.  ``convolve_blocks`` convolves each
block row with the taps by shifted accumulation, adds each row's tail into
the head of the next row, and threads the last tail through a (K-1,)
``carry``, so that chunk after chunk equals the stream convolution.

AWGN (noise/models.py:13-22): the noise power follows the *measured*
power of the convolved signal, here the mean |y|^2 over the whole chunk,
and noise = sqrt(P_n / 2) (z0 + j z1).  The normals are the caller's: the
eager chain draws them from ``prng.normal_planes`` (the K5 port) at the
chunk's run symbols and time samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def snr_linear(snr_db, device) -> torch.Tensor:
    """10^(snr_db / 10) in f32 as the JAX XLA path takes it: f32(snr_db) / 10
    then a power of 10, a 0-dim tensor on ``device``."""
    return torch.pow(torch.tensor(10.0, dtype=torch.float32, device=device),
                     torch.tensor(float(snr_db), dtype=torch.float32, device=device) / 10.0)


def mean_abs2(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Mean of |x|^2 (f32 for complex64), over ``dim`` or everything."""
    p = x.real * x.real + x.imag * x.imag
    return p.mean() if dim is None else p.mean(dim=dim, keepdim=keepdim)


def convolve_blocks(blocks: torch.Tensor, taps: torch.Tensor,
                    carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream-convolve ``blocks`` (B, T) with ``taps`` (K,), K - 1 <= T.

    Returns ``(out, new_carry)``: ``out`` is the full convolution of the
    stream [previous samples, blocks.ravel()] with the taps, restricted to
    this chunk's samples; ``new_carry`` the (K - 1,) tail for the next
    chunk.  ``carry=None`` means the stream's start (zeros)."""
    B, T = blocks.shape
    K = taps.shape[0]
    if K - 1 > T:
        raise ValueError(f"Channel order {K - 1} exceeds block length {T}.")
    taps = taps.to(device=blocks.device, dtype=blocks.dtype)
    if K == 1:
        return taps[0] * blocks, blocks.new_zeros((0,))
    y_full = blocks.new_zeros((B, T + K - 1))
    for k in range(K):
        y_full[:, k : k + T] += taps[k] * blocks
    out = y_full[:, :T]
    tail = y_full[:, T:]
    if carry is None:
        carry = blocks.new_zeros((K - 1,))
    out[0, : K - 1] += carry.to(blocks.dtype)
    out[1:, : K - 1] += tail[:-1]
    return out, tail[-1].clone()


def awgn(signal: torch.Tensor, snr_db, z: Tuple[torch.Tensor, torch.Tensor],
         power: Optional[torch.Tensor] = None) -> torch.Tensor:
    """signal + sigma (z0 + j z1), sigma = sqrt(measured power / snr_lin / 2),
    the measured power the mean |signal|^2, or ``power`` when given (a
    sharded run's mean over its ranks)."""
    if power is None:
        power = mean_abs2(signal)
    noise_power = power / snr_linear(snr_db, signal.device)
    sigma = torch.sqrt(noise_power / 2.0)
    return signal + torch.complex(sigma * z[0], sigma * z[1])


def transmit(blocks: torch.Tensor, taps: torch.Tensor, snr_db, z=None, add_noise: bool = True,
             carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel transmit = stream convolution + (optional) AWGN with the
    normals ``z``.  ``taps`` must be the unit-energy impulse response."""
    convolved, new_carry = convolve_blocks(blocks, taps, carry)
    if add_noise:
        convolved = awgn(convolved, snr_db, z)
    return convolved, new_carry
