"""Per-subcarrier one-tap frequency-domain equalizers (ZF / MMSE / none).

The port's copy of ``ofdm_tpu.ops.equalize`` on native complex tensors,
for the eager chain: ``rx`` is (..., N), ``h_freq`` (N,).

  * ZF (equalization/models.py:22-35): rx / H with H == 0 replaced by 1e-10.
  * MMSE (:39-63): the noise variance is re-estimated from each received
    row, sigma^2 = mean(|rx_row|^2) / snr_lin / mean(|H|^2), and the filter
    is conj(H) / (|H|^2 + sigma^2).
  * H is the caller's: the pipeline passes the FFT of the *un-normalized*
    impulse response (docs/PARITY.md quirk 1).
"""

from __future__ import annotations

import torch

from ofdm_tpu_torch.config import EqualizationMethod
from ofdm_tpu_torch.ops.channel import mean_abs2, snr_linear

_EPS = 1e-10


def zero_forcing(rx: torch.Tensor, h_freq: torch.Tensor) -> torch.Tensor:
    h = torch.where(h_freq == 0, torch.full_like(h_freq, _EPS), h_freq)
    return rx / h


def mmse(rx: torch.Tensor, h_freq: torch.Tensor, snr_db) -> torch.Tensor:
    snr_lin = snr_linear(snr_db, rx.device)
    h_abs2 = h_freq.real * h_freq.real + h_freq.imag * h_freq.imag
    channel_gain = h_abs2.mean()
    noise_variance = mean_abs2(rx, dim=-1, keepdim=True) / snr_lin / channel_gain
    gain = 1.0 / (h_abs2 + noise_variance)
    return rx * (torch.conj(h_freq) * gain)


def equalize(rx: torch.Tensor, h_freq: torch.Tensor, method: EqualizationMethod, snr_db) -> torch.Tensor:
    """ZF, MMSE or no equalizer by ``method``."""
    if method == EqualizationMethod.ZF:
        return zero_forcing(rx, h_freq)
    if method == EqualizationMethod.MMSE:
        return mmse(rx, h_freq, snr_db)
    if method == EqualizationMethod.NONE:
        return rx
    raise ValueError(f"Unknown equalization method: {method}")
