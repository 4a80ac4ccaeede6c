"""OFDM / SC-FDE modulation of the eager chain: guards around the ortho (I)DFT.

The port's copy of ``ofdm_tpu.ops.ofdm`` on native complex tensors, for
the eager chain (``pipeline.eager_chunk``) and the bit-level chain.  The
transforms are ``ops.dft.fft_ortho`` / ``ifft_ortho`` (PyTorch's
``torch.fft`` with ``norm="ortho"``, in the input's complex type);
``to_parallel`` / ``to_serial`` live in ``ops.framing`` and are imported
here too, where earlier callers find them.  Every function works on
``(..., N)`` or ``(..., N + L)`` blocks.

Reference semantics (modulation/models.py, prefix/models.py):
  * OFDM TX: IFFT(norm="ortho") then prefix; RX: strip prefix, FFT(ortho)
  * SC-FDE TX: prefix only; RX: strip, FFT, equalize, IFFT
  * CP: prepend the last L samples / drop the first L
  * ZP: append L zeros / overlap-add the L-sample tail onto the head
"""

from __future__ import annotations

import torch

from ofdm_tpu_torch.config import PrefixType
from ofdm_tpu_torch.ops.dft import fft_ortho, ifft_ortho
from ofdm_tpu_torch.ops.framing import to_parallel, to_serial  # noqa: F401 (their old home)


def add_prefix(x: torch.Tensor, prefix_type: PrefixType, prefix_length: int) -> torch.Tensor:
    """Add a guard interval along the last axis: (..., N) -> (..., N + L)."""
    if prefix_length == 0 or prefix_type == PrefixType.NONE:
        return x
    if prefix_type == PrefixType.CYCLIC:
        return torch.cat([x[..., -prefix_length:], x], dim=-1)
    if prefix_type == PrefixType.ZERO:
        return torch.nn.functional.pad(x, (0, prefix_length))
    raise ValueError(f"Unknown prefix type: {prefix_type}")


def remove_prefix(x: torch.Tensor, prefix_type: PrefixType, prefix_length: int) -> torch.Tensor:
    """Remove a guard interval along the last axis: (..., N + L) -> (..., N).
    A zero prefix folds its tail (this block's ISI spill) back onto the head."""
    if prefix_length == 0 or prefix_type == PrefixType.NONE:
        return x
    if prefix_type == PrefixType.CYCLIC:
        return x[..., prefix_length:]
    if prefix_type == PrefixType.ZERO:
        n = x.shape[-1] - prefix_length
        body = x[..., :n].clone()
        body[..., :prefix_length] += x[..., n:]
        return body
    raise ValueError(f"Unknown prefix type: {prefix_type}")


def ofdm_modulate(symbols: torch.Tensor, n_sc: int, prefix_type: PrefixType, prefix_length: int) -> torch.Tensor:
    """Frequency-domain symbols (..., N) -> time-domain blocks (..., N + L)."""
    return add_prefix(ifft_ortho(symbols, n_sc), prefix_type, prefix_length)


def ofdm_demodulate_to_freq(blocks: torch.Tensor, n_sc: int, prefix_type: PrefixType,
                            prefix_length: int) -> torch.Tensor:
    """Time blocks (..., N + L) -> unequalized frequency symbols (..., N)."""
    return fft_ortho(remove_prefix(blocks, prefix_type, prefix_length), n_sc)


def sc_modulate(symbols: torch.Tensor, prefix_type: PrefixType, prefix_length: int) -> torch.Tensor:
    """SC-FDE TX: time-domain symbols get only a guard interval."""
    return add_prefix(symbols, prefix_type, prefix_length)


def sc_demodulate_from_freq(equalized_freq: torch.Tensor, n_sc: int) -> torch.Tensor:
    """SC-FDE RX back-end: equalized frequency bins -> time-domain symbols."""
    return ifft_ortho(equalized_freq, n_sc)
