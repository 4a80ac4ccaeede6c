"""Serial <-> parallel framing (the reference's S/P "DSP block").

The port's copy of ``ofdm_tpu.ops.framing``: the reference's
serial/parallel conversion (serial_parallel/models.py:5-21), a validated
reshape to ``(-1, streams)`` and back, on tensors.
"""

from __future__ import annotations

import torch


def to_parallel(data: torch.Tensor, num_streams: int) -> torch.Tensor:
    """1D stream -> (blocks, num_streams); validates divisibility."""
    if data.ndim != 1:
        raise ValueError("Input data must be a 1D array.")
    if num_streams <= 0:
        raise ValueError("Number of streams must be a positive integer.")
    if data.shape[0] % num_streams != 0:
        raise ValueError("Length of data must be divisible by number of streams.")
    return data.reshape(-1, num_streams)


def to_serial(data: torch.Tensor) -> torch.Tensor:
    """(blocks, num_streams) -> flat 1D stream."""
    if data.ndim != 2:
        raise ValueError("Input data must be a 2D array.")
    return data.reshape(-1)
