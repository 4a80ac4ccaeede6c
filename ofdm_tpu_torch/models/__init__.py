"""Channel models for ofdm_tpu_torch."""

from ofdm_tpu_torch.models.channels import (
    CHANNEL_MODELS,
    channel_frequency_response,
    get_channel,
    normalize_impulse_response,
)

__all__ = [
    "CHANNEL_MODELS",
    "channel_frequency_response",
    "get_channel",
    "normalize_impulse_response",
]
