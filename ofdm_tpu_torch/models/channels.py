"""Built-in multipath channel impulse responses + channel helpers.

The reference ships seven complex128 impulse responses as `.npy` assets
(`config/channel_models/*.npy`, generated by
`examples/generate_channel_models.py:11-143`).  We embed the same *physical
channel coefficients* (they are data, and BER parity depends on them) and
provide the reference's channel-model math:

  * unit-energy normalization of the IR      (channel/models.py:37-44)
  * channel order = len(h) - 1               (channel/models.py:21-24)
  * frequency response H = FFT(h, n_fft)     (channel/models.py:26-30)
  * gains = |H|^2                            (channel/models.py:32-35)

All helpers here are host-side NumPy in float64: channel construction is
one-time setup, and SURVEY §7.3 requires f64 for H/gains so that waterfilling
water levels and adaptive order selection match the reference exactly.  The
port's own copy of ``ofdm_tpu.models.channels`` (same data, same math); the
kernel consumes the results as f32 constant rows.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from numpy.typing import NDArray


def _unit_energy(h: NDArray[np.complex128]) -> NDArray[np.complex128]:
    return h / np.sqrt(np.sum(np.abs(h) ** 2))


def _rayleigh_fading_6tap() -> NDArray[np.complex128]:
    """6-tap Rayleigh channel with exponential power delay profile.

    Reproduces examples/generate_channel_models.py:70-78 (seed 42).
    """
    rng = np.random.RandomState(42)
    num_taps = 6
    h = (rng.randn(num_taps) + 1j * rng.randn(num_taps)) / np.sqrt(2)
    h = h * np.sqrt(np.exp(-np.arange(num_taps) / 2.0))
    return _unit_energy(h)


# The reference's hardcoded default channel (simulation/models.py:237-245),
# identical to config/channel_models/default_multipath.npy.
DEFAULT_MULTIPATH = np.array(
    [
        7.767824138452235072e-01 + 4.560896742466611919e-01j,
        -6.669848996328063551e-02 + 2.839935704583463338e-01j,
        1.398968327715586490e-01 - 1.591963958343969865e-01j,
        2.229949514514480494e-02 + 2.409945439452868821e-01j,
    ],
    dtype=np.complex128,
)

CHANNEL_MODELS: Dict[str, NDArray[np.complex128]] = {
    "default_multipath": DEFAULT_MULTIPATH,
    "flat_fading": np.array([1.0 + 0.0j], dtype=np.complex128),
    "two_ray": _unit_energy(np.array([1.0 + 0.0j, 0.5 - 0.3j], dtype=np.complex128)),
    "severe_multipath": _unit_energy(
        np.array(
            [
                0.8 + 0.3j,
                0.5 - 0.2j,
                0.3 + 0.4j,
                -0.2 + 0.3j,
                0.15 - 0.25j,
                0.1 + 0.1j,
                -0.08 + 0.12j,
                0.05 - 0.05j,
            ],
            dtype=np.complex128,
        )
    ),
    "rayleigh_fading": _rayleigh_fading_6tap(),
    "Lin-Phoong_P1": _unit_energy(
        np.array(
            [0.9 + 0.1j, 0.3 - 0.2j, -0.1 + 0.3j, 0.05 + 0.05j],
            dtype=np.complex128,
        )
    ),
    # 4-tap channel P2 from the Lin & Phoong precoder literature; shipped as a
    # raw asset by the reference (config/channel_models/Lin-Phoong_P2.npy) and
    # used for the published BER tables (docs/OFDM-Based Systems.tex:199-264).
    "Lin-Phoong_P2": np.array(
        [
            -0.36988755 - 0.57818054j,
            -0.40528636 - 0.57498065j,
            -0.08339719 - 0.04059863j,
            0.15869466 - 0.01559948j,
        ],
        dtype=np.complex128,
    ),
}


def list_channels() -> List[str]:
    return sorted(CHANNEL_MODELS)


def get_channel(name_or_path: str | None) -> NDArray[np.complex128]:
    """Resolve a channel spec to a raw (un-normalized) impulse response.

    Accepts a built-in model name, a path to a `.npy` file (reference
    CUSTOM-channel semantics, simulation/models.py:169-188), or None for the
    reference's hardcoded default multipath channel.
    """
    if name_or_path is None:
        return DEFAULT_MULTIPATH.copy()
    if name_or_path in CHANNEL_MODELS:
        return CHANNEL_MODELS[name_or_path].copy()
    # Treat as a path; also try resolving "config/channel_models/X.npy"
    # style reference paths to the built-in of the same stem.
    if os.path.exists(name_or_path):
        h = np.load(name_or_path)
        if h.ndim != 1:
            raise ValueError("Channel impulse response must be 1D.")
        return np.asarray(h, dtype=np.complex128)
    stem = os.path.splitext(os.path.basename(name_or_path))[0]
    if stem in CHANNEL_MODELS:
        return CHANNEL_MODELS[stem].copy()
    raise FileNotFoundError(f"Channel model not found: {name_or_path}")


def normalize_impulse_response(h: NDArray[np.complex128]) -> NDArray[np.complex128]:
    """Normalize IR to unit energy (channel/models.py:37-44)."""
    power = np.sum(np.abs(h) ** 2)
    if power == 0:
        raise ValueError("Impulse response cannot be all zeros.")
    return h / np.sqrt(power)


def channel_order(h: NDArray[np.complex128]) -> int:
    """Channel order = number of taps - 1 (channel/models.py:21-24)."""
    return len(h) - 1


def channel_frequency_response(
    h: NDArray[np.complex128], n_fft: int
) -> NDArray[np.complex128]:
    """H = FFT(h, n_fft) in float64 (channel/models.py:26-30)."""
    return np.fft.fft(np.asarray(h, dtype=np.complex128), n=n_fft)


def channel_gains(h: NDArray[np.complex128], n_fft: int) -> NDArray[np.float64]:
    """|H|^2 per subcarrier (channel/models.py:32-35)."""
    return np.abs(channel_frequency_response(h, n_fft)) ** 2


def export_channel_models(output_dir: str) -> None:
    """Write all built-in channels as `.npy` assets (reference asset layout)."""
    os.makedirs(output_dir, exist_ok=True)
    for name, h in CHANNEL_MODELS.items():
        np.save(os.path.join(output_dir, f"{name}.npy"), h)


if __name__ == "__main__":  # pragma: no cover
    export_channel_models("config/channel_models")
    for _name in list_channels():
        print(f"{_name}: {len(CHANNEL_MODELS[_name])} taps")
