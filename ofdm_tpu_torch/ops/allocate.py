"""Power allocation: uniform and waterfilling, host NumPy float64.

The reference's exact bisection (power_allocation/models.py:140-225), so the
port's allocations and water levels equal ``ofdm_tpu.ops.allocate`` bit for
bit.  Reference quirks kept: the floor is N0 / (|H|^2 * N), the bisection
runs on [0, P_total + max(floor)] for at most 100 steps at tol 1e-8, and the
budget is renormalized exactly afterwards.  The capacity helpers
(power_allocation/models.py:228-334) are the JAX package's expressions in
float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from numpy.typing import NDArray


def uniform(total_power: float, num_subcarriers: int) -> NDArray[np.float64]:
    """Equal power per subcarrier (power_allocation/models.py:31-69)."""
    if total_power < 0:
        raise ValueError(f"Total power must be non-negative, got {total_power}")
    if num_subcarriers <= 0:
        raise ValueError(f"Number of subcarriers must be positive, got {num_subcarriers}")
    return np.full(num_subcarriers, total_power / num_subcarriers, dtype=np.float64)


def waterfilling(
    total_power: float,
    channel_gains: NDArray[np.float64],
    noise_power: float,
    tolerance: float = 1e-8,
    max_iterations: int = 100,
) -> NDArray[np.float64]:
    """Waterfilling allocation (host float64, exact reference semantics)."""
    channel_gains = np.asarray(channel_gains, dtype=np.float64)
    if total_power < 0:
        raise ValueError(f"Total power must be non-negative, got {total_power}")
    if noise_power < 0:
        raise ValueError(f"Noise power must be non-negative, got {noise_power}")
    if channel_gains.size == 0:
        raise ValueError("Channel gains array cannot be empty")
    if np.any(channel_gains <= 0):
        raise ValueError("All channel gains must be positive")

    floor = noise_power / (channel_gains * len(channel_gains))
    mu_min, mu_max = 0.0, total_power + float(np.max(floor))
    mu = (mu_min + mu_max) / 2
    for _ in range(max_iterations):
        mu = (mu_min + mu_max) / 2
        power_sum = float(np.sum(np.maximum(0.0, mu - floor)))
        if abs(power_sum - total_power) < tolerance:
            break
        if power_sum < total_power:
            mu_min = mu
        else:
            mu_max = mu

    power = np.maximum(0.0, mu - floor)
    s = power.sum()
    if s > 0:
        power = power * (total_power / s)
    return power


def water_level(
    power: NDArray[np.float64], channel_gains: NDArray[np.float64], noise_power: float
) -> float:
    """Reported water level = mean(P + N0/|H|^2) over active subcarriers
    (simulation/models.py:310-313; no 1/N factor, unlike the floor)."""
    floor = noise_power / np.asarray(channel_gains, dtype=np.float64)
    lvl = power + floor
    active = power > 1e-10
    return float(np.mean(lvl[active])) if np.any(active) else float("nan")


# --- capacity helpers (power_allocation/models.py:228-334) ------------------------


def capacity(
    power: NDArray[np.float64],
    channel_gains: NDArray[np.float64],
    noise_power: float,
) -> float:
    """Shannon capacity C = sum(log2(1 + P|H|^2/N0 + 1e-12)) bits/use."""
    snr = np.asarray(power) * np.asarray(channel_gains) / noise_power
    return float(np.sum(np.log2(1.0 + snr + 1e-12)))


def capacity_per_subcarrier(
    power: NDArray[np.float64],
    channel_gains: NDArray[np.float64],
    noise_power: float,
) -> NDArray[np.float64]:
    """log2(1 + P|H|^2/N0 + 1e-12) per subcarrier."""
    snr = np.asarray(power) * np.asarray(channel_gains) / noise_power
    return np.log2(1.0 + snr + 1e-12)


def compare_allocations(
    uniform_power: NDArray[np.float64],
    waterfilling_power: NDArray[np.float64],
    channel_gains: NDArray[np.float64],
    noise_power: float,
) -> Dict[str, float]:
    """Capacities of a uniform and a waterfilling allocation and the gain."""
    cap_u = capacity(uniform_power, channel_gains, noise_power)
    cap_w = capacity(waterfilling_power, channel_gains, noise_power)
    return {
        "uniform_capacity": cap_u,
        "waterfilling_capacity": cap_w,
        "capacity_gain": cap_w - cap_u,
        "capacity_gain_percent": 100 * (cap_w - cap_u) / cap_u if cap_u > 0 else 0.0,
    }
