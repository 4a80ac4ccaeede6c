"""Waterfilling robustness study under colored-noise bumps: the fused BER campaign.

Counterpart of ``ofdm_tpu/experiments/noise_bump.py``, the reproduction of
the reference's most complete manual pipeline
(``examples/waterfilling_noise_bump_experiment.py:43-260``).  Semantics
kept exactly:

  * noise profile = 1 except the top quarter band x 10^(bump/10)   (:43-52)
  * waterfilling on effective_gains = |H|^2 / noise_profile        (:133-139)
  * power floor 1e-4 then renormalize to the unit budget           (:144-147)
  * sqrt(P) applied at TX                                          (:148)
  * channel uses NO noise; the colored noise is injected *after*
    equalization, per subcarrier                                   (:165-172)
  * 1/sqrt(P) compensation with a 1e-10 guard                      (:174-178)
  * global unit-power normalization before demapping               (:180-183)

Three scenarios (uniform +3 dB, WF +3 dB, WF +6 dB) over SNR 0..30 dB.
The BER of each point comes from the diag chunk kernel with all four of
its stages on (``link_kernel.noise_bump_link``: the JAX package's
``_FusedLink`` on ``make_noise_bump_chunk``), one link for every point:
the scenario and SNR enter as the chunk's (3, n) rows.  The JAX package's
small-batch XLA sampler (``_Link``), which draws the constellation plots,
needs the eager chain and its normal-pair kernel and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from ofdm_tpu_torch.config import EqualizationMethod, NoiseType, PrefixType, SimulationConfig
from ofdm_tpu_torch.ops import allocate as al
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.pipeline import LinkRunner, prepare


@dataclass(frozen=True)
class Scenario:
    key: str
    name: str
    short_prefix: str
    power_allocation: str  # "UNIFORM" | "WATERFILLING"
    noise_bump_db: float


SCENARIOS = (
    Scenario("uniform", "Baseline (Uniform Power, +3 dB bump)", "CP-OFDM-UNIFORM",
             "UNIFORM", 3.0),
    Scenario("wf_plus3", "Water-filling (+3 dB noise bump)", "CP-OFDM-WF-3dB",
             "WATERFILLING", 3.0),
    Scenario("wf_plus6", "Water-filling (+6 dB noise bump)", "CP-OFDM-WF-6dB",
             "WATERFILLING", 6.0),
)

# Seed offset of the fused campaign's points (the JAX package folds
# 500_000 + 1000 * scenario + point into its key).
POINT_SEED_BASE = 500_000


def create_noise_profile(num_subcarriers: int, bump_db: float) -> np.ndarray:
    """Piecewise noise profile: +bump on the top quarter band (:43-52)."""
    profile = np.ones(num_subcarriers, dtype=np.float64)
    if bump_db <= 0:
        return profile
    profile[int(0.75 * num_subcarriers):] = 10 ** (bump_db / 10)
    return profile


def scenario_power(
    scenario: Scenario,
    channel_gains: np.ndarray,
    noise_profile: np.ndarray,
    snr_db: float,
) -> np.ndarray:
    """Per-point power allocation with the experiment's floor semantics."""
    n = len(channel_gains)
    if scenario.power_allocation == "WATERFILLING":
        effective_gains = channel_gains / noise_profile
        power = al.waterfilling(1.0, effective_gains, 10 ** (-snr_db / 10))
        power = np.maximum(power, 1e-4)
        power = power / power.sum()
    else:
        power = al.uniform(1.0, n)
    return power


def point_rows(channel_gains: np.ndarray, scenario: Scenario, noise_profile: np.ndarray,
               snr_db: float) -> np.ndarray:
    """(3, n) f32 rows of one point: [sqrt(P), 1/sqrt(P) with the
    reference's 1e-10 guard, the post-EQ sigma sqrt(10^(-snr/10) x
    profile / 2)], host f64 rounded once to f32."""
    power = scenario_power(scenario, channel_gains, noise_profile, snr_db)
    sqrt_power = np.sqrt(power)
    inv = sqrt_power.copy()
    inv[inv < 1e-10] = 1.0  # the reference's guard (:176-177)
    noise_std = np.sqrt(10 ** (-snr_db / 10) * noise_profile / 2.0)
    return np.stack([sqrt_power, 1.0 / inv, noise_std]).astype(np.float32)


class FusedLink:
    """The study's link on the diag chunk kernel with the noise-bump stages.

    The JAX package's ``_FusedLink`` configuration: ``num_subcarriers``,
    ``order``-QAM, the named channel, CP ratio 1.0, MMSE, no channel
    noise, both power switches on; ``num_ofdm_symbols`` a point in chunks of
    ``chunk`` (which must divide it).  One link serves every point.
    ``device=None`` means ``cuda``; ``"cpu"`` runs the plain version."""

    def __init__(self, num_ofdm_symbols: int, num_subcarriers: int, order: int, channel: str,
                 chunk: int = 1 << 17, device=None):
        chunk = min(chunk, num_ofdm_symbols)
        if num_ofdm_symbols % chunk:
            raise ValueError("num_ofdm_symbols must divide by the chunk size")
        cfg = SimulationConfig(
            num_symbols=num_subcarriers * num_ofdm_symbols,
            num_subcarriers=num_subcarriers,
            constellation_order=order,
            channel_type="CUSTOM",
            channel_model=channel,
            prefix_type=PrefixType.CYCLIC,
            prefix_length_ratio=1.0,
            equalization_method=EqualizationMethod.MMSE,
            noise_type=NoiseType.NONE,
            apply_power_allocation=True,
            normalize_before_demap=True,
            snr_db=30.0,
            symbols_per_chunk=chunk,
        )
        self.runner = LinkRunner(prepare(cfg), device)
        if self.runner.mode != "diag":
            raise ValueError(f"the noise-bump link runs on the diag chain, this one routes to {self.runner.mode}")
        self.link = lk.noise_bump_link(self.runner.link)
        self.device = self.runner.device
        self.B = num_ofdm_symbols
        self.n = num_subcarriers
        self.bits = int(np.log2(order))
        self.chunk = chunk
        self._work = (lk.chunk_workspace(self.link, chunk, self.device)
                      if self.device.type == "cuda" else None)

    def rows(self, scenario: Scenario, noise_profile: np.ndarray, snr_db: float) -> torch.Tensor:
        """``point_rows`` of one point, on the link's device."""
        gains = np.abs(self.runner.setup.h_freq) ** 2
        return torch.tensor(point_rows(gains, scenario, noise_profile, snr_db), device=self.device)

    def run_point(self, seed: int, scenario: Scenario, noise_profile: np.ndarray, snr_db: float) -> float:
        """BER of one (scenario, SNR) point over ``num_ofdm_symbols`` OFDM
        symbols drawn under ``seed``."""
        rows = self.rows(scenario, noise_profile, snr_db)
        key = prng.key_words(seed)
        snr_lin = lk.snr_linear(snr_db)
        acc, psum = lk.new_accumulators(self.device)
        for sym0 in range(0, self.B, self.chunk):
            lk.diag_chunk(self.link, key, sym0, self.chunk, snr_lin, acc, psum, self._work, rows)
        return int(acc[0].item()) / (self.B * self.n * self.bits)


def run_noise_bump_experiment(
    snr_values: Sequence[float] = (0, 5, 10, 15, 20, 25, 30),
    fused_symbols_per_point: int = 1 << 24,
    num_subcarriers: int = 64,
    constellation_order: int = 64,
    channel: str = "Lin-Phoong_P2",
    results_dir: str = "results",
    seed: int = 42,
    save_plots: bool = False,
    chunk: int = 1 << 17,
    device=None,
) -> Dict[str, List[float]]:
    """The fused BER campaign: all three scenarios over ``snr_values``,
    ``fused_symbols_per_point`` OFDM symbols a point on one ``FusedLink``.
    Returns {scenario name: [ber per snr]} and writes
    ``ber_{key}_waterfilling_study.csv`` per scenario under
    ``results_dir``.  Point (scenario s, SNR index p) runs under seed
    ``seed * 2^32 + 500000 + 1000 s + p``.

    The constellation plots (``save_plots``) and the XLA-only campaign
    (``fused_symbols_per_point=0``) need the JAX package's ``_Link``
    sampler, which is not ported: both raise NotImplementedError."""
    if save_plots or not fused_symbols_per_point:
        raise NotImplementedError(
            "not in this slice of the port: the noise-bump study's plots and its small-batch sampler "
            "(_Link) need the eager chain (ROADMAP modules item 2) and its normal-pair kernel "
            "(ROADMAP kernel item 9, K5)")
    if not 0 <= int(seed) < 1 << 32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    fused = FusedLink(fused_symbols_per_point, num_subcarriers, constellation_order, channel,
                      chunk=chunk, device=device)
    res_dir = Path(results_dir)
    res_dir.mkdir(parents=True, exist_ok=True)
    scenario_results: Dict[str, List[float]] = {}
    for s_i, scenario in enumerate(SCENARIOS):
        noise_profile = create_noise_profile(num_subcarriers, scenario.noise_bump_db)
        bers = [
            fused.run_point((int(seed) << 32) + POINT_SEED_BASE + s_i * 1000 + p_i, scenario,
                            noise_profile, float(snr_db))
            for p_i, snr_db in enumerate(snr_values)
        ]
        scenario_results[scenario.name] = bers
        with (res_dir / f"ber_{scenario.key}_waterfilling_study.csv").open("w", encoding="utf-8") as fp:
            fp.write("snr_db,bit_error_rate\n")
            for snr_db, ber in zip(snr_values, bers):
                fp.write(f"{snr_db},{ber}\n")
    return scenario_results
