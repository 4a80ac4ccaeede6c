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
Two links, as in the JAX package:

* ``_Link``, the small-batch sampler (``num_ofdm_symbols`` a point, 2048
  by default): the eager chain's operations on complex64 tensors, its
  post-EQ normals from ``prng.normal_planes`` (the K5 port) at c3 = 5.  It
  draws the constellation plots, and gives the BER of the eager-only
  campaign (``fused_symbols_per_point=0``).
* ``FusedLink``: the BER of each point from the chunk kernel the link
  routes to (``pipeline.kernel_mode``, as the JAX package's ``plan_for``:
  diag up to 512 subcarriers, lr past them, diag again for a single-tap
  channel) with all four of its stages on (``link_kernel.noise_bump_link``:
  the JAX package's ``_FusedLink`` on ``make_noise_bump_chunk``), one link
  for every point: the scenario and SNR enter as the chunk's (3, n) rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ofdm_tpu_torch.config import EqualizationMethod, NoiseType, PrefixType, SimulationConfig
from ofdm_tpu_torch.models import channels as chm
from ofdm_tpu_torch.ops import allocate as al
from ofdm_tpu_torch.ops import channel as ch
from ofdm_tpu_torch.ops import equalize as eq
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import mapping as mp
from ofdm_tpu_torch.ops import metrics as mt
from ofdm_tpu_torch.ops import ofdm
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.pipeline import LinkRunner, prepare
from ofdm_tpu_torch.utils import visualization as vis


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


class _Link:
    """The study's small-batch sampler (the JAX package's ``_Link``): one
    batch of ``num_ofdm_symbols`` OFDM symbols a point, ``order``-QAM over
    ``channel_ir`` with a CP of the channel order, no channel noise, MMSE,
    then the colored post-EQ noise, 1/sqrt(P) and the unit power over the
    whole batch, in complex64 on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, num_ofdm_symbols: int, num_subcarriers: int, order: int, channel_ir: np.ndarray,
                 device=None):
        self.B = num_ofdm_symbols
        self.n = num_subcarriers
        self.const = mp.make_constellation("QAM", order)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("_Link: CUDA is not available (pass device='cpu')")
        self.h_freq_np = chm.channel_frequency_response(channel_ir, num_subcarriers)
        self.prefix_length = int(1.0 * chm.channel_order(channel_ir))
        self.taps = torch.tensor(chm.normalize_impulse_response(channel_ir), dtype=torch.complex64,
                                 device=self.device)
        self.h_freq = torch.tensor(self.h_freq_np, dtype=torch.complex64, device=self.device)

    def run_point(self, seed: int, scenario: Scenario, noise_profile: np.ndarray, snr_db: float):
        """(BER, the normalized points as numpy complex64, symbol-major) of
        one point drawn under ``seed``: TX words from counters (b, k, 0),
        the post-EQ normals from (b, k, 5)."""
        n, B, L, dev = self.n, self.B, self.prefix_length, self.device
        gains = np.abs(self.h_freq_np) ** 2
        rows = torch.tensor(point_rows(gains, scenario, noise_profile, snr_db), device=dev)
        key = prng.key_words(seed)
        tx_idx = prng.philox_plane(key, 0, B, n, 0, dev) & (self.const.order - 1)
        symbols = mp.encode_indices(tx_idx, self.const) * rows[0]  # sqrt(P) at TX (:148)
        blocks = ofdm.ofdm_modulate(symbols, n, PrefixType.CYCLIC, L)
        rx_blocks, _ = ch.transmit(blocks, self.taps, snr_db, add_noise=False)
        freq = ofdm.ofdm_demodulate_to_freq(rx_blocks, n, PrefixType.CYCLIC, L)
        eqd = eq.equalize(freq, self.h_freq, EqualizationMethod.MMSE, snr_db)
        # Colored noise after equalization, per subcarrier (:165-172).
        z0, z1 = prng.normal_planes(key, 0, B, n, prng.BUMP_STREAM, dev)
        noisy = eqd + torch.complex(z0 * rows[2], z1 * rows[2])
        # 1/sqrt(P) compensation (:174-178), then global normalization (:180-183).
        noisy = noisy * rows[1]
        avg = ch.mean_abs2(noisy)
        noisy = torch.where(avg > 1e-12, noisy / torch.sqrt(avg), noisy)
        rx_idx = mp.decode_hard(noisy, self.const)
        errors = int(mt.index_bit_errors(tx_idx, rx_idx, self.const.bits_per_symbol))
        return errors / (B * n * self.const.bits_per_symbol), noisy.reshape(-1).cpu().numpy()


def fused_config(num_ofdm_symbols: int, num_subcarriers: int, order: int, channel: str,
                 chunk: int = 1 << 17) -> SimulationConfig:
    """The study's fused link (the JAX package's ``_FusedLink``): ``order``-QAM
    over the named channel, CP ratio 1.0, MMSE, no channel noise, both
    power switches on, ``num_ofdm_symbols`` a point in chunks of ``chunk``."""
    return SimulationConfig(
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
        symbols_per_chunk=min(chunk, num_ofdm_symbols),
    )


class FusedLink:
    """The study's link on its chunk kernel with the noise-bump stages.

    ``fused_config``'s link; ``chunk`` must divide ``num_ofdm_symbols``.
    One link serves every point; the runner's chain (``LinkRunner.mode``)
    picks the chunk wrapper and its workspace.  A link no kernel takes raises (the JAX package's campaign
    falls back to its XLA link there; this one does not hide the device).
    ``device=None`` means ``cuda``; ``"cpu"`` runs the plain version."""

    def __init__(self, num_ofdm_symbols: int, num_subcarriers: int, order: int, channel: str,
                 chunk: int = 1 << 17, device=None):
        chunk = min(chunk, num_ofdm_symbols)
        if num_ofdm_symbols % chunk:
            raise ValueError("num_ofdm_symbols must divide by the chunk size")
        cfg = fused_config(num_ofdm_symbols, num_subcarriers, order, channel, chunk)
        self.runner = LinkRunner(prepare(cfg), device)
        if self.runner.mode == "eager":
            raise ValueError(f"no chunk kernel takes this noise-bump link at {num_subcarriers} subcarriers: it "
                             "routes to the eager chain (ROADMAP modules item 6, lr past 4096 subcarriers)")
        self.kernel = self.runner.kernel
        self.link = lk.noise_bump_link(self.runner.link)
        self.device = self.runner.device
        self.B = num_ofdm_symbols
        self.n = num_subcarriers
        self.bits = int(np.log2(order))
        self.chunk = chunk
        self._work = (self.kernel.workspace(self.link, chunk, self.device)
                      if self.device.type == "cuda" else None)

    def rows(self, scenario: Scenario, noise_profile: np.ndarray, snr_db: float) -> torch.Tensor:
        """``point_rows`` of one point, on the link's device."""
        gains = np.abs(self.runner.setup.h_freq) ** 2
        return torch.tensor(point_rows(gains, scenario, noise_profile, snr_db), device=self.device)

    def run_point(self, seed: int, scenario: Scenario, noise_profile: np.ndarray, snr_db: float) -> float:
        """BER of one (scenario, SNR) point over ``num_ofdm_symbols`` OFDM
        symbols drawn under ``seed``: one stream of run symbols, chunk after
        chunk, as ``LinkRunner.run`` drives it (on the lr chain each chunk's
        first symbol recomputes its predecessor's tail from the stream's
        Philox words, bit-equal to the carry the JAX package threads)."""
        rows = self.rows(scenario, noise_profile, snr_db)
        key = prng.key_words(seed)
        snr_lin = lk.snr_linear(snr_db)
        acc, psum = lk.new_accumulators(self.device)
        for sym0 in range(0, self.B, self.chunk):
            self.kernel.chunk(self.link, key, sym0, self.chunk, snr_lin, acc, psum, self._work, rows)
        return int(acc[0].item()) / (self.B * self.n * self.bits)


def _plot_point(path, sample, ideal, scenario: Scenario, snr_db: float, ber: float) -> None:
    """One point's constellation PNG, in the JAX package's layout (PIL
    without matplotlib)."""
    title = f"{scenario.name}\nSNR = {snr_db} dB | BER = {ber:.3e}"
    if not vis.have_matplotlib():
        vis.pil_scatter_figure(sample, ideal, title, lim=2.2, legend=("Received Symbols", "Ideal Constellation"),
                               figsize=(6, 6)).savefig(path, dpi=200)
        return
    plt = vis._pyplot()
    plt.figure(figsize=(6, 6))
    plt.scatter(sample.real, sample.imag, color="tab:blue", alpha=0.15, s=6, label="Received Symbols")
    plt.scatter(ideal.real, ideal.imag, color="tab:red", marker="o", s=30, label="Ideal Constellation")
    plt.title(title)
    plt.xlabel("In-Phase")
    plt.ylabel("Quadrature")
    plt.axhline(0, color="gray", linewidth=0.5)
    plt.axvline(0, color="gray", linewidth=0.5)
    plt.grid(True, linestyle=":", alpha=0.4)
    plt.legend(loc="upper right", fontsize=8)
    plt.xlim([-2.2, 2.2])
    plt.ylim([-2.2, 2.2])
    plt.gca().set_aspect("equal", adjustable="box")
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close()


def _plot_comparison(path, snr_values, scenario_results: Dict[str, List[float]]) -> None:
    """The three scenarios' BER curves on one semilogy figure (PIL without matplotlib)."""
    title = "CP-OFDM BER vs. SNR with Colored Noise Bumps"
    if not vis.have_matplotlib():
        series = {s.name: (list(snr_values), scenario_results[s.name]) for s in SCENARIOS}
        vis.pil_ber_curves(path, series, title, size=(1750, 1250))
        return
    plt = vis._pyplot()
    plt.figure(figsize=(7, 5))
    for scenario in SCENARIOS:
        plt.semilogy(snr_values, scenario_results[scenario.name], marker="o", linewidth=2, label=scenario.name)
    plt.title(title)
    plt.xlabel("SNR (dB)")
    plt.ylabel("Bit Error Rate")
    plt.grid(True, which="both", linestyle=":", alpha=0.6)
    plt.legend()
    plt.tight_layout()
    plt.savefig(path, dpi=250)
    plt.close()


def default_fused_symbols(device) -> int:
    """OFDM symbols a point of the fused campaign by default: 2^24 on a CUDA
    device, 0 (the eager-only campaign) on the CPU."""
    return 1 << 24 if torch.device("cuda" if device is None else device).type == "cuda" else 0


def run_noise_bump_experiment(
    snr_values: Sequence[float] = (0, 5, 10, 15, 20, 25, 30),
    num_ofdm_symbols: int = 2048,
    num_subcarriers: int = 64,
    constellation_order: int = 64,
    channel: str = "Lin-Phoong_P2",
    output_dir: str = "images/Lin-Phoong_P2/CP-OFDM-Waterfilling-Study",
    results_dir: str = "results",
    seed: int = 42,
    save_plots: bool = False,
    max_plot_symbols: int = 32768,
    fused_symbols_per_point: Optional[int] = None,
    chunk: int = 1 << 17,
    device=None,
) -> Dict[str, List[float]]:
    """All three scenarios over ``snr_values``; returns {scenario name: [ber
    per snr]} and writes ``ber_{key}_waterfilling_study.csv`` per scenario
    under ``results_dir``.

    ``fused_symbols_per_point``: OFDM symbols a point on one ``FusedLink``
    (the link's chunk kernel with the study's stages), in chunks of ``chunk``;
    ``None`` means 2^24 on a CUDA device and 0 on the CPU, and 0 runs the
    eager-only campaign, each point's BER from ``_Link`` at
    ``num_ofdm_symbols``.  ``_Link`` runs a point only where its output is
    used (the BER of the eager-only campaign, the plots); the JAX package
    runs it for every point.  Point (scenario s, SNR index p) draws under
    seed ``seed * 2^32 + 1000 s + p`` on ``_Link`` and ``+ 500000`` on the
    fused link.

    ``save_plots`` writes each point's constellation PNG under
    ``output_dir/<scenario prefix>/`` and the BER comparison figure, with
    the JAX package's names and layout (drawn with PIL where matplotlib is
    missing).  It defaults to False (the JAX package's to True) because
    each plotted point runs ``_Link`` on top of its fused point: a timed
    campaign would pay for a small-batch run it does not count.
    ``device=None`` means ``cuda``."""
    if not 0 <= int(seed) < 1 << 32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    device = torch.device("cuda" if device is None else device)
    if fused_symbols_per_point is None:
        fused_symbols_per_point = default_fused_symbols(device)
    link = _Link(num_ofdm_symbols, num_subcarriers, constellation_order, chm.get_channel(channel), device)
    fused = None
    if fused_symbols_per_point:
        fused = FusedLink(fused_symbols_per_point, num_subcarriers, constellation_order, channel,
                          chunk=chunk, device=device)
    base_out = Path(output_dir)
    res_dir = Path(results_dir)
    res_dir.mkdir(parents=True, exist_ok=True)
    scenario_results: Dict[str, List[float]] = {}
    for s_i, scenario in enumerate(SCENARIOS):
        scen_dir = base_out / scenario.short_prefix
        if save_plots:
            scen_dir.mkdir(parents=True, exist_ok=True)
        noise_profile = create_noise_profile(num_subcarriers, scenario.noise_bump_db)
        bers: List[float] = []
        for p_i, snr_db in enumerate(snr_values):
            point_seed = (int(seed) << 32) + s_i * 1000 + p_i
            if fused is None or save_plots:
                ber, symbols = link.run_point(point_seed, scenario, noise_profile, float(snr_db))
            if fused is not None:
                ber = fused.run_point(point_seed + POINT_SEED_BASE, scenario, noise_profile, float(snr_db))
            bers.append(ber)
            if save_plots:
                _plot_point(scen_dir / f"{scenario.short_prefix}-SNR{int(snr_db):02d}dB.png",
                            symbols[:max_plot_symbols], link.const.table, scenario, snr_db, ber)
        scenario_results[scenario.name] = bers
        with (res_dir / f"ber_{scenario.key}_waterfilling_study.csv").open("w", encoding="utf-8") as fp:
            fp.write("snr_db,bit_error_rate\n")
            for snr_db, ber in zip(snr_values, bers):
                fp.write(f"{snr_db},{ber}\n")

    if save_plots:
        base_out.mkdir(parents=True, exist_ok=True)
        _plot_comparison(base_out / "CP-OFDM-waterfilling-ber-comparison.png", snr_values, scenario_results)
    return scenario_results
