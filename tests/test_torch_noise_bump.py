"""The port's noise-bump study (experiments/noise_bump.py) against the JAX package.

* Host f64 pieces, exactly: the noise profile and the per-point power
  allocation of all three scenarios.
* ``FusedLink`` on the CPU with zero words against the JAX package's
  ``_FusedLink`` in interpret mode (whose PRNG emits zeros): the same BER.
* The fused campaign end to end on the CPU at a small batch against the
  reference experiment's curves.
"""

import jax
import numpy as np
import pytest
import torch

from ofdm_tpu.experiments import noise_bump as jnb
from ofdm_tpu_torch.experiments import noise_bump as tnb
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import prng

# The reference experiment's curves at 0 / 15 / 30 dB (tests/test_experiments.py:40-48).
REFERENCE = {
    "Baseline (Uniform Power, +3 dB bump)": [0.4868, 0.4078, 0.1495],
    "Water-filling (+3 dB noise bump)": [0.4907, 0.4367, 0.1578],
    "Water-filling (+6 dB noise bump)": [0.4913, 0.4404, 0.1727],
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime; counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scenarios_equal_jax():
    assert [(s.key, s.name, s.short_prefix, s.power_allocation, s.noise_bump_db) for s in tnb.SCENARIOS] == [
        (s.key, s.name, s.short_prefix, s.power_allocation, s.noise_bump_db) for s in jnb.SCENARIOS]


@pytest.mark.parametrize("snr_db", [0.0, 15.0, 30.0])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_profile_and_power_equal_jax_in_f64(index, snr_db):
    ts, js = tnb.SCENARIOS[index], jnb.SCENARIOS[index]
    gains = np.abs(np.fft.fft(np.random.default_rng(5).standard_normal(64) + 0.3, 64)) ** 2 + 1e-3
    tp, jp = tnb.create_noise_profile(64, ts.noise_bump_db), jnb.create_noise_profile(64, js.noise_bump_db)
    assert tp.dtype == jp.dtype == np.float64 and np.array_equal(tp, jp)
    tw, jw = tnb.scenario_power(ts, gains, tp, snr_db), jnb.scenario_power(js, gains, jp, snr_db)
    assert tw.dtype == jw.dtype == np.float64 and np.array_equal(tw, jw)


def test_fused_link_matches_jax_fused_link_interpret(monkeypatch):
    """Zero words on both sides (the emulator's PRNG emits zeros): the
    campaign's scan of chunks, its rows and its BER."""
    fused = jnb._FusedLink(2048, 64, 64, "Lin-Phoong_P2", chunk=1024, interpret=True)
    scenario = jnb.SCENARIOS[1]
    profile = jnb.create_noise_profile(64, scenario.noise_bump_db)
    ref = fused.run_point(jax.random.PRNGKey(0), scenario, profile, 20.0)

    def zeros(key, sym0, count, n, device="cpu"):
        z = torch.zeros((count, n), dtype=torch.int64, device=device)
        return (z, z, z)

    monkeypatch.setattr(prng, "link_words", zeros)
    monkeypatch.setattr(prng, "post_noise_words", lambda *a, **k: zeros(*a, **k)[:2])
    port = tnb.FusedLink(2048, 64, 64, "Lin-Phoong_P2", chunk=1024, device="cpu")
    assert port.link.post_noise and port.link.compensate and not port.link.add_noise
    ber = port.run_point(0, tnb.SCENARIOS[1], tnb.create_noise_profile(64, 3.0), 20.0)
    assert ber > 0 and ber == pytest.approx(ref, abs=1e-12)


def test_fused_campaign_matches_reference_curves(tmp_path):
    res = tnb.run_noise_bump_experiment((0.0, 15.0, 30.0), fused_symbols_per_point=1 << 11,
                                        results_dir=str(tmp_path), device="cpu")
    for name, ref in REFERENCE.items():
        for a, b in zip(res[name], ref):
            assert abs(a - b) < 0.02, (name, res[name], ref)
    text = (tmp_path / "ber_wf_plus6_waterfilling_study.csv").read_text().splitlines()
    assert text[0] == "snr_db,bit_error_rate" and len(text) == 4
    assert (tmp_path / "ber_uniform_waterfilling_study.csv").exists()


def test_unported_paths_raise(tmp_path):
    # the plots and the eager-only campaign (the _Link sampler) run now
    res = tnb.run_noise_bump_experiment((10.0,), 1024, results_dir=str(tmp_path), output_dir=str(tmp_path / "img"),
                                        save_plots=True, max_plot_symbols=512, fused_symbols_per_point=1024,
                                        device="cpu")
    assert set(res) == {s.name for s in tnb.SCENARIOS} and all(0 < b[0] < 0.5 for b in res.values())
    assert (tmp_path / "img" / "CP-OFDM-WF-6dB" / "CP-OFDM-WF-6dB-SNR10dB.png").exists()
    assert (tmp_path / "img" / "CP-OFDM-waterfilling-ber-comparison.png").exists()
    eager = tnb.run_noise_bump_experiment((10.0,), 1024, results_dir=str(tmp_path), device="cpu")
    assert eager == tnb.run_noise_bump_experiment((10.0,), 1024, results_dir=str(tmp_path),
                                                  fused_symbols_per_point=0, device="cpu")
    assert all(0 < b[0] < 0.5 for b in eager.values()) and eager != res


def test_fused_link_chunks_divide_the_batch():
    with pytest.raises(ValueError, match="divide"):
        tnb.FusedLink(3000, 64, 64, "Lin-Phoong_P2", chunk=1024, device="cpu")
    fused = tnb.FusedLink(1024, 64, 64, "Lin-Phoong_P2", device="cpu")
    assert fused.chunk == 1024 and lk.rows_needed(fused.link) == 3
