"""Named experiment reproductions (reference examples/ studies)."""

from ofdm_tpu_torch.experiments.noise_bump import run_noise_bump_experiment

__all__ = ["run_noise_bump_experiment"]
