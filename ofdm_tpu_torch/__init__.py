"""ofdm_tpu_torch: the OFDM link simulator on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ofdm_tpu`` beside it; the JAX package is the reference.  Entry
points: ``pipeline.prepare`` and ``pipeline.LinkRunner``.  Importing the
package builds nothing and touches no device.
"""

from ofdm_tpu_torch.config import SimulationConfig

__all__ = ["SimulationConfig"]
