"""The system under test, ``ofdm_tpu_torch``, as the benchmark drives it.

This is the one module of the harness that imports the program, and it
takes from it only the entry points a campaign uses: ``prepare`` and
``LinkRunner``.  Nothing of the JAX package is imported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np


def channel_ir(config: Dict) -> np.ndarray:
    """The configuration's raw impulse response, as the file holds it."""
    return np.array([complex(re, im) for re, im in config["channel_taps"]], np.complex128)


def simulation_config(config: Dict, symbols: int):
    """The program's ``SimulationConfig`` of the configuration's link at a
    point of ``symbols`` OFDM symbols."""
    from ofdm_tpu_torch.config import SimulationConfig

    link = dict(config["link"])
    n = int(link.pop("num_subcarriers"))
    return SimulationConfig(num_subcarriers=n, num_symbols=n * symbols, snr_db=float(config["snr_grid_db"][0]),
                            **link)


def build_runner(config: Dict, symbols: int, device, spans: Dict[str, float]):
    """``LinkRunner(prepare(cfg))`` of the configuration at ``symbols`` a
    point, with the host clock's seconds of each step in ``spans``: the
    import, ``prepare``, ``LinkRunner`` and, where the configuration takes
    its PAPR from the sampled TX batch, that batch."""
    t0 = time.perf_counter()
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    t1 = time.perf_counter()
    setup = prepare(simulation_config(config, symbols), channel_ir(config))
    t2 = time.perf_counter()
    runner = LinkRunner(setup, device)
    t3 = time.perf_counter()
    spans["import"] = t1 - t0
    spans["prepare"] = t2 - t1
    spans["runner"] = t3 - t2
    # The runner draws the batch at its first point otherwise; a runner
    # without this method leaves it to the warm-up point.
    sample = getattr(runner, "_papr_sample", None)
    if config["estimator"]["papr_sampled_tx"] and sample is not None:
        sample()
        sync(device)
        spans["papr_sample"] = time.perf_counter() - t3
    return runner


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_point(runner, key: int, snr_db: float) -> Dict:
    """One campaign point: ``run()`` under the point's key at its SNR; the
    counts are on the host when it returns."""
    return runner.run(seed=key, snr_db=snr_db)


def answer(result: Dict) -> Tuple[int, int, float, List[float], float]:
    """What the check compares, and the runner's own span: (bit errors,
    symbol errors, PAPR dB, allocated power, transmission ms)."""
    return (int(result["bit_errors"]), int(result["symbol_errors"]), float(result["papr_db"]),
            [float(p) for p in result["allocated_power"]], float(result["transmission_time_ms"]))
