"""Tracing and throughput helpers (the port's ``ofdm_tpu.utils.profiling``).

Provides:
  * :func:`trace` — context manager around ``torch.profiler.profile`` (the
    CPU, and CUDA where a card is present) that writes a Chrome trace of
    the block under ``log_dir`` (view it in Perfetto or chrome://tracing);
  * :class:`ThroughputMeter` — explicit OFDM-symbols/s and bits/s counters
    across timed sections, with per-device rates on a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str = "ofdm_tpu_torch_trace") -> Iterator:
    """Profile a block and write its trace to ``log_dir/trace_<pid>_<n>.json``.

    Yields the ``torch.profiler.profile`` object, so a caller can read
    ``key_averages()`` after the block.  Example:

        with profiling.trace("traces") as prof:
            runner.run(0)
        print(prof.key_averages().table(row_limit=10))
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_"))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def _device_count() -> int:
    """The process group's world size, else the visible CUDA cards, else 1."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates work counters across timed sections."""

    ofdm_symbols: int = 0
    bits: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, ofdm_symbols: int, bits: int) -> None:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        self.seconds += time.perf_counter() - self._t0
        self.ofdm_symbols += ofdm_symbols
        self.bits += bits
        self._t0 = None

    @contextlib.contextmanager
    def section(self, ofdm_symbols: int, bits: int) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop(ofdm_symbols, bits)

    @property
    def ofdm_symbols_per_s(self) -> float:
        return self.ofdm_symbols / self.seconds if self.seconds else 0.0

    @property
    def bits_per_s(self) -> float:
        return self.bits / self.seconds if self.seconds else 0.0

    def report(self, num_devices: Optional[int] = None) -> str:
        n = num_devices or _device_count()
        return (
            f"{self.ofdm_symbols:,} OFDM symbols / {self.bits:,} bits in "
            f"{self.seconds:.3f}s -> {self.ofdm_symbols_per_s:,.0f} syms/s "
            f"({self.ofdm_symbols_per_s / n:,.0f}/device), "
            f"{self.bits_per_s / 1e6:,.1f} Mbit/s"
        )
