"""The JAX package's BER readings behind chip_smoke.py's bands for the new modes.

    JAX_PLATFORMS=cpu python jax_band_readings.py

Runs each of ``chip_smoke.BAND_LINKS`` (the audit's 8-PSK and adaptive
links) and the reference's adaptive config at 15 / 20 / 25 dB through the
JAX package's XLA path on the CPU, seed ``jax.random.PRNGKey(0)``, 2^18
OFDM symbols in chunks of 4096, and prints ``{name: [bit errors, bits]}``:
the values of ``chip_smoke.JAX_CPU_READINGS``.  About 40 s on one CPU.
"""

import json
import os
import sys

import jax

from chip_smoke import ADAPTIVE_CONFIG, AUDIT_BASE, BAND_LINKS
from ofdm_tpu.config import SimulationConfig
from ofdm_tpu.pipeline import LinkRunner, prepare

SYMBOLS = 1 << 18
CHUNK = 4096


def reading(cfg):
    r = LinkRunner(prepare(cfg)).run(jax.random.PRNGKey(0))
    assert r["hotpath_used"] == "xla", r["hotpath_used"]
    return [r["bit_errors"], r["total_bits"]]


def main():
    out = {}
    for name, (_, kw) in BAND_LINKS.items():
        base = dict(AUDIT_BASE, symbols_per_chunk=CHUNK, **kw)
        adaptive = base.get("adaptive_modulation_mode") == "CAPACITY_BASED"
        base["num_symbols"] = SYMBOLS if adaptive else SYMBOLS * base["num_subcarriers"]
        out[name] = reading(SimulationConfig(**base))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ADAPTIVE_CONFIG)
    for cfg in SimulationConfig.from_json(path):
        out[f"reference_adaptive_{int(cfg.snr_db)}db"] = reading(
            cfg.replace(num_symbols=SYMBOLS, symbols_per_chunk=CHUNK))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
