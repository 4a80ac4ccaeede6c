"""Shape audit on the card: every production shape through its chunk kernel.

    python3 -m ofdm_tpu_torch.shape_audit

The port's counterpart of ``tools/shape_audit.py`` (the JAX package's
robustness tool, which stays as it is).  It drives that tool's 30 shapes
with its own sizes, n x 16384 QAM symbols (16384 OFDM symbols; the
adaptive shapes 16384 OFDM symbols in chunks of 8192) at 30 dB over
severe_multipath, 64-QAM, MMSE, unless a shape says otherwise, and two
more: the adaptive-PSK zero-prefix link ``adapt_psk_wf_zp1.0_64`` and the
reference's adaptive config on SC-FDE at 1024 subcarriers and 20 dB
(``adaptive_scfde_1024sc``, on ``fold_wide``).  Each goes through
``prepare()`` -> ``LinkRunner.run()`` on the card and must

* build and launch,
* route to the chain the JAX package's ``pallas_link.plan_for`` picks
  (``ROUTES``; the JAX package has a plan for every shape, so none runs on
  the eager chain) and launch that chain's counting kernel once a chunk,
* and land its BER inside the z = 5 band (``metrics.ber_equivalent``)
  around the JAX package's XLA-path reading of the same shape on a CPU
  (``READINGS``, taken by ``jax_band_readings.py`` at min(16384, 2^24 / n)
  OFDM symbols, seed ``jax.random.PRNGKey(0)``).

The audit runs every shape before it reports, so one run names every bad
shape; ``main`` exits non-zero when any failed.  Needs a CUDA card: the
kernels have no other home, and nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import sys
import time

# The audit's base link (tools/shape_audit.py:38-50 without its sizes): 64
# subcarriers, 64-QAM, severe_multipath, CP ratio 1.0, MMSE, AWGN 30 dB.
AUDIT_BASE = dict(num_subcarriers=64, constellation_order=64, constellation_type="QAM", channel_type="CUSTOM",
                  channel_model="severe_multipath", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                  equalization_method="MMSE", noise_type="AWGN", snr_db=30.0)
AUDIT_OFDM_SYMBOLS = 16384  # the tool's num_symbols = n x 16384
AUDIT_CHUNK = 8192  # the tool's symbols_per_chunk = n x 8192 (8192 OFDM symbols under adaptive loading)
_ADAPT = dict(power_allocation_type="WATERFILLING", adaptive_modulation_mode="CAPACITY_BASED", snr_db=20.0,
              num_symbols=AUDIT_OFDM_SYMBOLS, symbols_per_chunk=AUDIT_CHUNK)


def _width(n, **kw):
    return dict(num_symbols=n * AUDIT_OFDM_SYMBOLS, num_subcarriers=n, symbols_per_chunk=n * AUDIT_CHUNK, **kw)


def _shapes():
    """{tag: changes to AUDIT_BASE}, in the tool's order (tools/shape_audit.py:67-121), then the two added."""
    shapes = {}
    for n in (64, 128, 256, 512, 1024, 2048, 4096):
        for prefix, ratio in (("CYCLIC", 1.0), ("CYCLIC", 0.34), ("ZERO", 1.0)):
            shapes[f"OFDM-{prefix[:2]}{ratio}-{n}"] = _width(n, prefix_type=prefix, prefix_length_ratio=ratio)
    for prefix in ("CYCLIC", "ZERO"):
        for n in (64, 1024):
            shapes[f"SC-{prefix[:2]}1.0-{n}"] = _width(n, modulation_type="SC-OFDM", prefix_type=prefix)
    shapes["OFDM-NONE-64"] = _width(64, prefix_type="NONE", snr_db=20.0)
    shapes["PSK8-CP1.0-64"] = _width(64, constellation_order=8, constellation_type="PSK")
    shapes["PSK8-CP0.34-64"] = _width(64, constellation_order=8, constellation_type="PSK", prefix_length_ratio=0.34)
    shapes["ADAPT-WF-CP1.0-64"] = dict(_ADAPT)
    shapes["ADAPT-WF-ZP0.5-256"] = dict(_ADAPT, num_subcarriers=256, prefix_type="ZERO", prefix_length_ratio=0.5)
    # chip_smoke.py's adaptive-PSK link on the mm chain, at the adaptive shapes' sizes
    shapes["adapt_psk_wf_zp1.0_64"] = dict(_ADAPT, constellation_type="PSK", prefix_type="ZERO")
    # the reference's adaptive config (config/simulation_settings_adaptive.json,
    # 16-QAM budget 4-256, Lin-Phoong P1) on SC-FDE at 1024 sc over
    # severe_multipath at 20 dB: chip_smoke.ASC_CELLS' adaptive_scfde_1024sc
    shapes["adaptive_scfde_1024sc"] = dict(_ADAPT, num_subcarriers=1024, constellation_order=16,
                                           modulation_type="SC-OFDM")
    return shapes


SHAPES = _shapes()

# The chain each shape routes to (the JAX package's plan_for: its "mm" /
# "mm4" kernel is the port's fold chain under a cyclic prefix or none and
# its mm chain under a zero prefix) and the kernel that counts its errors.
ROUTES = {
    "OFDM-CY1.0-64": ("diag", "diag_main"),
    "OFDM-CY0.34-64": ("fold", "fold_main"),
    "OFDM-ZE1.0-64": ("mm", "mm_main"),
    "OFDM-CY1.0-128": ("diag", "diag_main"),
    "OFDM-CY0.34-128": ("lr", "lr_main"),
    "OFDM-ZE1.0-128": ("lr", "lr_main"),
    "OFDM-CY1.0-256": ("diag", "diag_main"),
    "OFDM-CY0.34-256": ("lr", "lr_main"),
    "OFDM-ZE1.0-256": ("lr", "lr_main"),
    "OFDM-CY1.0-512": ("diag", "diag_wide"),
    "OFDM-CY0.34-512": ("lr", "lr_main"),
    "OFDM-ZE1.0-512": ("lr", "lr_main"),
    "OFDM-CY1.0-1024": ("lr", "lr_main"),
    "OFDM-CY0.34-1024": ("lr", "lr_main"),
    "OFDM-ZE1.0-1024": ("lr", "lr_main"),
    "OFDM-CY1.0-2048": ("lr", "lr_main"),
    "OFDM-CY0.34-2048": ("lr", "lr_main"),
    "OFDM-ZE1.0-2048": ("lr", "lr_main"),
    "OFDM-CY1.0-4096": ("lr", "lr_main"),
    "OFDM-CY0.34-4096": ("lr", "lr_main"),
    "OFDM-ZE1.0-4096": ("lr", "lr_main"),
    "SC-CY1.0-64": ("fold", "fold_main"),
    "SC-CY1.0-1024": ("fold", "fold_wide_main"),
    "SC-ZE1.0-64": ("mm", "mm_main"),
    "SC-ZE1.0-1024": ("mm", "mm_wide_main"),
    "OFDM-NONE-64": ("fold", "fold_main"),
    "PSK8-CP1.0-64": ("diag", "diag_main"),
    "PSK8-CP0.34-64": ("fold", "fold_main"),
    "ADAPT-WF-CP1.0-64": ("diag", "diag_main"),
    "ADAPT-WF-ZP0.5-256": ("lr", "lr_main"),
    "adapt_psk_wf_zp1.0_64": ("mm", "mm_main"),
    "adaptive_scfde_1024sc": ("fold", "fold_wide_main"),
}

# The JAX package's XLA-path readings, (bit errors, bits): jax_band_readings.py
# on a CPU at min(16384, 2^24 / n) OFDM symbols in chunks of min(4096, 2^20 / n).
READINGS = {
    "OFDM-CY1.0-64": (25, 6291456),
    "OFDM-CY0.34-64": (158520, 6291456),
    "OFDM-ZE1.0-64": (39, 6291456),
    "OFDM-CY1.0-128": (35, 12582912),
    "OFDM-CY0.34-128": (111212, 12582912),
    "OFDM-ZE1.0-128": (55, 12582912),
    "OFDM-CY1.0-256": (88, 25165824),
    "OFDM-CY0.34-256": (54699, 25165824),
    "OFDM-ZE1.0-256": (98, 25165824),
    "OFDM-CY1.0-512": (228, 50331648),
    "OFDM-CY0.34-512": (17988, 50331648),
    "OFDM-ZE1.0-512": (204, 50331648),
    "OFDM-CY1.0-1024": (389, 100663296),
    "OFDM-CY0.34-1024": (6227, 100663296),
    "OFDM-ZE1.0-1024": (373, 100663296),
    "OFDM-CY1.0-2048": (391, 100663296),
    "OFDM-CY0.34-2048": (1725, 100663296),
    "OFDM-ZE1.0-2048": (371, 100663296),
    "OFDM-CY1.0-4096": (403, 100663296),
    "OFDM-CY0.34-4096": (975, 100663296),
    "OFDM-ZE1.0-4096": (376, 100663296),
    "SC-CY1.0-64": (0, 6291456),
    "SC-CY1.0-1024": (0, 100663296),
    "SC-ZE1.0-64": (2, 6291456),
    "SC-ZE1.0-1024": (3, 100663296),
    "OFDM-NONE-64": (647147, 6291456),
    "PSK8-CP1.0-64": (0, 3145728),
    "PSK8-CP0.34-64": (762, 3145728),
    "ADAPT-WF-CP1.0-64": (1107, 4259840),
    "ADAPT-WF-ZP0.5-256": (6082, 16973824),
    "adapt_psk_wf_zp1.0_64": (95, 3260416),
    "adaptive_scfde_1024sc": (216282, 67862528),
}

BAND_Z = 5.0
# The libraries the shapes launch: each chain's plain build, and the
# samplers' (the wide links' sampled TX batch draws K4's words).
LIBRARIES = ("link_kernel", "diag_wide", "fold_kernel", "lr_kernel", "mm_kernel", "fold_wide", "mm_wide", "boxmuller")


def config_kw(tag: str) -> dict:
    """The full keyword set of shape ``tag``'s SimulationConfig (either package's)."""
    kw = dict(AUDIT_BASE, num_symbols=64 * AUDIT_OFDM_SYMBOLS, symbols_per_chunk=64 * AUDIT_CHUNK)
    kw.update(SHAPES[tag])
    return kw


def launch_counter(chain: str, kernel: str):
    """(wrapper, attribute) of the launch counter of ``kernel``, the
    counting kernel of ``chain``: the chain's chunk wrapper
    (``pipeline._KERNELS``), whose wide kernels count in ``wide_launches``."""
    from ofdm_tpu_torch.pipeline import _KERNELS

    wide = kernel in ("diag_wide", "fold_wide_main", "mm_wide_main")
    return _KERNELS[chain].chunk, "wide_launches" if wide else "launches"


def run_shape(tag: str, device="cuda") -> dict:
    """One shape through ``prepare()`` -> ``LinkRunner.run()``: its route,
    launches, BER, OFDM syms/s, seconds (setup and run) and the list of
    its faults (empty when it passed).  A build or launch error is a fault
    too, recorded and not raised."""
    from ofdm_tpu_torch.config import SimulationConfig
    from ofdm_tpu_torch.ops import metrics as mt
    from ofdm_tpu_torch.pipeline import LinkRunner, prepare

    chain, kernel = ROUTES[tag]
    out = {"shape": tag, "expected": f"{chain}/{kernel}", "faults": []}
    t0 = time.perf_counter()
    try:
        runner = LinkRunner(prepare(SimulationConfig(**config_kw(tag))), device=device)
        out["route"] = runner.mode
        if runner.mode != chain:
            out["faults"].append(f"routed to {runner.mode}, not {chain}")
        fn, attr = launch_counter(chain, kernel)
        before = getattr(fn, attr)
        r = runner.run(0)
    except Exception as e:  # noqa: BLE001 -- the audit reports every shape's fault and goes on
        out["faults"].append(f"{type(e).__name__}: {str(e)[:300]}")
        out["seconds"] = time.perf_counter() - t0
        return out
    chunks = runner._chunk_plan()[1]
    launches = getattr(fn, attr) - before
    out.update(hotpath=r["hotpath_used"], launches=launches, chunks=chunks, bit_errors=r["bit_errors"],
               total_bits=r["total_bits"], ber=r["bit_error_rate"], ofdm_symbols_per_s=r["ofdm_symbols_per_s"],
               run_s=r["transmission_time_ms"] / 1e3, seconds=time.perf_counter() - t0)
    if r["hotpath_used"] != "cuda" or launches != chunks:
        out["faults"].append(f"hotpath {r['hotpath_used']}, {kernel} launched {launches} times for {chunks} chunks")
    je, jb = READINGS[tag]
    if not mt.ber_equivalent(r["bit_errors"], r["total_bits"], je, jb, z=BAND_Z):
        out["faults"].append(f"BER {r['bit_error_rate']} outside its z = {BAND_Z} band around the JAX "
                             f"package's {je / jb} ({je} / {jb})")
    return out


def audit(device="cuda") -> list:
    """``run_shape`` on every shape, printing a line each."""
    results = []
    for tag in SHAPES:
        res = run_shape(tag, device)
        print(f"{'OK ' if not res['faults'] else 'BAD'} {tag:>22}: route {res.get('route')} "
              f"(expected {res['expected']}, {res.get('launches')} launches / {res.get('chunks')} chunks) "
              f"BER {res.get('ber')} ({res.get('bit_errors')} / {res.get('total_bits')}) "
              f"ofdm_symbols_per_s={res.get('ofdm_symbols_per_s')} run_s={res.get('run_s')} "
              f"seconds={res['seconds']:.2f}" + (f" faults: {res['faults']}" if res["faults"] else ""), flush=True)
        results.append(res)
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("shape_audit: no CUDA device", file=sys.stderr)
        return 1
    from ofdm_tpu_torch import build

    t0 = time.perf_counter()
    build.build(LIBRARIES)  # all at once, rather than one by one at first launch
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(LIBRARIES)} libraries)", flush=True)
    results = audit("cuda")
    bad = [r["shape"] for r in results if r["faults"]]
    print(json.dumps({"shapes": len(results), "bad": bad, "seconds": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
