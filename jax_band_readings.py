"""The JAX package's BER readings behind chip_smoke.py's bands.

    JAX_PLATFORMS=cpu python jax_band_readings.py [group ...]

Groups (all by default): bands, adaptive_scfde, noise_bump, bitlevel,
giant, audit, examples.

Runs each of ``chip_smoke.BAND_LINKS`` (the audit's 8-PSK and adaptive
links), the reference's adaptive config at 15 / 20 / 25 dB and
``chip_smoke.STAGED_BAND_LINKS`` (a waterfilling link a chain with
``apply_power_allocation`` and ``normalize_before_demap``) through the
JAX package's XLA path on the CPU, seed ``jax.random.PRNGKey(0)``, 2^18
OFDM symbols in chunks of 4096; ``chip_smoke.EAGER_LINKS`` the same way at
2^24 / n OFDM symbols (2^14 at 1024 subcarriers) in chunks of 2^20 / n;
then ``chip_smoke.ASC_CELLS`` (the reference's adaptive config on
SC-FDE) at 2^18 OFDM symbols, the fold cells also with the fold kernel's
measured power (``fold_power_estimator``); then every
point of the noise-bump study
(3 scenarios x SNR 0, 5, ..., 30 dB) through the JAX package's ``_Link``
at 2^16 OFDM symbols a point, key ``fold_in(PRNGKey(42), 1000 s + p)`` as
its campaign draws them, at 64 subcarriers and at each width of
``chip_smoke.NOISE_BUMP_WIDE`` (2^22 / n OFDM symbols a point there).
Then (group bitlevel) the two bit-level chains of ``chip_smoke.py``
with the JAX package's own functions and ``jax.random`` (key
``PRNGKey(0)``) at 2^16 OFDM symbols; then (group giant) the runs of
``chip_smoke.GIANT_RUNS`` held to a JAX reading (the 160-tap zero-prefix
link and the "taps" link, both at 1024 sc) at 2^24 / n OFDM symbols; then (group audit) every shape of
``ofdm_tpu_torch.shape_audit`` through the XLA path at min(16384, 2^24 /
n) OFDM symbols in chunks of min(4096, 2^20 / n).  Prints
``{"chip_smoke.JAX_CPU_READINGS": {name: [bit errors, bits]}}`` and
``{"shape_audit.READINGS": {...}}``, the values of those two tables.
Then (group examples) every link of the JAX package's ``examples/`` at
the script's own size and key (``example_readings``), printed as
``{"chip_smoke.EXAMPLE_READINGS": {...}}``; the noise-bump study's and
the parity report's noise-bump points are the noise_bump group's.
About 8 min on one CPU; the bitlevel and audit groups 82 s of them on 8
cores.

The bands of ``chip_smoke.py``'s sharded phase add no reading: the one-
and two-rank eager runs are ``OFDM-CY1.0-512``'s config (on the eager
chain by its hotpath), and the CLI's
adaptive points are the reference's adaptive config at 15 / 20 / 25 dB
(on its own 1,000 OFDM symbols a point), each held to the reading above.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import (ADAPTIVE_CONFIG, ASC_CELLS, ASC_READING_SYMBOLS, BAND_LINKS, EAGER_LINKS, GIANT_IR_SEED,
                        GIANT_KW, GIANT_RUNS, HEADLINE_KW, NOISE_BUMP_SNRS, NOISE_BUMP_WIDE, STAGED_BAND_LINKS,
                        noise_bump_name, seeded_taps)
from ofdm_tpu.config import EqualizationMethod, PrefixType, SimulationConfig
from ofdm_tpu.experiments import noise_bump as nb
from ofdm_tpu.models import channels as chm
from ofdm_tpu.ops import adaptive as jad
from ofdm_tpu.ops import allocate as jal
from ofdm_tpu.ops import bits as jbits
from ofdm_tpu.ops import channel as jch
from ofdm_tpu.ops import cplx
from ofdm_tpu.ops import equalize as jeq
from ofdm_tpu.ops import linops as jlin
from ofdm_tpu.ops import mapping as jmp
from ofdm_tpu.ops import metrics as jmt
from ofdm_tpu.ops import ofdm as jofdm
from ofdm_tpu.pipeline import LinkRunner, prepare
from ofdm_tpu_torch import shape_audit as sa
from ofdm_tpu_torch.shape_audit import AUDIT_BASE

SYMBOLS = 1 << 18
BITLEVEL_SYMBOLS = 1 << 16  # OFDM symbols of each bit-level chain's reading
CHUNK = 4096
NOISE_BUMP_SYMBOLS = 1 << 16
EAGER_BITS_SPAN = 1 << 24  # subcarriers x OFDM symbols of each EAGER_LINKS reading


def reading(cfg):
    r = LinkRunner(prepare(cfg)).run(jax.random.PRNGKey(0))
    assert r["hotpath_used"] == "xla", r["hotpath_used"]
    return [r["bit_errors"], r["total_bits"]]


@contextlib.contextmanager
def fold_power_estimator(guard):
    """The XLA path's AWGN with the JAX fold kernel's measured power: the
    mean |y|^2 over the n samples after the ``guard`` (Parseval: over the
    frequency bins, as pallas_link.py's fold branch measures it) instead of
    over all T samples.  Patched in this process only; the JAX package is
    not edited."""
    real = jch.awgn

    def awgn(key, signal, snr_db, measured_power=None, axis_name=None):
        if measured_power is None:
            measured_power = cplx.mean_abs2(cplx.CArray(signal.re[:, guard:], signal.im[:, guard:])
                                            if isinstance(signal, cplx.CArray) else signal[:, guard:])
        return real(key, signal, snr_db, measured_power, axis_name)

    jch.awgn = awgn
    try:
        yield
    finally:
        jch.awgn = real


def adaptive_scfde_readings():
    """{"<cell>_<snr>db": [bit errors, bits]} of chip_smoke.ASC_CELLS: the
    reference's adaptive config at each SNR point on SC-FDE with the cell's
    changes, ASC_READING_SYMBOLS OFDM symbols in chunks of at most 4096
    (2^20 / n at 1024 sc); for the cells on the fold chain also
    "<cell>_<snr>db_fold_power", the same run with the fold kernel's
    measured power (``fold_power_estimator``), which the kernel path's
    BER is held to."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ADAPTIVE_CONFIG)
    cfgs = {c.snr_db: c for c in SimulationConfig.from_json(path)}
    out = {}
    for cell, (chain, kw, snrs, _) in ASC_CELLS.items():
        n = kw.get("num_subcarriers", 64)
        for snr in snrs:
            cfg = cfgs[snr].replace(modulation_type="SC-OFDM", num_symbols=ASC_READING_SYMBOLS,
                                    symbols_per_chunk=min(CHUNK, (1 << 20) // n), **kw)
            out[f"{cell}_{int(snr)}db"] = reading(cfg)
            if chain == "fold":
                with fold_power_estimator(prepare(cfg).prefix_length):
                    out[f"{cell}_{int(snr)}db_fold_power"] = reading(cfg)
    return out


def band_readings():
    """BAND_LINKS, the reference's adaptive config, STAGED_BAND_LINKS and EAGER_LINKS."""
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
    for name, (_, kw) in STAGED_BAND_LINKS.items():
        out[name] = reading(SimulationConfig(**kw, num_symbols=SYMBOLS * kw["num_subcarriers"],
                                             symbols_per_chunk=CHUNK))
    for name, kw in EAGER_LINKS.items():
        n = kw["num_subcarriers"]
        out[name] = reading(SimulationConfig(**dict(kw, num_symbols=n * (EAGER_BITS_SPAN // n),
                                                    symbols_per_chunk=(1 << 20) // n)))
    return out


def giant_readings():
    """{name: [bit errors, bits]} of the runs of chip_smoke.GIANT_RUNS whose
    band is the JAX package's (the two at 1024 sc: the 160-tap zero-prefix
    link and the "taps" link): the XLA path at 2^24 / n OFDM symbols in
    chunks of 2^20 / n, on the seeded channel where the run has one.  The
    runs past 4096 sc are not read here (full-width links are not run on a
    shared CPU); chip_smoke.py holds them to the eager chain on the card."""
    out = {}
    for name, (kw, taps, _, _, jax_band) in GIANT_RUNS.items():
        if not jax_band:
            continue
        n = kw["num_subcarriers"]
        cfg = SimulationConfig(**dict(GIANT_KW, **kw), num_symbols=n * (EAGER_BITS_SPAN // n),
                               symbols_per_chunk=(1 << 20) // n)
        ir = None if taps is None else seeded_taps(taps, GIANT_IR_SEED)
        r = LinkRunner(prepare(cfg, channel_ir=ir)).run(jax.random.PRNGKey(0))
        assert r["hotpath_used"] == "xla", r["hotpath_used"]
        out[name] = [r["bit_errors"], r["total_bits"]]
    return out


def noise_bump_readings():
    """Every point of the noise-bump study through _Link, at 64 sc and NOISE_BUMP_WIDE's widths."""
    out = {}
    key = jax.random.PRNGKey(42)
    for n in (64, *NOISE_BUMP_WIDE):
        symbols = NOISE_BUMP_SYMBOLS * 64 // n
        link = nb._Link(symbols, n, 64, chm.get_channel("Lin-Phoong_P2"))
        bits = symbols * n * 6
        for s_i, scenario in enumerate(nb.SCENARIOS):
            profile = nb.create_noise_profile(n, scenario.noise_bump_db)
            for p_i, snr in enumerate(NOISE_BUMP_SNRS):
                ber, _ = link.run_point(jax.random.fold_in(key, s_i * 1000 + p_i), scenario, profile, snr)
                out[noise_bump_name(scenario.key, snr, n)] = [int(round(ber * bits)), bits]
    return out


def bitlevel_headline_reading(num_ofdm=BITLEVEL_SYMBOLS):
    """chip_smoke.bitlevel_headline's chain with the JAX package's functions
    and jax.random: the headline link's parameters from prepare(), bits ->
    mapping.encode -> linops.modulate -> linops.convolve (banded) ->
    channel.awgn -> linops.demodulate -> equalize -> decode_bits."""
    s = prepare(SimulationConfig(**HEADLINE_KW, num_symbols=64 * num_ofdm))
    cfg, const, n, L = s.cfg, s.const, s.cfg.num_subcarriers, s.prefix_length
    T = n + L
    kb, kn = jax.random.split(jax.random.PRNGKey(0))
    tx = jbits.random_bits(kb, (num_ofdm, n, const.bits_per_symbol))
    x = jlin.modulate(cplx.from_complex(jmp.encode(tx, const)), n, cfg.prefix_type, L, cfg.modulation_type)
    t0, t1 = jlin.conv_matrices(s.taps, T)
    E = jlin.ext_width(len(s.taps), T)

    def f32(m):
        return jnp.asarray(m.real, jnp.float32), jnp.asarray(m.imag, jnp.float32)

    y, _ = jlin.convolve(x, f32(t0), f32(t1[T - E:]), None, ext=E)
    y = jch.awgn(kn, y, cfg.snr_db)
    eqd = jeq.equalize(jlin.demodulate(y, n, cfg.prefix_type, L), cplx.from_complex(s.h_freq),
                       cfg.equalization_method, cfg.snr_db)
    rx = jmp.decode_bits(eqd.re + 1j * eqd.im, const)
    return [int(jmt.bit_errors(tx, rx)), int(tx.size)]


def bitlevel_adaptive_reading(num_ofdm=BITLEVEL_SYMBOLS, seed=0):
    """examples/overview.py's chain (its functions, jax.random) at ``num_ofdm``
    OFDM symbols under ``PRNGKey(seed)``: chip_smoke.bitlevel_adaptive's
    reference (seed 0), and examples/overview.py's own run (seed 42)."""
    n, snr_db = 64, 20.0
    raw = chm.get_channel("Lin-Phoong_P1")
    taps = jnp.asarray(chm.normalize_impulse_response(raw), jnp.complex64)
    h_freq = chm.channel_frequency_response(raw, n)
    gains = np.abs(h_freq) ** 2
    noise_power = 10 ** (-snr_db / 10)
    L = chm.channel_order(raw)
    power = jal.waterfilling(float(n), gains, noise_power)
    mapper = jad.make_adaptive_mapper("QAM", jmp.qam_bit_loading_orders(1e-3, power * gains / noise_power))
    kbits, knoise = jax.random.split(jax.random.PRNGKey(seed))
    tx = jbits.random_bits(kbits, (num_ofdm, mapper.bits_per_ofdm_symbol))
    symbols, _ = jad.encode(tx, mapper)
    symbols = symbols * jnp.sqrt(jnp.asarray(power)).astype(symbols.dtype)
    blocks = jofdm.ofdm_modulate(symbols, n, PrefixType.CYCLIC, L)
    rx, _ = jch.transmit(knoise, blocks, taps, snr_db)
    freq = jofdm.ofdm_demodulate_to_freq(rx, n, PrefixType.CYCLIC, L)
    eqd = jeq.equalize(freq, jnp.asarray(h_freq, jnp.complex64), EqualizationMethod.MMSE, snr_db)
    p = jnp.mean(jnp.abs(eqd) ** 2, axis=0, keepdims=True)
    eqd = jnp.where(p > 1e-10, eqd / jnp.sqrt(p), eqd)
    rx_bits, _ = jad.decode(eqd, mapper)
    return [int(jmt.bit_errors(tx, rx_bits)), int(tx.size)]


def walkthrough_reading(num_ofdm=10_000 // 64, snr_db=20.0, ser=1e-3, channel="Lin-Phoong_P2", n=64):
    """examples/bit_loading_walkthrough.py's link (steps 1-9, QAM, P = 1,
    PRNGKey(0)) at ``num_ofdm`` OFDM symbols: [bit errors, bits]."""
    noise_power = 1.0 / 10.0 ** (snr_db / 10.0)
    taps = chm.normalize_impulse_response(chm.get_channel(channel))
    h_freq = chm.channel_frequency_response(taps, n)
    gains = chm.channel_gains(taps, n)
    power = jal.waterfilling(1.0, gains, noise_power)
    orders = jmp.bit_loading_orders("QAM", ser, power * gains / (noise_power / n))
    mapper = jad.make_adaptive_mapper("QAM", orders)
    k_bits, k_chan = jax.random.split(jax.random.PRNGKey(0))
    tx = jbits.random_bits(k_bits, (num_ofdm, mapper.bits_per_ofdm_symbol))
    symbols, _ = jad.encode(tx, mapper)
    sqrt_power = jnp.sqrt(jnp.asarray(power, jnp.float32))
    blocks = jofdm.ofdm_modulate(symbols * sqrt_power[None, :], n, PrefixType.CYCLIC, len(taps) - 1)
    rx, _ = jch.transmit(k_chan, blocks, jnp.asarray(taps), snr_db)
    freq = jofdm.ofdm_demodulate_to_freq(rx, n, PrefixType.CYCLIC, len(taps) - 1)
    eqd = jeq.equalize(freq, jnp.asarray(h_freq), EqualizationMethod.MMSE, snr_db)
    comp = jnp.where(sqrt_power > 1e-10, 1.0 / jnp.maximum(sqrt_power, 1e-10), 0.0)
    rx_bits, _ = jad.decode(eqd * comp[None, :], mapper)
    return [int(jmt.bit_errors(tx, rx_bits)), int(tx.size)]


def _counts(r):
    return [int(r["bit_errors"]), int(r["total_bits"])]


_KEY = jax.random.PRNGKey(0)
_ADAPTIVE = dict(num_subcarriers=64, channel_type="CUSTOM", equalization_method=EqualizationMethod.MMSE,
                 power_allocation_type="WATERFILLING", adaptive_modulation_mode="CAPACITY_BASED")


def custom_channel_demo_reading(num_ofdm=1000):
    from ofdm_tpu.pipeline import simulate

    base = SimulationConfig(num_symbols=64 * num_ofdm, num_subcarriers=64, constellation_order=16,
                            channel_type="CUSTOM", equalization_method=EqualizationMethod.MMSE, snr_db=20.0)
    out = {name: _counts(simulate(base.replace(channel_model=name), _KEY))
           for name in ("flat_fading", "two_ray", "severe_multipath")}
    out["Lin-Phoong_P2.npy"] = _counts(simulate(base.replace(channel_model="config/channel_models/Lin-Phoong_P2.npy"),
                                                _KEY))
    out["custom 3-tap"] = _counts(simulate(base, _KEY, channel_ir=np.array([1.0 + 0.0j, 0.4 - 0.2j, 0.1 + 0.1j])))
    return out


def pod_scale_sweep_reading(qam_symbols=1 << 24, n=1024):
    """ShardedLinkRunner.run_grid on this process's devices, as the script runs it."""
    from ofdm_tpu.parallel import ShardedLinkRunner, make_mesh

    mesh = make_mesh()
    n_dev = mesh.devices.size
    num_ofdm = qam_symbols // n
    num_ofdm -= num_ofdm % n_dev
    cfg = SimulationConfig(num_symbols=num_ofdm * n, num_subcarriers=n, constellation_order=64,
                           channel_type="CUSTOM", channel_model="severe_multipath", prefix_type=PrefixType.CYCLIC,
                           prefix_length_ratio=1.0, equalization_method=EqualizationMethod.MMSE, snr_db=20.0,
                           symbols_per_chunk=min(num_ofdm, 8192 * n_dev))
    rs = ShardedLinkRunner(prepare(cfg), mesh=mesh).run_grid(_KEY, (0.0, 10.0, 20.0, 30.0))
    return {f"{r['snr_db']:.0f}db": _counts(r) for r in rs}


def quick_start_adaptive_reading(num_bits=500_000):
    cfg = SimulationConfig(num_bits=num_bits, channel_model="Lin-Phoong_P1", desired_symbol_error_rate=1e-3,
                           snr_db=20.0, **_ADAPTIVE)
    return {"quick_start": _counts(LinkRunner(prepare(cfg)).run(_KEY))}


def adaptive_modulation_demo_reading(num_ofdm=2000):
    from ofdm_tpu.config import AdaptiveModulationMode
    from ofdm_tpu.parallel import run_sweep

    base = SimulationConfig(num_symbols=64 * num_ofdm, num_subcarriers=64, constellation_order=16,
                            channel_type="CUSTOM", channel_model="Lin-Phoong_P1",
                            equalization_method=EqualizationMethod.MMSE, power_allocation_type="WATERFILLING",
                            snr_db=20.0)
    out = {}
    for mode, cfg in (("fixed", base), ("adaptive", base.replace(
            num_symbols=num_ofdm, adaptive_modulation_mode=AdaptiveModulationMode.CAPACITY_BASED))):
        for r in run_sweep(cfg, snrs=[10.0, 15.0, 20.0, 25.0], sharded=False, key=_KEY):
            out[f"{mode}_{r['snr_db']:.0f}db"] = _counts(r)
    return out


def configurable_simulation_demo_reading(num_ofdm=1000):
    from ofdm_tpu.parallel import run_sweep

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config/simulation_settings_waterfilling.json")
    cfgs = SimulationConfig.from_json(path)
    rs = run_sweep(cfgs[0].replace(num_symbols=64 * num_ofdm), snrs=[c.snr_db for c in cfgs], sharded=False,
                   key=_KEY)
    return {f"{r['snr_db']:.0f}db": _counts(r) for r in rs}


def plot_adaptive_constellation_demo_reading(num_ofdm=2000):
    cfg = SimulationConfig(num_symbols=num_ofdm, channel_model="severe_multipath", snr_db=22.0, **_ADAPTIVE)
    return {"adaptive_constellation": _counts(LinkRunner(prepare(cfg)).run(_KEY, collect_symbols=32768))}


def parity_report_reading(points=1 << 18, guard_grid=True):
    """The report's sweeps and (``guard_grid``) its 16 guard cells; its
    noise-bump rows are the noise_bump group's."""
    from ofdm_tpu.parallel import run_sweep
    from ofdm_tpu_torch.examples import parity_report as tpr

    campaign = dict(num_symbols=64 * points, num_subcarriers=64, channel_type="CUSTOM",
                    symbols_per_chunk=min(points, 1 << 17))
    sweeps = (("baseline_sc_qpsk", SimulationConfig(
        constellation_order=4, modulation_type="SC-OFDM", channel_model="Lin-Phoong_P1", prefix_type="CYCLIC",
        equalization_method="ZF", snr_db=20.0, **campaign), [0.0, 10.0, 20.0]),
        ("multipath_64qam_zf", SimulationConfig(constellation_order=64, channel_model="Lin-Phoong_P2",
                                                equalization_method="ZF", snr_db=30.0, **campaign), [30.0]),
        ("multipath_64qam_mmse", SimulationConfig(constellation_order=64, channel_model="Lin-Phoong_P2",
                                                  equalization_method="MMSE", snr_db=30.0, **campaign), [30.0]))
    out = {}
    for name, cfg, snrs in sweeps:
        for r in run_sweep(cfg, snrs=snrs, sharded=False, key=_KEY):
            out[f"{name}_{r['snr_db']:.0f}db"] = _counts(r)
    for cell in tpr.GUARD_GRID_REFERENCE if guard_grid else ():
        ptype, eqm, ratio = cell.split("-")
        cfg = SimulationConfig(constellation_order=64, channel_model="Lin-Phoong_P2", prefix_type=ptype,
                               prefix_length_ratio=float(ratio), equalization_method=eqm, snr_db=30.0, **campaign)
        out[cell] = _counts(run_sweep(cfg, snrs=[30.0], sharded=False, key=_KEY)[0])
    return out


# Each JAX example's links at the script's own size: {label: [bit errors, bits]}.
EXAMPLES = {
    "custom_channel_demo": custom_channel_demo_reading,
    "pod_scale_sweep": pod_scale_sweep_reading,
    "quick_start_adaptive": quick_start_adaptive_reading,
    "adaptive_modulation_demo": adaptive_modulation_demo_reading,
    "configurable_simulation_demo": configurable_simulation_demo_reading,
    "plot_adaptive_constellation_demo": plot_adaptive_constellation_demo_reading,
    "overview": lambda num_ofdm=1000: {"overview": bitlevel_adaptive_reading(num_ofdm, seed=42)},
    "bit_loading_walkthrough": lambda num_ofdm=10_000 // 64: {"bit_loading_walkthrough": walkthrough_reading(num_ofdm)},
    "parity_report": parity_report_reading,
}


def example_readings():
    """{"<example>/<label>": [bit errors, bits]}: every link of the JAX
    package's examples/ at the script's own size, keyed PRNGKey(0)
    (overview.py PRNGKey(42)) as the scripts key them; the labels are the
    port's ``ofdm_tpu_torch.examples`` records'.  The noise-bump study's
    points are the noise_bump group's."""
    return {f"{name}/{label}": v for name, fn in EXAMPLES.items() for label, v in fn().items()}


def audit_readings():
    """{tag: [bit errors, bits]} of every shape of ofdm_tpu_torch.shape_audit:
    the XLA path at min(16384, 2^24 / n) OFDM symbols in chunks of
    min(4096, 2^20 / n)."""
    out = {}
    for tag in sa.SHAPES:
        kw = sa.config_kw(tag)
        n = kw["num_subcarriers"]
        ofdm = min(sa.AUDIT_OFDM_SYMBOLS, (1 << 24) // n)
        adaptive = kw.get("adaptive_modulation_mode") == "CAPACITY_BASED"
        kw.update(num_symbols=ofdm if adaptive else ofdm * n, symbols_per_chunk=min(CHUNK, (1 << 20) // n))
        out[tag] = reading(SimulationConfig(**kw))
    return out


GROUPS = {
    "bands": band_readings,
    "adaptive_scfde": adaptive_scfde_readings,
    "noise_bump": noise_bump_readings,
    "bitlevel": lambda: {"bitlevel_headline": bitlevel_headline_reading(),
                         "bitlevel_adaptive": bitlevel_adaptive_reading()},
    "giant": giant_readings,
}


def main(argv):
    groups = argv or [*GROUPS, "audit", "examples"]
    out = {}
    for g in groups:
        if g in GROUPS:
            out.update(GROUPS[g]())
    if out:
        print(json.dumps({"chip_smoke.JAX_CPU_READINGS": out}, indent=1))
    if "audit" in groups:
        print(json.dumps({"shape_audit.READINGS": audit_readings()}, indent=1))
    if "examples" in groups:
        print(json.dumps({"chip_smoke.EXAMPLE_READINGS": example_readings()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
