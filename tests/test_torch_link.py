"""The port's diag chunk and runner against the JAX package.

* Against the real Pallas kernel (Mosaic interpret mode, whose PRNG emits
  zeros): the port's plain chunk on all-zero words must count the same
  errors.
* On seeded random words: the port's plain chunk against an oracle composed
  in the test from the JAX kernel's own helpers and constant rows.
* The slice end to end: the port's runner on the CPU against the JAX
  runner's XLA path, statistically (different generators).
* No fallback: no silent CPU run, links no kernel takes route to the
  eager chain before any launch, and the package runs with JAX, ofdm_tpu
  and matplotlib made unimportable.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import metrics as tmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_BER_30DB = 0.01901  # bench.py's gate value

HEADLINE = dict(
    num_symbols=64 * 1024,
    num_subcarriers=64,
    constellation_order=64,
    channel_type="CUSTOM",
    channel_model="Lin-Phoong_P2",
    prefix_type="CYCLIC",
    prefix_length_ratio=1.0,
    equalization_method="MMSE",
    snr_db=30.0,
)


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # With JAX's CPU runtime in the same process, torch's multi-threaded
    # CPU kernels were seen to compute float32 log with ~4e-5 relative
    # error on one worker thread's share of a plane; on one thread torch's
    # log stays within 1 ulp.  Counts here are compared exactly.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_chunk(kw, words, chunk, snr_db):
    ts = tpl.prepare(tcfg.SimulationConfig(**kw))
    link = lk.diag_link(ts, "cpu")
    acc, psum = lk.new_accumulators("cpu")
    carry = lk.diag_chunk_plain(link, (0, 0), 0, chunk, lk.snr_linear(snr_db), acc, psum, words=words)
    be, se, peak = acc.tolist()
    return be, se, lk.bits_f32(peak), float(psum), lk.papr_samples(link, chunk), carry


@pytest.mark.parametrize(
    "extra",
    [
        {},  # the headline: MMSE, AWGN, 30 dB
        dict(equalization_method="ZF", noise_type="NONE"),
    ],
    ids=["mmse_awgn", "zf_noiseless"],
)
def test_zero_words_match_pallas_kernel(extra):
    kw = dict(HEADLINE, **extra)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    fn = pk.make_pallas_chunk(jr, 1024, interpret=True)
    stats, _ = fn(jax.random.PRNGKey(0), jr._init_carry(), jnp.float32(kw["snr_db"]),
                  jnp.ones(64, jnp.float32))
    z = np.zeros((1024, 64), np.int64)
    be, se, peak, psum, count, _ = _port_chunk(kw, (z, z, z), 1024, kw["snr_db"])
    assert be == int(stats["bit_errors"]) and se == int(stats["symbol_errors"])
    if extra:
        assert be == 0 and se == 0
    assert count == int(stats["papr_count"])
    # JAX runs the PAPR plane in one bf16 pass (selected_passes -> 1), the port in f32
    assert peak == pytest.approx(float(stats["papr_peak"]), rel=2e-2)
    assert psum == pytest.approx(float(stats["papr_sum"]), rel=2e-2)


def _jax_oracle(kw, words, chunk):
    """The kernel's diag/qam chain in its op order, from the JAX helpers."""
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas")))
    spec = pk._spec_for(jr, chunk, True)
    consts = pk._consts_for(jr, spec)
    n = spec.n
    ncm = 3 if spec.passes == 1 else 6
    hre, him, habs2, gr, gi = (np.asarray(c, np.float32)[0, :n] for c in consts[1 + ncm : 6 + ncm])
    cg = np.float32(np.asarray(consts[0])[0])
    i32 = [jnp.asarray(np.asarray(w, np.uint32).view(np.int32)) for w in words]
    tx, sr, si = pk._encode_tile(spec, i32[0], None)
    yr = sr * hre - si * him
    yi = sr * him + si * hre
    snr_lin = jnp.exp(jnp.float32(kw["snr_db"]) * np.float32(np.log(10.0) / 10.0))
    if kw.get("noise_type", "AWGN") == "AWGN":
        S = lk.slice_symbols(n)
        sig = []
        for t0 in range(0, chunk, spec.tile):
            a, b = yr[t0 : t0 + min(S, spec.tile)], yi[t0 : t0 + min(S, spec.tile)]
            mp = jnp.mean(a * a + b * b)
            sig.append(jnp.full((spec.tile, 1), jnp.sqrt(mp / snr_lin / np.float32(2.0))))
        sigma = jnp.concatenate(sig)
        u1 = jnp.maximum(((i32[1] >> 8) & 0xFFFFFF).astype(jnp.float32) * np.float32(pk._INV_2_24),
                         np.float32(pk._INV_2_24))
        rad = jnp.sqrt(np.float32(-2.0) * jnp.log(u1))
        co, sn = pk._cossin_u24((i32[2] >> 8) & 0xFFFFFF)
        yr = yr + sigma * (rad * co)
        yi = yi + sigma * (rad * sn)
    slicer = np.float32(0.5 / pk._qam_geometry(spec.order)[2])
    method = kw.get("equalization_method", "MMSE")
    if method == "ZF":
        er, ei = yr * gr - yi * gi, yi * gr + yr * gi
    elif method == "MMSE":
        nv = jnp.mean(yr * yr + yi * yi, axis=1, keepdims=True) / snr_lin / cg
        g = slicer / (habs2 + nv)
        er, ei = (yr * hre + yi * him) * g, (yi * hre - yr * him) * g
    else:
        er, ei = yr * slicer, yi * slicer
    x = np.asarray(tx ^ pk._demap_tile(spec, er, ei, None)).astype(np.int64)
    be = int(sum(((x >> b) & 1).sum() for b in range(spec.bits)))
    se = int((x != 0).sum())
    # PAPR over the sampled tiles, in float64 from the f32 points
    rows = (np.arange(chunk) // spec.tile) % spec.pstride == 0
    from ofdm_tpu.ops import linops as jlin

    fr, fi = jlin.tx_matrix(n, jcfg.PrefixType(kw["prefix_type"]), spec.L, jcfg.ModulationType.OFDM)
    s = np.asarray(sr, np.float64)[rows] + 1j * np.asarray(si, np.float64)[rows]
    pw = np.abs(s @ (fr + 1j * fi)) ** 2
    return be, se, pw.max(), pw.sum(), spec.tile


@pytest.mark.parametrize(
    "extra,chunk",
    [
        ({}, 2048),
        (dict(equalization_method="ZF", snr_db=20.0), 2048),
        (dict(equalization_method="NONE", channel_model="flat_fading", snr_db=15.0), 1024),
        (dict(channel_model="severe_multipath", constellation_order=16, snr_db=10.0), 1024),
    ],
    ids=["mmse_30db", "zf_20db", "none_flat_15db", "mmse_16qam_severe"],
)
def test_random_words_match_jax_oracle(extra, chunk):
    kw = dict(HEADLINE, **extra)
    rng = np.random.default_rng(1234)
    words = [rng.integers(0, 1 << 32, size=(chunk, 64), dtype=np.uint64).astype(np.int64)
             for _ in range(3)]
    be, se, peak, psum, count, _ = _port_chunk(kw, words, chunk, kw["snr_db"])
    jbe, jse, jpeak, jsum, jtile = _jax_oracle(kw, words, chunk)
    assert lk.tile_for(chunk, lk.diag_link(tpl.prepare(tcfg.SimulationConfig(**kw)), "cpu").tile_cap) == jtile
    assert be > 0 and (be, se) == (jbe, jse)
    assert peak == pytest.approx(jpeak, rel=1e-5)
    assert psum == pytest.approx(jsum, rel=1e-5)


def _unit_ir(taps):
    rng = np.random.default_rng(3)
    ir = rng.standard_normal(taps) + 1j * rng.standard_normal(taps)
    return ir / np.linalg.norm(ir)


@pytest.mark.parametrize(
    "n,order,tile,extra,taps",
    [
        (64, 64, 8192, {}, None),
        (256, 64, 4096, {}, None),
        (256, 1024, 4096, {}, None),
        # 1024-QAM stages three bf16 passes in the JAX planner: T = 156 and
        # 309 lie just past a tile step there (one pass would give 8192 and 4096)
        (128, 1024, 4096, {}, 29),
        (256, 1024, 2048, {}, 54),
    ],
    ids=["n64", "n256", "n256_1024qam", "n128_t156_1024qam", "n256_t309_1024qam"],
)
def test_tile_matches_jax_spec_where_the_cap_binds(n, order, tile, extra, taps):
    # 2^17 divides by every ladder tile, so the cap alone picks the tile
    kw = dict(HEADLINE, num_symbols=n * 1024, num_subcarriers=n, constellation_order=order, **extra)
    ir = None if taps is None else _unit_ir(taps)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw, engine="planar", hotpath="pallas"), ir))
    setup = tpl.prepare(tcfg.SimulationConfig(**kw), ir)
    link = lk.diag_link(setup, "cpu")
    assert tpl.kernel_mode(setup) == "diag"
    assert lk.tile_for(1 << 17, link.tile_cap) == pk._spec_for(jr, 1 << 17, True).tile == tile


def _port_runner(num_ofdm, **extra):
    kw = dict(HEADLINE, num_symbols=64 * num_ofdm, **extra)
    return tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")


def test_slice_end_to_end_matches_jax_runner():
    B = 1 << 14
    port = _port_runner(B).run(0)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**dict(HEADLINE, num_symbols=64 * B))))
    ref = jr.run(jax.random.PRNGKey(0))
    assert set(port) == set(ref)
    assert port["hotpath_used"] == "torch" and port["papr_estimator"] == "in_run"
    for r in (port, ref):
        assert abs(r["bit_error_rate"] - REFERENCE_BER_30DB) < 1.5e-3
    assert tmt.ber_equivalent(port["bit_errors"], port["total_bits"], ref["bit_errors"],
                              ref["total_bits"], z=4)
    assert abs(port["papr_db"] - ref["papr_db"]) < 0.3


def test_counts_do_not_depend_on_tile_aligned_chunking():
    whole = _port_runner(1 << 14).run(5)
    split = _port_runner(1 << 14, symbols_per_chunk=8192).run(5)
    assert (whole["bit_errors"], whole["symbol_errors"]) == (split["bit_errors"], split["symbol_errors"])
    assert split["papr_sample_fraction"] == 2 * whole["papr_sample_fraction"]


def test_ragged_chunks_cover_every_symbol():
    r = _port_runner(1000, symbols_per_chunk=300, noise_type="NONE", equalization_method="ZF",
                     papr_stride=1).run(1)
    assert (r["bit_errors"], r["symbol_errors"]) == (0, 0)
    assert r["papr_sample_fraction"] == 1.0


def test_snr_sweep_falls():
    runner = _port_runner(1 << 12)
    bers = [runner.run(3, snr_db=s)["bit_error_rate"] for s in (0.0, 10.0, 20.0, 30.0)]
    assert all(a > b for a, b in zip(bers, bers[1:]))


def test_runner_needs_cuda_or_an_explicit_cpu():
    setup = tpl.prepare(tcfg.SimulationConfig(**HEADLINE))
    if torch.cuda.is_available():
        assert tpl.LinkRunner(setup).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpl.LinkRunner(setup)
    with pytest.raises(ValueError):
        lk.diag_chunk(lk.diag_link(setup, "cpu"), (0, 0), 0, 64, 1.0,
                      torch.zeros(3, dtype=torch.int64, device="meta"),
                      torch.zeros(1, dtype=torch.float64, device="meta"))


@pytest.mark.parametrize(
    "extra,mode",
    [
        # 8-PSK ISI-free past the 256-subcarrier warp layout: diag_wide (item 6b)
        (dict(constellation_type="PSK", constellation_order=8, num_subcarriers=384, num_symbols=384 * 16), "diag"),
        # zero-prefix links past the port's 256-subcarrier mm kernel (the JAX package runs mm):
        # the block-per-symbol mm kernel (modules item 7b)
        (dict(modulation_type="SC-OFDM", prefix_type="ZERO", num_subcarriers=512, num_symbols=512 * 16), "mm"),
        (dict(prefix_type="ZERO", channel_model="flat_fading", num_subcarriers=512, num_symbols=512 * 16), "mm"),
        # a single-tap channel past 256 subcarriers: the JAX package keeps diag, so does the port (txext)
        (dict(channel_model="flat_fading", num_subcarriers=1024, num_symbols=1024 * 16), "diag"),
        (dict(num_subcarriers=512, num_symbols=512 * 16), "diag"),
        # the power switches run on every kernel: adaptive SC-FDE on the fold
        # kernel since modules item 8b (its lane rows demap after the SC
        # IDFT), ISI-free 384 sc diag_wide
        (dict(apply_power_allocation=True, modulation_type="SC-OFDM", adaptive_modulation_mode="CAPACITY_BASED",
              power_allocation_type="WATERFILLING", num_symbols=16), "fold"),
        (dict(normalize_before_demap=True, num_subcarriers=384, num_symbols=384 * 16), "diag"),
    ],
    ids=["psk", "scfde", "zp", "flat_fading_1024sc", "n512", "apply_power", "normalize"],
)
def test_unsupported_configs_raise(extra, mode):
    # links the port took only on the eager chain before its wide diag and
    # mm kernels, and those it still does: each routes as the JAX package's
    # plan allows and runs
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(HEADLINE, **extra)))
    assert tpl.kernel_mode(setup) == mode
    r = tpl.LinkRunner(setup, device="cpu").run(0)
    assert r["hotpath_used"] == ("eager" if mode == "eager" else "torch") and r["total_bits"] == setup.total_bits
    # (adaptive SC-FDE reads ~0.106 at 30 dB in both packages: orders loaded per
    # bin, demapped per time sample after the SC IDFT)
    assert 0.0 <= r["bit_error_rate"] < 0.2 and r["papr_sample_fraction"] == 1.0


def test_adaptive_and_capture_raise():
    # adaptive loading with the TX power applied runs (its allocation sums
    # to n); symbol capture returns the counted points
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(
        HEADLINE, num_symbols=64, adaptive_modulation_mode="CAPACITY_BASED",
        power_allocation_type="WATERFILLING", apply_power_allocation=True)))
    runner = tpl.LinkRunner(setup, device="cpu")
    assert runner.mode == "diag" and runner.link.q.mode == "aqam" and runner.link.apply_power
    assert np.sum(setup.power_allocation) == pytest.approx(64.0)
    r = runner.run(0)
    assert 0.0 <= r["bit_error_rate"] < 0.05 and r["total_bits"] == setup.bits_per_ofdm_symbol * 64
    c = _port_runner(64).run(0, collect_symbols=16)
    assert c["received_symbols"].shape == (16,) and c["received_symbols"].dtype == np.complex64
    assert c["received_symbols_exact"] is True and np.isfinite(c["received_symbols"]).all()


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "ofdm_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "ofdm_tpu"), f"{path} imports {name}"


def test_port_runs_with_jax_unimportable():
    code = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["ofdm_tpu"] = None
sys.modules["matplotlib"] = None
sys.modules["PIL"] = None
import ofdm_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ofdm_tpu_torch.__path__, "ofdm_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(sys.argv[1], "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from ofdm_tpu_torch.config import SimulationConfig
from ofdm_tpu_torch.pipeline import LinkRunner, prepare
cfg = SimulationConfig(num_symbols=64 * 1024, num_subcarriers=64, constellation_order=64,
                       channel_type="CUSTOM", channel_model="Lin-Phoong_P2", snr_db=30.0)
r = LinkRunner(prepare(cfg), device="cpu").run(0)
assert 0.0 < r["bit_error_rate"] < 0.05, r["bit_error_rate"]
eager = LinkRunner(prepare(cfg.replace(hotpath="xla")), device="cpu").run(0, collect_symbols=8)
assert eager["hotpath_used"] == "eager" and eager["received_symbols"].shape == (8,)
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("OK", len(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_boxmuller_plain_passes_bench_moment_gate():
    z0, z1 = lk.boxmuller_sample(987654321, 123456789, (1 << 15, 128), device="cpu")
    assert z0.shape == (1 << 15, 128) and z0.dtype == torch.float32
    a, b = z0.reshape(-1).double(), z1.reshape(-1).double()
    mean, var = float(a.mean()), float(a.var(unbiased=False))
    tail3 = float((a.abs() > 3.0).double().mean())
    amax = max(float(a.abs().max()), float(b.abs().max()))
    corr = float((a * b).mean())
    assert abs(mean) < 3e-3 and abs(var - 1.0) < 5e-3
    assert 0.0025 <= tail3 <= 0.0029
    assert 4.0 < amax <= 5.78
    assert abs(corr) < 3e-3
    again = lk.boxmuller_sample(987654321, 123456789, (64, 128), device="cpu")
    assert torch.equal(again[0], z0[:64]) and torch.equal(again[1], z1[:64])
