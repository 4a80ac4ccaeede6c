"""Sweeps on the port: ``run_grid``, ``run_grid_multi``, ``run_sweep`` and ``prng.fold_in``.

* ``run_grid`` point p is ``run(fold_in(key, key_offset + p), snr_db=snrs[p])``
  exactly, with each point's waterfilling sqrt(P) row; adaptive setups raise.
* ``run_grid_multi`` equals the looped runs of its runners.
* ``run_sweep``'s grid equals its loop (fixed and adaptive), records each
  point in order and sets ``wall_time_s``.
* The port's grid BERs at z = 5 against the JAX package's ``run_grid`` on
  the same config (XLA path on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import metrics as mt
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.parallel import run_sweep

SCFDE = dict(num_symbols=64 * 512, num_subcarriers=64, constellation_order=4, channel_type="CUSTOM",
             channel_model="Lin-Phoong_P1", modulation_type="SC-OFDM", prefix_type="CYCLIC",
             prefix_length_ratio=1.0, equalization_method="ZF", snr_db=10.0, symbols_per_chunk=256)
ADAPTIVE = dict(num_symbols=256, num_subcarriers=64, constellation_order=16, channel_type="CUSTOM",
                channel_model="Lin-Phoong_P1", prefix_type="CYCLIC", prefix_length_ratio=1.0,
                equalization_method="MMSE", power_allocation_type="WATERFILLING",
                adaptive_modulation_mode="CAPACITY_BASED", snr_db=20.0)
SNRS = [0.0, 10.0, 20.0]


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(**kw):
    return tpl.LinkRunner(tpl.prepare(tcfg.SimulationConfig(**kw)), device="cpu")


def _counts(r):
    return r["bit_errors"], r["symbol_errors"], r["papr_db"]


def test_fold_in_is_deterministic_and_spreads():
    assert prng.fold_in(5, 3) == prng.fold_in((5, 0), 3)
    keys = {prng.fold_in(5, i) for i in range(256)} | {prng.fold_in(6, i) for i in range(256)}
    assert len(keys) == 512
    assert prng.fold_in(prng.fold_in(5, 1), 2) != prng.fold_in(prng.fold_in(5, 2), 1)
    with pytest.raises(ValueError):
        prng.fold_in(5, -1)


@pytest.mark.parametrize("offset", [0, 7])
def test_run_grid_points_are_folded_runs(offset):
    runner = _runner(**SCFDE)
    grid = runner.run_grid(11, SNRS, key_offset=offset)
    for p, (snr, r) in enumerate(zip(SNRS, grid)):
        want = runner.run(prng.fold_in(11, offset + p), snr_db=snr)
        assert _counts(r) == _counts(want) and r["snr_db"] == snr and r["grid_points"] == len(SNRS)


def test_run_grid_waterfilling_rows_per_point():
    kw = dict(SCFDE, power_allocation_type="WATERFILLING", apply_power_allocation=True, modulation_type="OFDM",
              prefix_length_ratio=0.5, channel_model="severe_multipath", constellation_order=16)
    runner = _runner(**kw)
    grid = runner.run_grid(2, SNRS)
    powers = [np.asarray(r["allocated_power"]) for r in grid]
    for snr, r, pw in zip(SNRS, grid, powers):
        np.testing.assert_array_equal(pw, runner.point_params(snr)[0])
        assert _counts(r) == _counts(runner.run(prng.fold_in(2, SNRS.index(snr)), snr_db=snr))
    assert not np.array_equal(powers[0], powers[-1])


def test_run_grid_refuses_adaptive():
    with pytest.raises(ValueError, match="SNR-dependent"):
        _runner(**ADAPTIVE).run_grid(0, SNRS)


def test_run_grid_multi_equals_looped_runs():
    runners = [_runner(**dict(ADAPTIVE, snr_db=s)) for s in (15.0, 20.0, 25.0)]
    got = tpl.run_grid_multi(runners, 4, [15.0, 20.0, 25.0], key_offset=2)
    for p, (r, runner) in enumerate(zip(got, runners)):
        assert _counts(r) == _counts(runner.run(prng.fold_in(4, 2 + p)))
        assert r["grid_points"] == 3


class _Recorder:
    def __init__(self):
        self.points = []

    def record(self, r):
        self.points.append((r["snr_db"], r["bit_errors"]))


@pytest.mark.parametrize("kw", [SCFDE, ADAPTIVE], ids=["fixed", "adaptive"])
def test_run_sweep_grid_equals_loop(kw):
    cfg = tcfg.SimulationConfig(**kw)
    snrs = [15.0, 20.0, 25.0]
    rec = _Recorder()
    grid = run_sweep(cfg, snrs=snrs, channels=["Lin-Phoong_P1", "Lin-Phoong_P2"], key=9, sharded=False,
                     grid=True, results_manager=rec, device="cpu")
    loop = run_sweep(cfg, snrs=snrs, channels=["Lin-Phoong_P1", "Lin-Phoong_P2"], key=9, sharded=False,
                     grid=False, device="cpu")
    assert [_counts(r) for r in grid] == [_counts(r) for r in loop]
    assert [r["channel_model"] for r in grid] == ["Lin-Phoong_P1"] * 3 + ["Lin-Phoong_P2"] * 3
    assert rec.points == [(r["snr_db"], r["bit_errors"]) for r in grid]
    assert all(r["wall_time_s"] > 0 for r in grid)
    # point i keys its run with fold_in(key, i)
    r4 = tpl.LinkRunner(tpl.prepare(cfg.replace(channel_model="Lin-Phoong_P2", snr_db=20.0)), device="cpu").run(
        prng.fold_in(9, 4), snr_db=20.0)
    assert _counts(grid[4]) == _counts(r4)


def test_grid_bers_match_jax_run_grid():
    kw = dict(SCFDE, num_symbols=64 * 2048, symbols_per_chunk=1024)
    got = _runner(**kw).run_grid(0, SNRS)
    jr = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw)))
    want = jr.run_grid(jax.random.PRNGKey(0), SNRS)
    for g, w in zip(got, want):
        assert g["total_bits"] == w["total_bits"]
        assert mt.ber_equivalent(g["bit_errors"], g["total_bits"], int(w["bit_errors"]), w["total_bits"], z=5.0)
    assert got[0]["bit_error_rate"] > got[1]["bit_error_rate"] > 0.0
