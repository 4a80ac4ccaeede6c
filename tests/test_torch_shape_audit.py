"""The port's shape audit (ofdm_tpu_torch.shape_audit) against the JAX package's.

* Its first 30 shapes are tools/shape_audit.py's, config for config: the
  tool's ``run`` is driven here with its ``prepare`` and ``LinkRunner``
  replaced by recorders (in this test only), so nothing runs.
* Its two added shapes are chip_smoke.py's adaptive-PSK zero-prefix link
  and the adaptive SC-FDE cell at 1024 subcarriers.
* Each shape's route is the JAX package's ``plan_for`` (its "mm" / "mm4"
  kernel is the port's fold chain without a zero prefix and its mm chain
  with one), and the port's router agrees at the widths where its lr
  factorization is cheap on a CPU (the card's audit checks every width).
  Past 1024 subcarriers ``plan_for`` reads a closed-form stand-in for the
  JAX package's ``lowrank.factor`` (whose dense host matrices take seconds
  and GiB at 2048 and 4096 subcarriers): the factors exist, with the ZP
  noise rank L, as the factorization's own algebra gives them.  The
  stand-in is held equal to the real factorization on every shape up to
  1024 subcarriers, where the real one runs here.
* Each shape has its JAX reading.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs
from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.ops import lowrank as jlr
from ofdm_tpu.ops import pallas_link as pk
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch import shape_audit as sa
from ofdm_tpu_torch.ops import fold_kernel as fk
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import mm_kernel as mmk

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import shape_audit as jsa  # noqa: E402  (tools/shape_audit.py)


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool_configs():
    """{tag: the JAX SimulationConfig tools/shape_audit.py builds}."""
    configs, tag = {}, {}

    def run(name, **kw):
        tag["now"] = name
        return real_run(name, **kw)

    class Runner:
        def __init__(self, setup):
            pass

        def run(self, key, snr_db=None):
            return {"hotpath_used": "none", "bit_error_rate": 0.0}

    def prepare(cfg):
        configs[tag["now"]] = cfg

    real_run = jsa.run
    saved = jsa.run, jsa.prepare, jsa.LinkRunner, dict(jsa.RESULTS)
    jsa.run, jsa.prepare, jsa.LinkRunner = run, prepare, Runner
    try:
        assert jsa.main() == 0
    finally:
        jsa.run, jsa.prepare, jsa.LinkRunner = saved[:3]
        jsa.RESULTS.update(saved[3])
    return configs


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_the_tools_shapes_in_its_order(tool_configs):
    tags = list(sa.SHAPES)
    assert len(tool_configs) == 30 and tags[:30] == list(tool_configs)
    assert tags[30:] == ["adapt_psk_wf_zp1.0_64", "adaptive_scfde_1024sc"]
    assert set(sa.ROUTES) == set(sa.SHAPES) == set(sa.READINGS)


@pytest.mark.parametrize("tag", list(sa.SHAPES)[:30])
def test_shape_is_the_tools(tag, tool_configs):
    assert _fields(jcfg.SimulationConfig(**sa.config_kw(tag))) == _fields(tool_configs[tag])


def test_added_shapes_are_chip_smokes():
    tool_sizes = dict(num_symbols=sa.AUDIT_OFDM_SYMBOLS, symbols_per_chunk=sa.AUDIT_CHUNK)
    psk = tcfg.SimulationConfig(**dict(sa.AUDIT_BASE, **cs.CODEC_LINKS["adapt_psk_wf_zp1.0_64"][2], **tool_sizes))
    assert _fields(tcfg.SimulationConfig(**sa.config_kw("adapt_psk_wf_zp1.0_64"))) == _fields(psk)
    chain, kw, snrs, _ = cs.ASC_CELLS["adaptive_scfde_1024sc"]
    asc = cs.asc_cfg(20.0, sa.AUDIT_OFDM_SYMBOLS, sa.AUDIT_CHUNK, **kw)
    ours = tcfg.SimulationConfig(**sa.config_kw("adaptive_scfde_1024sc"))
    assert _fields(ours) == _fields(asc)
    assert 20.0 in snrs and sa.ROUTES["adaptive_scfde_1024sc"][0] == chain


EXACT_MAX_N = 1024  # the real lowrank.factor runs up to this width here


def closed_form_factor(taps, n, prefix, L, modulation):
    """What ``plan_for`` reads of ``lowrank.factor`` on the links it asks
    about: factors that exist, with noise rank L under a zero prefix (the
    spill rows' B = S^H) and 0 otherwise."""
    return SimpleNamespace(noise_rank=L if prefix == jcfg.PrefixType.ZERO else 0)


def _jax_route(kw, monkeypatch):
    if kw["num_subcarriers"] > EXACT_MAX_N:
        monkeypatch.setattr(jlr, "factor", closed_form_factor)
    runner = jpl.LinkRunner(jpl.prepare(jcfg.SimulationConfig(**kw)))
    plan = pk.plan_for(runner)
    if plan is None or not pk.supports(runner, interpret=True):
        return "eager", runner
    if plan[1] in ("mm", "mm4"):
        return ("mm" if kw["prefix_type"] == "ZERO" else "fold"), runner
    return plan[1], runner


@pytest.mark.parametrize("tag", list(sa.SHAPES))
def test_route_is_the_jax_plan(tag, monkeypatch):
    kw = sa.config_kw(tag)
    adaptive = kw.get("adaptive_modulation_mode") == "CAPACITY_BASED"
    kw["num_symbols"] = 16 if adaptive else 16 * kw["num_subcarriers"]  # the plan does not read the size
    chain, kernel = sa.ROUTES[tag]
    route, runner = _jax_route(kw, monkeypatch)
    assert route == chain
    n = kw["num_subcarriers"]
    f = getattr(runner, "_lr_factors_cache", None)
    if n <= EXACT_MAX_N and f is not None:
        # the stand-in the wider shapes read agrees with the real factorization
        s = runner.setup
        assert f.noise_rank == closed_form_factor(s.taps, n, s.cfg.prefix_type, s.prefix_length, None).noise_rank
    if n <= 1024:
        setup = tpl.prepare(tcfg.SimulationConfig(**kw))
        assert tpl.kernel_mode(setup) == chain
        narrow = {"diag": n <= lk.WARP_MAX_N, "fold": n <= fk.MAX_N, "lr": True,
                  "mm": n <= mmk.MAX_N and setup.block_length <= mmk.MAX_T}[chain]
        wide = {"diag": "diag_wide", "fold": "fold_wide_main", "mm": "mm_wide_main"}
        assert kernel == (f"{chain}_main" if narrow else wide[chain])


@pytest.mark.parametrize("tag", list(sa.SHAPES))
def test_reading_is_of_the_shape(tag):
    # min(16384, 2^24 / n) OFDM symbols, each carrying bits on every active subcarrier
    errors, bits = sa.READINGS[tag]
    kw = sa.config_kw(tag)
    n = kw["num_subcarriers"]
    ofdm = min(16384, (1 << 24) // n)
    assert 0 <= errors < bits and bits % ofdm == 0
    if kw.get("adaptive_modulation_mode") != "CAPACITY_BASED":
        bps = (kw["constellation_order"]).bit_length() - 1
        assert bits == ofdm * n * bps
