"""The port's sharded runs: ``ShardedLinkRunner``, the mesh and the halo exchange.

* A one-rank mesh equals ``LinkRunner`` under ``fold_in(key, 0)`` on every
  chain and the eager chain, in both stream modes; a chunk that does not
  divide by the ranks raises.
* Two processes under gloo (``torch.distributed``, as
  ``tests/test_distributed.py`` runs two JAX processes): both ranks report
  the same global counts; independent streams equal the sum of the two
  shards' single-process runs under ``fold_in(key, 0)`` / ``fold_in(key,
  1)`` on fold, lr and mm; halo equals a single-process chained emulation
  (the shards' chunks in global order, each given the previous shard's K3
  tail); halo equals independent on diag; the halo tap convolution equals
  the unsharded convolution bit for bit; the eager link runs on both ranks
  with one result.
* The two-rank BER at z = 5 against the JAX package's ``ShardedLinkRunner``
  on two of conftest's eight virtual CPU devices.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from ofdm_tpu import config as jcfg
from ofdm_tpu import pipeline as jpl
from ofdm_tpu.parallel import ShardedLinkRunner as JaxShardedRunner
from ofdm_tpu.parallel import make_mesh as jax_make_mesh
from ofdm_tpu_torch import config as tcfg
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import metrics as mt
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.parallel import Mesh, ShardedLinkRunner, make_mesh

REPO = Path(__file__).resolve().parent.parent
KEY = 21
_BASE = dict(num_subcarriers=64, channel_type="CUSTOM", prefix_type="CYCLIC", prefix_length_ratio=1.0,
             symbols_per_chunk=512)
# One link a chain; fold, lr and mm with guards shorter than the channel, so
# that a symbol's predecessor reaches its points (the halo stream differs
# from the independent ones).
LINKS = {
    "fold": dict(_BASE, num_symbols=64 * 1024, constellation_order=16, channel_model="severe_multipath",
                 prefix_length_ratio=0.5, equalization_method="MMSE", snr_db=20.0),
    "lr": dict(_BASE, num_subcarriers=128, num_symbols=128 * 1024, constellation_order=16,
               channel_model="severe_multipath", prefix_length_ratio=0.34, equalization_method="MMSE", snr_db=20.0),
    "mm": dict(_BASE, num_symbols=64 * 1024, constellation_order=64, channel_model="Lin-Phoong_P2",
               prefix_type="ZERO", prefix_length_ratio=0.34, equalization_method="MMSE", snr_db=30.0),
    "diag": dict(_BASE, num_symbols=64 * 1024, constellation_order=64, channel_model="Lin-Phoong_P2",
                 equalization_method="MMSE", snr_db=25.0),
    "eager": dict(_BASE, num_symbols=64 * 512, constellation_order=16, channel_model="Lin-Phoong_P2",
                  equalization_method="MMSE", snr_db=20.0, hotpath="xla", symbols_per_chunk=256),
}


@pytest.fixture(autouse=True, scope="module")
def single_thread_torch():
    # As in test_torch_link.py: torch's multi-threaded CPU log lost accuracy
    # next to JAX's runtime.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, **kw):
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(LINKS[name], **kw)))
    assert tpl.kernel_mode(setup) == name
    return setup


def _counts(r):
    return r["bit_errors"], r["symbol_errors"], r["papr_db"]


@pytest.mark.parametrize("mode", ["independent", "halo"])
@pytest.mark.parametrize("name", list(LINKS))
def test_one_rank_mesh_equals_link_runner(name, mode):
    setup = _setup(name)
    r = ShardedLinkRunner(setup, mesh=make_mesh("cpu"), stream_mode=mode).run(KEY)
    want = tpl.LinkRunner(setup, device="cpu").run(prng.fold_in(KEY, 0))
    assert _counts(r) == _counts(want)
    assert (r["num_ranks"], r["stream_mode"], r["collective_backend"]) == (1, mode, "none")


def test_indivisible_chunk_raises():
    mesh = Mesh(0, 2, torch.device("cpu"))  # two ranks: the plan fails before any collective
    with pytest.raises(ValueError, match="do not divide by 2 ranks"):
        ShardedLinkRunner(_setup("fold", num_symbols=64 * 1023), mesh=mesh).run(KEY)
    with pytest.raises(ValueError, match="stream_mode"):
        ShardedLinkRunner(_setup("fold"), mesh=mesh, stream_mode="ring")


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["OFDM_TPU_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from ofdm_tpu_torch import pipeline as tpl
from ofdm_tpu_torch.config import SimulationConfig
from ofdm_tpu_torch.ops import channel as ch
from ofdm_tpu_torch.parallel import ShardedLinkRunner, distributed_init, halo, make_mesh

assert distributed_init(backend="gloo", timeout=60.0)
mesh = make_mesh("cpu")
assert (mesh.size, mesh.backend) == (2, "gloo"), mesh
links, key = json.loads(os.environ["LINKS"]), int(os.environ["KEY"])
out = {}
for name, kw in links.items():
    setup = tpl.prepare(SimulationConfig(**kw))
    for mode in ("independent", "halo"):
        r = ShardedLinkRunner(setup, mesh=mesh, stream_mode=mode).run(key)
        out[name + "/" + mode] = [r["bit_errors"], r["symbol_errors"], r["papr_db"], r["collective_backend"]]
# the halo tap convolution against the unsharded one, bit for bit
rng = np.random.default_rng(5)
taps = torch.tensor(rng.standard_normal(8) + 1j * rng.standard_normal(8), dtype=torch.complex64)
full = torch.tensor(rng.standard_normal((6, 32)) + 1j * rng.standard_normal((6, 32)), dtype=torch.complex64)
carry = torch.tensor(rng.standard_normal(7) + 1j * rng.standard_normal(7), dtype=torch.complex64)
got, got_carry = halo.convolve_taps_sharded(mesh, full[3 * mesh.rank : 3 * mesh.rank + 3].clone(), taps, carry)
parts = mesh.all_gather(got.contiguous())
want, want_carry = ch.convolve_blocks(full.clone(), taps, carry)
out["conv_bitwise"] = bool(torch.equal(torch.cat(parts), want) and torch.equal(got_carry, want_carry))
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def _run_two_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, OFDM_TPU_REPO=str(REPO), OFDM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   OFDM_TPU_NUM_PROCS="2", OFDM_TPU_PROC_ID=str(rank), LINKS=json.dumps(LINKS), KEY=str(KEY))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, se[-3000:]
        outs.append(json.loads([ln for ln in so.splitlines() if ln.startswith("RESULT ")][-1][7:]))
    return outs


@pytest.fixture(scope="module")
def two_ranks():
    return _run_two_ranks()


def _independent_sum(name):
    """The two shards' streams, each a single-process run of half the symbols."""
    kw = LINKS[name]
    n_sc = kw["num_subcarriers"]
    half = kw["num_symbols"] // n_sc // 2
    setup = tpl.prepare(tcfg.SimulationConfig(**dict(kw, num_symbols=n_sc * half,
                                                      symbols_per_chunk=kw["symbols_per_chunk"] // 2)))
    runs = [tpl.LinkRunner(setup, device="cpu").run(prng.fold_in(KEY, d)) for d in range(2)]
    return sum(r["bit_errors"] for r in runs), sum(r["symbol_errors"] for r in runs)


def _halo_emulation(name):
    """The contiguous shard-major stream in one process: each chunk's shards
    in order, shard d given shard d-1's K3 tail, shard 0 the previous
    chunk's last shard's (zeros at chunk 0)."""
    setup = _setup(name)
    runner = tpl.LinkRunner(setup, device="cpu")
    link, kern = runner.link, runner.kernel
    B, chunk = setup.num_ofdm_symbols, setup.cfg.symbols_per_chunk
    local = chunk // 2
    keys = [prng.fold_in(KEY, d) for d in range(2)]
    acc, psum = lk.new_accumulators("cpu")
    carry = (torch.zeros(link.E), torch.zeros(link.E))
    for c in range(B // chunk):
        for d in range(2):
            kern.chunk(link, keys[d], c * local, local, lk.snr_linear(setup.cfg.snr_db), acc, psum, None, None,
                       prev=carry)
            carry = kern.probe(link, keys[d], c * local, local, None)[2:]
    return tuple(acc[:2].tolist())


def test_two_ranks_agree(two_ranks):
    a, b = two_ranks
    assert a == b
    assert all(v[3] == "gloo" for k, v in a.items() if "/" in k)


@pytest.mark.parametrize("name", ["fold", "lr", "mm"])
def test_two_rank_independent_is_the_shards_sum(two_ranks, name):
    assert tuple(two_ranks[0][f"{name}/independent"][:2]) == _independent_sum(name)


@pytest.mark.parametrize("name", ["fold", "lr", "mm"])
def test_two_rank_halo_is_the_chained_stream(two_ranks, name):
    got = tuple(two_ranks[0][f"{name}/halo"][:2])
    assert got == _halo_emulation(name)
    assert got != tuple(two_ranks[0][f"{name}/independent"][:2])  # the exchange changed the stream


def test_two_rank_halo_on_diag_and_the_conv(two_ranks):
    r = two_ranks[0]
    assert r["diag/halo"] == r["diag/independent"]
    assert r["conv_bitwise"]
    be, se, _, _ = r["eager/halo"]
    bits = LINKS["eager"]["num_symbols"] * 4
    assert 0 < be / bits < 0.05 and r["eager/independent"][0] > 0


def test_two_rank_ber_matches_jax_sharded_runner(two_ranks):
    kw = dict(LINKS["fold"])
    kw.pop("symbols_per_chunk")
    jr = JaxShardedRunner(jpl.prepare(jcfg.SimulationConfig(**kw)), mesh=jax_make_mesh(num_devices=2))
    want = jr.run(jax.random.PRNGKey(0))
    be = two_ranks[0]["fold/independent"][0]
    assert mt.ber_equivalent(be, want["total_bits"], int(want["bit_errors"]), want["total_bits"], z=5.0)
