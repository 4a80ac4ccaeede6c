"""Sharded Monte-Carlo runs and the SNR x channel sweep driver.

The port's counterpart of ``ofdm_tpu.parallel.sweep``.
``ShardedLinkRunner`` shards each chunk's OFDM symbols over the ranks of a
mesh (``parallel.mesh``): chunk sizes and ``num_ofdm_symbols`` are global,
rank d runs 1/size of every chunk under its own key ``prng.fold_in(key,
d)`` (sweep.py:114-115), its local symbols contiguous in its own stream,
through the same chunk kernel a ``LinkRunner`` launches.  Counters stay on
the device and reduce once a run: the int64 error counters by an
all-reduce sum, the PAPR peak by an all-reduce max (kept as the f32 bits
of a non-negative float in an int64 counter, whose integer max is the
float max), the f64 PAPR power sum and sample count by a sum.

``stream_mode``:

* ``"independent"``: each rank's symbols are a contiguous stream of their
  own.  Nothing is exchanged in a chunk: each chunk kernel recomputes its
  first symbol's predecessor from Philox under the rank's key.
* ``"halo"``: the ranks' chunks form ONE contiguous shard-major stream.
  On fold, lr and mm every chunk runs probe -> exchange -> kernel
  (sweep.py:187-203): each rank computes its chunk's carry with K3 (the
  carry probe), sends the tail to its right neighbour, rank 0 takes the
  previous chunk's global carry (zeros at chunk 0), the chunk kernel reads
  the received tail for its first symbol, and the new global carry comes
  from the last rank.  Diag links need no probe and no exchange (their
  symbols read no predecessor), so halo equals independent there.

The eager chain measures the AWGN power as the mean of the ranks' means
(the JAX package's pmean) and, in halo mode, exchanges its stream
convolution's tail (``parallel.halo.convolve_taps_sharded``).

The chunk is rounded down to a multiple of size x the chain's tile
(``_chunk_multiple``, sweep.py:616-619), so each rank's part keeps
whole tiles of the per-tile power estimator; a chunk or a last chunk that
does not divide by the ranks raises.

``run_sweep`` drives an SNR x channel grid as the JAX package's does:
``run_grid`` for a fixed-mode grid, ``run_grid_multi`` (a runner a point)
for an adaptive one, else a loop; every point's key is ``fold_in(key,
index)``, and a results manager records each point as it completes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ofdm_tpu_torch.config import AdaptiveModulationMode, SimulationConfig
from ofdm_tpu_torch.ops import link_kernel as lk
from ofdm_tpu_torch.ops import prng
from ofdm_tpu_torch.parallel import halo
from ofdm_tpu_torch.parallel.mesh import Mesh, make_mesh
from ofdm_tpu_torch.pipeline import LinkRunner, LinkSetup, eager_carry, eager_chunk, prepare, run_grid_multi

STREAM_MODES = ("independent", "halo")
# The JAX package's tile granularity cap (pallas_link._TILE, chunk_multiple).
TILE_MULTIPLE_CAP = 1024


class ShardedLinkRunner(LinkRunner):
    """A ``LinkRunner`` whose chunks shard over the ranks of ``mesh``.

    ``mesh`` defaults to ``make_mesh(device)`` (the current process group, or
    this process alone); the runner runs on the mesh's device.  Results are
    global and equal on every rank."""

    def __init__(self, setup: LinkSetup, mesh: Optional[Mesh] = None, stream_mode: str = "independent",
                 device=None):
        if stream_mode not in STREAM_MODES:
            raise ValueError(f"unknown stream_mode: {stream_mode!r}")
        mesh = make_mesh(device) if mesh is None else mesh
        super().__init__(setup, mesh.device)
        self.mesh = mesh
        self.stream_mode = stream_mode

    def _chunk_multiple(self) -> int:
        """Ranks x the chain's tile (capped at 1024): a rank's part of a chunk
        is then whole tiles."""
        return self.mesh.size * min(self.link.tile_cap, TILE_MULTIPLE_CAP)

    def _chunk_plan(self):
        chunk, _, hotpath_used, passes_used = super()._chunk_plan()
        B = self.setup.num_ofdm_symbols
        n = self.mesh.size
        if self.mode != "eager":
            gran = self._chunk_multiple()
            if chunk >= gran:
                chunk -= chunk % gran
        if chunk % n or (B % chunk) % n:
            raise ValueError(f"chunks of {chunk} and {B % chunk} OFDM symbols do not divide by {n} ranks")
        return chunk, -(-B // chunk), hotpath_used, passes_used

    def _key(self, key):
        return prng.fold_in(key, self.mesh.rank)

    def _halo_prev(self, key, sym0: int, local: int, rows, carry):
        """probe -> exchange for one chunk of this rank (halo mode, a chain
        with a probe): (the tail this rank's first symbol reads, the new
        global carry)."""
        _, _, tail_r, tail_i = self.kernel.probe(self.link, key, sym0, local, rows)
        if self.link.E == 0:
            return None, carry
        recv = halo.neighbor_shift(self.mesh, (tail_r, tail_i))
        prev = carry if self.mesh.rank == 0 else recv
        return prev, halo.broadcast_from_last(self.mesh, (tail_r, tail_i))

    def _zero_carry(self):
        f32 = dict(dtype=torch.float32, device=self.device)
        return torch.zeros(self.link.E, **f32), torch.zeros(self.link.E, **f32)

    def _chunks(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect):
        s = self.setup
        B = s.num_ofdm_symbols
        n = self.mesh.size
        kd = self._key(key)
        eager = self.mode == "eager"
        is_halo = self.stream_mode == "halo"
        probing = is_halo and not eager and self.kernel.probe is not None
        works = {}
        papr_count = 0
        received = None
        carry = eager_carry(self.link) if eager else (self._zero_carry() if probing else None)
        for c in range(num_chunks):
            local = min(chunk, B - c * chunk) // n
            sym0 = c * (chunk // n)
            if eager:
                carry, data = eager_chunk(self.link, kd, sym0, local, snr_db, acc, psum, carry, rows,
                                          mesh=self.mesh, halo=is_halo)
                if c == 0 and collect > 0:
                    received = self._gather_points(data.reshape(-1)[:collect], collect)
                papr_count += local * s.block_length
                continue
            prev = None
            if probing:
                prev, carry = self._halo_prev(kd, sym0, local, rows, carry)
            if local not in works and self.device.type == "cuda":
                works[local] = self.kernel.workspace(self.link, local, self.device)
            extra = {} if prev is None else {"prev": prev}
            self.kernel.chunk(self.link, kd, sym0, local, snr_lin, acc, psum, works.get(local), rows, **extra)
            papr_count += self.kernel.papr_samples(self.link, local)
        return papr_count, received

    def _gather_points(self, pts: torch.Tensor, collect: int) -> torch.Tensor:
        """The first ``collect`` points of the ranks' ``pts`` (equal lengths
        on every rank), shard-major."""
        return torch.cat(self.mesh.all_gather(pts.contiguous()))[:collect]

    def capture(self, key, chunk: int, snr_lin: float, rows, collect: int):
        """The first ``collect`` points of the global chunk 0, shard-major and
        on every rank: each rank replays its part of chunk 0 through the
        dump stage under its own key (in halo mode with the carry-in its
        left neighbour's probe gives, as the counted chunk reads it), and
        the ranks' points are gathered (sweep.py:549-614)."""
        local = chunk // self.mesh.size
        kd = self._key(key)
        prev = None
        if self.stream_mode == "halo" and self.kernel.probe is not None:
            prev, _ = self._halo_prev(kd, 0, local, rows, self._zero_carry())
        n = self.setup.cfg.num_subcarriers
        dump = lk.new_dump(lk.dump_rows(collect, n, local), n, self.device)
        acc, psum = lk.new_accumulators(self.device)
        work = self.kernel.workspace(self.link, local, self.device) if self.device.type == "cuda" else None
        extra = {} if prev is None else {"prev": prev}
        self.kernel.chunk(self.link, kd, 0, local, snr_lin, acc, psum, work, rows, dump=dump, **extra)
        pts = torch.complex(dump[0], dump[1]).reshape(-1)
        return self._gather_points(pts, collect).cpu().numpy()

    def _totals(self, acc, psum, papr_count):
        m = self.mesh
        m.all_reduce_(acc[:2], "sum")
        m.all_reduce_(acc[2:], "max")  # f32 bits of a non-negative peak: integer max = float max
        f64 = torch.cat([psum, torch.tensor([float(papr_count)], dtype=torch.float64, device=psum.device)])
        m.all_reduce_(f64, "sum")
        be, se, peak_bits = acc.tolist()
        papr_sum, count = f64.tolist()
        return be, se, peak_bits, papr_sum, int(count)

    def run(self, seed=0, collect_symbols: int = 0, snr_db: Optional[float] = None,
            render_constellation: bool = False) -> Dict[str, Any]:
        r = super().run(seed, collect_symbols, snr_db, render_constellation)
        r["num_ranks"] = self.mesh.size
        r["stream_mode"] = self.stream_mode
        r["collective_backend"] = self.mesh.backend or "none"
        return r


def run_sweep(
    base_cfg: SimulationConfig,
    snrs: Optional[Sequence[float]] = None,
    channels: Optional[Sequence[str]] = None,
    key=0,
    mesh: Optional[Mesh] = None,
    sharded: bool = True,
    stream_mode: str = "independent",
    collect_symbols: int = 0,
    results_manager=None,
    grid: bool = True,
    device=None,
) -> List[Dict[str, Any]]:
    """Run an SNR x channel grid; one results dict a point (the reference's
    ``SimulationRunner.run_all``; ofdm_tpu.parallel.sweep.run_sweep).

    A fixed-mode grid of several points runs through ``run_grid`` on one
    runner, an adaptive one through ``run_grid_multi`` with a runner a
    point (bit loading depends on the SNR); otherwise a loop.  Point
    ``len(results)`` keys its run with ``fold_in(key, len(results))``, so
    the grid and the loop give the same results; ``wall_time_s`` is the
    grid's time over its points (the loop's own time a point), and
    ``results_manager.record`` runs after each point.  ``sharded`` runs a
    ``ShardedLinkRunner`` on ``mesh`` (default: the current process group,
    or this process alone) in ``stream_mode``; ``device`` is the runners'
    (cuda by default)."""
    snrs = list(snrs) if snrs is not None else [base_cfg.snr_db]
    channels = list(channels) if channels is not None else [base_cfg.channel_model]
    if sharded and mesh is None:
        mesh = make_mesh(device)

    def runner_for(setup):
        if sharded:
            return ShardedLinkRunner(setup, mesh=mesh, stream_mode=stream_mode)
        return LinkRunner(setup, device)

    def record(rs, wall, channel):
        for r in rs:
            r["channel_model"] = channel
            r["wall_time_s"] = wall
            results.append(r)
            if results_manager is not None:
                results_manager.record(r)

    results: List[Dict[str, Any]] = []
    for channel in channels:
        cfg = base_cfg.replace(channel_model=channel)
        adaptive = cfg.adaptive_modulation_mode == AdaptiveModulationMode.CAPACITY_BASED
        if grid and len(snrs) > 1:
            t0 = time.perf_counter()
            if adaptive:
                runners = [runner_for(prepare(cfg.replace(snr_db=float(snr)))) for snr in snrs]
                rs = run_grid_multi(runners, key, snrs, collect_symbols=collect_symbols, key_offset=len(results))
            else:
                runner = runner_for(prepare(cfg.replace(snr_db=float(snrs[0]))))
                rs = runner.run_grid(key, snrs, collect_symbols=collect_symbols, key_offset=len(results))
            record(rs, (time.perf_counter() - t0) / max(len(rs), 1), channel)
            continue
        runner = None
        for snr in snrs:
            t0 = time.perf_counter()
            if adaptive or runner is None:
                runner = runner_for(prepare(cfg.replace(snr_db=float(snr))))
            r = runner.run(prng.fold_in(key, len(results)), collect_symbols=collect_symbols, snr_db=float(snr))
            record([r], time.perf_counter() - t0, channel)
    return results
