"""Process group, mesh and collectives of a sharded run (torch.distributed).

The port's counterpart of ``ofdm_tpu.parallel.mesh``.  The Monte-Carlo
batch axis shards over the ranks of one process group, one rank a device;
error counters reduce with an all-reduce, the halo exchange of a
contiguous stream rides send / recv (``parallel.halo``), and per-shard
streams derive their keys with ``prng.fold_in``.

Backends are explicit: ``"nccl"`` (one CUDA device a rank) is the
default on the card; ``"gloo"`` must be asked for, as the CPU tests do and
as two ranks sharing one card must (NCCL refuses two ranks on a device).
gloo takes CPU tensors only, so a gloo mesh on CUDA tensors copies the few
bytes of each collective through host memory, explicitly (``Mesh``'s
methods); a run's results name the backend (``collective_backend``).

``distributed_init`` reads the same OFDM_TPU_COORDINATOR /
OFDM_TPU_NUM_PROCS / OFDM_TPU_PROC_ID variables as the JAX package and is a
no-op in a single process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout: float = 300.0,
) -> bool:
    """Join the process group of a multi-process run; True when one is up.

    The arguments default to OFDM_TPU_COORDINATOR (``host:port`` of rank 0's
    TCP rendezvous), OFDM_TPU_NUM_PROCS and OFDM_TPU_PROC_ID; without any of
    them this is a single process and nothing happens.  ``backend``
    "nccl" binds the rank to CUDA device ``process_id`` modulo the local
    count first; ``timeout`` (seconds) bounds the rendezvous and every
    collective."""
    coordinator_address = coordinator_address or os.environ.get("OFDM_TPU_COORDINATOR")
    if num_processes is None and "OFDM_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["OFDM_TPU_NUM_PROCS"])
    if process_id is None and "OFDM_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["OFDM_TPU_PROC_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, process count and process id")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a sharded run: this rank, their count, this rank's
    device and the group's backend (None: one process, no group; every
    collective is then the identity)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def via_host(self) -> bool:
        """Whether collectives copy through host memory (gloo on CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a collective takes it: real (complex as (re, im) pairs),
        contiguous, and in host memory when the group needs that."""
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.detach().cpu().contiguous() if self.via_host else t.contiguous()

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        h = h.to(self.device)
        return torch.view_as_complex(h) if like.is_complex() else h

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the ranks in place ("sum" or "max")."""
        if self.backend is None:
            return t
        h = self._staged(t)
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=self.group)
        if h.data_ptr() != t.data_ptr():
            t.copy_(h)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor on this rank's device)."""
        if self.backend is None:
            return t.clone()
        h = self._staged(t).clone()
        dist.broadcast(h, src=src, group=self.group)
        return self._back(h, t)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to rank + 1 and receive rank - 1's (rank 0 receives
        rank size - 1's): one send and one receive a rank."""
        if self.backend is None or self.size == 1:
            return t.clone()
        send = self._staged(t)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.size, self.group),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(recv, t)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on all), in rank order."""
        if self.backend is None:
            return [t]
        h = self._staged(t)
        out = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(out, h, group=self.group)
        return [self._back(o, t) for o in out]


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of the current process group (or of this one process, when
    none is up).  ``device`` defaults to the rank's CUDA device; the CPU is
    used only when asked for (``device="cpu"``, with a gloo group)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available (pass device='cpu' with a gloo group)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL mesh runs on CUDA devices")
    return Mesh(dist.get_rank(group), dist.get_world_size(group), device, backend, group)
