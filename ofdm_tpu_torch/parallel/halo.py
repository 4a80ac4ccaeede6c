"""Exact contiguous-stream convolution under sharding: the halo exchange.

The port's counterpart of ``ofdm_tpu.parallel.halo``.  In ``halo`` mode
the ranks' local batches form ONE contiguous shard-major stream: rank d's
first symbol follows rank d-1's last one, and rank 0's first follows the
last rank's last one of the previous chunk (the global carry).  What a
rank needs from its left neighbour is a pure function of that
neighbour's transmitted symbols, so each chunk costs one send / recv of a
short row (``neighbor_shift``) and one broadcast of the new global carry
(``broadcast_from_last``).

The chunk kernels exchange the tail their first symbol reads, which K3
(the carry probe) computes before the chunk runs; the eager chain
exchanges its stream convolution's (K-1,) tail (``convolve_taps_sharded``).
The matmul-form ``convolve_stream_sharded`` of the JAX package has no
counterpart: the port's eager chain convolves by taps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ofdm_tpu_torch.ops import channel as ch
from ofdm_tpu_torch.parallel.mesh import Mesh


def neighbor_shift(mesh: Mesh, x: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Each rank's tensors sent to its right neighbour: rank d receives rank
    d-1's, rank 0 the last rank's (the wrap-around, which is the chunk's
    new global carry)."""
    return tuple(mesh.ring_shift(t) for t in x)


def broadcast_from_last(mesh: Mesh, x: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """The last rank's tensors on every rank (halo.py:54-58's masked psum)."""
    return tuple(mesh.broadcast(t, mesh.size - 1) for t in x)


def convolve_taps_sharded(mesh: Mesh, blocks: torch.Tensor, taps: torch.Tensor,
                          carry_tail: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream convolution of a contiguous sharded stream, by taps.

    ``blocks`` is this rank's (B_local, T) part of the shard-major stream,
    ``carry_tail`` the replicated (K-1,) tail of the previous chunk's global
    stream.  Returns ``(out, new_carry)``, the carry replicated.  Bitwise
    the unsharded ``channel.convolve_blocks``: the local convolution runs
    with a zero head (x + 0 == x), then the left neighbour's tail (rank 0:
    the carry) adds into row 0's first K-1 samples, the one addition the
    unsharded stream makes there."""
    K = taps.shape[0]
    out, tail = ch.convolve_blocks(blocks, taps, None)
    if K == 1:
        return out, carry_tail
    (recv,) = neighbor_shift(mesh, (tail,))
    prev = carry_tail.to(out.dtype) if mesh.rank == 0 else recv
    out[0, : K - 1] += prev
    (new_carry,) = broadcast_from_last(mesh, (tail,))
    return out, new_carry
