"""The work count of an OFDM link's configuration (its file's ``"work"``):
operations and bytes a point needs, from the
configuration file's sizes alone (never from an object of the program):
n, the prefix, the taps, the constellation, the equalizer, the noise, the
chunk, the measured-power tile and slice, and the PAPR's sampling.

The count is of the link's mathematics, so it does not change when an
implementation re-routes a link, fuses kernels or recomputes: per bin the
chain of ``peaks.OPS_PER_BIN``; where the guard is shorter than the
channel, the tail product and its two corrections; per measured-power
sample |y|^2 and its sum; per in-run PAPR symbol an n-point IDFT and the
statistic of its T samples.  A PAPR taken from the sampled TX batch costs
the window nothing (the batch is drawn once, in set-up).  Bytes: the
link's rows read once a chunk and the counters written; the symbols are
made on the device from their counters.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from harness import peaks

TILE_LADDER = (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32)


def tile_for(chunk: int, cap: int) -> int:
    for t in TILE_LADDER:
        if t <= cap and chunk % t == 0:
            return t
    return next((t for t in TILE_LADDER if t <= min(cap, chunk)), TILE_LADDER[-1])


def idft_ops(n: int) -> int:
    """An n-point transform: radix-2 butterflies and the scale at a power of
    two, else the direct sum, 8 a term."""
    if n & (n - 1) == 0:
        return (n // 2) * int(math.log2(n)) * peaks.BUTTERFLY_OPS + peaks.SCALE_OPS * n
    return n * n * peaks.PRODUCT_TERM_OPS


def point_work(config: Dict, symbols: int) -> Tuple[int, int]:
    """(operations, bytes) one point of ``symbols`` OFDM symbols needs."""
    link, est = config["link"], config["estimator"]
    n = int(link["num_subcarriers"])
    K = len(config["channel_taps"])
    L = int(link["prefix_length_ratio"] * (K - 1))
    T = n + L
    awgn = link["noise_type"] == "AWGN"
    per_bin = sum(peaks.OPS_PER_BIN[k] for k in ("philox", "encode", "channel", "demap", "count"))
    per_bin += peaks.OPS_PER_BIN["noise"] if awgn else 0
    per_bin += peaks.OPS_PER_BIN["mmse" if link["equalization_method"] == "MMSE" else "zf"]
    E = max(0, min(K - 1, T)) if K - 1 > L else 0  # tail lanes that reach the next block
    per_symbol = n * per_bin + (3 * E * n * peaks.PRODUCT_TERM_OPS + 2 * n if E else 0)
    chunk = int(link["symbols_per_chunk"]) or symbols
    ops = symbols * per_symbol
    nbytes = 0
    for c0 in range(0, symbols, chunk):
        size = min(chunk, symbols - c0)
        tile = tile_for(size, int(est["power_tile_cap"]))
        tiles = -(-size // tile)
        if awgn:
            slice_syms = sum(min(int(est["power_slice_symbols"]), tile, size - t * tile) for t in range(tiles))
            ops += slice_syms * n * peaks.POWER_SUM_OPS
        if not est["papr_sampled_tx"]:
            stride = int(est["papr_tile_stride"])
            sampled = sum(min(tile, size - t * tile) for t in range(0, tiles, stride))
            ops += sampled * (idft_ops(n) + peaks.PAPR_OPS * T)
        nbytes += 5 * 4 * n + 3 * 8
    return ops, nbytes
