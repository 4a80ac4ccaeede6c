"""The premises the wide dense kernels' exactness rests on (fold_wide,
mm_wide; csrc/wide_dft.cuh and csrc/mm_wide_kernel.cu), at a small size.

* The staged transform: the kernel's round tables (``dft.STAGE_PERMS``, the
  header's kStagePerm) applied in torch reproduce ``dft.block_dft`` bit for
  bit at 512, 1024 and 2048 points, forward and inverse; every stage runs
  once, in order; the moves the kernel makes under __syncwarp keep each
  warp's elements; round 0 holds the input the convolution writes straight
  into registers and the last round leaves thread t with bins t + 256 j.
  Against the JAX package's orthonormal DFT (its XLA split) within f32
  tolerance.
* mm_wide_front's walk: whole symbols, each thread adding its elements of a
  power group in ascending order and the block's tree closing the group,
  gives the tile partials ``link_kernel._tile_sigma`` sums (the plain
  version's power_partials order) bit for bit, at T = 1031 and at a T that
  does not divide 4096 with a ragged last tile.
"""

import os
import re

import numpy as np
import pytest
import torch

from ofdm_tpu.ops import dft as jdft
from ofdm_tpu_torch.ops import dft
from ofdm_tpu_torch.ops import link_kernel as lk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ofdm_tpu_torch", "csrc")
WIDTHS = (512, 1024, 2048)


def _planes(n, rows, seed):
    g = np.random.default_rng(seed)
    return (torch.tensor(g.standard_normal((rows, n)), dtype=torch.float32),
            torch.tensor(g.standard_normal((rows, n)), dtype=torch.float32))


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("n", WIDTHS)
def test_staged_transform_bit_equal(n, inverse):
    plan = dft.dft_plan(n, "cpu")
    xr, xi = _planes(n, 3, n + inverse)
    want = dft.block_dft(xr, xi, plan, inverse)
    got = dft.staged_block_dft(xr, xi, plan, inverse)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", WIDTHS)
def test_stage_schedule_layout(n):
    rounds = dft.stage_rounds(n)
    J = n // 256
    t = np.arange(256)[:, None]
    j = np.arange(J)[None, :]
    # each round holds every position once; the stages run once each, in order
    for r in rounds:
        assert sorted(r.table.reshape(-1)) == list(range(n))
    assert [s for r in rounds for s in r.stages] == list(range(n.bit_length() - 1))
    # round 0: thread t holds the conv outputs brev8(t) + 256 brev_r(j)
    bits = J.bit_length() - 1
    rev = lambda v, w: int(format(v, f"0{w}b")[::-1], 2) if w else 0
    want = np.array([[rev(tt, 8) + 256 * rev(jj, bits) for jj in range(J)] for tt in range(256)])
    assert np.array_equal(dft._bitrev(n, n.bit_length() - 1)[rounds[0].table], want)
    # the last round leaves thread t with bins t + 256 j
    assert np.array_equal(rounds[-1].table, t + 256 * j)
    # a __syncwarp move keeps each warp's positions; the block moves are few
    for a, b in zip(rounds, rounds[1:]):
        if a.warp_local:
            for w in range(8):
                assert set(a.table[32 * w : 32 * w + 32].reshape(-1)) == set(b.table[32 * w : 32 * w + 32].reshape(-1))
    block_moves = sum(not r.warp_local for r in rounds[:-1])
    assert block_moves == {512: 2, 1024: 2, 2048: 1}[n]


def test_kernel_tables_match():
    with open(os.path.join(CSRC, "wide_dft.cuh")) as fh:
        text = fh.read()
    for n in WIDTHS:
        body = re.search(rf"// kStagePerm {n}\n\s*constexpr int p{n}\[\d+\]\[\d+\] = \{{(.*?)\n\s*\}};", text, re.S)
        rows = tuple(tuple(int(v) for v in row.split(",")) for row in re.findall(r"\{([\d, ]+)\}", body.group(1)))
        assert rows == dft.STAGE_PERMS[n]


@pytest.mark.parametrize("inverse", (False, True))
def test_staged_transform_against_jax(inverse):
    n = 1024
    plan = dft.dft_plan(n, "cpu")
    xr, xi = _planes(n, 2, 7)
    got = dft.staged_block_dft(xr, xi, plan, inverse)
    x = xr.numpy().astype(np.float64) + 1j * xi.numpy().astype(np.float64)
    fn = jdft.ifft_ortho if inverse else jdft.fft_ortho
    ref = np.asarray(fn(x.astype(np.complex64), n))
    err = np.abs((got[0].numpy() + 1j * got[1].numpy()) - ref).max()
    assert err < 1e-4, err


def _front_groups() -> int:
    """Power groups a block of mm_wide_front closes (the kernel's kFrontGroups)."""
    with open(os.path.join(CSRC, "mm_wide_kernel.cu")) as fh:
        return int(re.search(r"constexpr int kFrontGroups = (\d+);", fh.read()).group(1))


def _front_partials(pw: np.ndarray, chunk: int, tile: int, groups: int) -> np.ndarray:
    """mm_wide_front's walk in numpy f32: a block of kFrontGroups groups
    of a tile computes its symbols in order into a row, thread t adds
    element e = 4096 g + 256 j + t of the current group g while e lies in
    the symbol (j ascending), and a group's 256 sums close by the halving
    tree when its last element has passed."""
    T = pw.shape[1]
    B = lk.POWER_BLOCK
    tiles = -(-chunk // tile)
    out = np.zeros((tiles, groups), np.float32)
    t = np.arange(256)
    per_block = _front_groups()

    def close(acc):
        s = 128
        while s >= 1:
            acc = acc[:s] + acc[s : 2 * s]
            s >>= 1
        return acc[0]

    for ti in range(tiles):
        b0 = ti * tile
        count = min(tile, chunk - b0) * T
        for g_lo in range(0, groups, per_block):
            g_hi = min(g_lo + per_block, groups)
            e_lo, e_hi = g_lo * B, min(g_hi * B, count)
            g, acc, e_next = g_lo, np.zeros(256, np.float32), g_lo * B + t
            if e_lo < e_hi:
                for s in range(e_lo // T, (e_hi - 1) // T + 1):
                    row = pw[b0 + s]
                    s_e0, s_e1 = s * T, min(s * T + T, e_hi)
                    while g < g_hi:
                        g_end = min((g + 1) * B, e_hi)
                        stop = min(s_e1, g_end)
                        while True:
                            live = e_next < stop
                            if not live.any():
                                break
                            acc = np.where(live, acc + row[np.minimum(e_next - s_e0, T - 1)], acc)
                            e_next = np.where(live, e_next + 256, e_next)
                        if g_end > s_e1:
                            break
                        out[ti, g] = close(acc)
                        acc, g = np.zeros(256, np.float32), g + 1
                        e_next = g * B + t
            for gg in range(g, g_hi):
                out[ti, gg] = np.float32(0.0)
    return out


@pytest.mark.parametrize("T,tile,chunk", ((1031, 64, 2 * 64 + 37), (777, 128, 300)))
def test_front_walk_matches_power_order(T, tile, chunk):
    g = np.random.default_rng(T)
    y = g.standard_normal((chunk, T, 2)).astype(np.float32)
    pw = (y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1]).astype(np.float32)
    tiles = -(-chunk // tile)
    groups = -(-tile * T // lk.POWER_BLOCK)
    got = _front_partials(pw, chunk, tile, groups)
    # the plain version's order: _tile_sigma's segments through tree_sum
    flat = torch.from_numpy(pw).reshape(-1)
    seg = torch.zeros((tiles, groups * lk.POWER_BLOCK), dtype=torch.float32)
    for t_ in range(tiles):
        count = min(tile, chunk - t_ * tile) * T
        seg[t_, :count] = flat[t_ * tile * T : t_ * tile * T + count]
    want = lk.tree_sum(seg.view(tiles, groups, lk.POWER_BLOCK)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # and so the sigma the main kernel derives from the partials
    tot = np.zeros(tiles, np.float32)
    for gg in range(groups):
        tot = tot + got[:, gg]
    sig = lk._tile_sigma(torch.from_numpy(pw), chunk, tile, tiles, groups, 10.0, tile)
    counts = np.array([min(tile, chunk - t_ * tile) * T for t_ in range(tiles)], np.float32)
    mine = np.sqrt((tot / counts) * np.float32(1.0) / np.float32(10.0) / np.float32(2.0)).astype(np.float32)
    assert np.array_equal(mine, sig.numpy())
