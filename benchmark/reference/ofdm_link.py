"""Plain reference of one OFDM link point, in PyTorch float64.

Works a point out again from the configuration file and the point's key,
and imports nothing of the program under test.  The link, symbol by
symbol b of a point and bin k:

* TX: Philox4x32-10 (Salmon et al., SC'11) under the point's key at
  counter (b lo, b hi, k, 0) gives four words; word 0 masked by the order
  is the TX index, words 1 and 2 the AWGN draw.  The index is sent as the
  point of a Gray-coded square QAM with the reference's zig-zag rows, at
  unit mean power (``qam_table``).
* Channel: the orthonormal IDFT, the cyclic prefix, the stream
  convolution of the whole point's time samples with the unit-energy
  taps (the point starts from silence), the prefix dropped, the
  orthonormal DFT.
* AWGN per bin: sigma = sqrt(mp / snr / 2), mp the mean |y|^2 of the
  noiseless bins over the first ``power_slice_symbols`` symbols of the
  symbol's power tile; a chunk of ``symbols_per_chunk`` symbols is cut
  into tiles of the largest ladder size up to ``power_tile_cap`` that
  divides it.  The normal pair is Box-Muller of words 1 and 2:
  u1 = max(24 bits x 2^-24, 2^-24), u2 = 24 bits x 2^-24,
  z = sqrt(-2 ln u1) (cos 2 pi u2, sin 2 pi u2).
* Equalizer against the raw impulse response's FFT (the reference's
  quirk): ZF, or MMSE with the noise variance re-estimated a symbol,
  nv = mean_k |y_k|^2 / snr / mean_k |h_k|^2.
* Hard decision to the nearest grid point; bit errors are the popcount
  of TX index xor decided index, symbol errors the indices that differ.
* PAPR: peak over mean of |x|^2 of the time blocks (prefix included) of
  every ``papr_tile_stride``-th tile of each chunk; or, where the
  configuration says ``papr_sampled_tx``, of a fixed batch of
  min(max(1024, 2^25 // T), B) symbols whose indices are the uniform
  words of Philox counters (i lo, i hi, 0, 2) under the key (0x9A9, 0),
  four words a counter in order.

``precision`` "float64" is the reference.  "bfloat16" is the control:
every stage's output is rounded to bfloat16 before the next reads it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
PAPR_SAMPLE_KEY = (0x9A9, 0)
TILE_LADDER = (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32)
# symbols a pass of the reference holds, at most (bins a pass: this x n)
PASS_BINS = 1 << 23


def philox(c0, c1, c2, c3, key):
    """Philox4x32-10 on int64 tensors of uint32 words: four words out.  The
    32 x 32 -> 64-bit products wrap in int64, whose low 64 bits are exact."""
    k0, k1 = key
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = ((p1 >> 32) & M32) ^ c1 ^ k0, p1 & M32, ((p0 >> 32) & M32) ^ c3 ^ k1, p0 & M32
        k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return c0, c1, c2, c3


def key_words(key: int):
    """The two 32-bit words of a point's 64-bit key."""
    return key & M32, (key >> 32) & M32


def qam_table(order: int) -> np.ndarray:
    """Gray-coded square QAM at unit mean power: index i is sent as grid
    point gray(i) of the row-major m x m grid (columns left to right,
    rows top to bottom), every odd row of that order reversed."""
    m = int(round(math.sqrt(order)))
    if m * m != order:
        raise ValueError(f"not a square QAM order: {order}")
    levels = np.arange(-m + 1, m, 2, dtype=np.float64)
    grid = (levels[None, :] + 1j * levels[::-1, None]).reshape(-1)
    i = np.arange(order)
    table = grid[i ^ (i >> 1)].reshape(m, m)
    table[1::2] = table[1::2, ::-1]
    table = table.reshape(-1)
    return table / math.sqrt(np.mean(np.abs(table) ** 2))


def tile_for(chunk: int, cap: int) -> int:
    """The largest ladder tile <= cap that divides the chunk, else the largest that fits."""
    for t in TILE_LADDER:
        if t <= cap and chunk % t == 0:
            return t
    return next((t for t in TILE_LADDER if t <= min(cap, chunk)), TILE_LADDER[-1])


class Rounding:
    """The precision of every stage's output: float64, or bfloat16 (the control)."""

    def __init__(self, precision: str):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(f"precision float64 or bfloat16, not {precision!r}")
        self.low = precision == "bfloat16"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(self(x.real), self(x.imag))
        return x.to(torch.bfloat16).to(torch.float64)


class Link:
    """One configuration's link, worked out from its file on ``device``."""

    def __init__(self, config: Dict, device, precision: str = "float64"):
        link = config["link"]
        if link["modulation_type"] != "OFDM" or link["constellation_type"] != "QAM":
            raise ValueError("the plain reference computes OFDM with square QAM")
        if link["prefix_type"] != "CYCLIC" or link.get("apply_power_allocation") or \
                link.get("normalize_before_demap") or link["power_allocation_type"] != "UNIFORM":
            raise ValueError("the plain reference computes a cyclic prefix and uniform power, no power stages")
        self.device = torch.device(device)
        self.q = Rounding(precision)
        self.n = n = int(link["num_subcarriers"])
        self.order = int(link["constellation_order"])
        self.bits = self.order.bit_length() - 1
        self.m = int(round(math.sqrt(self.order)))
        ir = np.array([complex(re, im) for re, im in config["channel_taps"]], np.complex128)
        self.L = int(link["prefix_length_ratio"] * (len(ir) - 1))
        self.T = n + self.L
        self.taps = torch.tensor(ir / np.sqrt(np.sum(np.abs(ir) ** 2)), device=self.device)
        h = np.fft.fft(ir, n)
        self.h = torch.tensor(h, device=self.device)
        self.h_abs2 = self.h.abs() ** 2
        self.cg = float(np.mean(np.abs(h) ** 2))
        self.mmse = {"MMSE": True, "ZF": False}[link["equalization_method"]]
        self.awgn = link["noise_type"] == "AWGN"
        table = qam_table(self.order)
        self.table = torch.tensor(table, device=self.device)
        self.scale = 1.0 / math.sqrt(np.mean(np.abs(self._grid()) ** 2))
        # grid position row * m + col -> index
        pos = self._position(table)
        inv = np.empty(self.order, np.int64)
        inv[pos] = np.arange(self.order)
        self.inv = torch.tensor(inv, device=self.device)
        self.popcount = torch.tensor([bin(i).count("1") for i in range(self.order)], device=self.device)
        est = config["estimator"]
        self.chunk = int(link["symbols_per_chunk"])
        self.tile_cap = int(est["power_tile_cap"])
        self.slice = int(est["power_slice_symbols"])
        self.papr_stride = int(est["papr_tile_stride"])
        self.papr_sampled = bool(est["papr_sampled_tx"])

    def _grid(self) -> np.ndarray:
        levels = np.arange(-self.m + 1, self.m, 2, dtype=np.float64)
        return (levels[None, :] + 1j * levels[::-1, None]).reshape(-1)

    def _position(self, table: np.ndarray) -> np.ndarray:
        c = table / self.scale
        col = np.round((c.real + (self.m - 1)) / 2).astype(np.int64)
        row = np.round(((self.m - 1) - c.imag) / 2).astype(np.int64)
        return row * self.m + col

    # --- the chain, a pass of whole tiles of one chunk ------------------------

    def words(self, key, sym0: int, count: int):
        """Words 0, 1, 2 of counters (b lo, b hi, k, 0) for symbols [sym0, sym0 + count)."""
        b = torch.arange(sym0, sym0 + count, dtype=torch.int64, device=self.device)[:, None]
        k = torch.arange(self.n, dtype=torch.int64, device=self.device)[None, :]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        w0, w1, w2, _ = philox(b & M32, b >> 32, k, zero, key)
        return w0, w1, w2

    def modulate(self, s: torch.Tensor) -> torch.Tensor:
        """(S, n) points -> (S, T) time blocks: orthonormal IDFT, cyclic prefix."""
        x = self.q(torch.fft.ifft(s, dim=1, norm="ortho"))
        return torch.cat([x[:, self.n - self.L:], x], dim=1) if self.L else x

    def channel(self, x: torch.Tensor, tail: torch.Tensor):
        """The stream convolution of (S, T) blocks after ``tail`` (the K - 1
        samples before them): (S, n) noiseless bins and the next tail."""
        K = self.taps.shape[0]
        stream = torch.cat([tail, x.reshape(-1)])
        total = x.numel()
        y = torch.zeros(total, dtype=torch.complex128, device=self.device)
        for k in range(K):
            y = y + self.taps[k] * stream[K - 1 - k: K - 1 - k + total]
        y = self.q(y).reshape(x.shape)
        bins = self.q(torch.fft.fft(y[:, self.L:], dim=1, norm="ortho"))
        return bins, stream[total:].clone() if K > 1 else tail

    def sigma(self, y: torch.Tensor, tile: int, snr: float) -> torch.Tensor:
        """(S, 1) sigma of each symbol from its tile's measured-power slice;
        y holds whole tiles of one chunk (the last may be short)."""
        S = y.shape[0]
        tiles = -(-S // tile)
        p = torch.nn.functional.pad((y.real ** 2 + y.imag ** 2).sum(dim=1), (0, tiles * tile - S)).view(tiles, tile)
        syms = torch.tensor([min(self.slice, tile, S - t * tile) for t in range(tiles)], dtype=torch.float64,
                            device=self.device)
        mp = self.q(p[:, : self.slice].sum(dim=1) / (syms * self.n))
        return self.q(torch.sqrt(mp / snr / 2.0)).repeat_interleave(tile)[:S, None]

    def noise(self, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
        inv = 2.0 ** -24
        u1 = torch.clamp(((w1 >> 8) & 0xFFFFFF).to(torch.float64) * inv, min=inv)
        u2 = ((w2 >> 8) & 0xFFFFFF).to(torch.float64) * inv
        r = torch.sqrt(-2.0 * torch.log(u1))
        return self.q(torch.complex(r * torch.cos(2 * math.pi * u2), r * torch.sin(2 * math.pi * u2)))

    def equalize(self, y: torch.Tensor, snr: float) -> torch.Tensor:
        """Equalized points in slicer units (half the grid spacing is 1)."""
        slicer = 0.5 / self.scale
        if self.mmse:
            nv = self.q((y.real ** 2 + y.imag ** 2).mean(dim=1, keepdim=True) / snr / self.cg)
            g = self.q(slicer / (self.h_abs2 + nv))
            return self.q(y * self.h.conj() * g)
        h = torch.where(self.h == 0, torch.full_like(self.h, 1e-10), self.h)
        return self.q(y * (slicer / h))

    def decide(self, e: torch.Tensor) -> torch.Tensor:
        c0 = (self.m - 1) * 0.5
        cc = torch.clamp(torch.round(e.real + c0), 0, self.m - 1).to(torch.int64)
        rr = torch.clamp(torch.round(c0 - e.imag), 0, self.m - 1).to(torch.int64)
        return self.inv[rr * self.m + cc]

    def point(self, key: int, snr_db: float, symbols: int) -> Dict:
        """Bit errors, symbol errors, PAPR in dB and the power allocation of
        one point of ``symbols`` OFDM symbols at ``snr_db`` under ``key``."""
        kw = key_words(key)
        snr = 10.0 ** (snr_db / 10.0)
        bit_errors = symbol_errors = 0
        peak = torch.zeros((), dtype=torch.float64, device=self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = 0
        tail = torch.zeros(self.taps.shape[0] - 1, dtype=torch.complex128, device=self.device)
        for c0 in range(0, symbols, self.chunk):
            size = min(self.chunk, symbols - c0)
            tile = tile_for(size, self.tile_cap)
            step = max(tile, PASS_BINS // self.n // tile * tile)
            for p0 in range(0, size, step):
                S = min(step, size - p0)
                w0, w1, w2 = self.words(kw, c0 + p0, S)
                tx = w0 & (self.order - 1)
                s = self.q(self.table[tx])
                x = self.modulate(s)
                if not self.papr_sampled:
                    sampled = ((torch.arange(p0, p0 + S, device=self.device) // tile) % self.papr_stride) == 0
                    if bool(sampled.any()):
                        pw = x[sampled].real ** 2 + x[sampled].imag ** 2
                        peak = torch.maximum(peak, pw.max())
                        total = total + pw.sum()
                        count += pw.numel()
                y, tail = self.channel(x, tail)
                if self.awgn:
                    y = self.q(y + self.sigma(y, tile, snr) * self.noise(w1, w2))
                rx = self.decide(self.equalize(y, snr))
                diff = tx ^ rx
                bit_errors += int(self.popcount[diff].sum())
                symbol_errors += int((diff != 0).sum())
        if self.papr_sampled:
            peak, total, count = self.papr_sample(symbols)
        papr_db = 10.0 * math.log10(float(peak) / (float(total) / count))
        return {"bit_errors": bit_errors, "symbol_errors": symbol_errors, "papr_db": papr_db,
                "allocated_power": [1.0 / self.n] * self.n}

    def papr_sample(self, symbols: int):
        """(peak, power sum, samples) of the fixed sampled TX batch."""
        S = int(min(max(1024, (1 << 25) // self.T), symbols))
        words = S * self.n
        i = torch.arange(-(-words // 4), dtype=torch.int64, device=self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        w = torch.stack(philox(i & M32, i >> 32, zero, torch.full((), 2, dtype=torch.int64, device=self.device),
                               PAPR_SAMPLE_KEY), dim=1).reshape(-1)[:words]
        idx = (w & (self.order - 1)).reshape(S, self.n)
        x = self.modulate(self.q(self.table[idx]))
        pw = x.real ** 2 + x.imag ** 2
        return pw.max(), pw.sum(), pw.numel()
