"""Philox4x32-10, the port's counter-based generator.

The TPU kernels draw from the TPU's hardware generator, whose bits cannot
be reproduced elsewhere; the port draws every random word from Philox4x32-10
(Salmon et al., SC'11) instead, so parity with the JAX package is
statistical while the CUDA kernels and their plain versions agree bit for
bit.  The device function is ``csrc/link_common.cuh::philox4x32_10``; this
module holds the plain version (uint32 arithmetic emulated in int64, the
32x32->64 products taken exactly in 16-bit halves) and ``philox_words``,
whose kernel fills words for a range of counters.

Counter addressing of the link: the words of bin k of OFDM symbol b (the
symbol's index in the whole run) come from counter (b lo, b hi, k, 0)
under the key (seed lo, seed hi).  Word 0 is the TX index, words 1 and 2
are the Box-Muller u1 and u2, word 3 is unused.  A zero-prefix link's
colored noise draws r more complex normals per symbol (the g2 of
``ops.lowrank``): normal j < r takes words 1 and 2 of counter
(b lo, b hi, j, 1), so it never meets a bin's counter.  The zero-prefix
mm chain adds its noise to the T = n + L time samples of a symbol instead
of its n bins: time sample j < T takes words 1 and 2 of counter
(b lo, b hi, j, 0).  For j < n these are the words bin j already draws,
for n <= j < T new counters that meet neither the colored draws nor the
uniform-word stream below; ``link_words(key, sym0, count, T)`` is the
plain draw, and the mm chain reads its raw word only below column n.  The
noise-bump study's post-equalization noise (the diag chain's post_noise
stage) draws one complex normal a bin after the equalizer: bin k takes
words 1 and 2 of counter (b lo, b hi, k, 3) (``post_noise_words``), a
fourth value of the last counter word that meets none of the streams of
c3 = 0 (bins, time samples), 1 (colored draws) or 2 (uniform words).  The
eager chain (``pipeline``'s chain for the links no chunk kernel takes)
draws from two more: its time-domain AWGN takes words 1 and 2 of counter
(b lo, b hi, j, 4) for time sample j of symbol b, and the noise-bump
study's small-batch sampler (``experiments.noise_bump._Link``) its post-EQ
noise from counter (b lo, b hi, k, 5) for bin k (``normal_planes``).  A
draw therefore depends on neither the chunking nor the launch geometry.

``philox_plane`` fills a (rows, cols) plane with word 0 of counters
(b lo, b hi, c, c3), b = sym0 + row: at c3 = 0 the TX words the chunk
kernels draw, so the eager chain and every kernel send the same symbols
for one seed.  ``normal_planes`` turns words 1 and 2 of the same counters
into two N(0,1) planes by Box-Muller with the library's log, sqrt, cos and
sin (the TPU kernel ``ofdm_tpu.ops.prng._normal_kernel``'s math, not the
link kernels' polynomial phase).

``random_u32`` (the counterpart of ``ofdm_tpu.ops.prng.random_u32``, whose
TPU kernel is ``_pallas_u32``) fills uniform words from counters
(i lo, i hi, 0, 2), four words a counter, under the caller's key, with the
same ``ofdm_philox`` kernel.

``fold_in(key, i)`` derives the key of sub-stream i (an SNR point of a
sweep, a shard of a sharded run), the counterpart of ``jax.random.fold_in``:
words 0 and 1 of counter (i lo, i hi, 0, 6) under ``key``, a sixth value of
the last counter word that meets none of the streams above.  Like every
draw of the port it is a statistical contract, not the JAX package's
bits: derived keys are as independent of their parent and of each other
as Philox outputs are, and the same (key, i) always gives the same key.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def key_words(seed) -> Tuple[int, int]:
    """The two 32-bit key words of a run's seed: an int < 2^64, or a pair of
    key words (``fold_in``'s result) taken as they are."""
    if isinstance(seed, (tuple, list)):
        if len(seed) != 2 or not all(0 <= int(w) <= M32 for w in seed):
            raise ValueError(f"a key is two 32-bit words, got {seed}")
        return int(seed[0]), int(seed[1])
    if not 0 <= int(seed) < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    seed = int(seed)
    return seed & M32, (seed >> 32) & M32


# The last counter word of fold_in's derivation.
FOLD_STREAM = 6


def fold_in(key, i: int) -> Tuple[int, int]:
    """The key words of sub-stream ``i`` (0 <= i < 2^64) of ``key`` (a seed
    or key words): words 0 and 1 of Philox4x32-10 under ``key`` at counter
    (i lo, i hi, 0, FOLD_STREAM), computed on the host."""
    key = key_words(key)
    if not 0 <= int(i) < 1 << 64:
        raise ValueError(f"fold_in takes 0 <= i < 2^64, got {i}")
    w0, w1, _, _ = philox4x32_10(int(i) & M32, int(i) >> 32, 0, FOLD_STREAM, key)
    return int(w0), int(w1)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a and uint32 b in int64."""
    x = a * (b & 0xFFFF)  # < 2^48
    y = a * (b >> 16)  # < 2^48
    lo = (x + ((y & 0xFFFF) << 16)) & M32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, key: Tuple[int, int]):
    """Plain Philox4x32-10: four int64 tensors (or Python ints) of uint32
    counter words in, four out (broadcasting like the arithmetic operators)."""
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
    return c0, c1, c2, c3


def link_words(key: Tuple[int, int], sym0: int, count: int, n: int, device="cpu"):
    """(raw, u1 word, u2 word), each (count, n) int64, for run symbols
    [sym0, sym0 + count) — the plain form of the link kernel's draw.  With
    n = T the columns are a zero-prefix mm link's time samples."""
    b = torch.arange(sym0, sym0 + count, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0, w1, w2, _ = philox4x32_10(b & M32, b >> 32, k, zero, key)
    return w0, w1, w2


def noise_words(key: Tuple[int, int], sym0: int, count: int, r: int, device="cpu"):
    """(u1 word, u2 word), each (count, r) int64: the colored-noise draws of
    run symbols [sym0, sym0 + count), counter (b lo, b hi, j, 1)."""
    b = torch.arange(sym0, sym0 + count, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(r, dtype=torch.int64, device=device)[None, :]
    one = torch.ones((), dtype=torch.int64, device=device)
    _, w1, w2, _ = philox4x32_10(b & M32, b >> 32, j, one, key)
    return w1, w2


# The last counter word of the post-EQ noise stream.
POST_NOISE_STREAM = 3


def post_noise_words(key: Tuple[int, int], sym0: int, count: int, n: int, device="cpu"):
    """(u1 word, u2 word), each (count, n) int64: the post-equalization
    noise draws of run symbols [sym0, sym0 + count), counter
    (b lo, b hi, k, 3)."""
    b = torch.arange(sym0, sym0 + count, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    c3 = torch.full((), POST_NOISE_STREAM, dtype=torch.int64, device=device)
    _, w1, w2, _ = philox4x32_10(b & M32, b >> 32, k, c3, key)
    return w1, w2


def philox_words_plain(count: int, c2: int, c3: int, key: Tuple[int, int], device="cpu"):
    """(count, 4) int64 words for counters (i lo, i hi, c2, c3), i < count."""
    i = torch.arange(count, dtype=torch.int64, device=device)
    c2_ = torch.full_like(i, c2)
    c3_ = torch.full_like(i, c3)
    return torch.stack(philox4x32_10(i & M32, i >> 32, c2_, c3_, key), dim=1)


def _philox_fill(count: int, c2: int, c3: int, key: Tuple[int, int], device) -> torch.Tensor:
    """(count, 4) int32 words (the uint32 bits) from the ``ofdm_philox``
    kernel on a CUDA device; one launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the ofdm_philox kernel runs on cuda, not {device}")
    from ofdm_tpu_torch import build

    lib = build.load("boxmuller")
    out = torch.empty((count, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib, lib.ofdm_philox(out.data_ptr(), count, c2, c3, key[0], key[1], stream), "ofdm_philox")
    return out


def philox_words(count: int, c2: int, c3: int, key: Tuple[int, int], device="cuda"):
    """``philox_words_plain`` computed by the ``ofdm_philox`` kernel on a CUDA
    device (returned as int64 like the plain version); the plain version on
    the CPU."""
    if torch.device(device).type == "cpu":
        return philox_words_plain(count, c2, c3, key, device)
    out = _philox_fill(count, c2, c3, key, device)
    philox_words.launches += 1
    return out.to(torch.int64) & M32


philox_words.launches = 0

# Counter words (c2, c3) of the uniform-word stream.
U32_STREAM = (0, 2)


def random_u32_plain(key: Tuple[int, int], shape, device="cpu"):
    """Plain version of ``random_u32``."""
    count = math.prod(shape)
    w = philox_words_plain(-(-count // 4), *U32_STREAM, key, device).reshape(-1)[:count]
    return (w - ((w >> 31) << 32)).to(torch.int32).reshape(shape)


def random_u32(key: Tuple[int, int], shape, device="cuda"):
    """Uniform 32-bit words of ``shape``: ceil(count / 4) Philox counters
    (i lo, i hi, 0, 2), their four words each in order.  The words come as
    int32 holding the uint32 bits (torch has no full uint32 type; ``& M32``
    of the int64 widening gives the unsigned value).  On a CUDA device the
    ``ofdm_philox`` kernel writes them, with no further pass (counted in
    ``random_u32.launches``); on the CPU the plain version."""
    count = math.prod(shape)
    if torch.device(device).type == "cpu":
        return random_u32_plain(key, shape, device)
    words = _philox_fill(-(-count // 4), *U32_STREAM, key, device)
    random_u32.launches += 1
    return words.reshape(-1)[:count].reshape(shape)


random_u32.launches = 0


def uniform_indices(key: Tuple[int, int], shape, mask, device="cuda"):
    """Uniform int32 indices in [0, mask] for power-of-two masks + 1 below
    2^31: the words of ``random_u32`` masked (ofdm_tpu.ops.prng.uniform_indices).
    ``mask`` is an int, or a row over the last axis: each subcarrier's own
    mask under adaptive loading (``adaptive.index_mask``, 0 on inactive
    subcarriers)."""
    m = np.asarray(mask, np.int64)
    if m.size == 0 or int(m.min()) < 0 or int(m.max()) >= 1 << 31:
        raise ValueError(f"mask must be in [0, 2^31), got {mask}")
    words = random_u32(key, shape, device)
    if m.ndim == 0:
        return words & int(m)
    return words & torch.as_tensor(m.astype(np.int32), device=words.device)


# Last counter words of the eager chain's streams: its time-domain AWGN and
# the noise-bump sampler's post-EQ noise.
AWGN_STREAM = 4
BUMP_STREAM = 5
_TWO_PI = float(np.float32(2.0 * np.pi))


def _plane_counters(sym0: int, rows: int, cols: int, device):
    b = torch.arange(sym0, sym0 + rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return b & M32, b >> 32, c


def _check_plane(sym0: int, rows: int, cols: int, c3: int):
    if rows < 1 or cols < 1 or not 0 <= sym0 < 1 << 64 or not 0 <= c3 <= M32 or rows * cols >= 1 << 62:
        raise ValueError(f"bad plane: sym0={sym0} rows={rows} cols={cols} c3={c3}")


def philox_plane_plain(key: Tuple[int, int], sym0: int, rows: int, cols: int, c3: int = 0, device="cpu"):
    """Plain version of ``philox_plane``: (rows, cols) int32 holding the uint32 bits."""
    _check_plane(sym0, rows, cols, c3)
    lo, hi, c = _plane_counters(sym0, rows, cols, device)
    w0, _, _, _ = philox4x32_10(lo, hi, c, torch.full((), c3, dtype=torch.int64, device=device), key)
    return (w0 - ((w0 >> 31) << 32)).to(torch.int32)


def _plane_launch(fn: str, outs, key, sym0, rows, cols, c3, device):
    """Launch one of boxmuller.cu's plane kernels into ``outs``."""
    from ofdm_tpu_torch import build

    lib = build.load("boxmuller")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(*(o.data_ptr() for o in outs), rows, cols, sym0, c3, key[0], key[1], stream)
    build.check(lib, code, fn)


def philox_plane(key: Tuple[int, int], sym0: int, rows: int, cols: int, c3: int = 0, device="cuda"):
    """Word 0 of Philox counters (b lo, b hi, c, c3) for rows b = sym0 ...
    sym0 + rows - 1 and columns c < cols, as (rows, cols) int32 holding the
    uint32 bits (K4's plane form).  At c3 = 0 these are the TX words of the
    chunk kernels (``link_words``' first plane).  On a CUDA device the
    ``ofdm_philox_plane`` kernel writes them (``philox_plane.launches``);
    on the CPU the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_plane_plain(key, sym0, rows, cols, c3, device)
    if device.type != "cuda":
        raise ValueError(f"philox_plane runs on cpu or cuda, not {device}")
    _check_plane(sym0, rows, cols, c3)
    out = torch.empty((rows, cols), dtype=torch.int32, device=device)
    _plane_launch("ofdm_philox_plane", (out,), key, sym0, rows, cols, c3, device)
    philox_plane.launches += 1
    return out


philox_plane.launches = 0


def normal_planes_plain(key: Tuple[int, int], sym0: int, rows: int, cols: int, c3: int, device="cpu"):
    """Plain version of ``normal_planes``, in torch f32."""
    _check_plane(sym0, rows, cols, c3)
    lo, hi, c = _plane_counters(sym0, rows, cols, device)
    _, w1, w2, _ = philox4x32_10(lo, hi, c, torch.full((), c3, dtype=torch.int64, device=device), key)
    inv = 1.0 / 16777216.0
    u1 = torch.clamp(((w1 >> 8) & 0xFFFFFF).to(torch.float32) * inv, min=inv)
    u2 = ((w2 >> 8) & 0xFFFFFF).to(torch.float32) * inv
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def normal_planes(key: Tuple[int, int], sym0: int, rows: int, cols: int, c3: int, device="cuda"):
    """Two N(0,1) f32 planes (z0, z1) of shape (rows, cols): element (r, c)
    from words 1 and 2 of Philox counter ((sym0 + r) lo, hi, c, c3) by
    ``ofdm_tpu.ops.prng._normal_kernel``'s Box-Muller: 24-bit u1 floored at
    2^-24, u2 from 24 bits, r = sqrt(-2 ln u1), theta = 2 pi u2, z0 = r cos
    theta, z1 = r sin theta.  On a CUDA device the ``ofdm_normal_pair``
    kernel (K5's port; ``normal_planes.launches``), on the CPU the plain
    version; the two agree within a few ulps of the library cos and sin."""
    device = torch.device(device)
    if device.type == "cpu":
        return normal_planes_plain(key, sym0, rows, cols, c3, device)
    if device.type != "cuda":
        raise ValueError(f"normal_planes runs on cpu or cuda, not {device}")
    _check_plane(sym0, rows, cols, c3)
    z0 = torch.empty((rows, cols), dtype=torch.float32, device=device)
    z1 = torch.empty_like(z0)
    _plane_launch("ofdm_normal_pair", (z0, z1), key, sym0, rows, cols, c3, device)
    normal_planes.launches += 1
    return z0, z1


normal_planes.launches = 0
