"""Matrix form of the link's linear stages, built host-side in float64.

    x = X @ F_tx                 IDFT + guard insertion          (N -> T)
    y = x @ T0 + prev(x) @ T1    banded-Toeplitz stream conv     (T -> T)
    Y = y @ R                    guard removal + DFT             (T -> N)

with T = N + L.  The port uses these to check that a cyclic-prefix link is
exactly ``diag(h_freq)`` (so the diag kernel runs the elementwise chain),
to stage F_tx for the PAPR statistic, and for the fold kernel's two
products: F_tx,ext (TX with E duplicated tail columns) and the merged
conv + guard strip + DFT matrix.  Same builders, same float64 values as
``ofdm_tpu.ops.linops`` / ``ofdm_tpu.ops.dft`` / ``pallas_link._tx_ext_matrix``.

``modulate``, ``convolve`` and ``demodulate`` apply them to complex64
blocks, as the JAX package's functions of the same names do: the matrices
rounded to f32 from float64, each product one ``torch.matmul`` in complex64
(f32 arithmetic, no TF32), where the JAX package runs a bf16x3 split.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ofdm_tpu_torch.config import ModulationType, PrefixType


@lru_cache(maxsize=None)
def dft_matrix(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(real, imag) of the orthonormal (I)DFT matrix, F[k, j] = w^{kj}/sqrt(N).

    Layout is ``y = x @ F`` with x a row vector (F is symmetric)."""
    k = np.arange(n)
    sign = 2j if inverse else -2j
    F = np.exp(sign * np.pi * np.outer(k, k) / n) / np.sqrt(n)
    return np.ascontiguousarray(F.real), np.ascontiguousarray(F.imag)


@lru_cache(maxsize=None)
def tx_matrix(
    n: int, prefix: PrefixType, L: int, modulation: ModulationType
) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of F_tx (N, T): frequency symbols -> time block with guard.

    OFDM: orthonormal IDFT then CP prepend / ZP append.  SC-FDE: identity
    (symbols are already time domain) then guard.
    """
    if modulation == ModulationType.OFDM:
        fr, fi = dft_matrix(n, inverse=True)
        base = fr + 1j * fi
    else:
        base = np.eye(n, dtype=np.complex128)
    if L == 0 or prefix == PrefixType.NONE:
        out = base
    elif prefix == PrefixType.CYCLIC:
        out = np.concatenate([base[:, n - L :], base], axis=1)
    elif prefix == PrefixType.ZERO:
        out = np.concatenate([base, np.zeros((n, L), np.complex128)], axis=1)
    else:
        raise ValueError(prefix)
    return np.ascontiguousarray(out.real), np.ascontiguousarray(out.imag)


def conv_matrices(taps: np.ndarray, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(T0, T1) complex (T, T): intra-symbol and previous-symbol Toeplitz bands.

    T0[j, m] = h[m-j] (0 <= m-j < K) and T1[j, m] = h[T+m-j] (0 < T+m-j < K).
    """
    K = len(taps)
    T0 = np.zeros((T, T), np.complex128)
    T1 = np.zeros((T, T), np.complex128)
    for k in range(K):
        idx = np.arange(T - k)
        T0[idx, idx + k] = taps[k]
        if k >= 1:
            jdx = np.arange(T - k, T)
            T1[jdx, jdx + k - T] = taps[k]
    return T0, T1


def ext_width(num_taps: int, T: int) -> int:
    """Lanes of previous-symbol tail that reach into the current block."""
    return max(0, min(num_taps - 1, T))


def tx_ext_matrix(ftx: Tuple[np.ndarray, np.ndarray], E: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of F_tx,ext (N, T+E): F_tx with its last E columns repeated,
    so one product gives a block and the tail the next block's ISI reads."""
    fr, fi = ftx
    if not E:
        return fr, fi
    T = fr.shape[1]
    return (np.concatenate([fr, fr[:, T - E :]], axis=1),
            np.concatenate([fi, fi[:, T - E :]], axis=1))


def conv_matrix_merged(taps: np.ndarray, T: int) -> np.ndarray:
    """(T+E, T) complex C with y[b] = [x[b] | tail(x[b-1])] @ C."""
    E = ext_width(len(taps), T)
    T0, T1 = conv_matrices(taps, T)
    return np.concatenate([T0, T1[T - E :, :]], axis=0) if E else T0


@lru_cache(maxsize=None)
def rx_matrix(n: int, prefix: PrefixType, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of R (T, N): guard removal + orthonormal DFT.

    CP: drop the first L samples.  ZP: overlap-add the tail onto the head.
    """
    fr, fi = dft_matrix(n, inverse=False)
    F = fr + 1j * fi
    T = n + L
    R = np.zeros((T, n), np.complex128)
    if L == 0 or prefix == PrefixType.NONE:
        R[:, :] = F
    elif prefix == PrefixType.CYCLIC:
        R[L:, :] = F
    elif prefix == PrefixType.ZERO:
        R[:n, :] = F
        R[n:, :] = F[:L, :]
    else:
        raise ValueError(prefix)
    return np.ascontiguousarray(R.real), np.ascontiguousarray(R.imag)


def conv_rx_merged(taps: np.ndarray, n: int, prefix: PrefixType, L: int) -> np.ndarray:
    """(T+E, N) complex matrix folding the conv into guard strip + DFT.

    CP / no-prefix only: guard removal is a row selection and the DFT is
    unitary, so iid AWGN per frequency bin after this matrix is distributed
    exactly as AWGN per time sample before R.
    """
    if prefix == PrefixType.ZERO:
        raise ValueError("conv_rx_merged is defined for CP / no-prefix links only")
    T = n + L
    rr, ri = rx_matrix(n, prefix, L)
    return conv_matrix_merged(taps, T) @ (rr + 1j * ri)


# Widths up to which ``diag_response`` forms the dense (n, T) composite,
# which equals the JAX package's identity check bit for bit (its FFT form
# differs by ~1e-16).  Past it the composite costs minutes and tens of GB of
# host float64 (the 8K / 16K / 32K FFT modes): the closed form there.
DENSE_MAX_N = 4096


def diag_response(taps: np.ndarray, n: int, prefix: PrefixType, L: int) -> np.ndarray:
    """diag(F_tx @ C @ R) when the composite is diagonal, else ValueError.

    The ISI rows of the merged matrix must vanish (the CP covers the
    channel order); the returned diagonal is the per-bin response the
    elementwise chain multiplies by.  Past DENSE_MAX_N subcarriers the
    composite is not formed: a cyclic prefix covering the channel order (or
    a single tap without a zero prefix) makes it circulant, and the
    orthonormal DFT's diagonal of a circulant is the FFT of its taps.
    """
    if n > DENSE_MAX_N:
        K = len(taps)
        if prefix == PrefixType.ZERO:
            raise ValueError("conv_rx_merged is defined for CP / no-prefix links only")
        if K - 1 > (L if prefix == PrefixType.CYCLIC else 0):
            raise ValueError(f"link is not diagonal: {K} taps beyond a guard of {L}")
        return np.fft.fft(np.asarray(taps, np.complex128), n=n)
    T = n + L
    cmrx = conv_rx_merged(taps, n, prefix, L)
    if cmrx.shape[0] > T:
        tail = float(np.abs(cmrx[T:, :]).max())
        if tail >= 1e-12:
            raise ValueError(f"link is not diagonal: ISI rows reach {tail}")
    fr, fi = tx_matrix(n, prefix, L, ModulationType.OFDM)
    d = np.einsum("kt,tk->k", fr + 1j * fi, cmrx[:T, :])
    off = cmrx[:T, :].copy()
    full = (fr + 1j * fi) @ off
    full[np.diag_indices(n)] = 0.0
    if np.abs(full).max() >= 1e-12:
        raise ValueError("link is not diagonal: off-diagonal coupling")
    return d


@contextlib.contextmanager
def fp32_matmul():
    """f32 products in full precision inside the block: no TF32 on the card
    (ROADMAP §2: the port's products run in full f32); the caller's settings come
    back after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was[1])
        torch.backends.cuda.matmul.allow_tf32 = was[0]


def _matrix(mat, like: torch.Tensor) -> torch.Tensor:
    """A host matrix (complex, or its (re, im) pair) as complex64 on
    ``like``'s device; a tensor already there is taken as it is."""
    if isinstance(mat, tuple):
        mat = np.asarray(mat[0]) + 1j * np.asarray(mat[1])
    return torch.as_tensor(mat, dtype=torch.complex64, device=like.device)


def modulate(symbols: torch.Tensor, n: int, prefix: PrefixType, L: int,
             modulation: ModulationType) -> torch.Tensor:
    """(B, N) frequency / time symbols -> (B, T) guarded time blocks: X @ F_tx."""
    with fp32_matmul():
        return symbols @ _matrix(tx_matrix(n, prefix, L, modulation), symbols)


def convolve(blocks: torch.Tensor, t0, t1, carry_row: Optional[torch.Tensor] = None,
             ext: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stream convolution by the Toeplitz matrices of ``conv_matrices``:
    y[b] = x[b] @ T0 + x[b - 1] @ T1, x[-1] = ``carry_row`` (zeros when
    None).  Returns (out, last row), the carry of the next call.

    ``ext`` (``ext_width``, num_taps - 1) selects the banded form: ``t1`` is
    then the (E, T) band T1[T - E:, :], the previous block's last E samples,
    and the second product (B, E) @ (E, T); ``ext=0`` (a flat channel)
    drops the ISI term; ``ext=None`` keeps the dense (T, T) ``t1``."""
    T = blocks.shape[-1]
    if carry_row is None:
        carry_row = blocks.new_zeros((T,))
    with fp32_matmul():
        out = blocks @ _matrix(t0, blocks)
        if ext is None or ext > 0:
            prev = torch.cat([carry_row.to(blocks.dtype)[None, :], blocks[:-1]], dim=0)
            out = out + (prev if ext is None else prev[:, T - ext :]) @ _matrix(t1, blocks)
    return out, blocks[-1].clone()


def demodulate(y: torch.Tensor, n: int, prefix: PrefixType, L: int) -> torch.Tensor:
    """(B, T) received blocks -> (B, N) unequalized frequency symbols: y @ R."""
    with fp32_matmul():
        return y @ _matrix(rx_matrix(n, prefix, L), y)
