"""Low-rank ISI factorization of the link's symbol -> frequency-bin map.

Host float64 numpy, the same computation as ``ofdm_tpu.ops.lowrank`` on
the port's own builders (``ops.linops``).  For OFDM the TX -> channel -> RX
composite is almost diagonal: a guard shorter than the channel breaks the
circular wrap only in the span of the block's last E = taps - 1 time
samples, so with F = tx_matrix (N, T) and TailM = F[:, T-E:] (N, E)

    y[b] = s[b] * D + t[b] @ Cr + t[b-1] @ Cp,     t[b] = s[b] @ TailM

where D (N,) is the circulant tap response and Cr, Cp (E, N) are the
own-tail and previous-tail corrections.  t[b] is the block's last E time
samples, the quantity a chunk carries to the next.

Zero prefix: the overlap-add sums two noisy time samples into each head
bin, so the frequency-domain noise has covariance sigma^2 (I + B B^H) with
B = S^H, S the L spill rows of the RX matrix; z = g1 + g2 @ B^H with iid
g1, g2 reproduces it exactly.  CP / no prefix keep iid bin noise.

``factor`` certifies the factorization by random probes of the full-chain
residual (and of the noise Gram for ZP) to 1e-9 of the matrix scale and
returns None when they fail; ``apply_reference`` is the float64 oracle of
the factored chain.  Only OFDM is ported: the JAX module's SC-FDE branch
(a dense solve against the DFT basis) serves no link the port routes to
the lr kernel, so both functions refuse SC-FDE.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ofdm_tpu_torch.config import ModulationType, PrefixType
from ofdm_tpu_torch.ops import linops

_RTOL = 1e-9  # residual gate, relative to the matrix scale


class LRFactors(NamedTuple):
    """Host complex128 factors of one link's signal and noise maps."""

    d: np.ndarray  # (N,) the near-circulant response
    tail: np.ndarray  # (N, E) TailM = F_tx[:, T-E:]
    cr: np.ndarray  # (E, N) own-tail correction rows
    cp: np.ndarray  # (E, N) previous-tail (ISI) correction rows
    bnoise: Optional[np.ndarray]  # (N, r) ZP noise factor B (None: iid noise)
    pw_scale: float  # measured-power estimator scale (n/T for ZP, 1 otherwise)
    E: int

    @property
    def n(self) -> int:
        return self.d.shape[0]

    @property
    def noise_rank(self) -> int:
        return 0 if self.bnoise is None else self.bnoise.shape[1]


def _ofdm_only(modulation: ModulationType) -> None:
    if modulation != ModulationType.OFDM:
        raise ValueError(f"the low-rank factorization is ported for OFDM only, not {modulation}")


def _probes_pass(seed: int, n: int, lhs_of, rhs_of) -> bool:
    """Two complex Gaussian probes v: |lhs(v) - rhs(v)| within the gate."""
    rng = np.random.default_rng(seed)
    for _ in range(2):
        v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        lhs = lhs_of(v)
        if np.abs(lhs - rhs_of(v)).max(initial=0.0) > _RTOL * max(1.0, np.abs(lhs).max(initial=0.0)):
            return False
    return True


def factor(
    taps: np.ndarray,
    n: int,
    prefix: PrefixType,
    L: int,
    modulation: ModulationType,
) -> Optional[LRFactors]:
    """Low-rank factors for one OFDM link, or None when the certification
    fails.  SC-FDE links run on the fold kernel and are refused here."""
    _ofdm_only(modulation)
    taps = np.asarray(taps, np.complex128)
    T = n + L
    E = linops.ext_width(len(taps), T)
    fr, fi = linops.tx_matrix(n, prefix, L, modulation)
    F = fr + 1j * fi  # (N, T)

    # CR = the (T, N) conv + RX part, so that g_intra = F @ CR; cp = the
    # merged conv's previous-tail rows times R, exact by construction.  Both
    # from the conv's band (linops.conv_matrices), never the dense (T+E, T)
    # conv matrix: O(K T N) host work at any width.
    rr, ri = linops.rx_matrix(n, prefix, L)
    R = rr + 1j * ri  # (T, N): guard removal (CP) or overlap-add (ZP), then the DFT
    # the conv's row i holds taps[k] at column i + k: row i of CR sums taps[k] * R[i + k]
    CR = np.zeros((T, n), np.complex128)
    for k in range(len(taps)):
        CR[: T - k] += taps[k] * R[k:]
    # tail row e (the previous block's sample T - E + e) holds taps[k] at
    # column e - E + k: row e of cp sums taps[k] * R[e - E + k]
    cp = np.zeros((E, n), np.complex128)
    for k in range(1, len(taps)):
        e0 = max(0, E - k)
        cp[e0:] += taps[k] * R[e0 - E + k : k]
    zp_R = R if prefix == PrefixType.ZERO else None

    # Per column j: G_intra[:, j] = D_j e_j + TailM @ Cr[:, j].  Project out
    # col(TailM) with a rank-aware orthonormal basis qt (ZP tails hold
    # zero-guard columns).
    tail = np.ascontiguousarray(F[:, T - E :]) if E else np.zeros((n, 0), np.complex128)
    if E:
        u, sv, vh = np.linalg.svd(tail, full_matrices=False)
        rk = sv > 1e-12 * max(sv.max(initial=0.0), 1.0)
        qt = u[:, rk]
    else:
        qt = np.zeros((n, 0), np.complex128)
        vh = np.zeros((0, 0), np.complex128)
        sv = np.zeros(0)
        rk = np.zeros(0, bool)
    # Only the diagonal and E-row projections of g_intra = F @ CR are
    # needed, so the (N, N) product is never formed (O(E N T)).
    diag_g = np.einsum("jt,tj->j", F, CR)
    if qt.shape[1]:
        qtH_g = (qt.conj().T @ F) @ CR  # (rank, N)
        diag_qq = np.einsum("je,ej->j", qt, qtH_g)
        denom = 1.0 - (np.abs(qt) ** 2).sum(axis=1)
    else:
        diag_qq = np.zeros(n, np.complex128)
        denom = np.ones(n)
    d = (diag_g - diag_qq) / denom
    if E and rk.any():
        # Cr = pinv(TailM) (g_intra - diag(d)), pinv from the truncated SVD
        pinv_t = (vh[rk].conj().T * (1.0 / sv[rk])[None, :]) @ qt.conj().T
        cr = (pinv_t @ F) @ CR - pinv_t * d[None, :]
    else:
        cr = np.zeros((E, n), np.complex128)
    if not _probes_pass(1, n, lambda v: F @ (CR @ v),
                        lambda v: d * v + (tail @ (cr @ v) if E else 0.0)):
        return None

    bnoise = None
    pw_scale = 1.0
    if zp_R is not None:
        # R = [DFT; S]: Gram = R^H R = I + S^H S exactly, so B = S^H; the
        # probes certify both the body's orthonormality and the factor.
        S = zp_R[n:]  # (L, N) spill rows
        bnoise = np.ascontiguousarray(S.conj().T) if S.shape[0] else None
        if not _probes_pass(0, n, lambda v: zp_R.conj().T @ (zp_R @ v),
                            lambda v: v + (bnoise @ (bnoise.conj().T @ v) if bnoise is not None else 0.0)):
            return None
        # the bin-mean power sees the n-sample overlap-added window; the
        # reference measures the T-sample time mean: equal up to n/T
        pw_scale = n / T
    return LRFactors(d=d, tail=tail, cr=cr, cp=cp, bnoise=bnoise, pw_scale=pw_scale, E=E)


def apply_reference(
    f: LRFactors,
    symbols: np.ndarray,
    prev_tail: np.ndarray,
    modulation: ModulationType,
) -> np.ndarray:
    """Float64 oracle: (B, N) symbols -> (B, N) unequalized bins (no noise).

    ``prev_tail`` is the (E,) time tail before row 0; row b's previous tail
    is row b-1's own tail.  OFDM only, as ``factor``."""
    _ofdm_only(modulation)
    s = np.asarray(symbols, np.complex128)
    t = s @ f.tail
    tp = np.concatenate([np.asarray(prev_tail, np.complex128)[None, :], t[:-1]], 0)
    return s * f.d[None, :] + t @ f.cr + tp @ f.cp
