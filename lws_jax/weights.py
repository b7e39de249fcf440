"""LWS complex weight construction and stencil-tensor expansion.

`create_weights` reproduces the reference weight tensor W of shape
(Qprime, Q, L+1) (reference: python/lws.pyx:160-181), where row p carries the
phase ramp exp(+2i*pi*p*q/Qfloat) for bins with index p (mod Qprime).

`build_stencil` then expands W into the dense per-bin stencil tensor
Wst[dr+Q-1, dk+L, n] used by the device kernels: the phase update of bin (m, n) is

    temp(m, n) = sum_{dr, dk} Wst[dr, dk, n] * S(m+dr, n+dk)
    S(m, n)   <- temp(m, n) * |S0(m, n)| / |temp(m, n)|

on the Hermitian-extended spectrogram. This single tensor (plus causal masks
over dr, see core/stencil.py) subsumes all thirteen reference update kernels
(lwslib/lwslib.cpp:72-1421): the quadrant rules below are read off the general
LWSanyQ / LWSfractionalQ / NoFuture_LWSanyQ / Asym_UpdatePhaseanyQ code paths
(lwslib/lwslib.cpp:283-467, 620-764, 1129-1421), which are the semantic ground
truth (the reference's NoFuture_LWSQ4 specialization has an indexing bug and is
deliberately not reproduced).

Quadrant rules, with p+ = row(n), p- = row(-n), r in [1, Q), k in [1, L]:
    Wst[-r, -k'] = W[p+, r, k']        (k' in [0, L])
    Wst[+r, -k'] = conj(W[p+, r, k'])  (k' in [0, L])
    Wst[ 0, -k]  = W[p+, 0, k]
    Wst[ 0, +k]  = conj(W[p+, 0, k])
    Wst[+r, +k]  = W[p-, r, k]
    Wst[-r, +k]  = conj(W[p-, r, k])
    Wst[ 0,  0]  = 0                   (the self tap is never applied)

Weight pruning (w_flag in the reference, python/lws.pyx:231-232) becomes a
multiplicative mask applied to W before expansion: taps with |W| <= 1e-12 are
exactly zero, which reproduces the skip semantics bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from .windows import overlap_factor

__all__ = ["create_weights", "build_stencil", "W_PRUNE_THRESHOLD"]

# Reference prune threshold (python/lws.pyx:231).
W_PRUNE_THRESHOLD = 1.0e-12


def create_weights(
    awin: np.ndarray,
    swin: np.ndarray,
    fshift: int,
    L: int,
    use_summarized_weights: bool = True,
) -> np.ndarray:
    """Complex LWS weights, shape (Qprime, Q, L+1), complex128.

    Qprime == Q when fshift divides the window length and summarisation is on
    (each bin's weights depend only on n mod Q); otherwise Qprime == fsize and
    row p holds the exact per-bin phase ramp ("fractional Q").
    """
    awin = np.asarray(awin, dtype=np.float64)
    swin = np.asarray(swin, dtype=np.float64)
    T = len(awin)
    Q, Qfloat = overlap_factor(T, fshift)
    summarized = (T % fshift == 0) and use_summarized_weights
    Qprime = Q if summarized else T

    # windowprod[t, q] = awin[t] * swin[t + q*fshift] / T   (zero beyond overlap)
    windowprod = np.zeros((T, Q))
    for q in range(Q):
        nkeep = T - q * fshift
        windowprod[:nkeep, q] = awin[:nkeep] * swin[q * fshift:] / T

    ks = np.arange(L + 1)
    # DFT along t, truncated to the first L+1 frequency rows
    dft = np.exp(-2j * np.pi * np.outer(ks, np.arange(T)) / T)
    base = dft @ windowprod  # (L+1, Q)
    base = base * np.exp(-2j * np.pi * np.outer(ks, np.arange(Q)) / Qfloat)
    base[0, 0] -= 1.0  # subtract identity: the fixed point is S = sum of neighbours

    ramp = np.exp(2j * np.pi * np.outer(np.arange(Qprime), np.arange(Q)) / Qfloat)
    return np.einsum("kq,pq->pqk", base, ramp)


def build_stencil(W: np.ndarray, n_bins: int) -> np.ndarray:
    """Expand W (Qprime, Q, L+1) into Wst (2Q-1, 2L+1, n_bins) complex128.

    Row selection per true bin index n in [0, n_bins):
      p+ = n mod Qprime, p- = (Qprime - n) mod Qprime.
    For summarized weights (Qprime == Q) this matches the reference's
    (n % Q, (Q - n%Q) % Q) exactly (lwslib/lwslib.cpp:299-300). For fractional
    weights the reference uses rows n and N-n un-wrapped, which reads one row
    out of bounds at n == 0 (lwslib/lwslib.cpp:408; SURVEY.md 2.5.2) - here the
    index is taken modulo Qprime, which is the mathematically consistent ramp.
    """
    Qprime, Q, Lp1 = W.shape
    L = Lp1 - 1
    Wm = np.where(np.abs(W) > W_PRUNE_THRESHOLD, W, 0.0)

    n = np.arange(n_bins)
    p_pos = n % Qprime
    p_neg = (Qprime - n) % Qprime
    Wp = Wm[p_pos]  # (n_bins, Q, L+1)
    Wn = Wm[p_neg]  # (n_bins, Q, L+1)

    Wst = np.zeros((2 * Q - 1, 2 * L + 1, n_bins), dtype=np.complex128)
    c_r, c_k = Q - 1, L  # stencil centre
    for r in range(Q):
        for k in range(L + 1):
            if r == 0 and k == 0:
                continue
            if r == 0:
                # centre frame: -k direct, +k conjugate (lwslib.cpp:301-313)
                Wst[c_r, c_k - k] = Wp[:, 0, k]
                Wst[c_r, c_k + k] = np.conj(Wp[:, 0, k])
            elif k == 0:
                # same bin, frames m-r / m+r (lwslib.cpp:320-330)
                Wst[c_r - r, c_k] = Wp[:, r, 0]
                Wst[c_r + r, c_k] = np.conj(Wp[:, r, 0])
            else:
                # four quadrants (lwslib.cpp:331-353)
                Wst[c_r - r, c_k - k] = Wp[:, r, k]
                Wst[c_r + r, c_k - k] = np.conj(Wp[:, r, k])
                Wst[c_r + r, c_k + k] = Wn[:, r, k]
                Wst[c_r - r, c_k + k] = np.conj(Wn[:, r, k])
    return Wst
