"""Mel filterbanks and mel -> linear inversion for vocoder post-processing.

Supports the "Tacotron-style magnitude spectrogram -> linear spectrogram ->
LWS phase recovery -> waveform" pipeline (BASELINE.json config 4). The
reference library has no mel support; this is an extension: the filterbank
is a dense (n_mels, n_bins) matrix so both projections are single matmuls,
batched over utterances.
"""
from __future__ import annotations

import hashlib

import numpy as np

import jax.numpy as jnp

__all__ = ["mel_filterbank", "linear_to_mel", "mel_to_linear", "mel_vocoder_pipeline"]


def _hz_to_mel(f, htk=False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above
    f_sp = 200.0 / 3
    brk = 1000.0
    mel = f / f_sp
    log_step = np.log(6.4) / 27.0
    above = f >= brk
    mel = np.where(above, brk / f_sp + np.log(np.maximum(f, brk) / brk) / log_step, mel)
    return mel


def _mel_to_hz(m, htk=False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    brk_mel = 1000.0 / f_sp
    log_step = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= brk_mel
    return np.where(above, 1000.0 * np.exp(log_step * (m - brk_mel)), f)


def mel_filterbank(
    n_mels: int,
    fftsize: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, fftsize//2 + 1), float64."""
    if fmax is None:
        fmax = sample_rate / 2
    n_bins = fftsize // 2 + 1
    fft_freqs = np.arange(n_bins) * sample_rate / fftsize
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb


def linear_to_mel(spec_mag, fb) -> jnp.ndarray:
    """(..., T, n_bins) magnitudes -> (..., T, n_mels)."""
    spec_mag = jnp.asarray(spec_mag)
    fb = jnp.asarray(fb, dtype=spec_mag.dtype)
    return spec_mag @ fb.T


_PINV_CACHE: dict = {}


def mel_to_linear(mel_mag, fb, eps: float = 1e-10) -> jnp.ndarray:
    """Approximate inverse projection: (..., T, n_mels) -> (..., T, n_bins).

    Uses the Moore-Penrose pseudo-inverse of the filterbank with a
    non-negativity clamp - the standard Tacotron-style inversion before
    phase recovery. The pinv is computed once per filterbank (host SVD,
    float64, cached on the filterbank bytes) and applied as one batched
    matmul.
    """
    mel_mag = jnp.asarray(mel_mag)
    fb64 = np.ascontiguousarray(np.asarray(fb, dtype=np.float64))
    # key on a cryptographic digest of the contents: Python's 64-bit hash()
    # can collide for distinct same-shape filterbanks, which would silently
    # return the wrong pseudo-inverse
    key = (fb64.shape, hashlib.sha256(fb64.tobytes()).digest())
    inv = _PINV_CACHE.get(key)
    if inv is None:
        inv = np.linalg.pinv(fb64)  # (n_bins, n_mels)
        _PINV_CACHE[key] = inv
    proj = mel_mag @ jnp.asarray(inv.T, dtype=mel_mag.dtype)
    return jnp.maximum(proj, eps)


def mel_vocoder_pipeline(mel_mag, proc, fb=None, sample_rate=None, return_spec=False):
    """mel magnitudes -> linear magnitudes -> LWS phase recovery -> waveform.

    mel_mag: (..., T, n_mels); proc: an LWS processor whose fftsize matches
    the filterbank. Returns (..., n_samples) audio (or the recovered complex
    spectrogram pair with return_spec=True).
    """
    mel_mag = jnp.asarray(mel_mag)
    if fb is None:
        if sample_rate is None:
            raise ValueError("provide fb or sample_rate")
        fb = mel_filterbank(mel_mag.shape[-1], proc.fftsize, sample_rate)
    lin = mel_to_linear(mel_mag, fb).astype(proc.rdtype)
    pair = (lin, jnp.zeros_like(lin))
    pair = proc.run_lws(pair)
    if return_spec:
        return pair
    return proc.istft(pair)
