"""Batched STFT / iSTFT / consistency metric (device layer, JAX).

Batch-first redesign of the reference analysis-synthesis loop
(python/lws.pyx:43-144): instead of a Python loop of per-frame np.fft calls,
signals are framed with strided slice+reshape columns (no index tensors) and
transformed with a single batched jnp.fft.rfft / irfft over (..., M, fsize);
overlap-add is K shifted column sums (no scatter).
All functions accept arbitrary leading batch dimensions (the reference Python
binding is mono-only, python/lws.pyx:46-47; the MATLAB binding is
multi-channel, matlab/stft.m:27-29 - here batching is native).

Complex values exist only *inside* jit bodies: the `_ri` device functions take
and return split real/imag float pairs (the layout the sweep kernels use, so
no complex array crosses a jit boundary).
The public stft/istft/get_consistency wrappers keep the reference's
complex-array signatures by splitting/merging at the host boundary.

Frame-count and padding arithmetic is identical to the reference, including
the `perfectrec` pre/post padding so the signal starts on a frame boundary.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["stft", "istft", "get_consistency", "stft_ri", "istft_ri",
           "get_consistency_ri", "frame_signal"]


def _stft_layout(n_samples: int, fsize: int, fshift: int, perfectrec: bool):
    """Static padding/frame-count arithmetic (mirrors python/lws.pyx:54-77)."""
    if perfectrec:
        residual = fsize % fshift
        pre = fsize - fshift if residual == 0 else fsize - residual
        post = 0 if n_samples % fshift == 0 else fshift - n_samples % fshift
        padded = pre + n_samples + post
        M = padded // fshift
    else:
        pre = 0
        rem = (n_samples - fsize) % fshift
        post = 0 if rem == 0 else fshift - rem
        padded = n_samples + post
        M = (padded - fsize) // fshift + 1
    tail = (M - 1) * fshift + fsize - padded
    return pre, post + tail, M


def frame_signal(x: jnp.ndarray, fsize: int, fshift: int, M: int) -> jnp.ndarray:
    """(..., n) -> (..., M, fsize) frames at starts m*fshift.

    Built from ceil(fsize/fshift) strided slice+reshape columns instead of a
    gather: frame[m, k*fshift + r] == x[(m+k)*fshift + r], so column k is
    x[k*fshift : k*fshift + M*fshift] viewed as (M, fshift). No (M, fsize)
    index tensor exists anywhere — a gather formulation embeds one as a
    program constant, which scales O(M*fsize) and breaks long signals
    (a 10-minute 48 kHz STFT would carry a ~1 GB literal)."""
    K = -(-fsize // fshift)
    need = (M + K) * fshift
    pad = need - x.shape[-1]
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    lead = x.shape[:-1]
    cols = [
        x[..., k * fshift:(k + M) * fshift].reshape(lead + (M, fshift))
        for k in range(K)
    ]
    return jnp.concatenate(cols, axis=-1)[..., :fsize]


def overlap_add(frames: jnp.ndarray, fshift: int) -> jnp.ndarray:
    """(..., M, fsize) windowed frames -> (..., (M+K)*fshift) overlap-added
    signal, the inverse of frame_signal's slice+reshape layout: K shifted
    column sums, no scatter and no O(M*fsize) index constant. The true
    signal occupies the first fshift*(M-1) + fsize samples; the rest is
    zero slack (callers slice)."""
    M, fsize = frames.shape[-2], frames.shape[-1]
    K = -(-fsize // fshift)
    lead = frames.shape[:-2]
    fpad = jnp.pad(frames, [(0, 0)] * len(lead) + [(0, 0), (0, K * fshift - fsize)])
    signal = jnp.zeros(lead + ((M + K) * fshift,), dtype=frames.dtype)
    for k in range(K):
        seg = fpad[..., :, k * fshift:(k + 1) * fshift].reshape(lead + (M * fshift,))
        signal = signal.at[..., k * fshift:(k + M) * fshift].add(seg)
    return signal


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _stft_jit(x, awin, fsize, fshift, fftsize, perfectrec):
    n = x.shape[-1]
    pre, post, M = _stft_layout(n, fsize, fshift, perfectrec)
    pad = [(0, 0)] * (x.ndim - 1) + [(pre, post)]
    x = jnp.pad(x, pad)
    frames = frame_signal(x, fsize, fshift, M) * awin.astype(x.dtype)
    spec = jnp.fft.rfft(frames, n=fftsize, axis=-1)
    return jnp.real(spec), jnp.imag(spec)


def stft_ri(x, fsize, fshift, awin, fftsize=None, perfectrec=False,
            framepadding=False):
    """Batched STFT: (..., n) real -> split pair of (..., M, fftsize//2+1).

    `framepadding=True` zero-pads (Q-1)*fshift samples on BOTH sides before
    framing, so boundary samples receive full overlap-add coverage (the
    MATLAB binding's opts.framepadding, matlab/stft.m:43-46; independent of
    the perfectrec alignment padding)."""
    if fftsize is None:
        fftsize = fsize
    if fftsize % 2 == 1:
        raise ValueError("Odd ffts not supported.")
    x = jnp.asarray(x)
    if framepadding:
        Q = -(-int(fsize) // int(fshift))
        pad = (Q - 1) * int(fshift)
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    _, _, M = _stft_layout(x.shape[-1], int(fsize), int(fshift),
                           bool(perfectrec))
    if M > _LONGFORM_BLOCK:
        # multi-hour signals: the one-shot rfft's temporaries grow with M
        # (4 x 5.15 GB at M=337k); per-frame-independent chunks are exact
        return _stft_blocked(x, jnp.asarray(awin), int(fsize), int(fshift),
                             int(fftsize), bool(perfectrec))
    return _stft_jit(x, jnp.asarray(awin), int(fsize), int(fshift), int(fftsize),
                     bool(perfectrec))


def stft(x, fsize, fshift, awin, fftsize=None, perfectrec=False,
         framepadding=False) -> np.ndarray:
    """Batched STFT returning a host complex array (reference signature,
    python/lws.pyx:43-90; framepadding from matlab/stft.m:43-46)."""
    sr, si = stft_ri(x, fsize, fshift, awin, fftsize, perfectrec, framepadding)
    return np.asarray(sr) + 1j * np.asarray(si)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _istft_jit(sr, si, swin, fshift, fftsize, perfectrec):
    M, Nreal = sr.shape[-2], sr.shape[-1]
    fsize = 2 * (Nreal - 1)
    spec = sr + 1j * si  # complex lives only inside the jit body
    # flatten leading dims for the irfft: one rank-2 batched transform
    # over all frames. The reshape is exact and free.
    flat = spec.reshape((-1, spec.shape[-1]))
    frames = jnp.fft.irfft(flat, n=fftsize, axis=-1)
    frames = frames.reshape(spec.shape[:-1] + (fftsize,))[..., :fsize]
    frames = frames * swin[:fsize].astype(sr.dtype)

    T = fshift * (M - 1) + fsize
    signal = overlap_add(frames, fshift)[..., :T]

    if perfectrec:
        residual = fsize % fshift
        pre = fsize - fshift if residual == 0 else fsize - residual
        signal = signal[..., pre:(fshift - fsize)]
    return signal


def _prep_swin(swin, awin, fshift, fftsize):
    if awin is not None:
        # re-normalise for perfect reconstruction (python/lws.pyx:105-108)
        from .windows import synthwin
        swin = synthwin(np.asarray(awin), fshift, swin=np.asarray(swin))
    swin = np.asarray(swin)
    if fftsize > len(swin):
        swin = np.concatenate([swin, np.zeros(fftsize - len(swin))])
    return swin


def istft_ri(sr, si, fshift, swin, awin=None, fftsize=None, perfectrec=False):
    """Batched iSTFT from a split pair -> (..., n_samples) real device array."""
    sr = jnp.asarray(sr)
    Nreal = sr.shape[-1]
    if Nreal % 2 != 1:
        raise ValueError("Expected only non-negative frequencies in the spectrogram.")
    fsize = 2 * (Nreal - 1)
    if fftsize is None:
        fftsize = fsize
    swin = _prep_swin(swin, awin, fshift, fftsize)
    if sr.shape[-2] > _LONGFORM_BLOCK:
        # multi-hour spectrograms: bounded-memory OLA accumulation
        return _istft_blocked(sr, jnp.asarray(si), jnp.asarray(swin),
                              int(fshift), int(fftsize), bool(perfectrec))
    return _istft_jit(sr, jnp.asarray(si), jnp.asarray(swin), int(fshift),
                      int(fftsize), bool(perfectrec))


def istft(spec, fshift, swin, awin=None, fftsize=None, perfectrec=False):
    """Batched iSTFT from a complex array (reference signature,
    python/lws.pyx:93-137)."""
    spec = np.asarray(spec)
    return istft_ri(spec.real.copy(), spec.imag.copy(), fshift, swin, awin,
                    fftsize, perfectrec)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _consistency_jit(sr, si, awin, swin, fsize, fshift, fftsize, perfectrec):
    x = _istft_jit(sr, si, swin, fshift, fftsize, perfectrec)
    br, bi = _stft_jit(x, awin, fsize, fshift, fftsize, perfectrec)
    dr, di = br - sr, bi - si
    axes = (-2, -1)
    num = jnp.sum(sr * sr + si * si, axis=axes)
    den = jnp.sum(dr * dr + di * di, axis=axes)
    return 10.0 * (jnp.log10(num) - jnp.log10(den))


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _stft_chunk_jit(ys, awin, fsize, fshift, Mc, fftsize):
    frames = frame_signal(ys, fsize, fshift, Mc) * awin.astype(ys.dtype)
    spec = jnp.fft.rfft(frames, n=fftsize, axis=-1)
    return jnp.real(spec), jnp.imag(spec)


# the whole-spectrogram consistency round trip materialises (M, fftsize)
# frame matrices several times over; past this frame count the blocked path
# keeps peak memory bounded (a 1-hour 48 kHz / F=2049 spectrogram holds
# several 5 GB frame matrices at once in the one-shot path)
_CONSISTENCY_BLOCK = 16384
# stft/istft alone hold one frame matrix + FFT temps, not several, so they
# auto-block only past this frame count (a 2-hour 48 kHz analysis is
# M=337k, 4 x 5.15 GB of FFT temps)
_LONGFORM_BLOCK = 131072


def _istft_blocked(sr, si, swin, fshift, fftsize, perfectrec,
                   block=_CONSISTENCY_BLOCK):
    """Bounded-memory iSTFT: OLA is linear in the frames, so chunk-local
    overlap-adds accumulate into the signal — identical math to _istft_jit
    up to f32 addition order at the chunk seams."""
    M, Nreal = sr.shape[-2], sr.shape[-1]
    fsize = 2 * (Nreal - 1)
    T = fshift * (M - 1) + fsize
    y = jnp.zeros(sr.shape[:-2] + (T,), sr.dtype)
    for m0 in range(0, M, block):
        m1 = min(M, m0 + block)
        seg = _istft_jit(sr[..., m0:m1, :], si[..., m0:m1, :], swin,
                         fshift, fftsize, False)
        y = y.at[..., m0 * fshift:m0 * fshift + seg.shape[-1]].add(seg)
    if perfectrec:
        residual = fsize % fshift
        pre = fsize - fshift if residual == 0 else fsize - residual
        y = y[..., pre:(fshift - fsize)]
    return y


def _stft_blocked(x, awin, fsize, fshift, fftsize, perfectrec,
                  block=_CONSISTENCY_BLOCK):
    """Bounded-memory STFT: frames are independent, so chunks of the
    (padded) signal analyse separately and concatenate — bit-equal to
    _stft_jit per frame."""
    pre, post, M = _stft_layout(x.shape[-1], fsize, fshift, perfectrec)
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pre, post)])
    outs_r, outs_i = [], []
    for m0 in range(0, M, block):
        m1 = min(M, m0 + block)
        ys = x[..., m0 * fshift:(m1 - 1) * fshift + fsize]
        br, bi = _stft_chunk_jit(ys, awin, fsize, fshift, m1 - m0, fftsize)
        outs_r.append(br)
        outs_i.append(bi)
    if len(outs_r) == 1:
        return outs_r[0], outs_i[0]
    return (jnp.concatenate(outs_r, axis=-2),
            jnp.concatenate(outs_i, axis=-2))


def _consistency_blocked(sr, si, awin, swin, fsize, fshift, fftsize,
                         perfectrec, block=_CONSISTENCY_BLOCK):
    """Blocked evaluation of the consistency metric for very long
    spectrograms: OLA is linear in the frames, so the iSTFT accumulates
    chunk-local overlap-adds into the signal, and the re-analysis error
    norm accumulates per frame chunk — identical math to _consistency_jit
    (same windows, same layout; only f32 addition order at chunk seams
    differs)."""
    M = sr.shape[-2]
    y = _istft_blocked(sr, si, swin, fshift, fftsize, perfectrec,
                       block=block)
    pre2, post2, M2 = _stft_layout(y.shape[-1], fsize, fshift, perfectrec)
    y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(pre2, post2)])
    num = den = 0.0
    for m0 in range(0, min(M, M2), block):
        m1 = min(M, M2, m0 + block)
        ys = y[..., m0 * fshift:(m1 - 1) * fshift + fsize]
        br, bi = _stft_chunk_jit(ys, awin, fsize, fshift, m1 - m0, fftsize)
        src = sr[..., m0:m1, :]
        sic = si[..., m0:m1, :]
        dr, di = br - src, bi - sic
        num = num + jnp.sum(src * src + sic * sic, axis=(-2, -1))
        den = den + jnp.sum(dr * dr + di * di, axis=(-2, -1))
    return 10.0 * (jnp.log10(num) - jnp.log10(den))


def get_consistency_ri(sr, si, fsize, fshift, awin, swin, fftsize=None, perfectrec=False):
    """Consistency 20*log10(||S|| / ||STFT(iSTFT(S)) - S||) dB from a split pair.

    Batched: one dB value per leading batch element (python/lws.pyx:140-144).
    Spectrograms longer than ~16k frames evaluate in bounded-memory blocks
    (identical math; the one-shot round trip would materialise multi-GB
    frame matrices)."""
    if fftsize is None:
        fftsize = 2 * (jnp.asarray(sr).shape[-1] - 1)
    swin = _prep_swin(swin, None, fshift, fftsize)
    sr, si = jnp.asarray(sr), jnp.asarray(si)
    if sr.shape[-2] > _CONSISTENCY_BLOCK:
        return _consistency_blocked(sr, si, jnp.asarray(awin),
                                    jnp.asarray(swin), int(fsize),
                                    int(fshift), int(fftsize),
                                    bool(perfectrec))
    return _consistency_jit(sr, si, jnp.asarray(awin),
                            jnp.asarray(swin), int(fsize), int(fshift), int(fftsize),
                            bool(perfectrec))


def get_consistency(S, fsize, fshift, awin, swin, fftsize=None, perfectrec=False):
    """Consistency metric from a complex array (reference signature)."""
    S = np.asarray(S)
    return get_consistency_ri(S.real.copy(), S.imag.copy(), fsize, fshift, awin, swin,
                              fftsize, perfectrec)
