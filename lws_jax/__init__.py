"""lws_jax: GPU spectrogram phase recovery via Local Weighted Sums.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Jonathan-LeRoux/lws (fast phase recovery with batch, online/RTISI-LA and
no-future update schedules), built batch-first: one vectorized
visibility-masked stencil kernel replaces the reference's thirteen scalar C
update loops, analysis/synthesis is batched rfft/irfft, and utterance batches
/ long spectrograms shard over device meshes. On device, spectrograms are
split real/imag float planes; complex arrays appear only at the host
boundary.

Public surface mirrors the reference Python module (python/lws.pyx): the
`lws`/`LWS` processor class plus the free functions hann, synthwin, stft,
istft, get_consistency, create_weights, build_asymmetric_windows,
get_thresholds, batch_lws, nofuture_lws, online_lws.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .processor import LWS, lws
from .stft import (
    get_consistency,
    get_consistency_ri,
    istft,
    istft_ri,
    stft,
    stft_ri,
)
from .weights import W_PRUNE_THRESHOLD, build_stencil, create_weights
from .windows import (
    build_asymmetric_windows,
    default_window,
    get_thresholds,
    hann,
    overlap_factor,
    synthwin,
)
from .core.batch import lws_sweeps
from .core.online import rtisi_la
from .core.stencil import make_stencil, merge, split
from .mel import linear_to_mel, mel_filterbank, mel_to_linear, mel_vocoder_pipeline
from .io import read_wav, write_wav
from . import device
from .streaming import StreamingLWS
from .checkpoint import resumable_lws, save_checkpoint, load_checkpoint

__version__ = "0.1.0"

__all__ = [
    "LWS", "lws", "hann", "synthwin", "default_window", "build_asymmetric_windows",
    "get_thresholds", "overlap_factor", "create_weights", "build_stencil",
    "stft", "istft", "get_consistency", "stft_ri", "istft_ri", "get_consistency_ri",
    "batch_lws", "nofuture_lws", "online_lws", "extspec", "split", "merge",
    "StreamingLWS", "mel_filterbank", "linear_to_mel", "mel_to_linear",
    "mel_vocoder_pipeline", "read_wav", "write_wav",
    "resumable_lws", "save_checkpoint", "load_checkpoint",
]


def _stencil_from_W(W, n_bins, v, dtype):
    Q = W.shape[1]
    L = W.shape[2] - 1
    return make_stencil(build_stencil(np.asarray(W), n_bins), Q, L, v=v, dtype=dtype)


def _split_in(S):
    """Host complex array -> pair + real dtype (f64 in, f64 planes out)."""
    S = np.asarray(S)
    if S.shape[-1] % 2 == 0:
        raise ValueError("Please only include non-negative frequencies in the input spectrogram.")
    rdtype = jnp.float64 if S.dtype == np.complex128 else jnp.float32
    return split(S, dtype=rdtype), rdtype


def extspec(S, L, Q):
    """Hermitian/edge-replicated extended spectrogram (python/lws.pyx:146-157).

    Exposed for parity; the device kernels build their halos internally.
    """
    from .core.stencil import freq_extend, make_time_halos, time_extend
    (sr, si), _ = _split_in(S)
    er, ei = freq_extend(sr, si, L)
    top_r, bot_r = make_time_halos(er, Q)
    top_i, bot_i = make_time_halos(ei, Q)
    return merge(time_extend(er, top_r, bot_r), time_extend(ei, top_i, bot_i))


def batch_lws(S, W, thresholds, use_simplifications=True, order="gs"):
    """Batch-mode LWS phase reconstruction (mirrors python/lws.pyx:209-258).

    `W` is a (Qprime, Q, L+1) complex weight tensor from `create_weights`.
    `use_simplifications` is accepted for signature parity; the stencil
    expansion already encodes summarized vs fractional weights via Qprime.
    """
    del use_simplifications
    (pair, rdtype) = _split_in(S)
    thr = jnp.asarray(np.asarray(thresholds, dtype=np.float64), dtype=rdtype)
    if thr.shape[0] == 0:
        return merge(*pair)
    st = _stencil_from_W(W, pair[0].shape[-1], v=W.shape[1] - 1, dtype=rdtype)
    fn = jax.jit(lambda a, b, t: lws_sweeps(a, b, st=st, thresholds=t, order=order))
    return merge(*fn(*pair, thr))


def nofuture_lws(S, W, thresholds, use_simplifications=True, order="gs"):
    """No-future LWS initialisation pass (mirrors python/lws.pyx:261-311)."""
    del use_simplifications
    (pair, rdtype) = _split_in(S)
    thr = jnp.asarray(np.asarray(thresholds, dtype=np.float64), dtype=rdtype)
    if thr.shape[0] == 0:
        return merge(*pair)
    st = _stencil_from_W(W, pair[0].shape[-1], v=-1, dtype=rdtype)
    fn = jax.jit(lambda a, b, t: lws_sweeps(a, b, st=st, thresholds=t, order=order))
    return merge(*fn(*pair, thr))


def online_lws(S, W, W_ai, W_af, thresholds, LA, fshift=None, use_simplifications=True):
    """Online-mode LWS phase reconstruction (mirrors python/lws.pyx:314-375).

    `fshift` is accepted for signature parity: the reference only uses it for
    the dead `update_type==1` self-term (python/lws.pyx:339, 363).
    """
    del use_simplifications, fshift
    (pair, rdtype) = _split_in(S)
    thr = jnp.asarray(np.asarray(thresholds, dtype=np.float64), dtype=rdtype)
    if thr.shape[0] == 0:
        return merge(*pair)
    F = pair[0].shape[-1]
    Q = W.shape[1]
    st_ai = _stencil_from_W(W_ai, F, v=-1, dtype=rdtype)
    st_af = _stencil_from_W(W_af, F, v=0, dtype=rdtype)
    st_la = [_stencil_from_W(W, F, v=min(d, Q - 1), dtype=rdtype) for d in range(1, LA + 1)]
    fn = jax.jit(lambda a, b, t: rtisi_la(a, b, st_la=st_la, st_ai=st_ai, st_af=st_af, thresholds=t))
    return merge(*fn(*pair, thr))
