"""The LWS processor: public API mirroring the reference `lws` class.

Drop-in equivalent of python/lws.pyx:378-499 with the same constructor surface
(parameter names preserved) plus extensions: arbitrary leading batch
dimensions, dtype control (float32 planes by default, float64 under
jax_enable_x64 for oracle parity), sweep-order selection, and GPU kernels
for the frame-sequential sweeps (ops/gpu_sweeps.py).

All weight tensors are precomputed once at construction (host, float64) and
the three schedules run as jit-compiled device programs with no host
round-trips between iterations.

Device data convention: spectrograms are SPLIT real/imag float pairs
(sr, si) on device; complex arrays appear only at the host boundary. Every
phase-recovery method accepts either a complex array (returns a host complex
array, reference-compatible) or an (sr, si) pair (returns a pair, zero-copy
chaining for production pipelines).
"""
from __future__ import annotations

import functools
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from . import device
from . import stft as _stft
from .core.batch import lws_sweeps
from .core.online import rtisi_la
from .core.stencil import make_stencil, merge, split
from .ops.gpu_sweeps import (MAX_BINS, MAX_Q, gs_sweeps, kernel_supported,
                             online_sweeps, segmented_gs_sweeps)
from .weights import build_stencil, create_weights
from .windows import (
    build_asymmetric_windows,
    default_window,
    get_thresholds,
    overlap_factor,
    synthwin,
)

__all__ = ["LWS", "lws"]

JACOBI_MXU_WARNING = (
    "lws_jax: order='jacobi_mxu' at the backend-default matmul precision "
    "runs its banded matmuls in TF32 on the GPU, which floors achievable "
    "consistency on high-consistency material (a 3 s tone: 15.7 dB against "
    "32.0 dB at precision='highest', measured on an H100); pass "
    "precision='highest' for elementwise-Jacobi-exact results")


def _default_real_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class LWS:
    """Fast spectrogram phase recovery using Local Weighted Sums.

    Constructor signature mirrors the reference (python/lws.pyx:379-383);
    `mode='speech'` selects batch-only, `mode='music'` enables the no-future
    and online stages (python/lws.pyx:432-437).

    `backend` picks how the frame-sequential ("gs" order) sweeps run:
    "auto" runs the GPU kernels (ops/gpu_sweeps.py) on a GPU where they
    support the configuration and the XLA scan otherwise; "xla" always runs
    the XLA scan; "gpu" runs the GPU kernels or raises. `interpret=True`
    runs the GPU kernels in the Pallas interpreter (CPU tests only).
    """

    def __init__(
        self,
        awin_or_fsize,
        fshift,
        L=5,
        swin=None,
        look_ahead=3,
        nofuture_iterations=0,
        nofuture_alpha=1,
        nofuture_beta=0.1,
        nofuture_gamma=1,
        online_iterations=0,
        online_alpha=1,
        online_beta=0.1,
        online_gamma=1,
        batch_iterations=100,
        batch_alpha=100,
        batch_beta=0.1,
        batch_gamma=1,
        symmetric_win=True,
        mode=None,
        fftsize=None,
        perfectrec=True,
        use_simplifications=True,
        dtype=None,
        order="gs",
        precision=None,
        inner_passes=None,
        inner_scheme=None,
        backend="auto",
        interpret=False,
        auto_segment=True,
    ):
        if isinstance(awin_or_fsize, (int, np.integer)):
            awin = default_window(int(awin_or_fsize), fshift, symmetric=symmetric_win)
        else:
            awin = np.asarray(awin_or_fsize, dtype=np.float64)
            if awin.ndim > 1:
                if awin.ndim > 2 or (awin.shape[0] > 1 and awin.shape[1] > 1):
                    raise ValueError("The analysis window should be flat")
                awin = awin.flatten()

        if fftsize is None:
            fftsize = len(awin)
        if fftsize > len(awin):
            # symmetric zero-padding of the windows (python/lws.pyx:399-410);
            # boundary samples then fall outside the perfect-reconstruction region
            if (fftsize - len(awin)) % 2 != 0:
                raise ValueError("The zero-padding should add even length to the original window.")
            warnings.warn(
                "lws_jax: fftsize exceeds the window length; the windows are "
                "symmetrically zero-padded, so samples within fftsize/2 of "
                "the signal boundaries lose perfect reconstruction "
                "(reference behaviour, python/lws.pyx:403-406)")
            pad = np.zeros((fftsize - len(awin)) // 2)
            awin = np.concatenate([pad, awin, pad])
            if swin is not None:
                swin = np.concatenate([pad, np.asarray(swin, dtype=np.float64), pad])

        if use_simplifications and not np.allclose(awin, awin[::-1]):
            # the summarized-weight simplifications assume a symmetric
            # analysis window, awin[t] == awin[T-1-t] (python/lws.pyx:452-454)
            warnings.warn(
                "lws_jax: the analysis window is not symmetric, but "
                "use_simplifications=True assumes awin[t] == awin[T-1-t]; "
                "pass use_simplifications=False for exact weights")
        self.awin = awin
        self.swin = synthwin(awin, fshift, swin=swin)
        self.fshift = int(fshift)
        self.fsize = len(awin)
        self.fftsize = int(fftsize)
        self.perfectrec = perfectrec
        self.L = int(L)
        self.look_ahead = int(look_ahead)
        self.use_simplifications = use_simplifications
        self.order = order
        # matmul precision for order="jacobi_mxu" (None = backend default);
        # "highest" matches the elementwise Jacobi order exactly
        # (tests/test_mxu.py). Ignored by other orders.
        self.precision = precision
        if order == "jacobi_mxu" and precision is None:
            warnings.warn(JACOBI_MXU_WARNING)
        self._inner_passes_arg = inner_passes  # resolved after Q is known
        self.inner_scheme = inner_scheme  # resolved after Q is known
        if backend not in ("auto", "xla", "gpu"):
            raise ValueError(
                f"backend must be 'auto', 'xla' or 'gpu', got {backend!r}")
        self.backend = backend
        self.interpret = bool(interpret)
        self.auto_segment = bool(auto_segment)
        if dtype is not None and jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
            dtype = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 else jnp.float32
        self.rdtype = jnp.dtype(dtype) if dtype is not None else _default_real_dtype()

        Qint, Qfloat = overlap_factor(self.fsize, self.fshift)
        self.Q = Qint if self.fsize % self.fshift == 0 else Qfloat
        self._Qi = Qint
        if self.inner_scheme is None:
            # Low-overlap stencils (Q <= 3) are the order-sensitive cases
            # where in-frame Jacobi loses ~1 dB vs the reference's in-frame
            # raster Gauss-Seidel; red-black x3 rounds restores (and for Q=2
            # beats) the reference's information flow (QUALITY.md).
            self.inner_scheme = "color2x3" if Qint <= 3 else "jacobi"
        # in-frame passes: explicit value applies to every stage (legacy
        # behaviour); the default resolves per stage. Bench-scale anchoring
        # vs the float64 oracle (QUALITY.md) showed plain in-frame Jacobi
        # losing up to 1.6 dB to the reference's in-frame raster order at
        # Q=4 on long (T~600+) spectrograms — three same-frame re-passes
        # close the gap and beat the reference by ~2 dB mean at ~10-15%
        # cost, so they are the batch-stage default for jacobi-scheme
        # configs. Q=8 measures no gap (cross-frame taps dominate), and the
        # color schemes already carry their own in-frame flow.
        self.inner_passes = (1 if self._inner_passes_arg is None
                             else int(self._inner_passes_arg))
        if self._inner_passes_arg is None and self.inner_scheme == "jacobi" \
                and 4 <= Qint <= 7:
            self.batch_inner_passes = 3
        else:
            self.batch_inner_passes = self.inner_passes

        if mode == "speech":
            nofuture_iterations = 0
            online_iterations = 0
        elif mode == "music":
            nofuture_iterations = 1
            online_iterations = 10

        self.batch_iterations = batch_iterations
        self.batch_alpha, self.batch_beta, self.batch_gamma = batch_alpha, batch_beta, batch_gamma
        self.online_iterations = online_iterations
        self.online_alpha, self.online_beta, self.online_gamma = online_alpha, online_beta, online_gamma
        self.nofuture_iterations = nofuture_iterations
        self.nofuture_alpha, self.nofuture_beta, self.nofuture_gamma = (
            nofuture_alpha, nofuture_beta, nofuture_gamma)

        # weight tensors (host, float64), reference-identical layout
        self.W = create_weights(self.awin, self.swin, self.fshift, self.L, use_simplifications)
        self.win_ai, self.win_af = build_asymmetric_windows(self.awin * self.swin, self.fshift)
        self.W_ai = create_weights(self.win_ai, self.swin, self.fshift, self.L, use_simplifications)
        self.W_af = create_weights(self.win_af, self.swin, self.fshift, self.L, use_simplifications)

        # expanded stencil tensors (device) for every visibility the pipeline needs
        nreal = self.fftsize // 2 + 1
        Q = self._Qi
        wst = build_stencil(self.W, nreal)
        wst_ai = build_stencil(self.W_ai, nreal)
        wst_af = build_stencil(self.W_af, nreal)
        self._st_batch = make_stencil(wst, Q, self.L, v=Q - 1, dtype=self.rdtype)
        self._st_nofuture = make_stencil(wst_ai, Q, self.L, v=-1, dtype=self.rdtype)
        self._st_af = make_stencil(wst_af, Q, self.L, v=0, dtype=self.rdtype)
        self._st_la = [
            make_stencil(wst, Q, self.L, v=min(d, Q - 1), dtype=self.rdtype)
            for d in range(1, self.look_ahead + 1)
        ]

        self._batch_xla = jax.jit(functools.partial(
            lws_sweeps, st=self._st_batch, order=self.order,
            inner_passes=self.batch_inner_passes,
            inner_scheme=self.inner_scheme, precision=self.precision))
        self._nofuture_xla = jax.jit(
            functools.partial(lws_sweeps, st=self._st_nofuture,
                              order=self.order, precision=self.precision))
        self._online_xla = jax.jit(functools.partial(
            rtisi_la, st_la=self._st_la, st_ai=self._st_nofuture, st_af=self._st_af,
            inner_passes=self.inner_passes, inner_scheme=self.inner_scheme))
        kern = dict(inner_scheme=self.inner_scheme, interpret=self.interpret)
        self._batch_gpu = jax.jit(functools.partial(
            gs_sweeps, st=self._st_batch,
            inner_passes=self.batch_inner_passes, **kern))
        self._nofuture_gpu = jax.jit(functools.partial(
            gs_sweeps, st=self._st_nofuture, interpret=self.interpret))
        self._batch_seg = jax.jit(functools.partial(
            segmented_gs_sweeps, st=self._st_batch,
            inner_passes=self.batch_inner_passes, **kern),
            static_argnames=("segments", "sweeps_per_exchange"))
        self._nofuture_seg = jax.jit(functools.partial(
            segmented_gs_sweeps, st=self._st_nofuture,
            interpret=self.interpret),
            static_argnames=("segments", "sweeps_per_exchange"))
        self._online_gpu = jax.jit(functools.partial(
            online_sweeps, st_la=self._st_la, st_ai=self._st_nofuture,
            st_af=self._st_af, inner_passes=self.inner_passes, **kern))

    def _use_kernel(self, F):
        """The one dispatch rule for every sweep stage: whether this call
        runs the GPU kernels (ops/gpu_sweeps.py) or the XLA scan.

        The kernels run the "gs" order on float32 planes, for rows up to
        gpu_sweeps.MAX_BINS bins and Q up to gpu_sweeps.MAX_Q; any other
        configuration takes the XLA path. backend="xla" always takes the XLA
        path; backend="gpu" takes the kernels or raises."""
        if self.backend == "xla":
            return False
        fits = (self.order == "gs" and self.rdtype == jnp.float32
                and kernel_supported(F, self._Qi))
        on_gpu = self.interpret or device.gpu_available()
        if self.backend == "gpu":
            if not on_gpu:
                raise RuntimeError(
                    "backend='gpu' needs a GPU; JAX found "
                    f"{device.platform()!r}")
            if not fits:
                raise ValueError(
                    "backend='gpu': the GPU kernels run order='gs' on "
                    f"float32 planes with F <= {MAX_BINS} and Q <= {MAX_Q} "
                    f"(got order={self.order!r}, dtype={self.rdtype}, F={F}, "
                    f"Q={self._Qi})")
        return fits and on_gpu

    def _auto_segments(self, B, T):
        """Time segments for long, small-batch workloads on the kernel path.

        One program walks one utterance's frames, so a batch of a few long
        spectrograms keeps a few SMs busy. Splitting time into S segments
        that run as separate programs, with a halo exchange every 10
        sweeps, runs S times as many at quality parity (segmented_gs_sweeps).
        The batch is topped up to _SEG_PROGRAMS programs, at most
        _MAX_SEGMENTS segments per utterance, each segment >= 2048 frames;
        ordinary workloads keep the exact unsegmented order."""
        if not self.auto_segment:
            return 1
        free = self._SEG_PROGRAMS // max(1, B)
        if free < 2:
            return 1
        return max(1, min(free, self._MAX_SEGMENTS, T // 2048))

    _SEG_PROGRAMS = 32
    _MAX_SEGMENTS = 8

    # macro time-chunking: past _MACRO_T frames the sweeps run in chunks of
    # about _MACRO_CHUNK frames, each with its REAL neighbour frames as
    # frozen halos and the whole signal's threshold scale, so a seam behaves
    # exactly like a segmented-kernel seam with zero exchanges
    # (quality-equivalent; gated on auto_segment). The chunk bounds the
    # device memory one launch's slab preparation needs at any signal length
    # (a 2-hour 48 kHz signal at F=2049 is T=337k frames).
    _MACRO_T = 150_000
    _MACRO_CHUNK = 60_000

    def _macro_sweeps(self, sr, si, thresholds, gpu, seg, xla):
        """Sequential macro-chunked sweeps for arbitrarily long T."""
        shape = sr.shape
        if sr.ndim == 2:
            sr, si = sr[None], si[None]
        elif sr.ndim > 3:
            sr = sr.reshape((-1,) + shape[-2:])
            si = si.reshape((-1,) + shape[-2:])
        B, T, F = sr.shape
        Q1 = self._Qi - 1
        n = -(-T // self._MACRO_CHUNK)
        bounds = [round(i * T / n) for i in range(n + 1)]
        mean = jnp.mean(jnp.sqrt(sr * sr + si * si), axis=(-2, -1))

        def edge_rows(x, lo, hi, edge):
            # rows [lo, hi) clamped to [0, T), padded with the edge-frame
            # replica where they fall outside (reference edge semantics)
            part = x[:, max(lo, 0):min(hi, T)]
            miss = (hi - lo) - part.shape[1]
            if miss:
                pad = jnp.tile(x[:, edge:edge + 1], (1, miss, 1))
                part = (jnp.concatenate([pad, part], axis=1) if lo < 0
                        else jnp.concatenate([part, pad], axis=1))
            return part

        outs_r, outs_i = [], []
        for i in range(n):
            a, b = bounds[i], bounds[i + 1]
            halo = (edge_rows(sr, a - Q1, a, 0), edge_rows(si, a - Q1, a, 0),
                    edge_rows(sr, b, b + Q1, T - 1),
                    edge_rows(si, b, b + Q1, T - 1))
            o_r, o_i = self._sweep_fn(sr[:, a:b], si[:, a:b], thresholds,
                                      gpu, seg, xla, halo=halo,
                                      mean_amp=mean)
            outs_r.append(o_r)
            outs_i.append(o_i)
        osr = jnp.concatenate(outs_r, axis=1)
        osi = jnp.concatenate(outs_i, axis=1)
        return osr.reshape(shape), osi.reshape(shape)

    def _sweep_fn(self, sr, si, thresholds, gpu, seg, xla, halo=None,
                  mean_amp=None):
        """Shared batch/no-future dispatch: the GPU kernel (segmented when
        _auto_segments splits a long small batch) where _use_kernel says so,
        the XLA scan otherwise. T past _MACRO_T takes the macro-chunked
        path (bounded device memory at any length)."""
        if (halo is None and self.auto_segment
                and sr.shape[-2] > self._MACRO_T):
            # any path: the XLA sweeps honour the frozen-halo/mean contract
            # too (core/batch.lws_sweeps)
            return self._macro_sweeps(sr, si, thresholds, gpu, seg, xla)
        extra = {}
        if halo is not None:
            extra["halo"] = halo
        if mean_amp is not None:
            extra["mean_amp"] = mean_amp
        if not self._use_kernel(sr.shape[-1]):
            return xla(sr, si, thresholds=thresholds, **extra)
        B = int(np.prod(sr.shape[:-2]))
        S = self._auto_segments(B, sr.shape[-2])
        if S > 1:
            # 10 sweeps per halo exchange: quality-equivalent to per-sweep
            # exchange on the long-form config (QUALITY.md)
            return seg(sr, si, thresholds=thresholds, segments=S,
                       sweeps_per_exchange=10, **extra)
        return gpu(sr, si, thresholds=thresholds, **extra)

    def _batch_fn(self, sr, si, thresholds):
        return self._sweep_fn(sr, si, thresholds, self._batch_gpu,
                              self._batch_seg, self._batch_xla)

    def _nofuture_fn(self, sr, si, thresholds):
        return self._sweep_fn(sr, si, thresholds, self._nofuture_gpu,
                              self._nofuture_seg, self._nofuture_xla)

    def _online_fn(self, sr, si, thresholds):
        if self._use_kernel(sr.shape[-1]):
            return self._online_gpu(sr, si, thresholds=thresholds)
        return self._online_xla(sr, si, thresholds=thresholds)

    # ---------------- analysis / synthesis ----------------

    def stft(self, x, framepadding=False):
        """STFT -> host complex array (reference-compatible; framepadding
        mirrors matlab/stft.m:43-46)."""
        return _stft.stft(x, self.fsize, self.fshift, self.awin,
                          fftsize=self.fftsize, perfectrec=self.perfectrec,
                          framepadding=framepadding)

    def stft_ri(self, x, framepadding=False):
        """STFT -> (sr, si) device pair (zero-copy pipeline path)."""
        return _stft.stft_ri(x, self.fsize, self.fshift, self.awin,
                             fftsize=self.fftsize, perfectrec=self.perfectrec,
                             framepadding=framepadding)

    def istft(self, S):
        # swin is already normalised for perfect reconstruction at construction
        sr, si = self._as_pair(S)
        return _stft.istft_ri(sr, si, self.fshift, self.swin,
                              fftsize=self.fftsize, perfectrec=self.perfectrec)

    def get_consistency(self, S):
        sr, si = self._as_pair(S)
        return _stft.get_consistency_ri(sr, si, self.fsize, self.fshift,
                                        self.awin, self.swin,
                                        fftsize=self.fftsize, perfectrec=self.perfectrec)

    # ---------------- phase recovery schedules ----------------

    def _as_pair(self, S):
        if self._is_pair(S):
            pair = (jnp.asarray(S[0], dtype=self.rdtype),
                    jnp.asarray(S[1], dtype=self.rdtype))
        else:
            pair = split(np.asarray(S), dtype=self.rdtype)
        if pair[0].shape[-1] % 2 == 0:
            raise ValueError(
                "Please only include non-negative frequencies in the input spectrogram.")
        return pair

    @staticmethod
    def _is_pair(S):
        return isinstance(S, (tuple, list)) and len(S) == 2

    def _ret(self, pair, was_pair):
        return pair if was_pair else merge(*pair)

    def _thr(self, iterations, alpha, beta, gamma, thresholds):
        if thresholds is None:
            thresholds = get_thresholds(iterations, alpha, beta, gamma)
        return jnp.asarray(np.asarray(thresholds, dtype=np.float64), dtype=self.rdtype)

    def nofuture_lws(self, S, iterations=None, thresholds=None):
        """No-future initialisation pass (strictly-past stencil, W_ai weights)."""
        if iterations is None:
            iterations = self.nofuture_iterations
        thr = self._thr(iterations, self.nofuture_alpha, self.nofuture_beta,
                        self.nofuture_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0]:
            pair = self._nofuture_fn(*pair, thresholds=thr)
        return self._ret(pair, was_pair)

    def online_lws(self, S, iterations=None, thresholds=None):
        """Online (TF-RTISI-LA) sliding-commit pass."""
        if iterations is None:
            iterations = self.online_iterations
        thr = self._thr(iterations, self.online_alpha, self.online_beta,
                        self.online_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0]:
            pair = self._online_fn(*pair, thresholds=thr)
        return self._ret(pair, was_pair)

    def batch_lws(self, S, iterations=None, thresholds=None, mesh=None,
                  kernel=None, sweeps_per_exchange=1):
        """Full batch LWS sweeps.

        With `mesh` (a ('data','time') jax Mesh), long spectrograms run
        time-sharded with per-round halo exchange - the long-form multi-card
        path (see lws_jax.parallel). `kernel` picks the per-shard sweep
        implementation: None (default) takes the GPU kernel where
        `_use_kernel` does and the XLA scan otherwise; "gpu"/"xla" force
        one.
        `sweeps_per_exchange` trades halo traffic for cross-shard staleness.
        """
        if iterations is None:
            iterations = self.batch_iterations
        thr = self._thr(iterations, self.batch_alpha, self.batch_beta,
                        self.batch_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0]:
            if mesh is not None:
                from .parallel import shard_pair, sharded_lws_sweeps
                pair = shard_pair(pair, mesh, time_sharded=True)
                if kernel is None:
                    kernel = ("gpu" if self._use_kernel(pair[0].shape[-1])
                              else "xla")
                if kernel == "gpu" and not (self.interpret
                                            or device.gpu_available()):
                    raise RuntimeError(
                        "kernel='gpu' needs a GPU; JAX found "
                        f"{device.platform()!r}")
                pair = sharded_lws_sweeps(
                    *pair, st=self._st_batch, thresholds=thr, mesh=mesh,
                    order=self.order,
                    inner_passes=self.batch_inner_passes,
                    inner_scheme=self.inner_scheme, kernel=kernel,
                    sweeps_per_exchange=int(sweeps_per_exchange),
                    interpret=self.interpret)
            else:
                pair = self._batch_fn(*pair, thresholds=thr)
        return self._ret(pair, was_pair)

    def run_lws(self, S):
        """The 3-stage pipeline: no-future -> online -> batch (python/lws.pyx:495-499).

        Stays on device between stages (the reference re-extends and
        re-extracts the spectrogram around every stage,
        python/lws.pyx:256/288/355; here the split pair never leaves the
        device).
        """
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        pair = self.nofuture_lws(pair)
        pair = self.online_lws(pair)
        pair = self.batch_lws(pair)
        return self._ret(pair, was_pair)


# lowercase alias for drop-in compatibility with `lws.lws(...)`
lws = LWS
