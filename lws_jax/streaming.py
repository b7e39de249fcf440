"""Streaming (real-time chunked) online LWS.

The reference's online mode (TF_RTISI_LA, lwslib.cpp:1424-1492) is an offline
function over a whole spectrogram even though the algorithm itself is a
sliding frame-commit pipeline. This module exposes the pipeline as a true
streaming processor: push raw audio chunks of any size, receive committed
audio back with a fixed latency of (look_ahead + 1) frames plus the
analysis/synthesis window overlap.

State per stream (all jnp, jit-stepped once per new frame):
  - sample ring: the last fsize-fshift input samples (framing overlap)
  - phase window: the last LA+Q frames of the evolving spectrogram, with
    frequency halos maintained exactly like the offline kernels (the update
    of frame m only ever reads frames <= m, so this window reproduces the
    offline lax.scan state exactly)
  - magnitude window: the fixed per-frame targets
  - OLA tail: fsize-fshift samples of synthesis overlap
  - running magnitude sum/count for the threshold scale (the offline code
    scales thresholds by the global mean input magnitude, python/lws.pyx:361;
    a stream cannot know the future, so the default is the running mean -
    pass mean_amp explicitly for bit-parity with the offline function)

With an explicit mean_amp, feeding a whole signal chunk-by-chunk produces the
same committed frames as proc.online_lws on the full spectrogram.
"""
from __future__ import annotations

import collections
import functools
import time

import numpy as np

import jax
import jax.numpy as jnp

from . import device
from .core.stencil import freq_extend, update_frame
from .stft import frame_signal, overlap_add

__all__ = ["StreamingLWS", "StreamStats"]


class StreamStats:
    """Serving observability: per-push latency and throughput of a stream.

    Recorded automatically by the push entry points (a perf_counter pair per
    call - negligible next to a device dispatch). The reference has no
    serving story to mirror; this plays the run_lws.m tic/toc role
    (matlab/run_lws.m:85-148) for the streaming path.
    """

    def __init__(self, window: int = 8192):
        self._walls = collections.deque(maxlen=window)
        self.pushes = 0
        self.frames = 0
        self.samples = 0
        self.wall = 0.0

    def reset(self):
        """Zero the counters (e.g. after compile warm-up, to report
        steady-state serving latency only)."""
        self.__init__(window=self._walls.maxlen)

    def record(self, wall: float, frames: int, samples: int):
        self._walls.append(wall)
        self.pushes += 1
        self.frames += int(frames)
        self.samples += int(samples)
        self.wall += wall

    def summary(self, sample_rate: float | None = None) -> dict:
        """p50/p95/p99 push latency (s), pushes, frames, emitted samples and,
        with a sample_rate, the aggregate realtime factor per stream."""
        w = np.asarray(self._walls, dtype=np.float64)
        out = dict(pushes=self.pushes, frames=self.frames,
                   samples=self.samples, wall_s=self.wall)
        if w.size:
            out.update(p50_s=float(np.percentile(w, 50)),
                       p95_s=float(np.percentile(w, 95)),
                       p99_s=float(np.percentile(w, 99)))
        if sample_rate and self.wall > 0:
            out["realtime_factor"] = self.samples / sample_rate / self.wall
        return out


class StreamingLWS:
    """Chunked real-time online LWS around an LWS processor's weight set.

    `streams > 1` runs that many independent streams in lockstep (batched on
    device - the vocoder-serving case): push()/push_frame() then take and
    return arrays with a leading streams dimension.
    """

    def __init__(self, proc, iterations=None, thresholds=None, mean_amp=None,
                 streams: int = 1, keep_frames: bool = False,
                 backend: str = "auto",
                 block_frames: int = 32, emit: str = "host",
                 prefetch: bool = True):
        self.streams = int(streams)
        # committed_frames retention is opt-in: a long-running stream would
        # otherwise accumulate every committed frame on the host without bound
        self.keep_frames = bool(keep_frames)
        from .windows import get_thresholds

        self.proc = proc
        if iterations is None:
            iterations = proc.online_iterations or 10
        if thresholds is None:
            thresholds = get_thresholds(iterations, proc.online_alpha,
                                        proc.online_beta, proc.online_gamma)
        self.thresholds = jnp.asarray(np.asarray(thresholds, np.float64), dtype=proc.rdtype)
        self.iters = int(len(thresholds))
        self.mean_amp = mean_amp

        Q, L, LA = proc._Qi, proc.L, proc.look_ahead
        self.Q, self.L, self.LA = Q, L, LA
        self.K = LA + Q  # LA+1 updatable frames + Q-1 committed context
        self.F = proc.fftsize // 2 + 1
        self.latency_frames = LA + 1

        # "gpu" runs the carried-state online kernel (one device dispatch
        # per chunk, ops/gpu_sweeps.online_chunk); "xla" is the per-frame
        # scan step (any dtype, the float64 test path). The kernel runs in
        # the Pallas interpreter when the processor's does (proc.interpret).
        if backend == "auto":
            backend = "gpu" if proc._use_kernel(self.F) else "xla"
        if backend not in ("gpu", "xla"):
            raise ValueError(
                f"backend must be 'auto', 'gpu' or 'xla', got {backend!r}")
        if backend == "gpu" and not (proc.interpret
                                     or device.gpu_available()):
            raise RuntimeError("backend='gpu' needs a GPU; JAX found "
                               f"{device.platform()!r}")
        self.backend = backend
        # gpu backend: push_block consumes frames in fixed-size groups so
        # every kernel dispatch reuses ONE compiled shape (a varying chunk
        # size would otherwise recompile the kernel per chunk); remainder
        # frames stay buffered until the next push or flush. block_frames=0
        # disables quantisation (per-chunk compile).
        self.block_frames = int(block_frames)
        # emit="device" (gpu backend) returns committed audio as device
        # arrays without forcing a host sync per chunk: dispatches pipeline
        # and the caller fetches (np.asarray) when convenient - the serving
        # mode when host<->device latency dominates
        self.emit = emit
        # prefetch (device emit only): start an async device->host copy of
        # each emitted audio block as soon as its dispatch is enqueued, so
        # the copy overlaps later blocks' compute and the caller's eventual
        # np.asarray finds the bytes already on host. One final consumer
        # sync instead of one host round-trip per block. Disable when the
        # consumer keeps the audio on device.
        self.prefetch = bool(prefetch)
        self._step_fn = self._make_step()
        self._step = jax.jit(self._step_fn)
        self._block_step = jax.jit(self._make_block_step())
        if self.backend == "gpu":
            # state buffers are donated: the old state is dead after each
            # call
            from_ri, from_samples = self._make_chunk_fns()
            self._chunk_fn = jax.jit(from_ri, donate_argnums=(2,))
            self._chunk_sample_fn = jax.jit(from_samples, donate_argnums=(1,))
        # cumulative across reset(): observability over a serving lifetime
        self.stats = StreamStats()
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        proc = self.proc
        self._win_r = None  # allocated lazily on the first frame
        self._win_i = None
        self._amp_w = None
        self._frames_seen = 0
        self._amp_sum = 0.0
        self._sample_buf = (np.zeros((self.streams, 0)) if self.streams > 1
                            else np.zeros(0))
        self._started = False
        tail_shape = ((self.streams, proc.fsize) if self.streams > 1
                      else (proc.fsize,))
        self._ola_tail = np.zeros(tail_shape)
        self._committed = 0
        self._pl_state = None  # gpu backend: carried kernel state
        self._frontier_tail = None  # unemitted OLA at the commit frontier
        self._live_seen = 0  # frames pushed live (drain steps excluded)
        self.committed_frames: list = []

    # ------------------------------------------------------------------
    def _make_step(self):
        proc = self.proc
        Q, L, LA, K, F = self.Q, self.L, self.LA, self.K, self.F
        st_ai = proc._st_nofuture
        st_af = proc._st_af
        st_la = proc._st_la
        iters = self.iters
        thr_sched = self.thresholds

        def step(win_r, win_i, amp_w, frame_r, frame_i, frame_amp, mean_amp,
                 m_abs, live):
            """Advance by one frame. Window rows 0..K-1 (axis -2) hold frames
            (newest at K-1); rows K.. are never-read dummy padding. Leading
            dims are batched streams. `live` False = drain step: the pipeline
            shifts and commits but no update runs (offline semantics stop at
            the last real frame)."""
            big = jnp.asarray(3.4e38, amp_w.dtype)
            # shift in the new frame (freq-extended)
            er, ei = freq_extend(frame_r[..., None, :], frame_i[..., None, :], L)
            ax = -2
            win_r = jnp.concatenate([win_r[..., 1:K, :], er, win_r[..., K:, :]], axis=ax)
            win_i = jnp.concatenate([win_i[..., 1:K, :], ei, win_i[..., K:, :]], axis=ax)
            amp_w = jnp.concatenate([amp_w[..., 1:K, :], frame_amp[..., None, :],
                                     amp_w[..., K:, :]], axis=ax)

            newest = K - 1  # window row of the newest frame
            # update_frame takes the "true" index m of an array whose frame m
            # sits at row m + Q - 1; our newest row index maps to:
            m_newest = newest - (Q - 1)

            # (1) asym-init from strictly-past frames, threshold 0
            thr0 = jnp.where(live, jnp.zeros((), amp_w.dtype), big)
            win_r, win_i = update_frame(win_r, win_i, m_newest,
                                        amp_w[..., newest, :], st_ai, thr0)

            def h_body(h, w):
                wr, wi = w
                thr = jnp.where(
                    live,
                    jax.lax.dynamic_index_in_dim(thr_sched, h, keepdims=False) * mean_amp,
                    big)
                for d in range(LA, 0, -1):
                    # frames before the stream start are frozen halo replicas
                    # (offline clamps lframe at 0, lwslib.cpp:1434-1439)
                    wr, wi = jax.lax.cond(
                        m_abs - d >= 0,
                        lambda ww, dd=d: update_frame(ww[0], ww[1], m_newest - dd,
                                                      amp_w[..., newest - dd, :],
                                                      st_la[dd - 1], thr),
                        lambda ww: ww,
                        (wr, wi),
                    )
                wr, wi = update_frame(wr, wi, m_newest, amp_w[..., newest, :],
                                      st_af, thr)
                return wr, wi

            win_r, win_i = jax.lax.fori_loop(0, iters, h_body, (win_r, win_i))

            # the frame leaving the look-ahead window is now final
            committed_row = newest - LA
            return win_r, win_i, amp_w, (win_r[..., committed_row, L:L + F],
                                         win_i[..., committed_row, L:L + F])

        return step

    # ------------------------------------------------------------------
    def _make_block_step(self):
        """Latency-tolerant chunked path: one device dispatch per chunk of N
        frames (lax.scan over the per-frame step) instead of one per 8 ms
        hop. Bit-identical state evolution to repeated push_frame calls."""
        step = self._step_fn
        batched = self.streams > 1

        def block(win_r, win_i, amp_w, fr_blk, fi_blk, amp_blk, live_blk,
                  amp_sum0, count0, m_abs0, mean_fixed, use_fixed):
            def body(carry, xs):
                w_r, w_i, a_w, amp_sum, count = carry
                i, fr, fi, amp, live = xs
                amp_sum = amp_sum + jnp.mean(amp, axis=-1)
                count = count + 1
                mean = jnp.where(use_fixed, mean_fixed, amp_sum / count)
                if batched:
                    mean = mean[..., None]
                w_r, w_i, a_w, (cr, ci) = step(
                    w_r, w_i, a_w, fr, fi, amp, mean, m_abs0 + i, live)
                return (w_r, w_i, a_w, amp_sum, count), (cr, ci)

            n = fr_blk.shape[0]
            idx = jnp.arange(n, dtype=jnp.int32)
            carry, (crs, cis) = jax.lax.scan(
                body, (win_r, win_i, amp_w, amp_sum0, count0),
                (idx, fr_blk, fi_blk, amp_blk, live_blk))
            return carry, crs, cis

        return block

    def _make_chunk_fns(self):
        """Build the gpu-backend device programs: a spectrogram-frame
        entry (vocoder-style frame pushers) and a raw-sample entry (framing +
        STFT + threshold-scale tracking all on device; the host only moves
        raw audio bytes). Both share one core: the carried-state online
        kernel + device-side iFFT/OLA emission."""
        from .ops.gpu_sweeps import online_chunk
        proc = self.proc
        fsize, fshift, fftsize = proc.fsize, proc.fshift, proc.fftsize
        swin = np.asarray(proc.swin)[:fsize]
        awin = np.asarray(proc.awin)
        fixed = (None if self.mean_amp is None else
                 np.broadcast_to(np.asarray(self.mean_amp, np.float64)
                                 .reshape(-1), (self.streams,)))

        def core(fr, fi, state, means, seen, n_live, skip, end):
            kstate, tail = state[:3], state[3]
            cr, ci, new_k = online_chunk(
                fr, fi, kstate, means, proc._st_la, proc._st_nofuture,
                proc._st_af, self.thresholds, seen, n_live=n_live,
                inner_passes=proc.inner_passes,
                inner_scheme=proc.inner_scheme, interpret=proc.interpret)
            # device-side iFFT + OLA emission (one small audio transfer per
            # chunk instead of two committed-plane transfers + host FFTs);
            # rows outside [skip, end) are pipeline-fill / flush-padding
            # garbage and are masked before they can pollute the overlap
            n = cr.shape[1]
            rows = jnp.arange(n)
            valid = ((rows >= skip) & (rows < end)).astype(cr.dtype)
            spec = (cr + 1j * ci) * valid[None, :, None]  # complex only in-jit
            frames = jnp.fft.irfft(spec, n=fftsize, axis=-1)[..., :fsize]
            frames = frames * jnp.asarray(swin, dtype=cr.dtype)
            ws = overlap_add(frames, fshift).at[:, :fsize].add(tail)
            audio = ws[:, :n * fshift]
            new_tail = ws[:, n * fshift:n * fshift + fsize]
            return audio, cr, ci, (*new_k, new_tail)

        def from_ri(fr, fi, state, seen, n_live, skip, end):
            # fr/fi: (S, n, F). The threshold scale (running mean input
            # magnitude, python/lws.pyx:361 adapted to a stream that cannot
            # see the future) is carried on device as (amp_sum, count).
            asum, cnt = state[4], state[5]
            n = fr.shape[1]
            fm = jnp.mean(jnp.sqrt(fr * fr + fi * fi), axis=-1)  # (S, n)
            if fixed is None:
                counts = (cnt + jnp.arange(1, n + 1, dtype=jnp.int32)).astype(fr.dtype)
                means = (asum[:, None] + jnp.cumsum(fm, axis=1)) / counts
            else:
                means = jnp.broadcast_to(
                    jnp.asarray(fixed, fr.dtype)[:, None], fm.shape)
            audio, cr, ci, st = core(fr, fi, state, means, seen, n_live,
                                     skip, end)
            return audio, cr, ci, (*st, asum + jnp.sum(fm, axis=1), cnt + n)

        def from_samples(x, state, seen, n_live, skip, end):
            # x: (S, (n-1)*fshift + fsize) raw samples
            n = (x.shape[-1] - (fsize - fshift)) // fshift
            frames = frame_signal(x, fsize, fshift, n)
            spec = jnp.fft.rfft(frames * jnp.asarray(awin, x.dtype),
                                n=fftsize, axis=-1)
            return from_ri(spec.real.astype(x.dtype), spec.imag.astype(x.dtype),
                           state, seen, n_live, skip, end)

        return from_ri, from_samples

    def _ensure_pl_state(self, fr0, fi0):
        """First-frame state: window replicas of the frequency-extended first
        frame (extspec edge semantics), zero OLA tail and mean totals."""
        from .ops.gpu_sweeps import online_chunk_init
        proc = self.proc
        S = self.streams
        tail = jnp.zeros((S, proc.fsize), dtype=proc.rdtype)
        asum = jnp.zeros((S,), dtype=proc.rdtype)
        cnt = jnp.zeros((), dtype=jnp.int32)
        self._pl_state = online_chunk_init(
            fr0, fi0, proc._st_la, proc._st_af) + (tail, asum, cnt)

    def _commit_range(self, n, n_live):
        """Valid rows of this call's committed slab: row m commits absolute
        frame frames_seen+m-LA, which must exist and have been pushed live
        (drain-padding rows past the flush tail commit dead frames)."""
        prev = self._frames_seen
        skip = max(0, self.LA - prev)
        end = min(n, self._live_seen + int(n_live) + self.LA - prev)
        return skip, end

    def _finish_advance(self, audio, cr, ci, n, n_live, skip, end):
        proc = self.proc
        S = self.streams
        self._frames_seen += n
        self._live_seen += int(n_live)
        if self.keep_frames and end > skip:
            com = np.asarray(cr) + 1j * np.asarray(ci)
            self.committed_frames.extend(
                com[:, i] if S > 1 else com[0, i] for i in range(skip, end))
        end = max(skip, end)
        # the unemitted overlap-add frontier: emission stops at end*fshift
        # but the last committed frames' contributions extend fsize-fshift
        # samples further. When end < n (flush padding the final block with
        # drain rows), that region lies inside `audio` beyond the emitted
        # slice rather than in the carried state tail (which is anchored at
        # n*fshift) — track it so flush() emits the true signal tail instead
        # of the state tail's zeros
        self._frontier_tail = jnp.concatenate(
            [audio[:, end * proc.fshift:], self._pl_state[3]],
            axis=-1)[:, :proc.fsize]
        a = audio[:, skip * proc.fshift:end * proc.fshift]
        if S == 1:
            a = a[0]
        return a if self.emit == "device" else np.asarray(a)

    def _advance_gpu(self, specs, n_live):
        """Advance the chunked kernel stream by the stacked spectrogram
        frames `specs` (n, [S,] F); frames >= n_live are drain steps. One
        kernel dispatch per call (spec pushers control their chunk shape)."""
        proc = self.proc
        specs = np.asarray(specs).astype(np.complex128)
        n = specs.shape[0]
        S = self.streams
        # streams-first (S, n, F) layout for the kernel
        sp = specs.transpose(1, 0, 2) if S > 1 else specs[:, None].transpose(1, 0, 2)
        fr = jnp.asarray(sp.real, dtype=proc.rdtype)
        fi = jnp.asarray(sp.imag, dtype=proc.rdtype)
        if self._pl_state is None:
            self._ensure_pl_state(fr[:, 0], fi[:, 0])
        skip, end = self._commit_range(n, n_live)
        audio, cr, ci, self._pl_state = self._chunk_fn(
            fr, fi, self._pl_state, np.int32(self._frames_seen),
            np.int32(n_live), np.int32(skip), np.int32(end))
        return self._finish_advance(audio, cr, ci, n, n_live, skip, end)

    def _advance_samples(self, xblk, n_frames, n_live):
        """Advance by a raw-sample window covering n_frames frames; the
        device program does framing, STFT and threshold tracking."""
        proc = self.proc
        S = self.streams
        xblk = np.reshape(np.asarray(xblk, np.float64), (S, -1))
        if self._pl_state is None:
            f0 = np.fft.rfft(xblk[:, :proc.fsize] * np.asarray(proc.awin),
                             n=proc.fftsize, axis=-1)
            self._ensure_pl_state(jnp.asarray(f0.real, dtype=proc.rdtype),
                                  jnp.asarray(f0.imag, dtype=proc.rdtype))
        skip, end = self._commit_range(n_frames, n_live)
        audio, cr, ci, self._pl_state = self._chunk_sample_fn(
            jnp.asarray(xblk, dtype=proc.rdtype), self._pl_state,
            np.int32(self._frames_seen), np.int32(n_live), np.int32(skip),
            np.int32(end))
        return self._finish_advance(audio, cr, ci, n_frames, n_live, skip, end)

    def _maybe_prefetch(self, a):
        """Device-emit serving: start the async device->host copy of the
        array the CALLER receives (after any internal per-block concat —
        prefetching intermediate slices that are then concatenated on
        device copies the wrong buffers and wins nothing, measured).
        np.asarray on it later finds the bytes already on host: one tail
        sync per collection instead of a host round-trip per block."""
        if (self.prefetch and self.emit == "device" and a.shape[-1]
                and hasattr(a, "copy_to_host_async")):
            a.copy_to_host_async()
        return a

    def _timed(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = self._maybe_prefetch(fn(*args, **kw))
        wall = time.perf_counter() - t0
        n = int(out.shape[-1])
        self.stats.record(wall, n // self.proc.fshift, n)
        return out

    def push_block(self, x) -> np.ndarray:
        """Feed an audio chunk; all contained frames run in ONE device
        dispatch per kernel block (see _push_block). Timed into .stats."""
        return self._timed(self._push_block, x)

    def push(self, x) -> np.ndarray:
        """Feed audio samples; returns newly committed audio (see _push).
        Timed into .stats."""
        return self._timed(self._push, x)

    def push_frame(self, spec, drain: bool = False) -> np.ndarray:
        """Feed one spectrogram frame (see _push_frame). Timed into .stats."""
        return self._timed(self._push_frame, spec, drain=drain)

    def push_frames(self, specs) -> np.ndarray:
        """Feed N stacked spectrogram frames (N, [S,] F) in ONE device
        dispatch - the vocoder-serving entry when the acoustic model emits
        frames in blocks (per-frame push_frame costs one dispatch round-trip
        per hop; this amortises it over the block). Timed into .stats."""
        specs = np.asarray(specs)
        return self._timed(self._push_frames, specs)

    def _push_block(self, x) -> np.ndarray:
        """Feed an audio chunk and process all contained frames in ONE device
        dispatch (scan over frames). Same semantics as push(); use this for
        throughput-oriented serving where chunk latency is acceptable.
        Chunks of the same frame count reuse the compiled step."""
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        x = np.asarray(x, dtype=np.float64)
        x = x.reshape(self.streams, -1) if self.streams > 1 else x.reshape(-1)
        self._sample_buf = np.concatenate([self._sample_buf, x], axis=-1)
        avail = self._sample_buf.shape[-1]
        n = max(0, (avail - fsize) // fshift + 1) if avail >= fsize else 0
        if self.backend == "gpu" and self.block_frames:
            # only consume whole kernel blocks; the remainder stays buffered
            n = (n // self.block_frames) * self.block_frames
        if n == 0:
            return np.zeros(self._sample_buf.shape[:-1] + (0,))
        if self.backend == "gpu":
            # hand raw sample windows to the device program block by block;
            # framing/STFT/thresholds all run on device
            view = (self._sample_buf if self.streams > 1
                    else self._sample_buf[None])
            nb = self.block_frames or n
            outs = []
            for i in range(0, n, nb):
                b = min(nb, n - i)
                w = view[:, i * fshift:i * fshift + (b - 1) * fshift + fsize]
                outs.append(self._advance_samples(w, b, b))
            self._sample_buf = self._sample_buf[..., n * fshift:]
            cat = jnp.concatenate if self.emit == "device" else np.concatenate
            return cat(outs, axis=-1)
        starts = fshift * np.arange(n)
        frames = np.stack([self._sample_buf[..., s:s + fsize] for s in starts])
        self._sample_buf = self._sample_buf[..., n * fshift:]
        specs = np.fft.rfft(frames * proc.awin, n=proc.fftsize, axis=-1)
        return self._push_frames(specs)

    def _push_frames(self, specs) -> np.ndarray:
        """Run N stacked spectrogram frames (N, [S,] F) through the pipeline
        in one dispatch; returns committed audio."""
        if self.backend == "gpu":
            return self._advance_gpu(specs, n_live=specs.shape[0])
        proc = self.proc
        specs = np.asarray(specs).astype(np.complex128)
        n = specs.shape[0]
        fr = jnp.asarray(specs.real, dtype=proc.rdtype)
        fi = jnp.asarray(specs.imag, dtype=proc.rdtype)
        amp = jnp.asarray(np.abs(specs), dtype=proc.rdtype)

        if self._win_r is None:
            e0r, e0i = freq_extend(fr[0][None, :], fi[0][None, :], self.L)
            if self.streams > 1:
                self._init_window(e0r.reshape(self.streams, -1),
                                  e0i.reshape(self.streams, -1), amp[0])
            else:
                self._init_window(e0r[0], e0i[0], amp[0])

        use_fixed = self.mean_amp is not None
        mean_fixed = np.asarray(self.mean_amp if use_fixed else 0.0, np.float64)
        if self.streams > 1:
            mean_fixed = np.broadcast_to(mean_fixed, (self.streams,))
        amp_sum0 = jnp.asarray(np.broadcast_to(
            np.asarray(self._amp_sum, np.float64),
            (self.streams,) if self.streams > 1 else ()), dtype=proc.rdtype)
        live = jnp.ones((n,), dtype=bool)

        (self._win_r, self._win_i, self._amp_w, amp_sum, _count), crs, cis = \
            self._block_step(
                self._win_r, self._win_i, self._amp_w, fr, fi, amp, live,
                amp_sum0, jnp.asarray(self._frames_seen, jnp.int32),
                jnp.asarray(self._frames_seen, jnp.int32),
                jnp.asarray(mean_fixed, dtype=proc.rdtype),
                jnp.asarray(use_fixed))

        prev_seen = self._frames_seen
        self._frames_seen += n
        self._amp_sum = np.asarray(amp_sum, np.float64)

        # commits are valid once the LA pipeline has filled
        skip = max(0, self.LA - prev_seen)
        if skip >= n:
            return np.zeros(self._sample_buf.shape[:-1] + (0,))
        committed = np.asarray(crs)[skip:] + 1j * np.asarray(cis)[skip:]
        if self.keep_frames:
            self.committed_frames.extend(list(committed))
        outs = [self._emit(c) for c in committed]
        return np.concatenate(outs, axis=-1)

    # ------------------------------------------------------------------
    def _init_window(self, er0, ei0, amp0):
        """Fill the window with replicas of the first frame (extspec edge
        semantics, lwslib.cpp:21-25) - left context rows = original frame 0.
        Shapes: er0/amp0 are (F',) single-stream or (S, F') batched; windows
        get the row axis at -2 so update_frame's (..., rows, F') layout holds."""
        rows = self.K + (self.Q - 1)
        reps = (rows, 1) if er0.ndim == 1 else (1, rows, 1)
        self._win_r = jnp.tile(er0[..., None, :], reps)
        self._win_i = jnp.tile(ei0[..., None, :], reps)
        self._amp_w = jnp.tile(amp0[..., None, :], reps)

    def _push(self, x) -> np.ndarray:
        """Feed audio samples; returns any newly committed audio samples.

        Frames are taken at starts 0, fshift, 2*fshift, ... of the stream
        (apply the perfectrec pre-padding yourself if you need alignment with
        proc.stft(x, perfectrec=True)).
        """
        if self.backend == "gpu":
            return self._push_block(x)  # same framing, one dispatch per chunk
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        x = np.asarray(x, dtype=np.float64)
        if self.streams > 1:
            x = x.reshape(self.streams, -1)
        else:
            x = x.reshape(-1)
        self._sample_buf = np.concatenate([self._sample_buf, x], axis=-1)
        out = []
        while self._sample_buf.shape[-1] >= fsize:
            out.append(self._process_frame(self._sample_buf[..., :fsize]))
            self._sample_buf = self._sample_buf[..., fshift:]
        return (np.concatenate(out, axis=-1) if out
                else np.zeros(self._sample_buf.shape[:-1] + (0,)))

    def _process_frame(self, frame) -> np.ndarray:
        proc = self.proc
        spec = np.fft.rfft(frame * proc.awin, n=proc.fftsize, axis=-1)
        return self._push_frame(spec)

    def _push_frame(self, spec, drain: bool = False) -> np.ndarray:
        """Feed one spectrogram frame directly (complex with untrusted phase,
        or magnitudes - e.g. streaming vocoder output). Returns committed
        audio samples (empty while the look-ahead pipeline fills).

        drain=True shifts the pipeline without running any updates (used by
        flush() so the tail frames keep their offline-final values)."""
        proc = self.proc
        spec = np.asarray(spec).astype(np.complex128)
        if self.streams > 1:
            spec = spec.reshape(self.streams, -1)
        else:
            spec = spec.reshape(-1)
        if self.backend == "gpu":
            return self._advance_gpu(spec[None], n_live=0 if drain else 1)
        fr = jnp.asarray(spec.real, dtype=proc.rdtype)
        fi = jnp.asarray(spec.imag, dtype=proc.rdtype)
        amp = jnp.asarray(np.abs(spec), dtype=proc.rdtype)

        if self._win_r is None:
            er, ei = freq_extend(fr[None, :], fi[None, :], self.L)
            self._init_window(er[0], ei[0], amp)

        self._frames_seen += 1
        self._amp_sum = self._amp_sum + np.mean(np.abs(spec), axis=-1)
        mean = (self.mean_amp if self.mean_amp is not None
                else self._amp_sum / self._frames_seen)
        if self.streams > 1:
            mean = np.reshape(mean, (self.streams, 1))

        self._win_r, self._win_i, self._amp_w, (cr, ci) = self._step(
            self._win_r, self._win_i, self._amp_w, fr, fi, amp,
            jnp.asarray(mean, dtype=proc.rdtype),
            jnp.asarray(self._frames_seen - 1, dtype=jnp.int32),
            jnp.asarray(not drain))

        # frames before the LA pipeline fills are replicas, not real commits
        if self._frames_seen <= self.LA:
            shape = (self.streams, 0) if self.streams > 1 else (0,)
            return np.zeros(shape)
        spec = np.asarray(cr) + 1j * np.asarray(ci)
        if self.keep_frames:
            self.committed_frames.append(spec)
        return self._emit(spec)

    def _emit(self, committed_spec) -> np.ndarray:
        """Overlap-add one committed frame; emit fshift finished samples."""
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        iframe = np.fft.irfft(committed_spec, n=proc.fftsize)[..., :fsize] * proc.swin[:fsize]
        self._ola_tail = self._ola_tail + iframe
        done = self._ola_tail[..., :fshift].copy()
        self._ola_tail = np.concatenate(
            [self._ola_tail[..., fshift:],
             np.zeros(self._ola_tail.shape[:-1] + (fshift,))], axis=-1)
        self._committed += 1
        return done

    def flush(self) -> np.ndarray:
        """Drain the pipeline: zero-pad so every frame containing buffered
        samples forms and is pushed live, then advance the look-ahead with LA
        frozen drain steps (no updates - the tail frames keep their
        offline-final values) and emit the OLA tail."""
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        out = []
        pending = self._sample_buf.shape[-1]
        zero_shape = (self.streams, self.F) if self.streams > 1 else (self.F,)
        if self.backend == "gpu":
            # sample-domain drain: form every frame containing buffered
            # samples, append the LA drain steps, and pad to whole kernel
            # blocks with extra drains (their dead commits are discarded by
            # the live-frame accounting)
            n_res = -(-pending // fshift) if pending > 0 else 0
            if self._pl_state is not None or n_res:
                nb = self.block_frames
                total = n_res + self.LA
                total_pad = -(-total // nb) * nb if nb else max(total, 1)
                need = (total_pad - 1) * fshift + fsize
                view = (self._sample_buf if self.streams > 1
                        else self._sample_buf[None])
                buf = np.concatenate(
                    [view, np.zeros((view.shape[0], need - view.shape[-1]))],
                    axis=-1)
                step_nb = nb or total_pad
                for i in range(0, total_pad, step_nb):
                    b = min(step_nb, total_pad - i)
                    w = buf[:, i * fshift:i * fshift + (b - 1) * fshift + fsize]
                    out.append(self._advance_samples(
                        w, b, int(np.clip(n_res - i, 0, b))))
                # emit the commit-frontier OLA tail (NOT the carried state
                # tail: with drain-padded final blocks the true tail lies in
                # the last chunk's unemitted audio region) and zero the
                # carried tail so nothing is double-emitted later
                t = self._pl_state[3]
                ft = self._frontier_tail
                tail = ft if self.streams > 1 else ft[0]
                out.append(tail if self.emit == "device" else np.asarray(tail))
                self._pl_state = (*self._pl_state[:3], jnp.zeros_like(t),
                                  *self._pl_state[4:])
                self._frontier_tail = None
        else:
            if pending > 0:
                # frames whose start lies inside the buffered samples
                n_frames = -(-pending // fshift)
                pad = max(0, (n_frames - 1) * fshift + fsize - pending)
                pad_shape = (self.streams, pad) if self.streams > 1 else (pad,)
                out.append(self._push(np.zeros(pad_shape)))
            zero = np.zeros(zero_shape, dtype=np.complex128)
            for _ in range(self.LA):
                if self._win_r is not None:
                    out.append(self._push_frame(zero, drain=True))
            out.append(self._ola_tail.copy())
        tail_shape = ((self.streams, fsize) if self.streams > 1 else (fsize,))
        self._ola_tail = np.zeros(tail_shape)
        self._sample_buf = (np.zeros((self.streams, 0)) if self.streams > 1
                            else np.zeros(0))
        if not out:
            return np.zeros(tail_shape[:-1] + (0,))
        cat = jnp.concatenate if self.emit == "device" else np.concatenate
        return self._maybe_prefetch(cat(out, axis=-1))
