"""Frame-sequential LWS sweeps as Pallas kernels for NVIDIA GPUs (Triton route).

The sweeps update one frame at a time, in order (the reference's Gauss-Seidel
frame order, lwslib.cpp batch sweep structure), and every frame update reads
the 2Q-1 neighbouring rows as they stand after the previous frame. XLA cannot
fuse that dependence: it runs the scan as one small while-loop step per
frame. Here one program owns one utterance (or one time segment of one) and
walks its frames itself, with the frequency bins of a row spread over the
block's threads.

State layout: each utterance's spectrogram lives in device memory as a
frequency-pre-extended slab of rows, (rows, W) with W = BF + 2L and
BF = next power of two >= F. Row r holds frame r - (Q-1); columns [L, L+F)
hold the bins, [0, L) and [L+F, L+F+L) their conjugate reflections (the
reference's ExtendSpec margins, lwslib.cpp:27-40), so every tap (dr, dk) is
one contiguous load of BF lanes at column dk. A frame update is: all taps
loaded and summed per bin, phase-updated, then - after a block barrier, so
no thread still reads the old row - stored back with its margins, and a
second barrier makes the new row visible before the next frame reads it.
The slab rows stay in L2 across frames; the stencil weights depend on the
bin only through n mod Q' (weights.build_stencil), so the kernels read them
from a small periodic table.

`interpret=True` runs the same kernels in the Pallas interpreter (CPU tests);
there the block is sequential and the barriers are dropped.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.stencil import Stencil, _parse_colors, freq_extend

__all__ = ["gs_sweeps", "segmented_gs_sweeps", "online_sweeps",
           "online_chunk_init", "online_chunk", "kernel_supported",
           "MAX_BINS", "MAX_Q"]

# Widest row and largest overlap the kernels accept: the geometries that have
# been compiled, checked and timed on an H100 (F=2049 at Q=4, F=1025 at Q=8).
# A row of BF lanes is spread over at most 8 warps, so wider rows put more
# bins and re/im accumulators on each thread (register spills past
# BF=4096), and a larger Q adds taps, (2Q-1)(2L+1), to every row update.
# Larger geometries take the XLA scan.
MAX_BINS = 2049
MAX_Q = 8


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def kernel_supported(F: int, Q: int) -> bool:
    """Shape rule for the GPU sweep kernels: rows up to MAX_BINS bins and
    overlap factors up to MAX_Q."""
    return F <= MAX_BINS and Q <= MAX_Q


def _num_warps(BF: int) -> int:
    return max(1, min(8, BF // 128))


def _params(BF: int):
    # num_stages=1: no software pipelining, so no load of the next frame is
    # hoisted above the barrier that publishes this frame's row
    return plgpu.CompilerParams(num_warps=_num_warps(BF), num_stages=1)


def weight_table(st: Stencil):
    """(period, Wr, Wi): the stencil's per-bin weights as a table indexed by
    bin mod period. Summarised weights repeat every Q' bins (Q' = Q); the
    fractional-Q weights get the full per-bin table (period = F)."""
    F = st.n_bins
    wr = np.asarray(st.Wr)
    wi = np.asarray(st.Wi)
    n = np.arange(F)
    for p in range(1, min(F, 64) + 1):
        if (np.array_equal(wr, wr[..., n % p])
                and np.array_equal(wi, wi[..., n % p])):
            return p, wr[..., :p], wi[..., :p]
    return F, wr, wi


def _table(sets):
    """Common-period weight tables of several stencils, stacked:
    (period, Wr (S, 2Q-1, 2L+1, period), Wi)."""
    tabs = [weight_table(s) for s in sets]
    period = tabs[0][0]
    if any(t[0] != period for t in tabs):
        period = sets[0].n_bins
        tabs = [(period, np.asarray(s.Wr), np.asarray(s.Wi)) for s in sets]
    return (period, np.stack([t[1] for t in tabs]),
            np.stack([t[2] for t in tabs]))


def _i32(x):
    return jnp.asarray(x, jnp.int32)


class _Row:
    """In-kernel row machinery shared by the batch and online kernels."""

    def __init__(self, xr, xi, am, wr, wi, b, *, F, L, Q, BF, W, period,
                 interpret):
        self.xr, self.xi, self.am, self.wr, self.wi, self.b = (
            xr, xi, am, wr, wi, b)
        self.F, self.L, self.Q, self.BF, self.W = F, L, Q, BF, W
        self.interpret = interpret
        self.col = lax.broadcasted_iota(jnp.int32, (BF,), 0)
        self.valid = self.col < F
        self.widx = self.col % jnp.int32(period)

    def sync(self):
        if not self.interpret:
            plgpu.debug_barrier()

    def load(self, ref, row, start):
        return plgpu.load(ref.at[self.b, _i32(row), pl.ds(_i32(start),
                                                           self.BF)])

    def weight(self, s, dr, dk):
        at = (_i32(s), _i32(dr), _i32(dk), self.widx)
        return plgpu.load(self.wr.at[at]), plgpu.load(self.wi.at[at])

    def taps(self, s, row, lo, hi, acc):
        """acc + sum over dr in [lo, hi) (a loop in the kernel) and dk (2L+1
        taps, unrolled) of W[dr, dk, n] * X(row - (Q-1) + dr, n + dk - L),
        in update_frame's accumulation order. Taps the stencil prunes to
        zero add exactly zero."""
        def body(dr, acc):
            tr, ti = acc
            x_row = row - (self.Q - 1) + dr
            for dk in range(2 * self.L + 1):
                w_r, w_i = self.weight(s, dr, dk)
                b_r = self.load(self.xr, x_row, dk)
                b_i = self.load(self.xi, x_row, dk)
                tr = tr + (w_r * b_r - w_i * b_i)
                ti = ti + (w_r * b_i + w_i * b_r)
            return tr, ti

        return lax.fori_loop(_i32(lo), _i32(hi), body, acc)

    def store(self, row, new_r, new_i):
        """Write an updated row (bins + conjugate margins). Barrier before
        (every thread has read the old row) and after (the new row is visible
        to the next update)."""
        F, L, W = self.F, self.L, self.W
        col = self.col
        row = _i32(row)
        self.sync()
        plgpu.store(self.xr.at[self.b, row, pl.ds(_i32(L), self.BF)], new_r,
                    mask=self.valid)
        plgpu.store(self.xi.at[self.b, row, pl.ds(_i32(L), self.BF)], new_i,
                    mask=self.valid)
        if L:
            # masked lanes point at the row's last (dead) column, so their
            # addresses stay in bounds and distinct from the real targets
            left = (col >= 1) & (col <= L)
            idx = jnp.where(left, L - col, W - 1)
            plgpu.store(self.xr.at[self.b, row, idx], new_r, mask=left)
            plgpu.store(self.xi.at[self.b, row, idx], -new_i, mask=left)
            right = (col >= F - L - 1) & (col <= F - 2)
            idx = jnp.where(right, L + 2 * F - 2 - col, W - 1)
            plgpu.store(self.xr.at[self.b, row, idx], new_r, mask=right)
            plgpu.store(self.xi.at[self.b, row, idx], -new_i, mask=right)
        self.sync()

    def update(self, s, row, amp_row, thr, *, lo, vis, has_centre,
               inner_passes, inner_scheme):
        """core/stencil.update_frame on slab row `row` with weight set `s`,
        whose nonzero taps lie in stencil rows [lo, Q-1+vis] (`vis` is the
        visibility v of make_stencil; it and `s` may be traced)."""
        Q1 = self.Q - 1
        zero = jnp.zeros((self.BF,), self.xr.dtype)
        acc = self.taps(s, row, lo, Q1, (zero, zero))
        tr, ti = self.taps(s, row, Q1 + 1, Q1 + 1 + jnp.maximum(vis, 0), acc)
        amp = self.load(self.am, amp_row, 0)
        old_r = self.load(self.xr, row, self.L)
        old_i = self.load(self.xi, row, self.L)

        def phase(fr, fi, cur_r, cur_i):
            a2 = fr * fr + fi * fi
            scale = amp * lax.rsqrt(jnp.where(a2 > 0, a2, 1))
            cond = (amp > thr) & (a2 > 0)
            return (jnp.where(cond, fr * scale, cur_r),
                    jnp.where(cond, fi * scale, cur_i))

        if not has_centre:
            self.store(row, *phase(tr, ti, old_r, old_i))
            return

        def centre():
            return self.taps(s, row, Q1, Q1 + 1, (zero, zero))

        if inner_scheme != "jacobi":
            # red-black (colorKxR) in-frame order: each color re-reads the
            # centre row with the colors before it already updated
            k, rounds = _parse_colors(inner_scheme)
            parity = self.col % k

            def color_step(i, cur):
                cr, ci = centre()
                nr, ni = phase(tr + cr, ti + ci, *cur)
                sel = parity == i % k
                cur = (jnp.where(sel, nr, cur[0]), jnp.where(sel, ni, cur[1]))
                self.store(row, *cur)
                return cur

            lax.fori_loop(0, k * rounds, color_step, (old_r, old_i))
            return

        def one_pass(i, c):
            cr, ci = centre()
            self.store(row, *phase(tr + cr, ti + ci, old_r, old_i))
            return c

        lax.fori_loop(0, inner_passes, one_pass, 0)


def _tap_rows(nz):
    """(lo, vis): a stencil's nonzero taps lie in rows [lo, Q-1+vis]; a
    stencil with none gives the empty range."""
    live = np.flatnonzero(nz.any(axis=1))
    Q1 = nz.shape[0] // 2
    if not live.size:
        return Q1, -1
    return int(live[0]), int(live[-1]) - Q1


def _extend_rows(sr, si, L, W):
    """(..., F) planes -> frequency-extended rows padded to width W."""
    er, ei = freq_extend(sr, si, L)
    pad = [(0, 0)] * (er.ndim - 1) + [(0, W - er.shape[-1])]
    return jnp.pad(er, pad), jnp.pad(ei, pad)


def _pad_bins(a, BF):
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, BF - a.shape[-1])])


# ---------------------------------------------------------------------------
# batch / no-future sweeps
# ---------------------------------------------------------------------------

def _gs_kernel(thr_ref, mean_ref, live_ref, am_ref, wr_ref, wi_ref,
               xr_in, xi_in, xr_ref, xi_ref, *, T, F, Q, L, BF, W, period,
               iters, nz, inner_passes, inner_scheme, interpret):
    del xr_in, xi_in  # aliased to xr_ref / xi_ref
    b = pl.program_id(0)
    rows = _Row(xr_ref, xi_ref, am_ref, wr_ref, wi_ref, b, F=F, L=L, Q=Q,
                BF=BF, W=W, period=period, interpret=interpret)
    mean = mean_ref[b]
    lo, vis = _tap_rows(nz)
    has_centre = bool(nz[Q - 1].any())

    def sweep(it, c):
        thr = thr_ref[it] * mean

        def frame(m, c2):
            rows.update(0, m + Q - 1, m, thr, lo=lo, vis=vis,
                        has_centre=has_centre, inner_passes=inner_passes,
                        inner_scheme=inner_scheme)
            return c2

        def run():
            lax.fori_loop(0, T, frame, 0)

        # sparsity-threshold sweep skip (python/lws.pyx:203-206 applied at
        # sweep granularity): when no bin exceeds this sweep's threshold
        # every update keeps its old value, so the sweep is skipped exactly
        lax.cond(live_ref[b, it] != 0, run, lambda: None)
        return c

    lax.fori_loop(0, iters, sweep, 0)


def _live_sweeps(amp, mean_amp, thresholds):
    """(B, iters) int32: 1 where some bin of the utterance exceeds that
    sweep's scaled threshold (amp is fixed across sweeps)."""
    amax = jnp.max(amp, axis=(-2, -1))
    return (amax[:, None] > thresholds[None, :].astype(amax.dtype)
            * mean_amp[:, None]).astype(jnp.int32)


def gs_sweeps(sr, si, st: Stencil, thresholds, inner_passes: int = 1,
              inner_scheme: str = "jacobi", halo=None, mean_amp=None,
              amp=None, interpret: bool = False):
    """Batch / no-future sweeps in exact frame order: the GPU kernel form of
    core/batch.lws_sweeps(order="gs") for (..., T, F) planes, with the same
    `halo` (frozen (Q-1)-frame time halos, (..., Q-1, F) each) and
    `mean_amp` ((...,) threshold scale) contract. `amp` ((..., T, F)) gives
    the target magnitudes when a caller runs one stage as several calls
    (halo exchange rounds): taken from the stage input once, they stay the
    same in every call instead of being re-derived from updated phases."""
    if thresholds.shape[0] == 0:
        return sr, si
    shape = sr.shape
    T, F = shape[-2:]
    sr = sr.reshape((-1, T, F))
    si = si.reshape((-1, T, F))
    B = sr.shape[0]
    Q, L = st.Q, st.L
    Q1 = Q - 1
    if not kernel_supported(F, Q):
        raise ValueError(f"GPU sweep kernel supports F <= {MAX_BINS} and "
                         f"Q <= {MAX_Q}, got F={F}, Q={Q}")
    BF = _pow2(F)
    W = BF + 2 * L
    iters = int(thresholds.shape[0])
    dt = sr.dtype

    if amp is None:
        amp = jnp.sqrt(sr * sr + si * si)
    amp = jnp.reshape(amp, (B, T, F)).astype(dt)
    if mean_amp is None:
        mean_amp = jnp.mean(amp, axis=(-2, -1))
    mean_amp = jnp.reshape(mean_amp, (B,)).astype(dt)
    if halo is None:
        top_r = jnp.repeat(sr[:, :1], Q1, axis=1)
        top_i = jnp.repeat(si[:, :1], Q1, axis=1)
        bot_r = jnp.repeat(sr[:, -1:], Q1, axis=1)
        bot_i = jnp.repeat(si[:, -1:], Q1, axis=1)
    else:
        top_r, top_i, bot_r, bot_i = (jnp.reshape(h, (B, Q1, F)).astype(dt)
                                      for h in halo)
    xr, xi = _extend_rows(jnp.concatenate([top_r, sr, bot_r], axis=1),
                          jnp.concatenate([top_i, si, bot_i], axis=1), L, W)
    period, tr, ti = _table([st])
    thr = thresholds.astype(dt)
    live = _live_sweeps(amp, mean_amp, thr)

    kern = functools.partial(
        _gs_kernel, T=T, F=F, Q=Q, L=L, BF=BF, W=W, period=period,
        iters=iters, nz=st.nz, inner_passes=int(inner_passes),
        inner_scheme=inner_scheme, interpret=interpret)
    out = jax.ShapeDtypeStruct(xr.shape, dt)
    xr, xi = pl.pallas_call(
        kern, out_shape=(out, out), grid=(B,),
        input_output_aliases={6: 0, 7: 1},
        backend="triton", compiler_params=_params(BF),
        interpret=interpret, name="lws_gs_sweeps",
    )(thr, mean_amp, live, _pad_bins(amp, BF), jnp.asarray(tr, dt),
      jnp.asarray(ti, dt), xr, xi)
    return (xr[:, Q1:Q1 + T, L:L + F].reshape(shape),
            xi[:, Q1:Q1 + T, L:L + F].reshape(shape))


def segmented_gs_sweeps(sr, si, st: Stencil, thresholds, segments: int,
                        sweeps_per_exchange: int = 1, inner_passes: int = 1,
                        inner_scheme: str = "jacobi", halo=None,
                        mean_amp=None, interpret: bool = False):
    """Batch / no-future sweeps with each utterance's time axis split into
    `segments` parts that run as separate programs.

    A long single spectrogram is one program on one SM; splitting time into
    S segments runs S at once. Cross-segment information flows through a
    (Q-1)-frame halo exchange every `sweeps_per_exchange` sweeps - the
    single-device analogue of the mesh time sharding in parallel/sharding.py
    (block-Jacobi at the seams, frozen stage-entry halos at the true
    boundaries, the whole signal's mean as threshold scale).

    `halo` / `mean_amp` follow gs_sweeps' contract for the true boundaries
    (the processor's macro time-chunking passes real neighbour frames). T is
    padded to a segment multiple with edge-frame replicas; the padded frames
    live in the last segment and are discarded on return."""
    if thresholds.shape[0] == 0:
        return sr, si
    shape = sr.shape
    T, F = shape[-2:]
    sr = sr.reshape((-1, T, F))
    si = si.reshape((-1, T, F))
    B = sr.shape[0]
    Q1 = st.Q - 1
    S = max(1, int(segments))
    Tseg = -(-T // S)
    if Tseg < max(Q1, 1) * 2:
        raise ValueError(
            f"segments={S} leaves {Tseg} frames/segment; need >= {2 * Q1}")
    iters = int(thresholds.shape[0])
    s_ex = max(1, int(sweeps_per_exchange))
    rounds, rem = divmod(iters, s_ex)

    t_pad = S * Tseg - T
    if mean_amp is None:
        mean_amp = jnp.mean(jnp.sqrt(sr * sr + si * si), axis=(-2, -1))
    mean_seg = jnp.repeat(jnp.reshape(mean_amp, (B,)), S)
    if t_pad:
        sr = jnp.concatenate([sr, jnp.repeat(sr[:, -1:], t_pad, axis=1)], 1)
        si = jnp.concatenate([si, jnp.repeat(si[:, -1:], t_pad, axis=1)], 1)
    if halo is None:
        halo = (jnp.repeat(sr[:, :1], Q1, axis=1),
                jnp.repeat(si[:, :1], Q1, axis=1),
                jnp.repeat(sr[:, T - 1:T], Q1, axis=1),
                jnp.repeat(si[:, T - 1:T], Q1, axis=1))
    frozen = [jnp.repeat(jnp.reshape(h, (B, Q1, F)), S, axis=0) for h in halo]
    first = (jnp.arange(B * S) % S == 0)[:, None, None]
    last = (jnp.arange(B * S) % S == S - 1)[:, None, None]

    cr = sr.reshape(B * S, Tseg, F)
    ci = si.reshape(B * S, Tseg, F)
    amp = jnp.sqrt(cr * cr + ci * ci)

    def run_block(cr, ci, thr_block):
        # live halos from the same utterance's neighbour segments; the
        # first/last masks put the frozen halos at the true boundaries, so
        # the roll never carries frames across utterances
        top_r = jnp.where(first, frozen[0], jnp.roll(cr[:, -Q1:], 1, axis=0))
        top_i = jnp.where(first, frozen[1], jnp.roll(ci[:, -Q1:], 1, axis=0))
        bot_r = jnp.where(last, frozen[2], jnp.roll(cr[:, :Q1], -1, axis=0))
        bot_i = jnp.where(last, frozen[3], jnp.roll(ci[:, :Q1], -1, axis=0))
        return gs_sweeps(cr, ci, st, thr_block, inner_passes=inner_passes,
                         inner_scheme=inner_scheme,
                         halo=(top_r, top_i, bot_r, bot_i),
                         mean_amp=mean_seg, amp=amp, interpret=interpret)

    if rounds:
        def body(carry, thr_block):
            return run_block(*carry, thr_block), None
        (cr, ci), _ = lax.scan(
            body, (cr, ci), thresholds[:rounds * s_ex].reshape(rounds, s_ex))
    if rem:
        cr, ci = run_block(cr, ci, thresholds[rounds * s_ex:])
    return (cr.reshape(B, S * Tseg, F)[:, :T].reshape(shape),
            ci.reshape(B, S * Tseg, F)[:, :T].reshape(shape))


# ---------------------------------------------------------------------------
# online RTISI-LA (offline and carried-state streaming entries)
# ---------------------------------------------------------------------------

def _online_kernel(thr_ref, mean_ref, scal_ref, am_ref, wr_ref, wi_ref,
                   xr_in, xi_in, xr_ref, xi_ref, *, N, F, Q, L, LA, BF, W,
                   period, r0, iters, nzs, inner_passes, inner_scheme,
                   interpret):
    """core/online.rtisi_la's frame-commit pipeline over slab rows
    r0 .. r0+N-1 (the new frames). Per new frame j (absolute index
    m_abs0 + j): initialise it from strictly-past frames (weight set 0,
    threshold 0), then `iters` rounds of the look-ahead frames j-LA..j-1
    (set 2+d-1 for the frame d behind, only frames with a non-negative
    absolute index) and the newest frame (set 1). Frames j >= n_live are
    drain steps: nothing updates."""
    del xr_in, xi_in  # aliased to xr_ref / xi_ref
    b = pl.program_id(0)
    rows = _Row(xr_ref, xi_ref, am_ref, wr_ref, wi_ref, b, F=F, L=L, Q=Q,
                BF=BF, W=W, period=period, interpret=interpret)
    n_live = scal_ref[0]
    m_abs0 = scal_ref[1]
    Q1 = Q - 1
    lo_ai = _tap_rows(nzs[0])[0]
    lo = min(_tap_rows(nz)[0] for nz in nzs[1:])

    def frame(j, c):
        row = r0 + j
        m_abs = m_abs0 + j
        mean = mean_ref[b, j]

        def live():
            rows.update(0, row, row, 0.0, lo=lo_ai, vis=-1, has_centre=False,
                        inner_passes=1, inner_scheme=inner_scheme)

            def rnd(h, c2):
                thr = thr_ref[h] * mean

                def step(i, c3):
                    # frames d = LA .. 1 behind the newest (weight set
                    # 1 + d, visibility min(d, Q-1)), then the newest
                    # itself (d = 0: set 1, visibility 0)
                    d = LA - i

                    def upd():
                        rows.update(1 + d, row - d,
                                    row - d, thr, lo=lo,
                                    vis=jnp.minimum(d, Q1), has_centre=True,
                                    inner_passes=inner_passes,
                                    inner_scheme=inner_scheme)

                    lax.cond(m_abs - d >= 0, upd, lambda: None)
                    return c3

                lax.fori_loop(0, LA + 1, step, 0)
                return c2

            lax.fori_loop(0, iters, rnd, 0)

        lax.cond(j < n_live, live, lambda: None)
        return c

    lax.fori_loop(0, N, frame, 0)


def _online_call(xr, xi, amp, means, n_live, m_abs0, sets, thresholds, *,
                 r0, N, F, Q, L, inner_passes, inner_scheme, interpret):
    B = xr.shape[0]
    BF = _pow2(F)
    W = xr.shape[-1]
    dt = xr.dtype
    period, tr, ti = _table(sets)
    kern = functools.partial(
        _online_kernel, N=N, F=F, Q=Q, L=L, LA=len(sets) - 2, BF=BF, W=W,
        period=period, r0=r0, iters=int(thresholds.shape[0]),
        nzs=[s.nz for s in sets], inner_passes=int(inner_passes),
        inner_scheme=inner_scheme, interpret=interpret)
    scal = jnp.stack([jnp.asarray(n_live, jnp.int32),
                      jnp.asarray(m_abs0, jnp.int32)])
    out = jax.ShapeDtypeStruct(xr.shape, dt)
    return pl.pallas_call(
        kern, out_shape=(out, out), grid=(B,),
        input_output_aliases={6: 0, 7: 1},
        backend="triton", compiler_params=_params(BF),
        interpret=interpret, name="lws_online_sweeps",
    )(thresholds.astype(dt), means.astype(dt), scal, _pad_bins(amp, BF),
      jnp.asarray(tr, dt), jnp.asarray(ti, dt), xr, xi)


def online_sweeps(sr, si, st_la, st_ai, st_af, thresholds,
                  inner_passes: int = 1, inner_scheme: str = "jacobi",
                  interpret: bool = False):
    """Online (RTISI-LA) phase recovery over (..., T, F) planes: the GPU
    kernel form of core/online.rtisi_la."""
    if thresholds.shape[0] == 0:
        return sr, si
    shape = sr.shape
    T, F = shape[-2:]
    sr = sr.reshape((-1, T, F))
    si = si.reshape((-1, T, F))
    Q, L = st_af.Q, st_af.L
    Q1 = Q - 1
    if not kernel_supported(F, Q):
        raise ValueError(f"GPU online kernel supports F <= {MAX_BINS} and "
                         f"Q <= {MAX_Q}, got F={F}, Q={Q}")
    W = _pow2(F) + 2 * L
    amp = jnp.sqrt(sr * sr + si * si)
    mean = jnp.mean(amp, axis=(-2, -1))
    xr, xi = _extend_rows(
        jnp.concatenate([jnp.repeat(sr[:, :1], Q1, 1), sr,
                         jnp.repeat(sr[:, -1:], Q1, 1)], axis=1),
        jnp.concatenate([jnp.repeat(si[:, :1], Q1, 1), si,
                         jnp.repeat(si[:, -1:], Q1, 1)], axis=1), L, W)
    amp_s = jnp.pad(amp, ((0, 0), (Q1, Q1), (0, 0)))
    means = jnp.broadcast_to(mean[:, None], (sr.shape[0], T))
    xr, xi = _online_call(
        xr, xi, amp_s, means, T, 0, [st_ai, st_af] + list(st_la), thresholds,
        r0=Q1, N=T, F=F, Q=Q, L=L, inner_passes=inner_passes,
        inner_scheme=inner_scheme, interpret=interpret)
    return (xr[:, Q1:Q1 + T, L:L + F].reshape(shape),
            xi[:, Q1:Q1 + T, L:L + F].reshape(shape))


def online_chunk_init(fr0, fi0, st_la, st_af):
    """Initial carried state of a chunked online stream from each stream's
    first frame (B, F): the LA+Q-1 context rows are replicas of the
    frequency-extended first frame (extspec edge semantics,
    lwslib.cpp:21-25) with zero target magnitudes (pre-start frames never
    update). Returns (rows_r, rows_i, rows_amp)."""
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    K1 = LA + Q - 1
    F = fr0.shape[-1]
    er, ei = _extend_rows(fr0, fi0, L, _pow2(F) + 2 * L)
    return (jnp.repeat(er[:, None], K1, axis=1),
            jnp.repeat(ei[:, None], K1, axis=1),
            jnp.zeros((fr0.shape[0], K1, F), fr0.dtype))


def online_chunk(sr, si, state, means, st_la, st_ai, st_af, thresholds,
                 frames_seen, n_live=None, inner_passes: int = 1,
                 inner_scheme: str = "jacobi", interpret: bool = False):
    """Advance a chunked online stream by the frames in `sr`/`si` (B, N, F).

    `state` comes from `online_chunk_init` or a prior call; `means` (B, N)
    is the threshold scale in effect at each frame; `frames_seen` is the
    absolute index of the first new frame (look-ahead frames before the
    stream start never update). Returns (committed_r, committed_i,
    new_state): committed row j holds the final value of absolute frame
    frames_seen + j - LA (the caller drops rows from before the pipeline
    filled). Frames j >= n_live (may be traced) are drain steps."""
    B, N, F = sr.shape
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    Q1 = Q - 1
    K1 = LA + Q - 1
    W = _pow2(F) + 2 * L
    rows_r, rows_i, rows_a = state
    nr, ni = _extend_rows(sr, si, L, W)
    zeros = jnp.zeros((B, Q1, W), sr.dtype)
    xr = jnp.concatenate([rows_r, nr, zeros], axis=1)
    xi = jnp.concatenate([rows_i, ni, zeros], axis=1)
    n_live = N if n_live is None else n_live
    # drain frames keep zero target magnitudes: they never update later
    live = (jnp.arange(N) < n_live)[None, :, None]
    amp = jnp.concatenate([rows_a,
                           jnp.where(live, jnp.sqrt(sr * sr + si * si), 0),
                           jnp.zeros((B, Q1, F), sr.dtype)], axis=1)
    xr, xi = _online_call(
        xr, xi, amp, means, n_live, frames_seen,
        [st_ai, st_af] + list(st_la), thresholds, r0=K1, N=N, F=F, Q=Q, L=L,
        inner_passes=inner_passes, inner_scheme=inner_scheme,
        interpret=interpret)
    c0 = K1 - LA
    new_state = (xr[:, N:N + K1], xi[:, N:N + K1], amp[:, N:N + K1])
    return xr[:, c0:c0 + N, L:L + F], xi[:, c0:c0 + N, L:L + F], new_state
