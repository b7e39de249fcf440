"""The masked-dense LWS stencil update (device layer, split-complex).

One vectorized complex stencil op subsumes all thirteen scalar update kernels
of the reference C core (lwslib/lwslib.cpp:72-1421). For every bin (m, n) of a
Hermitian-extended spectrogram:

    temp(m, n) = sum_{dr, dk} Wst[dr, dk, n] * S(m+dr, n+dk)
    S(m, n)   <- temp * amp(m, n) / |temp|     if amp > threshold and |temp| > 0

Spectrograms are carried as SPLIT real/imaginary float arrays (sr, si) - the
reference does the same at the C boundary (double* Sr / Si, lwslib.h:6-26):
float32 planes map directly onto the kernels' vector lanes, and no complex
dtype ever crosses a jit boundary (XLA decomposes complex arithmetic into
real pairs anyway).

The reference's branchy accelerations become masks:
  - weight pruning (w_flag):   zeros baked into Wst (weights.build_stencil)
  - sparsity thresholds:       jnp.where on amp > threshold
  - causal / look-ahead gating (no-future, RTISI-LA rframe/cframe logic,
    lwslib.cpp:788-798): zeroing all taps with dr > v ("visibility"), applied
    host-side in make_stencil. v = Q-1 full batch sweep, v = 0 newest-frame
    asymmetric update, v = -1 no-future / asym-init, v = min(d, Q-1) for a
    look-ahead frame d steps behind the newest.

Update order: the reference sweeps bins in raster order updating in place
(Gauss-Seidel, lwslib.cpp:81-82). Here two orders are offered:
  - "gs": frame-sequential Gauss-Seidel (lax.scan over frames; all bins of a
    frame update in parallel) - matches the reference's dominant cross-frame
    information flow, vectorized over batch and frequency;
  - "jacobi": fully parallel sweeps - maximal parallelism, slightly different
    convergence per sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

# A split-complex spectrogram: pair of identically-shaped real arrays.
RI = tuple  # (sr, si)


@jax.custom_jvp
def safe_sqrt(x):
    """`jnp.sqrt` with a finite derivative at exactly 0.

    The primal is literally `jnp.sqrt(x)` — same HLO, bit-identical forward
    (guarding the operand with `where` instead was measured to perturb XLA's
    f32 fusion choices by ulps, which sweeps amplify). Only the JVP is
    guarded: d(sqrt)/dx at 0 is +inf, which would propagate NaN through the
    phase update's masked branches under `jax.grad`; here the tangent is 0
    at x == 0 (magnitudes/zero-sum bins hold their value there, so a zero
    subgradient is the correct choice)."""
    return jnp.sqrt(x)


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,), (xdot,) = primals, tangents
    y = jnp.sqrt(x)
    pos = x > 0
    return y, jnp.where(pos, xdot / (2 * jnp.where(pos, y, 1)),
                        jnp.zeros_like(y))


@dataclass(frozen=True)
class Stencil:
    """Device stencil tensor + host-side metadata for trace-time tap skipping."""

    Wr: jnp.ndarray  # (2Q-1, 2L+1, F) real part, visibility mask pre-applied
    Wi: jnp.ndarray  # (2Q-1, 2L+1, F) imag part
    nz: np.ndarray = field(repr=False)  # host bool (2Q-1, 2L+1): tap is nonzero
    Q: int = 0
    L: int = 0

    @property
    def n_bins(self) -> int:
        return self.Wr.shape[-1]

    def band_mats(self):
        """Banded (2Q-1, F+2L, F) matmul form of the per-dr frequency taps,
        cached on first use: M[dr, n+dk, n] = W[dr, dk, n], so the whole
        dk-sum over a frequency-extended row block is one (T, F+2L) @
        (F+2L, F) matmul per dr — the matmul-order Jacobi sweep's
        workhorse (apply_stencil_mxu). Band density is 11/(F+2L): the FLOP
        inflation is traded for the matrix units' rate, and the whole (B, T)
        grid batches into the matmul."""
        if getattr(self, "_band", None) is None:
            F, Q, L = self.n_bins, self.Q, self.L
            E = F + 2 * L
            Wr = np.asarray(self.Wr, np.float64)
            Wi = np.asarray(self.Wi, np.float64)
            Mr = np.zeros((2 * Q - 1, E, F))
            Mi = np.zeros((2 * Q - 1, E, F))
            cols = np.arange(F)
            for dr in range(2 * Q - 1):
                for dk in range(2 * L + 1):
                    if not self.nz[dr, dk]:
                        continue
                    Mr[dr, cols + dk, cols] = Wr[dr, dk]
                    Mi[dr, cols + dk, cols] = Wi[dr, dk]
            # cache NUMPY arrays: band_mats can first be called inside a
            # jit trace, where jnp.asarray returns a trace-local tracer —
            # caching that leaks it into later traces. numpy constants are
            # trace-safe and XLA hoists the conversion.
            dt = np.dtype(self.Wr.dtype)
            object.__setattr__(self, "_band", (Mr.astype(dt), Mi.astype(dt)))
        return self._band


def make_stencil(Wst_np: np.ndarray, Q: int, L: int, v: int, dtype=jnp.float32) -> Stencil:
    """Apply the dr <= v visibility mask and move the stencil to device.

    v = Q-1 keeps everything (batch LWS); v = 0 keeps past + centre frame
    (asym-full); v = -1 keeps strictly past frames (no-future / asym-init).
    """
    dr = np.arange(-(Q - 1), Q)
    masked = np.where((dr <= v)[:, None, None], Wst_np, 0.0)
    nz = np.any(np.abs(masked) > 0, axis=-1)
    return Stencil(
        Wr=jnp.asarray(masked.real, dtype=dtype),
        Wi=jnp.asarray(masked.imag, dtype=dtype),
        nz=nz, Q=Q, L=L,
    )


def split(S, dtype=None) -> RI:
    """Host complex array -> (sr, si) device-ready pair."""
    S = np.asarray(S)
    if dtype is None:
        dtype = jnp.float64 if S.dtype == np.complex128 else jnp.float32
    return jnp.asarray(S.real, dtype=dtype), jnp.asarray(S.imag, dtype=dtype)


def merge(sr, si) -> np.ndarray:
    """(sr, si) pair -> host complex numpy array (two real transfers)."""
    sr = np.asarray(sr)
    return sr + 1j * np.asarray(si)


def freq_extend(sr: jnp.ndarray, si: jnp.ndarray, L: int) -> RI:
    """(..., T, F) -> (..., T, F+2L): conjugate-reflect below DC / above Nyquist.

    Mirrors ExtendSpec's frequency margins (lwslib/lwslib.cpp:27-40).
    """
    if L == 0:
        return sr, si
    lr = jnp.flip(sr[..., 1:L + 1], axis=-1)
    li = -jnp.flip(si[..., 1:L + 1], axis=-1)
    rr = jnp.flip(sr[..., -L - 1:-1], axis=-1)
    ri = -jnp.flip(si[..., -L - 1:-1], axis=-1)
    return (jnp.concatenate([lr, sr, rr], axis=-1),
            jnp.concatenate([li, si, ri], axis=-1))


def time_extend(x: jnp.ndarray, top: jnp.ndarray, bot: jnp.ndarray) -> jnp.ndarray:
    """Attach the frozen (Q-1)-frame edge-replica halos along time.

    The reference replicates edge frames once at extension time and never
    updates them during sweeps (lwslib.cpp:21-25; updates only touch
    m in [Q-1, M+Q-1)), so the halos are fixed per stage call.
    """
    return jnp.concatenate([top, x, bot], axis=-2)


def make_time_halos(x: jnp.ndarray, Q: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Frozen edge-frame replica halos from the stage-input extended rows."""
    reps = [1] * (x.ndim - 2) + [Q - 1, 1]
    return jnp.tile(x[..., :1, :], reps), jnp.tile(x[..., -1:, :], reps)


def phase_update(tr, ti, amp, old_r, old_i, thr) -> RI:
    """Magnitude-preserving phase update with threshold skip.

    Mirrors lwslib.cpp:84-85 (threshold test, strict >) and 133-137 (keep the
    old value when the weighted sum is exactly zero).

    The scale is computed as `amp * rsqrt(|temp|^2)` rather than
    `amp / sqrt(|temp|^2)`: one fast reciprocal-root op instead of a root
    plus a divide on the sweep's serial epilogue path, at identical
    consistency. `a2 > 0` iff `sqrt(a2) > 0`, so the keep-old guard is
    unchanged; the `where` guard keeps rsqrt finite at exactly-zero sums
    (and zeroes their gradient — the masked branch holds the old value, so
    a zero subgradient is correct, same contract as safe_sqrt)."""
    a2 = tr * tr + ti * ti
    scale = amp * lax.rsqrt(jnp.where(a2 > 0, a2, 1))
    cond = (amp > thr) & (a2 > 0)
    return jnp.where(cond, tr * scale, old_r), jnp.where(cond, ti * scale, old_i)


def apply_stencil(xr: jnp.ndarray, xi: jnp.ndarray, st: Stencil) -> RI:
    """Jacobi application over the full grid: (..., Tp, Fp) -> (..., T, F)."""
    Q, L = st.Q, st.L
    T = xr.shape[-2] - 2 * (Q - 1)
    F = st.n_bins
    tr = jnp.zeros(xr.shape[:-2] + (T, F), dtype=xr.dtype)
    ti = jnp.zeros_like(tr)
    for dr in range(2 * Q - 1):
        for dk in range(2 * L + 1):
            if not st.nz[dr, dk]:
                continue
            wr, wi = st.Wr[dr, dk], st.Wi[dr, dk]
            br = xr[..., dr:dr + T, dk:dk + F]
            bi = xi[..., dr:dr + T, dk:dk + F]
            tr = tr + (wr * br - wi * bi)
            ti = ti + (wr * bi + wi * br)
    return tr, ti


def apply_stencil_mxu(xr: jnp.ndarray, xi: jnp.ndarray, st: Stencil,
                      precision=None) -> RI:
    """`apply_stencil` recast as banded matmuls, so the matrix units do
    the FLOPs.

    Same math, different op order: per time offset dr the (2L+1)-tap
    frequency sum over the extended rows is ONE (..., T, F+2L) @ (F+2L, F)
    matmul against the band matrix (Stencil.band_mats); the split-complex
    product is the usual 4-real-matmul form. Elementwise-equivalent to
    apply_stencil up to matmul accumulation order (float64 agreement to
    1e-9, tests/test_mxu.py). `precision` is the jax matmul precision —
    None (backend default; reduced-precision passes such as TF32 where
    the backend uses them) or "highest" (f32-accurate)."""
    Q = st.Q
    T = xr.shape[-2] - 2 * (Q - 1)
    Mr, Mi = st.band_mats()
    tr = ti = 0.0
    for dr in range(2 * Q - 1):
        if not st.nz[dr].any():
            continue
        br = xr[..., dr:dr + T, :]
        bi = xi[..., dr:dr + T, :]
        tr = tr + (jnp.matmul(br, Mr[dr], precision=precision)
                   - jnp.matmul(bi, Mi[dr], precision=precision))
        ti = ti + (jnp.matmul(br, Mi[dr], precision=precision)
                   + jnp.matmul(bi, Mr[dr], precision=precision))
    return tr, ti


def _parse_colors(scheme: str) -> tuple[int, int]:
    """'twocolor' -> (2, 1); 'colorK' -> (K, 1); 'colorKxR' -> (K, R)."""
    if scheme == "twocolor":
        return 2, 1
    if scheme.startswith("color"):
        body = scheme[5:]
        k, _, r = body.partition("x")
        return int(k), int(r) if r else 1
    raise ValueError(f"unknown inner_scheme: {scheme!r}")


def update_frame(
    xr: jnp.ndarray, xi: jnp.ndarray, m, amp_m: jnp.ndarray, st: Stencil, thr,
    inner_passes: int = 1, inner_scheme: str = "jacobi",
) -> RI:
    """Gauss-Seidel update of one frame (true index m) of the extended arrays.

    Reads the (2Q-1)-frame neighbourhood from the current state, updates all F
    bins of frame m in parallel, and writes back the frequency-re-extended row
    (the reference mirrors updated margin bins into the halo immediately,
    lwslib.cpp:139-145; re-extending the whole updated row is equivalent).

    The reference additionally Gauss-Seidels *within* the frame (raster order
    over bins, lwslib.cpp:81-82), which a vectorized update cannot reproduce
    exactly. Two approximations of that in-frame information flow:
      - inner_scheme="jacobi", inner_passes > 1: re-apply the same-frame
        (dr = 0) taps against freshly updated values (symmetric re-passes);
      - inner_scheme="twocolor": red-black ordering over bins — even bins
        update first, odd bins then read the updated evens through the
        dr = 0 frequency taps (sequential flow at full vector width).
    Off-centre taps are computed once and reused in both schemes.
    """
    Q, L = st.Q, st.L
    F = st.n_bins
    c = Q - 1
    tdim = xr.ndim - 2
    pr = lax.dynamic_slice_in_dim(xr, m, 2 * Q - 1, axis=tdim)
    pi = lax.dynamic_slice_in_dim(xi, m, 2 * Q - 1, axis=tdim)

    tr = jnp.zeros(pr.shape[:-2] + (F,), dtype=pr.dtype)
    ti = jnp.zeros_like(tr)
    for dr in range(2 * Q - 1):
        if dr == c:
            continue
        for dk in range(2 * L + 1):
            if not st.nz[dr, dk]:
                continue
            wr, wi = st.Wr[dr, dk], st.Wi[dr, dk]
            br, bi = pr[..., dr, dk:dk + F], pi[..., dr, dk:dk + F]
            tr = tr + (wr * br - wi * bi)
            ti = ti + (wr * bi + wi * br)

    def centre_taps(row_r, row_i):
        cr = jnp.zeros_like(tr)
        ci = jnp.zeros_like(tr)
        for dk in range(2 * L + 1):
            if not st.nz[c, dk]:
                continue
            wr, wi = st.Wr[c, dk], st.Wi[c, dk]
            br, bi = row_r[..., dk:dk + F], row_i[..., dk:dk + F]
            cr = cr + (wr * br - wi * bi)
            ci = ci + (wr * bi + wi * br)
        return cr, ci

    has_centre = bool(st.nz[c].any())
    row_r, row_i = pr[..., c, :], pi[..., c, :]
    old_r, old_i = row_r[..., L:L + F], row_i[..., L:L + F]
    if has_centre and inner_scheme != "jacobi":
        k, rounds = _parse_colors(inner_scheme)
        parity = jnp.arange(F) % k
        cur_r, cur_i = old_r, old_i
        for _round in range(rounds):
            for color in range(k):
                cr, ci = centre_taps(row_r, row_i)
                fr, fi = tr + cr, ti + ci
                nr, ni = phase_update(fr, fi, amp_m, cur_r, cur_i, thr)
                sel = parity == color
                cur_r = jnp.where(sel, nr, cur_r)
                cur_i = jnp.where(sel, ni, cur_i)
                er, ei = freq_extend(cur_r[..., None, :], cur_i[..., None, :], L)
                row_r, row_i = er[..., 0, :], ei[..., 0, :]
    else:
        for _ in range(inner_passes if has_centre else 1):
            if has_centre:
                cr, ci = centre_taps(row_r, row_i)
                fr, fi = tr + cr, ti + ci
            else:
                fr, fi = tr, ti
            new_r, new_i = phase_update(fr, fi, amp_m, old_r, old_i, thr)
            er, ei = freq_extend(new_r[..., None, :], new_i[..., None, :], L)
            row_r, row_i = er[..., 0, :], ei[..., 0, :]

    xr = lax.dynamic_update_slice_in_dim(xr, row_r[..., None, :], m + Q - 1, axis=tdim)
    xi = lax.dynamic_update_slice_in_dim(xi, row_i[..., None, :], m + Q - 1, axis=tdim)
    return xr, xi
