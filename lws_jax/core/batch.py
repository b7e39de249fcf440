"""Batch-mode LWS sweeps (batch and no-future schedules), split-complex.

Functional equivalent of the reference batch drivers (python/lws.pyx:209-311 +
lwslib/lwslib.cpp:72-764): iterate thresholded phase-update sweeps over the
whole spectrogram. The no-future schedule is the same sweep with a stencil
whose visibility is v = -1 (strictly-past taps only), built from the
asymmetric-init weights.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .stencil import (
    Stencil,
    apply_stencil,
    apply_stencil_mxu,
    freq_extend,
    make_time_halos,
    phase_update,
    safe_sqrt,
    time_extend,
    update_frame,
)


def lws_sweeps(
    sr: jnp.ndarray,
    si: jnp.ndarray,
    st: Stencil,
    thresholds: jnp.ndarray,
    order: str = "gs",
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    precision=None,
    halo: tuple | None = None,
    mean_amp: jnp.ndarray | None = None,
):
    """Run len(thresholds) LWS sweeps over (sr, si) of shape (..., T, F).

    Target magnitudes are fixed to |S| at entry (lwslib.cpp:59-65 via
    python/lws.pyx:239); thresholds are scaled by the per-item mean input
    magnitude (python/lws.pyx:240-245). `order` selects the sweep schedule:
    "gs" (frame-sequential Gauss-Seidel, reference-like), "jacobi"
    (whole-grid parallel sweeps), or "jacobi_mxu" (the same Jacobi sweeps
    with the frequency taps cast as banded matmuls so the matrix units do
    the FLOPs — apply_stencil_mxu; `precision` sets the matmul precision).

    `halo` is (top_r, top_i, bot_r, bot_i) of shape (..., Q-1, F): explicit
    frozen time-halo frames used instead of the default edge replicas, and
    `mean_amp` (...,) overrides the locally computed mean magnitude — the
    same contract as the GPU kernels (ops/gpu_sweeps.py), used by the
    time-sharded and macro-chunked paths.
    """
    if thresholds.shape[0] == 0:
        return sr, si
    Q, L = st.Q, st.L
    T = sr.shape[-2]
    # safe_sqrt: zero bins (silence / padding) would otherwise put
    # d(sqrt)/dx|_0 = inf on the backward path; forward is plain jnp.sqrt
    amp = safe_sqrt(sr * sr + si * si)
    if mean_amp is None:
        mean_amp = jnp.mean(amp, axis=(-2, -1), keepdims=True)
    else:
        mean_amp = mean_amp[..., None, None].astype(amp.dtype)

    xr0, xi0 = freq_extend(sr, si, L)
    if halo is None:
        top_r, bot_r = make_time_halos(xr0, Q)
        top_i, bot_i = make_time_halos(xi0, Q)
    else:
        top_r, top_i = freq_extend(halo[0], halo[1], L)
        bot_r, bot_i = freq_extend(halo[2], halo[3], L)

    if order in ("jacobi", "jacobi_mxu"):
        mxu = order == "jacobi_mxu"

        def one_iter(carry, thr_rel):
            cr, ci = carry
            thr = thr_rel * mean_amp
            er, ei = freq_extend(cr, ci, L)
            xr = time_extend(er, top_r, bot_r)
            xi = time_extend(ei, top_i, bot_i)
            if mxu:
                tr, ti = apply_stencil_mxu(xr, xi, st, precision=precision)
            else:
                tr, ti = apply_stencil(xr, xi, st)
            return phase_update(tr, ti, amp, cr, ci, thr), None

        (sr, si), _ = lax.scan(one_iter, (sr, si), thresholds)
        return sr, si

    if order != "gs":
        raise ValueError(f"unknown sweep order: {order!r}")

    # Frame-sequential Gauss-Seidel: scan frames within each sweep, carrying
    # the extended arrays so later frames read already-updated neighbours.
    amp_t = jnp.moveaxis(amp, -2, 0)  # (T, ..., F) for scan consumption
    F = st.n_bins

    def one_iter(carry, thr_rel):
        cr, ci = carry
        thr = thr_rel * mean_amp[..., 0, :]  # (..., 1), broadcasts against (..., F)
        er, ei = freq_extend(cr, ci, L)
        xr = time_extend(er, top_r, bot_r)
        xi = time_extend(ei, top_i, bot_i)

        def frame_body(x, xs):
            m, amp_m = xs
            return update_frame(x[0], x[1], m, amp_m, st, thr, inner_passes,
                                inner_scheme), None

        (xr, xi), _ = lax.scan(frame_body, (xr, xi), (jnp.arange(T), amp_t))
        return (xr[..., Q - 1:Q - 1 + T, L:L + F], xi[..., Q - 1:Q - 1 + T, L:L + F]), None

    (sr, si), _ = lax.scan(one_iter, (sr, si), thresholds)
    return sr, si
