"""Exact (float64) single-bin parity of the stencil op vs the reference C core.

Golden scenario: exactly one bin's magnitude is above threshold, so only that
bin updates and it reads only old neighbour values - Gauss-Seidel and Jacobi
coincide and the golden value checks every tap weight and index exactly,
including the frequency (DC/Nyquist) and time boundaries.

Goldens were produced by the general LWSanyQ / LWSfractionalQ /
NoFuture_LWSanyQ / Asym_UpdatePhaseanyQ reference kernels (ground truth; see
SURVEY.md 2.5.1 for the NoFuture_LWSQ4 reference bug).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import build_stencil
from lws_jax.core.stencil import (
    apply_stencil,
    freq_extend,
    make_stencil,
    make_time_halos,
    phase_update,
    split,
    time_extend,
)


def _one_bin_update(golden, W, v, bm, bn):
    """Jacobi sweep with crafted amplitudes: 0.5 everywhere, 2.0 at (bm, bn)."""
    sr, si = split(golden.S, dtype=jnp.float64)
    T, F = sr.shape
    Q = int(golden.Q)
    L = int(golden.L)
    st = make_stencil(build_stencil(W, F), Q, L, v=v, dtype=jnp.float64)
    amp = jnp.full((T, F), 0.5).at[bm, bn].set(2.0)
    er, ei = freq_extend(sr, si, L)
    top_r, bot_r = make_time_halos(er, Q)
    top_i, bot_i = make_time_halos(ei, Q)
    tr, ti = apply_stencil(time_extend(er, top_r, bot_r), time_extend(ei, top_i, bot_i), st)
    out_r, out_i = phase_update(tr, ti, amp, sr, si, 1.0)
    return np.asarray(out_r) + 1j * np.asarray(out_i)


def test_single_bin_batch(golden):
    Q = int(golden.Q)
    for i, (bm, bn) in enumerate(golden.sb_mn):
        out = _one_bin_update(golden, golden.W, v=Q - 1, bm=bm, bn=bn)
        np.testing.assert_allclose(
            out[bm, bn], golden.sb_batch[i], rtol=1e-10, atol=1e-12,
            err_msg=f"batch single-bin {i} at ({bm},{bn})")


def test_single_bin_nofuture(golden):
    for i, (bm, bn) in enumerate(golden.sb_mn):
        out = _one_bin_update(golden, golden.W_ai, v=-1, bm=bm, bn=bn)
        np.testing.assert_allclose(
            out[bm, bn], golden.sb_nofuture[i], rtol=1e-10, atol=1e-12,
            err_msg=f"nofuture single-bin {i} at ({bm},{bn})")


def test_single_bin_asym_visibility(golden):
    """Asym updates with the reference's rframe/cframe gating == dr<=v masking."""
    if "asym_cases" not in golden:
        pytest.skip("summarized-weight configs only")
    Q = int(golden.Q)
    for (Mu, M0, bm, bn), val in zip(golden.asym_cases, golden.asym_vals):
        j = int(bm)  # updated frames are 0..Mu-1; bm < Mu by construction
        raw = int(M0) - j
        v = min(raw - 1, Q - 1) if raw >= 1 else -1
        out = _one_bin_update(golden, golden.W_af, v=v, bm=bm, bn=bn)
        np.testing.assert_allclose(
            out[bm, bn], val, rtol=1e-10, atol=1e-12,
            err_msg=f"asym M={Mu} M0={M0} bin=({bm},{bn}) v={v}")


def test_untouched_bins_stay(golden_q4):
    g = golden_q4
    out = _one_bin_update(g, g.W, v=int(g.Q) - 1, bm=3, bn=7)
    mask = np.ones(out.shape, bool)
    mask[3, 7] = False
    np.testing.assert_array_equal(out[mask], np.asarray(g.S)[mask])
