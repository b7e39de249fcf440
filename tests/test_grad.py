"""Differentiability of the XLA sweep paths (backend="xla").

The reference is a C library with no gradient story; lws_jax's XLA-order
sweeps are pure jnp, so `jax.grad` flows end-to-end — magnitude in,
recovered phase out — enabling training losses through phase recovery
(e.g. a TTS vocoder fine-tuned against time-domain reconstructions).

The numerical hazard is the phase update's `sqrt` at exactly-zero bins
(silence / padded frames): d(sqrt)/dx at 0 is inf, and a plain
`jnp.where(a > 0, ...)` still back-propagates 0*inf = NaN through the
unselected branch. `core.stencil.phase_update` and the amp computation in
`core.batch/online` use the double-`where` guard (forward bit-identical —
the golden exact suites pin that) so every gradient below must be finite.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lws_jax import LWS, get_thresholds


def _mag_with_zeros(proc, B=2, secs=0.35, sr_hz=8000):
    """Magnitudes of a batch whose signals start/end in exact silence, so
    the spectrograms contain exactly-zero frames (the grad hazard)."""
    rng = np.random.default_rng(11)
    n = int(secs * sr_hz)
    x = np.zeros((B, n))
    t = np.arange(n // 2) / sr_hz
    x[:, n // 4:n // 4 + n // 2] = (
        np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal((B, n // 2)))
    sr, si = proc.stft_ri(x)
    sq = sr * sr + si * si
    amp = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1)), 0.0)
    assert float(jnp.sum(amp == 0)) > 0, "fixture must contain zero bins"
    return amp


def _grad_of_sweeps(proc, amp, iters=3, alpha=100.0):
    thr = jnp.asarray(get_thresholds(iters, alpha, 0.1, 1), dtype=proc.rdtype)

    def loss(a):
        out_r, out_i = proc._batch_fn(a, jnp.zeros_like(a), thresholds=thr)
        return jnp.sum(out_r ** 2 + out_i ** 2)

    return jax.grad(loss)(amp)


@pytest.mark.parametrize("order", ["jacobi", "jacobi_mxu", "gs"])
def test_batch_grad_finite(order):
    proc = LWS(128, 32, backend="xla", order=order)
    amp = _mag_with_zeros(proc)
    g = _grad_of_sweeps(proc, amp)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0


def test_gs_quality_knobs_grad_finite():
    proc = LWS(128, 32, backend="xla", order="gs", inner_passes=3,
               inner_scheme="color2x3")
    amp = _mag_with_zeros(proc)
    g = _grad_of_sweeps(proc, amp, iters=2)
    assert np.all(np.isfinite(np.asarray(g)))


def test_online_grad_finite():
    proc = LWS(128, 32, backend="xla", look_ahead=2, online_iterations=2)
    amp = _mag_with_zeros(proc)
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1), dtype=proc.rdtype)

    def loss(a):
        out_r, out_i = proc._online_fn(a, jnp.zeros_like(a), thresholds=thr)
        return jnp.sum(out_r ** 2 + out_i ** 2)

    g = jax.grad(loss)(amp)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0


def test_grad_to_waveform_loss():
    """End-to-end: d(time-domain L2)/d(magnitude) through sweeps + iSTFT —
    the shape of a vocoder training loss."""
    proc = LWS(128, 32, backend="xla", order="jacobi")
    rng = np.random.default_rng(3)
    n = 2000
    x = np.zeros((1, n))
    x[:, 400:1600] = np.sin(2 * np.pi * 330 * np.arange(1200) / 8000)
    sr, si = proc.stft_ri(x)
    target = proc.istft((sr, si))
    amp = jnp.sqrt(jnp.maximum(sr * sr + si * si, 1e-30))
    thr = jnp.asarray(get_thresholds(2, 100, 0.1, 1), dtype=proc.rdtype)

    def loss(a):
        out_r, out_i = proc._batch_fn(a, jnp.zeros_like(a), thresholds=thr)
        y = proc.istft((out_r, out_i))
        m = min(y.shape[-1], target.shape[-1])
        return jnp.mean((y[..., :m] - target[..., :m]) ** 2)

    val, g = jax.value_and_grad(loss)(amp)
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0


def test_phase_update_guard_forward_identity():
    """The double-where guard changes no forward value: compare against the
    naive unguarded formula on strictly-positive data, and check the
    zero-sum case keeps the old value exactly."""
    from lws_jax.core.stencil import phase_update
    rng = np.random.default_rng(5)
    tr = jnp.asarray(rng.standard_normal((4, 8)))
    ti = jnp.asarray(rng.standard_normal((4, 8)))
    amp = jnp.asarray(np.abs(rng.standard_normal((4, 8))) + 0.1)
    old_r = jnp.asarray(rng.standard_normal((4, 8)))
    old_i = jnp.asarray(rng.standard_normal((4, 8)))
    out_r, out_i = phase_update(tr, ti, amp, old_r, old_i, 0.0)
    # unguarded form, same op order (rsqrt epilogue)
    scale = amp * jax.lax.rsqrt(tr * tr + ti * ti)
    np.testing.assert_array_equal(np.asarray(out_r), np.asarray(tr * scale))
    np.testing.assert_array_equal(np.asarray(out_i), np.asarray(ti * scale))
    # and stays within float tolerance of the reference's sqrt+divide form
    ref = amp / jnp.sqrt(tr * tr + ti * ti)
    np.testing.assert_allclose(np.asarray(scale), np.asarray(ref), rtol=1e-12)
    # zero weighted sum -> keep old value bit-for-bit (lwslib.cpp:133-137)
    zr, zi = phase_update(jnp.zeros_like(tr), jnp.zeros_like(ti), amp,
                          old_r, old_i, 0.0)
    np.testing.assert_array_equal(np.asarray(zr), np.asarray(old_r))
    np.testing.assert_array_equal(np.asarray(zi), np.asarray(old_i))
