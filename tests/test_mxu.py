"""Matmul-order Jacobi sweeps (`order="jacobi_mxu"`): the banded-matmul
formulation of apply_stencil (core/stencil.py::apply_stencil_mxu).

Same math as order="jacobi" with the frequency taps cast as
(T, F+2L) @ (F+2L, F) band matmuls so the matrix units do the FLOPs.
Semantics are anchored by float64 agreement
with the elementwise path; reference role: the same whole-grid update the
reference's batch sweep applies frame-by-frame (lwslib.cpp:283-373), in
Jacobi order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lws_jax import LWS, get_thresholds
from lws_jax.core.batch import lws_sweeps


def _mk(seed, B=2, T=50, F=257):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((B, T, F)) + 1j * rng.standard_normal((B, T, F))
    return jnp.asarray(S.real), jnp.asarray(S.imag)


@pytest.mark.parametrize("stage", ["batch", "nofuture"])
def test_mxu_matches_elementwise_jacobi_f64(stage):
    """float64: banded-matmul sweeps == elementwise Jacobi sweeps to 1e-9
    (same math, matmul accumulation order), for the batch and the
    visibility-masked no-future stencils."""
    p = LWS(512, 128, dtype=jnp.float64)
    st = p._st_batch if stage == "batch" else p._st_nofuture
    sr, si = _mk(0)
    thr = jnp.asarray(get_thresholds(5, 1, 0.1, 1))
    a = lws_sweeps(sr, si, st, thr, order="jacobi")
    b = lws_sweeps(sr, si, st, thr, order="jacobi_mxu", precision="highest")
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=1e-9)


def test_mxu_fractional_q_per_bin_rows():
    """Fractional frame shifts give per-bin weight rows; the band matrices
    are built per bin and must reproduce the elementwise path exactly."""
    p = LWS(500, 160, dtype=jnp.float64)  # Q = 500/160 fractional
    sr, si = _mk(1, F=p._st_batch.n_bins)
    thr = jnp.asarray(get_thresholds(4, 1, 0.1, 1))
    a = lws_sweeps(sr, si, p._st_batch, thr, order="jacobi")
    b = lws_sweeps(sr, si, p._st_batch, thr, order="jacobi_mxu",
                   precision="highest")
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-9)


def test_mxu_band_cache_is_trace_safe():
    """band_mats may first be called inside a jit trace: the cached arrays
    must be reusable across later traces (numpy constants, not leaked
    tracers — regression for an UnexpectedTracerError)."""
    import functools
    p = LWS(512, 128, dtype=jnp.float64)
    sr, si = _mk(2)
    for iters in (2, 3):  # two different traces sharing the stencil cache
        thr = jnp.asarray(get_thresholds(iters, 1, 0.1, 1))
        fn = jax.jit(functools.partial(lws_sweeps, st=p._st_batch,
                                       order="jacobi_mxu"))
        out = fn(sr, si, thresholds=thr)
        assert np.all(np.isfinite(np.asarray(out[0])))


def test_mxu_precision_knob_plumbs_through():
    """LWS(precision=...) reaches the XLA sweep partials (the knob that
    controls the jacobi_mxu matmul accuracy)."""
    p = LWS(512, 128, order="jacobi_mxu", precision="highest")
    assert p._batch_xla.__wrapped__.keywords["precision"] == "highest"
    assert p._nofuture_xla.__wrapped__.keywords["precision"] == "highest"


def test_mxu_sharded_matches_unsharded():
    """order='jacobi_mxu' composes with the time-sharded halo-exchange path
    (pure XLA: shard_map needs no extra plumbing) — sharded result matches
    the unsharded sweeps."""
    from lws_jax.parallel import make_mesh, shard_pair, sharded_lws_sweeps
    p = LWS(512, 128, dtype=jnp.float64)
    sr, si = _mk(4, B=2, T=64)
    thr = jnp.asarray(get_thresholds(3, 1, 0.1, 1))
    want = lws_sweeps(sr, si, p._st_batch, thr, order="jacobi_mxu")
    mesh = make_mesh(data=2, time=4)
    pair = shard_pair((sr, si), mesh, time_sharded=True)
    got = sharded_lws_sweeps(*pair, st=p._st_batch, thresholds=thr,
                             mesh=mesh, order="jacobi_mxu",
                             sweeps_per_exchange=1)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=1e-9)


def test_mxu_order_runs_the_xla_path(monkeypatch):
    """order='jacobi_mxu' is an XLA-path order: the processor never routes
    it to the GPU kernels (which run the "gs" order only), even where they
    apply, and its precision reaches the matmuls."""
    p = LWS(512, 128, order="jacobi_mxu", precision="highest",
            dtype=jnp.float32, interpret=True)
    assert not p._use_kernel(257)
    calls = []
    real = p._batch_xla
    monkeypatch.setattr(p, "_batch_xla", lambda sr, si, thresholds, **kw:
                        calls.append(kw) or real(sr, si, thresholds=thresholds,
                                                 **kw))
    sr, si = _mk(5, B=1, T=24, F=257)
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1), jnp.float32)
    out = p._batch_fn(jnp.asarray(sr, jnp.float32),
                      jnp.asarray(si, jnp.float32), thresholds=thr)
    assert calls == [{}]
    assert real.__wrapped__.keywords["order"] == "jacobi_mxu"
    assert real.__wrapped__.keywords["precision"] == "highest"
    want = lws_sweeps(jnp.asarray(sr, jnp.float32),
                      jnp.asarray(si, jnp.float32), p._st_batch, thr,
                      order="jacobi_mxu", precision="highest")
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(want[0]),
                               atol=1e-5)


def test_mxu_processor_end_to_end():
    """LWS(order='jacobi_mxu') runs the full batch stage: magnitudes
    preserved, consistency in the same band as the elementwise Jacobi
    order (identical semantics)."""
    p = LWS(512, 128, order="jacobi_mxu", dtype=jnp.float64)
    pj = LWS(512, 128, order="jacobi", dtype=jnp.float64)
    rng = np.random.default_rng(3)
    t = np.arange(16000) / 16000.0
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(16000)
    A = np.abs(p.stft(x)).astype(np.complex128)
    thr = get_thresholds(20, 100, 0.1, 1)
    out = np.asarray(p.batch_lws(A, thresholds=thr))
    out_j = np.asarray(pj.batch_lws(A, thresholds=thr))
    np.testing.assert_allclose(np.abs(out), np.abs(A), atol=1e-9)
    c = float(np.asarray(p.get_consistency(out)))
    c_j = float(np.asarray(pj.get_consistency(out_j)))
    assert abs(c - c_j) < 1e-6, (c, c_j)
