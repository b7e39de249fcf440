"""The native C++ oracle vs reference goldens, and JAX kernels vs the oracle.

Chain of trust: reference C build -> golden vectors -> C++ oracle (exact) ->
JAX/Pallas kernels (exact where order coincides, quality elsewhere).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import LWS, get_thresholds
from lws_jax import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="g++ oracle unavailable")


def test_oracle_matches_reference_batch(golden):
    """Full 100-iteration batch run must match the reference C core closely.

    Both are float64 Gauss-Seidel raster sweeps; tiny divergences from
    accumulation-order differences are amplified by near-zero |temp| bins, so
    the criterion is quality equality + overwhelming elementwise agreement.
    """
    A = np.abs(golden.S).astype(np.complex128)
    out = oracle.oracle_sweeps(A, golden.W, get_thresholds(100, 100, 0.1, 1))
    ref = golden.batch_i100.astype(np.complex128)
    p = LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L), dtype=jnp.float64)
    c_o = float(np.asarray(p.get_consistency(out)))
    assert abs(c_o - float(golden.consistency_batch)) < 0.15
    # elementwise agreement decays with iterations (accumulation-order fp
    # noise amplified by near-zero |temp| normalisations); the single-sweep
    # test below is the exactness check
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.90, close.mean()


def test_oracle_matches_reference_batch_single_iter(golden):
    """One sweep at threshold 0 is a deterministic raster pass: near-exact."""
    A = np.abs(golden.S).astype(np.complex128)
    out = oracle.oracle_sweeps(A, golden.W, np.zeros(1))
    ref = golden.batch_i1_t0.astype(np.complex128)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_oracle_matches_reference_nofuture(golden):
    A = np.abs(golden.S).astype(np.complex128)
    out = oracle.oracle_sweeps(A, golden.W_ai, get_thresholds(1, 1, 0.1, 1), visibility=-1)
    ref = golden.nofuture_i1_anyq.astype(np.complex128)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_oracle_matches_reference_online(golden):
    """The oracle's RTISI-LA sequencing reproduces TF_RTISI_LA."""
    ref_in = golden.nofuture_i1.astype(np.complex128)
    out = oracle.oracle_online(ref_in, golden.W, golden.W_ai, golden.W_af,
                               get_thresholds(10, 1, 0.1, 1), LA=3)
    ref = golden.online_i10.astype(np.complex128)
    p = LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L), dtype=jnp.float64)
    c_o = float(np.asarray(p.get_consistency(out)))
    assert abs(c_o - float(golden.consistency_online)) < 0.2, c_o
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.60, close.mean()


def test_oracle_online_deterministic_exact(golden):
    """Short-horizon TF_RTISI_LA sequencing, bit-comparable: 8 frames,
    1 iteration, threshold 0, LA=2, float64. The oracle shares the
    reference's raster update order, so any real sequencing divergence
    (frame-commit interleaving, init/look-ahead/newest ordering,
    lwslib.cpp:1424-1492) shows up far above fp noise."""
    out = oracle.oracle_online(golden.online_det_in, golden.W, golden.W_ai,
                               golden.W_af, np.zeros(1), LA=2)
    np.testing.assert_allclose(out, golden.online_det_out, rtol=1e-9, atol=1e-11)


def test_jax_online_deterministic_exact(golden):
    """JAX rtisi_la vs the reference on the sparse-magnitude golden: one
    active (threshold-passing) bin per frame means no in-frame update-order
    dependence, so the vectorized kernel must reproduce the reference's
    cross-frame commit sequencing to fp precision."""
    p = LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L),
            look_ahead=2, dtype=jnp.float64)
    out = np.asarray(p.online_lws(golden.online_sparse_in,
                                  thresholds=golden.online_sparse_thr))
    np.testing.assert_allclose(out, golden.online_sparse_out,
                               rtol=1e-9, atol=1e-10)


def _bench_mixture(n, sr_hz, seed):
    """The bench.py make_batch mixture (tone+chirp+noise), replicated here
    so the oracle anchoring runs on the same signal class the benchmarks
    measure (BASELINE.json configs)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr_hz
    return (0.5 * np.sin(2 * np.pi * 240 * t)
            + 0.3 * np.sin(2 * np.pi * 1128 * t)
            + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
            + 0.05 * rng.standard_normal(n))


def test_bench_scale_batch_anchored_to_oracle():
    """Quality anchoring at the BENCH geometry, not just the toy goldens:
    one 5 s / 16 kHz utterance (T=628, F=257), the full 100-iteration batch
    schedule, float64. The default batch path must land at or above the
    float64 oracle's consistency (in-frame re-passes close the in-frame
    raster gap, QUALITY.md 'bench-scale anchoring')."""
    p = LWS(512, 128, dtype=jnp.float64)
    A = np.abs(p.stft(_bench_mixture(80000, 16000, 0))).astype(np.complex128)
    assert A.shape[0] > 600  # really the bench geometry
    thr = get_thresholds(100, 100, 0.1, 1)
    out_j = np.asarray(p.batch_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W, thr)
    c_j = float(np.asarray(p.get_consistency(out_j)))
    c_c = float(np.asarray(p.get_consistency(out_c)))
    assert c_j > c_c - 0.25, (c_j, c_c)
    np.testing.assert_allclose(np.abs(out_j), np.abs(A), atol=1e-8)


def test_longform_slice_anchored_to_oracle():
    """Long-form geometry slice (F=2049, Q=4, 4096/1024 at 48 kHz): the
    default batch path vs the float64 oracle on a ~10 s slice. Anchors the
    longform bench config's consistency scale (QUALITY.md); the full-length
    T=2019 anchor at 100 iterations is recorded there from the same
    harness."""
    p = LWS(4096, 1024, dtype=jnp.float64)
    x = _bench_mixture(int(11.0 * 48000), 48000, 4)
    A = np.abs(p.stft(x)).astype(np.complex128)
    assert A.shape[-1] == 2049
    thr = get_thresholds(30, 100, 0.1, 1)
    out_j = np.asarray(p.batch_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W, thr)
    c_j = float(np.asarray(p.get_consistency(out_j)))
    c_c = float(np.asarray(p.get_consistency(out_c)))
    assert c_j > c_c - 0.25, (c_j, c_c)


def test_vocoder_scale_q8_anchored_to_oracle():
    """Q=8 bench-scale anchoring (the vocoder stencil, 2048/256, T=223,
    F=1025, full 100-iteration schedule, float64): the default batch path
    (inner_passes=1 at Q=8 — no in-frame raster gap measured, QUALITY.md)
    must track the oracle's consistency."""
    p = LWS(2048, 256, dtype=jnp.float64)
    A = np.abs(p.stft(_bench_mixture(int(2.5 * 22050), 22050, 3))
               ).astype(np.complex128)
    assert A.shape == (223, 1025)
    thr = get_thresholds(100, 100, 0.1, 1)
    out_j = np.asarray(p.batch_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W, thr)
    c_j = float(np.asarray(p.get_consistency(out_j)))
    c_c = float(np.asarray(p.get_consistency(out_c)))
    assert c_j > c_c - 0.25, (c_j, c_c)
    np.testing.assert_allclose(np.abs(out_j), np.abs(A), atol=1e-8)


def test_jax_nofuture_matches_oracle_fresh_config():
    """A config with no golden: oracle and JAX agree exactly on no-future
    (strictly-past taps -> identical update order)."""
    p = LWS(320, 80, L=3, dtype=jnp.float64)  # Q=4, fresh geometry
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4000)
    S = p.stft(x)
    A = np.abs(S).astype(np.complex128)
    thr = get_thresholds(2, 1, 0.1, 1)
    out_j = np.asarray(p.nofuture_lws(A, thresholds=thr))
    out_o = oracle.oracle_online  # noqa: avoid unused warning style
    out_c = oracle.oracle_sweeps(A, p.W_ai, thr, visibility=-1)
    np.testing.assert_allclose(out_j, out_c, rtol=1e-6, atol=1e-8)


def test_jax_batch_quality_matches_oracle_fresh_config():
    p = LWS(384, 96, L=4, dtype=jnp.float64)  # Q=4
    rng = np.random.default_rng(8)
    x = rng.standard_normal(6000)
    S = p.stft(x)
    A = np.abs(S).astype(np.complex128)
    thr = get_thresholds(50, 100, 0.1, 1)
    out_j = np.asarray(p.batch_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W, thr)
    c_j = float(np.asarray(p.get_consistency(out_j)))
    c_c = float(np.asarray(p.get_consistency(out_c)))
    assert c_j > c_c - 0.5, (c_j, c_c)


def test_fftsize_padding_matches_oracle():
    """fftsize > fsize: windows are zero-padded symmetrically
    (python/lws.pyx:399-410); validate the whole path against the oracle."""
    p = LWS(384, 96, L=3, fftsize=512, dtype=jnp.float64)
    assert p.fsize == 512 and p.fftsize == 512  # windows padded to fftsize
    assert np.all(p.awin[:64] == 0) and np.all(p.awin[-64:] == 0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(5000)
    S = p.stft(x)
    A = np.abs(S).astype(np.complex128)
    thr = get_thresholds(2, 1, 0.1, 1)
    out_j = np.asarray(p.nofuture_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W_ai, thr, visibility=-1)
    np.testing.assert_allclose(out_j, out_c, rtol=1e-6, atol=1e-8)
    # batch quality parity vs oracle on this config
    out_jb = np.asarray(p.batch_lws(A, thresholds=get_thresholds(30, 100, 0.1, 1)))
    out_cb = oracle.oracle_sweeps(A, p.W, get_thresholds(30, 100, 0.1, 1))
    c_j = float(np.asarray(p.get_consistency(out_jb)))
    c_c = float(np.asarray(p.get_consistency(out_cb)))
    assert c_j > c_c - 0.5, (c_j, c_c)


def test_custom_window_matches_oracle():
    """User-provided analysis window (array constructor arg)."""
    win = np.hamming(256)
    p = LWS(np.sqrt(win), 64, L=4, dtype=jnp.float64)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(4000)
    A = np.abs(p.stft(x)).astype(np.complex128)
    thr = get_thresholds(1, 1, 0.1, 1)
    out_j = np.asarray(p.nofuture_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W_ai, thr, visibility=-1)
    np.testing.assert_allclose(out_j, out_c, rtol=1e-6, atol=1e-8)


def test_fuzz_random_geometries_vs_oracle():
    """Property fuzz: random window/shift/L geometries, JAX no-future must
    equal the oracle exactly and batch must match its quality."""
    rng = np.random.default_rng(42)
    cases = [(256, 64, 2), (320, 80, 5), (512, 256, 3), (448, 112, 4),
             (384, 128, 1), (512, 160, 3)]  # incl. fractional 512/160
    for fsize, fshift, L in cases:
        p = LWS(fsize, fshift, L=L, dtype=jnp.float64)
        x = rng.standard_normal(3500)
        A = np.abs(p.stft(x)).astype(np.complex128)
        thr = get_thresholds(1, 1, 0.1, 1)
        out_j = np.asarray(p.nofuture_lws(A, thresholds=thr))
        out_c = oracle.oracle_sweeps(A, p.W_ai, thr, visibility=-1)
        np.testing.assert_allclose(out_j, out_c, rtol=1e-6, atol=1e-8,
                                   err_msg=f"{fsize}/{fshift}/L{L}")


def test_xla_fallback_quality_at_unfittable_geometry(monkeypatch):
    """Q=32 (past the GPU kernels' MAX_Q=8): on a GPU the batch path runs
    the exact frame-sequential XLA scan (no order substitution, no warning)
    and lands on the float64 Gauss-Seidel oracle's consistency."""
    import warnings as _w
    import lws_jax.device as dev
    from lws_jax.ops import MAX_Q

    p = LWS(256, 8, L=3, dtype=jnp.float64)  # Q=32 > MAX_Q
    assert p._Qi > MAX_Q
    rng = np.random.default_rng(13)
    x = rng.standard_normal(1200)
    A = np.abs(p.stft(x)).astype(np.complex128)
    thr = get_thresholds(20, 100, 0.1, 1)

    monkeypatch.setattr(dev, "gpu_available", lambda: True)
    assert not p._use_kernel(A.shape[-1])
    with _w.catch_warnings():
        _w.simplefilter("error")
        out_j = np.asarray(p.batch_lws(A, thresholds=thr))
    monkeypatch.undo()

    out_c = oracle.oracle_sweeps(A, p.W, thr)
    c_j = float(np.asarray(p.get_consistency(out_j)))
    c_c = float(np.asarray(p.get_consistency(out_c)))
    assert abs(c_j - c_c) < 1.5, (c_j, c_c)
    np.testing.assert_allclose(np.abs(out_j), np.abs(A), atol=1e-8)


def test_use_simplifications_false_matches_oracle():
    """use_simplifications=False builds per-bin (Qprime=fsize) weight rows
    even for integer Q (python/lws.pyx:166-169); full-path check vs oracle."""
    p = LWS(256, 64, L=3, use_simplifications=False, dtype=jnp.float64)
    assert p.W.shape[0] == 256  # Qprime == fsize
    rng = np.random.default_rng(21)
    x = rng.standard_normal(3000)
    A = np.abs(p.stft(x)).astype(np.complex128)
    thr = get_thresholds(1, 1, 0.1, 1)
    out_j = np.asarray(p.nofuture_lws(A, thresholds=thr))
    out_c = oracle.oracle_sweeps(A, p.W_ai, thr, visibility=-1)
    np.testing.assert_allclose(out_j, out_c, rtol=1e-6, atol=1e-8)
    # summarized and full weights give numerically equivalent updates
    ps = LWS(256, 64, L=3, dtype=jnp.float64)
    out_s = np.asarray(ps.nofuture_lws(A, thresholds=thr))
    np.testing.assert_allclose(out_j, out_s, rtol=1e-8, atol=1e-9)
