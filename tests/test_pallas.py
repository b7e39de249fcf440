"""GPU sweep kernels (ops/gpu_sweeps.py) vs the XLA reference path, run in
the Pallas interpreter on the CPU, plus the processor's dispatch rule."""
import warnings

import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import LWS, get_thresholds
from lws_jax.core.batch import lws_sweeps
from lws_jax.core.online import rtisi_la
from lws_jax.core.stencil import merge, split
# imported from the package surface deliberately: lws_jax.ops must export
# the production kernels the processor actually runs
from lws_jax.ops import (MAX_BINS, MAX_Q, gs_sweeps, kernel_supported,
                         online_chunk, online_chunk_init, online_sweeps,
                         segmented_gs_sweeps)
from lws_jax.ops.gpu_sweeps import weight_table


def _setup(golden, dtype=jnp.float32, max_t=None):
    # pin inner_scheme=jacobi: these tests compare kernels against the XLA
    # path at IDENTICAL update order (the color-scheme parity has its own
    # test below and in test_sharding)
    p = LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L), dtype=dtype,
            inner_scheme="jacobi")
    A = np.abs(golden.S).astype(np.complex64)
    if max_t is not None:
        A = A[:max_t]
    return p, A, split(A, dtype=dtype)


def _gs(pair, st, thr, **kw):
    return gs_sweeps(*pair, st, thr, interpret=True, **kw)


def _online(p, pair, thr, **kw):
    return online_sweeps(*pair, p._st_la, p._st_nofuture, p._st_af, thr,
                         interpret=True, **kw)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=atol)


def test_kernel_matches_xla_gs(golden):
    """The batch kernel reproduces the frame-sequential Gauss-Seidel order:
    same consistency trajectory as the XLA "gs" path on every golden
    config (f32), and float64 agreement to roundoff."""
    p, A, pair = _setup(golden)
    thr = jnp.asarray(get_thresholds(12, 100, 0.1, 1), dtype=jnp.float32)
    out_p = merge(*_gs(pair, p._st_batch, thr,
                       inner_passes=p.batch_inner_passes,
                       inner_scheme=p.inner_scheme))
    out_x = np.asarray(p.batch_lws(A, thresholds=np.asarray(thr)))
    c_p = float(np.asarray(p.get_consistency(out_p)))
    c_x = float(np.asarray(p.get_consistency(out_x)))
    assert abs(c_p - c_x) < 0.25, (c_p, c_x)

    p64, _, pair64 = _setup(golden, dtype=jnp.float64, max_t=24)
    thr64 = jnp.asarray(get_thresholds(3, 1, 0.1, 1))
    ref = lws_sweeps(*pair64, st=p64._st_batch, thresholds=thr64, order="gs",
                     inner_passes=p64.batch_inner_passes)
    _close(_gs(pair64, p64._st_batch, thr64,
               inner_passes=p64.batch_inner_passes), ref, 1e-8)


@pytest.mark.parametrize("stage", ["batch", "nofuture"])
def test_kernel_short_run_is_exact(golden_q4, stage):
    """Over a few sweeps the kernel matches the XLA gs path numerically."""
    p, A, pair = _setup(golden_q4)
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1), dtype=jnp.float32)
    if stage == "batch":
        out_p = merge(*_gs(pair, p._st_batch, thr,
                           inner_passes=p.batch_inner_passes))
        out_x = np.asarray(p.batch_lws(A, thresholds=np.asarray(thr)))
    else:
        out_p = merge(*_gs(pair, p._st_nofuture, thr))
        out_x = np.asarray(p.nofuture_lws(A, thresholds=np.asarray(thr)))
    np.testing.assert_allclose(out_p, out_x, atol=2e-3)


def test_kernel_quality_and_magnitudes(golden):
    """Dense sweeps converge (+5 dB over the zero-phase input; Q=2 couples
    every frame to its direct neighbour and is held to a weaker bar) and
    magnitudes are preserved exactly."""
    p, A, pair = _setup(golden)
    thr = jnp.asarray(get_thresholds(15, 1, 0.1, 1), dtype=jnp.float32)
    out = merge(*_gs(pair, p._st_batch, thr))
    c = float(np.asarray(p.get_consistency(out)))
    c0 = float(np.asarray(p.get_consistency(A)))
    assert c > c0 + (3.5 if int(golden.Q) == 2 else 5), (c, c0)
    np.testing.assert_allclose(np.abs(out), np.abs(A), atol=1e-4)


@pytest.mark.parametrize("kernel", ["gs", "online"])
def test_batched_grid(golden_q4, kernel):
    """One program per utterance: batched results equal single runs, and
    the iteration is scale-invariant (thresholds scale with mean amp)."""
    p, A, _ = _setup(golden_q4, max_t=40)
    Ab = np.stack([A, 0.5 * A, 2 * A])
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1), dtype=jnp.float32)
    if kernel == "gs":
        def run(x):
            return merge(*_gs(split(x, dtype=jnp.float32), p._st_batch, thr))
    else:
        def run(x):
            return merge(*_online(p, split(x, dtype=jnp.float32), thr))
    out = run(Ab)
    out0 = run(A)
    np.testing.assert_allclose(out[0], out0, atol=1e-6)
    if kernel == "gs":
        np.testing.assert_allclose(out[1], 0.5 * out0, atol=1e-5)
    np.testing.assert_allclose(np.abs(out[2]), 2 * np.abs(A), atol=1e-4)


def test_kernel_shape_rule():
    """kernel_supported is the kernels' shape rule, and the processor's one
    dispatch function applies it with the order and dtype conditions."""
    assert kernel_supported(257, 4) and kernel_supported(2049, 4)
    assert kernel_supported(1025, 8) and kernel_supported(MAX_BINS, MAX_Q)
    assert not kernel_supported(MAX_BINS + 2, 4)
    assert not kernel_supported(257, MAX_Q + 1)
    assert LWS(512, 128, dtype=jnp.float32, interpret=True)._use_kernel(257)
    assert not LWS(512, 128, dtype=jnp.float64,
                   interpret=True)._use_kernel(257)
    assert not LWS(512, 128, dtype=jnp.float32, order="jacobi",
                   interpret=True)._use_kernel(257)
    assert not LWS(256, 8, L=3, dtype=jnp.float32,
                   interpret=True)._use_kernel(129)  # Q=32
    assert not LWS(512, 128, dtype=jnp.float32, interpret=True,
                   backend="xla")._use_kernel(257)
    # on the CPU without interpret mode: the XLA path, never the kernel
    assert not LWS(512, 128, dtype=jnp.float32)._use_kernel(257)


def test_backend_validation(golden_q4):
    g = golden_q4
    A = np.abs(g.S).astype(np.complex64)
    p = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float32,
            backend="gpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        p.batch_lws(A, iterations=1)  # CPU backend -> no kernel, no silent fallback
    with pytest.raises(ValueError, match="backend must be"):
        LWS(512, 128, backend="pallas")
    p64 = LWS(512, 128, dtype=jnp.float64, backend="gpu", interpret=True)
    with pytest.raises(ValueError, match="float32"):
        p64.batch_lws(A, iterations=1)


def test_streamed_online_matches_scan(golden_q4):
    """Online kernel == XLA scan semantics (quality; bitwise divergence grows
    chaotically along the sequential pipeline in f32)."""
    p, A, pair = _setup(golden_q4)
    thr = jnp.asarray(get_thresholds(4, 1, 0.1, 1), dtype=jnp.float32)
    out_p = merge(*_online(p, pair, thr))
    out_x = merge(*p._online_xla(*pair, thresholds=thr))
    c_p = float(np.asarray(p.get_consistency(out_p)))
    c_x = float(np.asarray(p.get_consistency(out_x)))
    assert abs(c_p - c_x) < 0.5, (c_p, c_x)
    # early frames agree tightly before chaotic divergence sets in
    np.testing.assert_allclose(out_p[:6], np.asarray(out_x)[:6], atol=1e-3)
    np.testing.assert_allclose(np.abs(out_p), np.abs(A), atol=1e-4)


def test_streamed_online_batched(golden_q4):
    p, A, _ = _setup(golden_q4)
    Ab = np.stack([A, 0.3 * A])
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1), dtype=jnp.float32)
    out = merge(*_online(p, split(Ab, dtype=jnp.float32), thr))
    out0 = merge(*_online(p, split(A, dtype=jnp.float32), thr))
    np.testing.assert_allclose(out[0], out0, atol=1e-6)
    np.testing.assert_allclose(np.abs(out[1]), 0.3 * np.abs(A), atol=1e-4)
    c = np.asarray(p.get_consistency((jnp.asarray(out.real, jnp.float32),
                                      jnp.asarray(out.imag, jnp.float32))))
    assert abs(c[0] - c[1]) < 0.5, c


def test_color_scheme_kernels_match_xla(golden):
    """inner_scheme='color2x3' (the Q<=3 default): batch and online kernels
    reproduce the XLA red-black in-frame order (f64 interpret mode)."""
    if int(golden.Q) > 4:
        pytest.skip("covered by q2/q3/q4 geometries")
    p = LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L),
            dtype=jnp.float64, inner_scheme="color2x3")
    A = np.abs(golden.S).astype(np.complex128)
    pair = split(A, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(2, 100, 0.1, 1))
    out_x = p._batch_xla(*pair, thresholds=thr)
    out_p = _gs(pair, p._st_batch, thr, inner_scheme="color2x3")
    _close(out_p, out_x, 1e-8)
    thr_on = jnp.asarray(get_thresholds(2, 1, 0.1, 1))
    on_x = merge(*p._online_xla(*pair, thresholds=thr_on))
    on_p = merge(*_online(p, pair, thr_on, inner_scheme="color2x3"))
    # dense online runs amplify accumulation-order fp noise through the
    # sequential pipeline (see test_streamed_online_matches_scan); early
    # frames agree tightly, overall quality matches
    np.testing.assert_allclose(on_p[:4], on_x[:4], rtol=1e-6, atol=1e-7)
    c_p = float(np.asarray(p.get_consistency(on_p)))
    c_x = float(np.asarray(p.get_consistency(on_x)))
    assert abs(c_p - c_x) < 0.3, (c_p, c_x)


def test_kernel_f64_matches_xla_gs(golden_q4):
    """float64: the kernel's order equals the XLA frame-GS order, with the
    default 3 in-frame re-passes at Q=4, on a batch of 3."""
    p, A, _ = _setup(golden_q4, dtype=jnp.float64)
    Ab = np.stack([A * (0.5 + 0.5 * i) for i in range(3)])
    pair = split(Ab, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(5, 1, 0.1, 1), dtype=jnp.float64)
    out_p = merge(*_gs(pair, p._st_batch, thr,
                       inner_passes=p.batch_inner_passes))
    out_x = np.asarray(p.batch_lws(Ab, thresholds=np.asarray(thr)))
    np.testing.assert_allclose(out_p, out_x, atol=1e-9)


def test_online_kernel_quality(golden_q4):
    p, A, _ = _setup(golden_q4)
    Ab = np.stack([A, A * 0.7])
    pair = split(Ab, dtype=jnp.float32)
    thr = jnp.asarray(get_thresholds(3, 1, 0.1, 1), dtype=jnp.float32)
    out = merge(*_online(p, pair, thr))
    out_x = merge(*p._online_xla(*pair, thresholds=thr))
    c = np.asarray(p.get_consistency((jnp.asarray(out.real, jnp.float32),
                                      jnp.asarray(out.imag, jnp.float32))))
    c_x = np.asarray(p.get_consistency(out_x))
    assert np.all(np.abs(c - c_x) < 0.5), (c, c_x)
    np.testing.assert_allclose(np.abs(out), np.abs(Ab), atol=1e-4)


def test_nofuture_kernel_exact(golden_q4):
    """No-future via the kernel: strictly-past taps, matching the reference
    golden of one no-future iteration."""
    p, A, pair = _setup(golden_q4)
    thr = jnp.asarray(get_thresholds(1, 1, 0.1, 1), dtype=jnp.float32)
    out = merge(*_gs(pair, p._st_nofuture, thr))
    ref = golden_q4.nofuture_i1_anyq.astype(np.complex64)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)


def test_kernel_leading_dims(golden_q4):
    """(..., T, F) inputs: any leading batch shape runs as one flat grid."""
    p, A, _ = _setup(golden_q4, dtype=jnp.float64, max_t=24)
    Ab = np.stack([A * (1 + 0.1 * i) for i in range(6)]).reshape(2, 3, 24, -1)
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1))
    pair = split(Ab, dtype=jnp.float64)
    got = _gs(pair, p._st_batch, thr)
    flat = _gs(tuple(x.reshape(6, 24, -1) for x in pair), p._st_batch, thr)
    assert got[0].shape == Ab.shape
    _eq((got[0].reshape(6, 24, -1), got[1].reshape(6, 24, -1)), flat)


@pytest.mark.parametrize("case", ["summarized", "fractional"])
def test_weight_table_period(case):
    """The kernels read each tap's weights from a table indexed by bin mod
    period: summarised weights repeat every Q bins; fractional-Q weights are
    kept per bin. The table reproduces the dense stencil exactly."""
    if case == "summarized":
        p, want = LWS(512, 128), 4
    else:
        p, want = LWS(64, 24), 33  # Q = 8/3: per-bin weight rows
    period, tr, ti = weight_table(p._st_batch)
    assert period == want
    n = np.arange(p._st_batch.n_bins)
    np.testing.assert_array_equal(tr[..., n % period],
                                  np.asarray(p._st_batch.Wr))
    np.testing.assert_array_equal(ti[..., n % period],
                                  np.asarray(p._st_batch.Wi))


def test_segmented_matches_kernel_single_segment(golden_q4):
    """segments=1 degenerates to the plain kernel bit-for-bit (the
    halo/mean-override plumbing is exact)."""
    p, A, pair = _setup(golden_q4, max_t=40)
    thr = jnp.asarray(get_thresholds(4, 100, 0.1, 1), dtype=jnp.float32)
    ref = _gs(pair, p._st_batch, thr)
    out = segmented_gs_sweeps(*pair, st=p._st_batch, thresholds=thr,
                              segments=1, interpret=True)
    _eq(out, ref)


@pytest.mark.parametrize("segments", [2, 4])
def test_segmented_quality_and_magnitudes(golden_q4, segments):
    """Multi-segment (block-Jacobi seams): quality-equivalent to the
    unsegmented sweep, magnitudes exactly preserved, T padding round-trips
    (T=66 is not a multiple of 4)."""
    p, A, pair = _setup(golden_q4)
    thr = jnp.asarray(get_thresholds(15, 100, 0.1, 1), dtype=jnp.float32)
    ref = merge(*_gs(pair, p._st_batch, thr))
    out = merge(*segmented_gs_sweeps(*pair, st=p._st_batch, thresholds=thr,
                                     segments=segments, interpret=True))
    assert out.shape == A.shape
    c_r = float(np.asarray(p.get_consistency(ref)))
    c_s = float(np.asarray(p.get_consistency(out)))
    assert abs(c_s - c_r) < 0.5, (c_s, c_r)
    np.testing.assert_allclose(np.abs(out), np.abs(A), atol=1e-4)


def test_online_chunk_matches_offline_exact(golden_q4):
    """Carried-state streaming entry (online_chunk, fixed mean) == offline
    online_sweeps: any chunking of the frame stream reproduces the offline
    pipeline (lwslib.cpp:1424-1492 semantics streamed through
    StreamingLWS.push_block)."""
    p, A, pair = _setup(golden_q4, dtype=jnp.float64)
    T, F = A.shape[-2:]
    LA = p.look_ahead
    thr = jnp.asarray(get_thresholds(2, p.online_alpha, p.online_beta,
                                     p.online_gamma), dtype=jnp.float64)
    sr, si = pair[0][None], pair[1][None]
    osr, osi = _online(p, (sr, si), thr)
    mean = jnp.mean(jnp.sqrt(sr * sr + si * si), axis=(-2, -1))

    state = online_chunk_init(sr[:, 0], si[:, 0], p._st_la, p._st_af)
    outs = []
    for a, b in [(0, 17), (17, 18), (18, T)]:
        m = jnp.broadcast_to(mean[:, None], (1, b - a))
        cr, ci, state = online_chunk(sr[:, a:b], si[:, a:b], state, m,
                                     p._st_la, p._st_nofuture, p._st_af, thr,
                                     a, interpret=True)
        outs.append((cr, ci))
    z = jnp.zeros((1, LA, F), dtype=sr.dtype)
    m = jnp.broadcast_to(mean[:, None], (1, LA))
    cr, ci, state = online_chunk(z, z, state, m, p._st_la, p._st_nofuture,
                                 p._st_af, thr, T, n_live=0, interpret=True)
    outs.append((cr, ci))
    all_r = jnp.concatenate([o[0] for o in outs], axis=1)[:, LA:LA + T]
    all_i = jnp.concatenate([o[1] for o in outs], axis=1)[:, LA:LA + T]
    _close((all_r, all_i), (osr, osi), 1e-12)


def test_large_q_kernel_matches_xla_gs():
    """Q=MAX_Q (8): the kernel matches the XLA frame-GS order in f64
    interpret mode."""
    proc = LWS(1024, 128, L=3, dtype=jnp.float64)
    assert proc._Qi == MAX_Q
    rng = np.random.default_rng(7)
    F = proc.fftsize // 2 + 1
    amp = np.abs(rng.standard_normal((2, 30, F)))
    sr = jnp.asarray(amp)
    si = jnp.zeros_like(sr)
    thr = jnp.asarray(get_thresholds(2, 100, 0.1, 1), dtype=jnp.float64)
    ref = lws_sweeps(sr, si, st=proc._st_batch, thresholds=thr, order="gs")
    _close(_gs((sr, si), proc._st_batch, thr), ref, 1e-8)


def test_kernel_rejects_beyond_shape_rule():
    """Geometries outside kernel_supported are refused by the kernels
    themselves (the processor routes them to XLA before that)."""
    proc = LWS(256, 8, L=3, dtype=jnp.float64)  # Q=32 > MAX_Q
    sr = jnp.zeros((1, 40, 129))
    thr = jnp.ones((1,))
    with pytest.raises(ValueError, match="Q <="):
        gs_sweeps(sr, sr, proc._st_batch, thr, interpret=True)
    with pytest.raises(ValueError, match="Q <="):
        online_sweeps(sr, sr, proc._st_la, proc._st_nofuture, proc._st_af,
                      thr, interpret=True)


def test_auto_segments_rule():
    """The segment count: up to 8 segments of >= 2048 frames while the
    batch has fewer than 32 programs' worth of utterances; the benchmark
    geometries keep their counts (batch 1, vocoder 1, long-form 8)."""
    proc = LWS(512, 128)
    assert proc._auto_segments(32, 628) == 1
    assert proc._auto_segments(1024, 216) == 1
    assert proc._auto_segments(1, 29532) == 8
    assert proc._auto_segments(2, 16384) == 8
    assert proc._auto_segments(4, 16384) == 8
    assert proc._auto_segments(8, 16384) == 4
    assert proc._auto_segments(16, 16384) == 2
    assert proc._auto_segments(1, 4096) == 2
    assert proc._auto_segments(1, 2000) == 1
    assert LWS(512, 128, auto_segment=False)._auto_segments(1, 29532) == 1


def _spy(proc, monkeypatch):
    calls = []
    for name in ("_batch_gpu", "_batch_seg", "_batch_xla", "_online_gpu",
                 "_online_xla"):
        real = getattr(proc, name)

        def wrapped(*a, _n=name, _r=real, **kw):
            calls.append((_n, kw.get("segments")))
            return _r(*a, **kw)
        monkeypatch.setattr(proc, name, wrapped)
    return calls


def test_dispatch_routes_kernel_and_xla(monkeypatch):
    """_use_kernel decides every stage: the kernel where it applies, the
    XLA scan for backend='xla'."""
    pair = (jnp.ones((2, 20, 257), jnp.float32),) * 2
    thr = jnp.asarray(get_thresholds(1, 1, 0.1, 1), jnp.float32)
    p = LWS(512, 128, dtype=jnp.float32, interpret=True)
    calls = _spy(p, monkeypatch)
    p._batch_fn(*pair, thresholds=thr)
    p._online_fn(*pair, thresholds=thr)
    assert calls == [("_batch_gpu", None), ("_online_gpu", None)]
    px = LWS(512, 128, dtype=jnp.float32, interpret=True, backend="xla")
    calls = _spy(px, monkeypatch)
    px._batch_fn(*pair, thresholds=thr)
    px._online_fn(*pair, thresholds=thr)
    assert calls == [("_batch_xla", None), ("_online_xla", None)]


def test_segmented_dispatch_long_small_batch(monkeypatch):
    """A long small batch on the kernel path runs the segmented kernel with
    the _auto_segments count; auto_segment=False keeps the plain kernel."""
    p = LWS(512, 128, dtype=jnp.float32, interpret=True)
    calls = []
    monkeypatch.setattr(p, "_batch_seg", lambda sr, si, thresholds, **kw:
                        calls.append(("seg", kw["segments"])) or (sr, si))
    monkeypatch.setattr(p, "_batch_gpu", lambda sr, si, thresholds, **kw:
                        calls.append(("gpu", None)) or (sr, si))
    long_pair = (jnp.zeros((1, 4200, 257), jnp.float32),) * 2
    p._batch_fn(*long_pair, thresholds=jnp.ones((1,)))
    assert calls == [("seg", 2)]
    p.auto_segment = False
    p._batch_fn(*long_pair, thresholds=jnp.ones((1,)))
    assert calls[-1] == ("gpu", None)


def test_online_dispatch_uses_kernel_rule(monkeypatch):
    """The online stage follows the same rule as the sweeps: F=2049 / Q=8
    takes the kernel (no separate fit gate), Q beyond MAX_Q takes XLA."""
    p = LWS(4096, 512, L=5, dtype=jnp.float32, look_ahead=1, interpret=True)
    assert p._use_kernel(2049)
    calls = []
    monkeypatch.setattr(p, "_online_gpu", lambda sr, si, thresholds:
                        calls.append("gpu") or (sr, si))
    pair = (jnp.zeros((1, 8, 2049)),) * 2
    p._online_fn(*pair, thresholds=jnp.ones((1,)))
    assert calls == ["gpu"]


def test_xla_path_is_silent(monkeypatch):
    """A configuration outside the kernels' shape rule runs the exact XLA
    scan on a GPU without warnings (no order substitution)."""
    import lws_jax.device as dev
    monkeypatch.setattr(dev, "gpu_available", lambda: True)
    p = LWS(144, 16, L=1, dtype=jnp.float32)  # Q=9
    assert p._Qi == MAX_Q + 1 and not p._use_kernel(73)
    sr = jnp.asarray(np.abs(np.random.default_rng(0).standard_normal(
        (1, 20, 73))), jnp.float32)
    thr = jnp.asarray(get_thresholds(1, 1, 0.1, 1), jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = p._batch_fn(sr, jnp.zeros_like(sr), thresholds=thr)
    ref = p._batch_xla(sr, jnp.zeros_like(sr), thresholds=thr)
    _eq(out, ref)


def test_processor_kernel_partials():
    """The processor's kernel partials carry its schedule: batch in-frame
    passes and scheme, the online scheme, and the interpret flag."""
    p = LWS(512, 128, dtype=jnp.float32, interpret=True)
    kw = p._batch_gpu.__wrapped__.keywords
    assert kw["inner_passes"] == p.batch_inner_passes == 3
    assert kw["inner_scheme"] == "jacobi" and kw["interpret"] is True
    assert p._online_gpu.__wrapped__.keywords["inner_passes"] == 1
    q2 = LWS(512, 256, dtype=jnp.float32)
    assert q2._batch_gpu.__wrapped__.keywords["inner_scheme"] == "color2x3"
    assert q2._batch_gpu.__wrapped__.keywords["interpret"] is False


@pytest.mark.parametrize("scheme", ["jacobi", "color2x3"])
def test_nofuture_and_batch_stencils_f64_exact(golden_q4, scheme):
    """float64: both sweep stencils (full visibility and strictly past)
    agree with the XLA path to roundoff under either in-frame scheme."""
    p = LWS(512, 128, dtype=jnp.float64, inner_scheme=scheme)
    A = np.abs(golden_q4.S[:30]).astype(np.complex128)
    pair = split(A, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(3, 0.5, 0.5, 1))
    for st in (p._st_batch, p._st_nofuture):
        ref = lws_sweeps(*pair, st=st, thresholds=thr, order="gs",
                         inner_scheme=scheme)
        got = _gs(pair, st, thr, inner_scheme=scheme)
        assert np.abs(np.asarray(ref[0]) - np.asarray(pair[0])).max() > 0
        _close(got, ref, 1e-8)


def test_kernel_frozen_halos_and_mean(golden_q4):
    """Explicit frozen time halos and an external mean_amp (the macro-chunk,
    segmented and sharded callers' contract) match lws_sweeps'."""
    p, A, _ = _setup(golden_q4, dtype=jnp.float64, max_t=30)
    Ab = np.stack([A, 0.6 * A])
    pair = split(Ab, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(3, 100, 0.1, 1))
    rng = np.random.default_rng(3)
    halo = tuple(jnp.asarray(rng.standard_normal((2, p._Qi - 1, 257)))
                 for _ in range(4))
    mean = jnp.asarray([0.5, 1.5])
    ref = lws_sweeps(*pair, st=p._st_batch, thresholds=thr, halo=halo,
                     mean_amp=mean)
    _close(_gs(pair, p._st_batch, thr, halo=halo, mean_amp=mean), ref, 1e-8)


def test_kernel_fractional_q():
    """Per-bin weight rows under fractional Q (8/3) stay exact."""
    rng = np.random.default_rng(7)
    p = LWS(64, 24, inner_scheme="jacobi", dtype=jnp.float64)
    S = (rng.standard_normal((3, 16, 33))
         + 1j * rng.standard_normal((3, 16, 33)))
    pair = split(S, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(3, 100, 0.1, 1))
    ref = lws_sweeps(*pair, st=p._st_batch, thresholds=thr)
    _close(_gs(pair, p._st_batch, thr), ref, 1e-8)


def test_threshold_iteration_skip_is_bit_neutral(golden_q4):
    """The sparsity-threshold sweep skip is exact: an all-dead schedule is a
    pure identity, and a schedule whose leading sweeps are dead (the
    reference batch defaults, alpha=100) still matches the XLA GS path
    (python/lws.pyx:203-206 skip semantics)."""
    p, A, pair = _setup(golden_q4, max_t=40)
    dead = jnp.full((4,), jnp.inf, dtype=jnp.float32)
    _eq(_gs(pair, p._st_batch, dead), pair)

    thr = jnp.asarray(get_thresholds(10, 100, 0.5, 1), dtype=jnp.float32)
    got = merge(*_gs(pair, p._st_batch, thr, inner_passes=p.batch_inner_passes,
                     inner_scheme=p.inner_scheme))
    ref = np.asarray(p.batch_lws(A, thresholds=np.asarray(thr)))
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=5e-4)


def test_online_drain_and_look_ahead_zero(golden_q4):
    """look_ahead=0 (newest frame only) matches the XLA scan, and drain
    frames (n_live) never update."""
    p = LWS(512, 128, look_ahead=0, dtype=jnp.float64)
    A = np.abs(golden_q4.S[:30]).astype(np.complex128)
    pair = split(A, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(2, 1, 0.1, 1))
    ref = rtisi_la(*pair, p._st_la, p._st_nofuture, p._st_af, thr)
    _close(_online(p, pair, thr), ref, 1e-8)

    p3 = LWS(512, 128, dtype=jnp.float64)
    sr, si = pair[0][None], pair[1][None]
    state = online_chunk_init(sr[:, 0], si[:, 0], p3._st_la, p3._st_af)
    means = jnp.ones((1, 30))
    cr, ci, _ = online_chunk(sr, si, state, means, p3._st_la,
                             p3._st_nofuture, p3._st_af, thr, 0, n_live=0,
                             interpret=True)
    # nothing updates: committed row j is input frame j - LA (rows before
    # the pipeline filled hold the first-frame replicas)
    LA = p3.look_ahead
    np.testing.assert_array_equal(np.asarray(cr[0, LA:]),
                                  np.asarray(sr[0, :30 - LA]))


@pytest.mark.parametrize("geom", [(16, 4, 5), (48, 12, 3)])
def test_kernel_narrow_rows(geom):
    """Rows narrower than the stencil reach (F=9 with L=5: the left and
    right conjugate margins overlap) keep the XLA semantics."""
    fsize, fshift, L = geom
    p = LWS(fsize, fshift, L=L, dtype=jnp.float64, inner_scheme="jacobi")
    F = fsize // 2 + 1
    rng = np.random.default_rng(fsize)
    S = rng.standard_normal((2, 12, F)) + 1j * rng.standard_normal((2, 12, F))
    pair = split(S, dtype=jnp.float64)
    thr = jnp.asarray(get_thresholds(3, 1, 0.1, 1))
    ref = lws_sweeps(*pair, st=p._st_batch, thresholds=thr)
    _close(_gs(pair, p._st_batch, thr), ref, 1e-8)
    ref = rtisi_la(*pair, p._st_la, p._st_nofuture, p._st_af, thr)
    _close(_online(p, pair, thr), ref, 1e-8)


def test_inner_passes_kernel_matches_xla(golden_q4):
    """The kernel honours inner_passes (in-frame jacobi re-passes,
    core/stencil.py update_frame semantics): float64 agreement with the XLA
    GS path for passes in {2, 3}, and passes=2 genuinely changes the result
    vs passes=1."""
    p, A, pair = _setup(golden_q4, dtype=jnp.float64, max_t=40)
    thr = jnp.asarray(get_thresholds(3, 0.5, 0.5, 1), dtype=jnp.float64)
    one = _gs(pair, p._st_batch, thr)
    for passes in (2, 3):
        ref = lws_sweeps(*pair, st=p._st_batch, thresholds=thr, order="gs",
                         inner_passes=passes)
        _close(_gs(pair, p._st_batch, thr, inner_passes=passes), ref, 1e-8)
        if passes == 2:
            assert np.abs(np.asarray(ref[0]) - np.asarray(one[0])).max() > 1e-6


def test_macro_sweeps_chunking_logic(monkeypatch):
    """The macro time-chunking path (ultra-long T, bounded device memory):
    chunk bounds tile T exactly, each chunk receives REAL-neighbour
    stage-entry halos (edge replicas only at the true signal boundaries) and
    the whole-signal mean, and the concatenated result preserves frame
    order. This pins the host-side slicing logic everywhere."""
    proc = LWS(512, 128, dtype=jnp.float32)
    B, T, F = 2, 50, 257
    Q1 = proc._Qi - 1
    rng = np.random.default_rng(0)
    sr = jnp.asarray(rng.standard_normal((B, T, F)), jnp.float32)
    si = jnp.asarray(rng.standard_normal((B, T, F)), jnp.float32)
    proc._MACRO_CHUNK = 20
    seen = []

    def spy(sr_c, si_c, thresholds, gpu, seg, xla, halo=None, mean_amp=None):
        seen.append((sr_c.shape, halo, mean_amp))
        return sr_c, si_c

    monkeypatch.setattr(proc, "_sweep_fn", spy)
    o_r, o_i = proc._macro_sweeps(sr, si, jnp.zeros((1,)), None, None, None)
    # identity chunks concatenate back to the input
    np.testing.assert_array_equal(np.asarray(o_r), np.asarray(sr))
    assert sum(s[0][1] for s in seen) == T
    # first chunk's top halo replicates frame 0; interior seams pass the
    # REAL neighbour frames; last chunk's bottom halo replicates frame T-1
    first_top = np.asarray(seen[0][1][0])
    np.testing.assert_array_equal(first_top,
                                  np.tile(np.asarray(sr[:, :1]), (1, Q1, 1)))
    a1 = seen[0][0][1]  # first chunk length = second chunk's start
    mid_top = np.asarray(seen[1][1][0])
    np.testing.assert_array_equal(mid_top, np.asarray(sr[:, a1 - Q1:a1]))
    mid_bot = np.asarray(seen[0][1][2])
    np.testing.assert_array_equal(mid_bot, np.asarray(sr[:, a1:a1 + Q1]))
    last_bot = np.asarray(seen[-1][1][2])
    np.testing.assert_array_equal(last_bot,
                                  np.tile(np.asarray(sr[:, -1:]), (1, Q1, 1)))
    # every chunk gets the WHOLE-signal mean (reference threshold scale)
    want_mean = np.asarray(jnp.mean(jnp.sqrt(sr * sr + si * si),
                                    axis=(-2, -1)))
    for _, _, m in seen:
        np.testing.assert_allclose(np.asarray(m), want_mean, rtol=1e-6)


def test_kernel_fixed_target_magnitudes(golden_q4):
    """A stage run as several calls (halo-exchange rounds) passes the
    stage-entry magnitudes as `amp`: every call then restores exactly those
    magnitudes, and the result equals one call over all sweeps."""
    p, A, pair = _setup(golden_q4, dtype=jnp.float64, max_t=30)
    thr = jnp.asarray(get_thresholds(4, 1, 0.1, 1))
    amp = jnp.sqrt(pair[0] ** 2 + pair[1] ** 2)
    entry = dict(amp=amp, mean_amp=jnp.mean(amp)[None], halo=tuple(
        jnp.repeat(x[None, r], p._Qi - 1, axis=1)
        for r in (slice(0, 1), slice(-1, None)) for x in pair))
    one = _gs(pair, p._st_batch, thr)
    two = _gs(pair, p._st_batch, thr[:2], **entry)
    two = _gs(two, p._st_batch, thr[2:], **entry)
    _close(two, one, 1e-8)
    np.testing.assert_allclose(np.hypot(*map(np.asarray, two)),
                               np.asarray(amp), rtol=1e-12)
