"""Streaming online LWS vs the offline RTISI-LA scan."""
import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import LWS
from lws_jax.streaming import StreamingLWS


def _padded_signal(proc, x):
    """Apply the perfectrec pre-padding so stream frames align with proc.stft."""
    fsize, fshift = proc.fsize, proc.fshift
    residual = fsize % fshift
    pre = fsize - fshift if residual == 0 else fsize - residual
    post = 0 if len(x) % fshift == 0 else fshift - len(x) % fshift
    return np.concatenate([np.zeros(pre), x, np.zeros(post)])


def test_streaming_matches_offline_online(golden_q4):
    """With a fixed mean_amp, committed frames == the offline online_lws
    output rows (the stream window reproduces the scan state exactly)."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=4)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)

    S = proc.stft(x)  # perfectrec=True -> frames at 0, fshift, ... of xp
    A = np.abs(S).astype(np.complex128)
    mean_amp = float(np.mean(np.abs(A)))
    offline = np.asarray(proc.online_lws(A))

    stream = StreamingLWS(proc, iterations=4, mean_amp=mean_amp, keep_frames=True)
    # stream the magnitude frames directly (vocoder-style frame input)
    for i in range(A.shape[0]):
        stream.push_frame(np.abs(S[i]))

    committed = np.stack(stream.committed_frames)
    n = committed.shape[0]  # frames 0 .. T-LA-1
    # separate jit programs -> different fusion/rounding; state evolution is
    # identical (>99% bitwise agreement, rest at ~1e-5 relative)
    np.testing.assert_allclose(committed, offline[:n], rtol=1e-3, atol=1e-3)
    close = np.isclose(committed, offline[:n], rtol=1e-6, atol=1e-8)
    assert close.mean() > 0.97, close.mean()


def test_push_block_matches_push(golden_q4):
    """push_block (one scan dispatch per chunk) produces the same audio as
    sample-by-sample push: the block step is the same per-frame step under
    lax.scan, so state evolution is identical."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=4)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)

    a = StreamingLWS(proc, iterations=4)
    out_a = [a.push(xp)]
    out_a.append(a.flush())
    ya = np.concatenate(out_a)

    b = StreamingLWS(proc, iterations=4)
    out_b = []
    for i in range(0, len(xp), 4000):
        out_b.append(b.push_block(xp[i:i + 4000]))
    out_b.append(b.flush())
    yb = np.concatenate(out_b)

    assert ya.shape == yb.shape
    # separate jit programs (standalone step vs scan-of-step) fuse/round
    # differently; agreement is at fp-noise level
    np.testing.assert_allclose(ya, yb, rtol=1e-4, atol=1e-6)


def test_push_block_batched_streams(golden_q4):
    """push_block with streams>1 stays consistent with single-stream runs."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=3)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)
    X = np.stack([xp, 0.5 * xp])

    s2 = StreamingLWS(proc, iterations=3, streams=2)
    y2 = np.concatenate([s2.push_block(X), s2.flush()], axis=-1)

    s1 = StreamingLWS(proc, iterations=3)
    y1 = np.concatenate([s1.push_block(xp), s1.flush()], axis=-1)
    assert y2.shape == (2, y1.shape[0])
    np.testing.assert_allclose(y2[0], y1, rtol=1e-4, atol=1e-6)
    # scale equivariance of the whole pipeline (thresholds are relative)
    np.testing.assert_allclose(y2[1], 0.5 * y1, rtol=1e-4, atol=1e-6)


def test_streaming_audio_end_to_end(golden_q4):
    """Push real audio in ragged chunks; the reconstructed stream should be
    a faithful signal (energy, length) and improve consistency vs zero-phase."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=4)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)
    stream = StreamingLWS(proc, iterations=4, keep_frames=True)

    rng = np.random.default_rng(0)
    out = []
    i = 0
    while i < len(xp):
        n = int(rng.integers(50, 700))
        out.append(stream.push(xp[i:i + n]))
        i += n
    out.append(stream.flush())
    y = np.concatenate(out)
    assert len(y) > len(xp) - proc.fsize - (stream.LA + 1) * proc.fshift
    # committed spectra form a coherent phase-recovered spectrogram
    committed = np.stack(stream.committed_frames)
    c = float(np.asarray(proc.get_consistency(committed.astype(np.complex128))))
    assert c > 5.0, c  # audio input is already consistent; sanity bound


def test_streaming_latency_accounting(golden_q4):
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64)
    stream = StreamingLWS(proc, iterations=2)
    assert stream.latency_frames == proc.look_ahead + 1
    # no output until fsize + LA*fshift samples arrived
    out = stream.push(np.zeros(proc.fsize - 1))
    assert out.size == 0
    out = stream.push(np.zeros(proc.fshift * proc.look_ahead + 1))
    assert out.size >= 0  # pipeline filling
    stream.reset()
    assert stream._frames_seen == 0


def test_flush_commits_all_content_frames(golden_q4):
    """flush() must commit every frame that contains real samples, with the
    tail frames keeping their offline-final values (frozen drain)."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=4)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)
    S = proc.stft(x)
    mean_amp = float(np.mean(np.abs(S)))
    offline = np.asarray(proc.online_lws(np.abs(S).astype(np.complex128)))

    stream = StreamingLWS(proc, iterations=4, mean_amp=mean_amp, keep_frames=True)
    for i in range(S.shape[0]):
        stream.push_frame(np.abs(S[i]))
    stream.flush()
    committed = np.stack(stream.committed_frames)
    assert committed.shape[0] == S.shape[0]  # every frame committed
    # the drained tail rows equal the offline extraction (no extra updates)
    np.testing.assert_allclose(committed[-proc.look_ahead:],
                               offline[-proc.look_ahead:], rtol=1e-3, atol=1e-3)


def test_flush_audio_covers_signal(golden_q4):
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=2)
    x = np.asarray(g.x)
    xp = _padded_signal(proc, x)
    stream = StreamingLWS(proc, iterations=2)
    y1 = stream.push(xp)
    y2 = stream.flush()
    y = np.concatenate([y1, y2])
    n_frames = (len(xp) - proc.fsize) // proc.fshift + 1
    # all frames committed -> fshift samples each, plus the OLA tail
    assert len(y) >= n_frames * proc.fshift


def test_batched_streams_match_single(golden_q4):
    """streams=S lockstep == S independent single streams."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=2)
    x = np.asarray(g.x)[:4000]
    xs = np.stack([x, 0.5 * x])
    sb = StreamingLWS(proc, iterations=2, streams=2)
    yb = np.concatenate([sb.push(xs), sb.flush()], axis=-1)
    singles = []
    for i in range(2):
        s1 = StreamingLWS(proc, iterations=2)
        singles.append(np.concatenate([s1.push(xs[i]), s1.flush()]))
    ys = np.stack(singles)
    assert yb.shape == ys.shape
    np.testing.assert_allclose(yb, ys, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# chunked GPU-kernel backend (ops/gpu_sweeps.py::online_chunk), run in the
# Pallas interpreter
# ---------------------------------------------------------------------------

def _pallas_stream(proc, iters, mean_amp, streams=1):
    return StreamingLWS(proc, iterations=iters, mean_amp=mean_amp,
                        streams=streams, keep_frames=True,
                        backend="gpu")


def test_pallas_streaming_matches_offline_packed(golden_q4):
    """The chunked kernel backend with a fixed mean_amp reproduces the
    offline online_sweeps kernel: the carried rows are exactly the offline
    kernel's slab rows (tests/test_pallas.py::
    test_online_chunk_matches_offline_exact; here the stream's jitted chunk
    fn and the offline program fuse differently, so the comparison uses the
    standard chaos band)."""
    from lws_jax.ops.gpu_sweeps import online_sweeps
    from lws_jax.windows import get_thresholds
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               interpret=True, online_iterations=4)
    S = proc.stft(np.asarray(g.x))
    A = np.abs(S)
    T, F = A.shape
    mean_amp = float(np.mean(A))
    thr = jnp.asarray(get_thresholds(4, proc.online_alpha, proc.online_beta,
                                     proc.online_gamma), dtype=jnp.float64)
    sr = jnp.asarray(A)[None]
    # jit the offline call like the stream's chunk fn (the StreamingLWS
    # backend jits its kernel; fusion inside jit differs from eager at the
    # last ulp, which phase-recovery chaos would amplify)
    import jax
    import functools
    offline_fn = jax.jit(functools.partial(
        online_sweeps, st_la=proc._st_la, st_ai=proc._st_nofuture,
        st_af=proc._st_af, thresholds=thr, interpret=True))
    osr, osi = offline_fn(sr, jnp.zeros_like(sr))
    offline = np.asarray(osr[0]) + 1j * np.asarray(osi[0])
    # the mean must match the offline kernel's own jnp computation to the
    # last ulp or a borderline amp > thr*mean comparison can flip
    mean_amp = float(jnp.mean(jnp.sqrt(sr * sr), axis=(-2, -1))[0])

    stream = _pallas_stream(proc, 4, mean_amp)
    for a, b in [(0, 17), (17, 18), (18, T)]:
        stream._push_frames(A[a:b].astype(np.complex128))
    stream.flush()
    committed = np.stack(stream.committed_frames)
    assert committed.shape[0] == T
    np.testing.assert_allclose(committed.real, offline.real, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(committed.imag, offline.imag, rtol=1e-3, atol=1e-3)
    close = np.isclose(committed, offline, rtol=1e-6, atol=1e-8)
    assert close.mean() > 0.97, close.mean()


def test_pallas_chunk_size_invariance(golden_q4):
    """Any chunking of the same stream yields bit-identical audio."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               interpret=True, online_iterations=3)
    x = _padded_signal(proc, np.asarray(g.x))

    def run(chunk):
        s = _pallas_stream(proc, 3, None)
        outs = [s.push(x[i:i + chunk]) for i in range(0, len(x), chunk)]
        outs.append(s.flush())
        return np.concatenate(outs, axis=-1)

    y1, y2 = run(len(x)), run(700)
    n = min(len(y1), len(y2))
    # the running mean is a chunk-boundary-dependent float sum (last-ulp);
    # with a fixed mean_amp the outputs are bit-identical
    np.testing.assert_allclose(y1[:n], y2[:n], rtol=1e-9, atol=1e-12)


def test_pallas_flush_emits_true_ola_tail(golden_q4):
    """flush() on the kernel backend must emit the final fsize-fshift
    samples of overlap-add audio (the commit-frontier tail). Block
    quantisation pads the final chunk with drain rows, which used to strand
    the true tail in the unemitted audio region and emit the carried state
    tail's zeros instead — the XLA backend is the ground truth here,
    including the tail."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               interpret=True, online_iterations=3)
    x = _padded_signal(proc, np.asarray(g.x))
    mean_amp = float(np.mean(np.abs(proc.stft(np.asarray(g.x)))))

    sx = StreamingLWS(proc, iterations=3, mean_amp=mean_amp, backend="xla")
    yx = np.concatenate([sx.push(x), sx.flush()], axis=-1)

    sp = _pallas_stream(proc, 3, mean_amp)
    yp = np.concatenate([sp.push(x), sp.flush()], axis=-1)

    assert yp.shape == yx.shape
    tail = proc.fsize - proc.fshift
    # the tail region carries real signal energy, not silence
    assert np.abs(yx[-proc.fsize:-proc.fsize + tail]).max() > 1e-3
    np.testing.assert_allclose(yp[-proc.fsize:], yx[-proc.fsize:],
                               rtol=1e-3, atol=1e-4)
    # and the whole stream agrees within the usual separate-program band
    np.testing.assert_allclose(yp, yx, rtol=1e-3, atol=1e-4)


def test_pallas_batched_streams_match_single(golden_q4):
    """streams=4 lockstep == the same signals processed alone (running mean
    is tracked per stream)."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               interpret=True, online_iterations=3)
    x = _padded_signal(proc, np.asarray(g.x))
    xs = np.stack([x, 0.3 * x, np.roll(x, 1000), -x])

    sb = _pallas_stream(proc, 3, None, streams=4)
    yb = np.concatenate([sb.push_block(xs[:, :4096]),
                         sb.push_block(xs[:, 4096:]), sb.flush()], axis=-1)
    s1 = _pallas_stream(proc, 3, None)
    y1 = np.concatenate([s1.push_block(x[:4096]), s1.push_block(x[4096:]),
                         s1.flush()], axis=-1)
    assert yb.shape == (4, y1.shape[0])
    np.testing.assert_allclose(yb[0], y1, rtol=1e-10, atol=1e-12)
    # scale equivariance holds mathematically but 0.3*x rounds differently;
    # the fp difference is chaos-amplified (same band as the XLA test above)
    np.testing.assert_allclose(yb[1], 0.3 * y1, rtol=1e-3, atol=1e-5)


def test_pallas_device_emit_matches_host(golden_q4):
    """emit='device' returns committed audio as device arrays (no host sync
    per chunk) that are bit-identical to the host-emit path — same device
    program, only the materialisation point differs."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               interpret=True, online_iterations=2)
    x = _padded_signal(proc, np.asarray(g.x))[:6000]

    sh = _pallas_stream(proc, 2, 1.0)
    yh = np.concatenate([sh.push_block(x), sh.flush()], axis=-1)

    sd = StreamingLWS(proc, iterations=2, mean_amp=1.0, backend="gpu",
                      emit="device")
    outs = [sd.push_block(x), sd.flush()]
    assert all(isinstance(o, jnp.ndarray) for o in outs)
    yd = np.asarray(jnp.concatenate(outs, axis=-1))
    np.testing.assert_array_equal(yd, yh)

    # prefetch (async device->host copies of returned blocks, the serving
    # collection optimisation) is value-neutral: same bits with it disabled
    sn = StreamingLWS(proc, iterations=2, mean_amp=1.0, backend="gpu",
                      emit="device", prefetch=False)
    yn = np.asarray(jnp.concatenate([sn.push_block(x), sn.flush()], axis=-1))
    np.testing.assert_array_equal(yn, yd)


def test_pallas_stream_fuzz_geometries_vs_xla():
    """The chunked kernel backend agrees with the XLA per-frame backend on
    random geometries (fsize/fshift/L/LA), not just the golden q4 one —
    full audio including the flush tail, fixed mean for determinism."""
    rng = np.random.default_rng(21)
    for fsize, fshift, L, LA in [(384, 96, 3, 2), (512, 160, 4, 1),
                                 (256, 64, 5, 3)]:
        proc = LWS(fsize, fshift, L=L, look_ahead=LA, dtype=jnp.float64,
                   interpret=True, online_iterations=2)
        n = 20 * fshift + fsize
        t = np.arange(n) / 16000.0
        x = (0.6 * np.sin(2 * np.pi * 220 * t)
             + 0.1 * rng.standard_normal(n))
        mean = float(np.mean(np.abs(proc.stft(x))))

        sx = StreamingLWS(proc, iterations=2, mean_amp=mean, backend="xla")
        yx = np.concatenate([sx.push(x), sx.flush()], axis=-1)
        sp = StreamingLWS(proc, iterations=2, mean_amp=mean,
                          backend="gpu", block_frames=8)
        yp = np.concatenate([sp.push(x), sp.flush()], axis=-1)
        assert yp.shape == yx.shape, (fsize, fshift, yp.shape, yx.shape)
        np.testing.assert_allclose(yp, yx, rtol=1e-3, atol=1e-4,
                                   err_msg=f"geom {(fsize, fshift, L, LA)}")


def test_stream_stats_recorded():
    """Push entry points record latency/throughput into .stats."""
    import lws_jax
    proc = lws_jax.LWS(512, 128, look_ahead=2, online_iterations=2,
                       dtype=jnp.float64)
    s = StreamingLWS(proc, iterations=2, backend="xla")
    x = np.sin(2 * np.pi * 220 * np.arange(4096) / 16000)
    s.push(x[:2048])
    s.push(x[2048:])
    s.flush()
    rep = s.stats.summary(sample_rate=16000)
    assert rep["pushes"] == 2
    assert rep["samples"] > 0 and rep["wall_s"] > 0
    assert "p50_s" in rep and rep["p99_s"] >= rep["p50_s"]
    assert rep["realtime_factor"] > 0


def test_push_frames_matches_push_frame(golden_q4):
    """push_frames (N frames, one dispatch) == the same N push_frame calls:
    the block step is the per-frame step under lax.scan over the stack."""
    g = golden_q4
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               online_iterations=3)
    S = proc.stft(np.asarray(g.x))
    A = np.abs(S)
    mean_amp = float(A.mean())

    a = StreamingLWS(proc, iterations=3, mean_amp=mean_amp, keep_frames=True)
    for i in range(A.shape[0]):
        a.push_frame(A[i])

    b = StreamingLWS(proc, iterations=3, mean_amp=mean_amp, keep_frames=True)
    for i in range(0, A.shape[0] - A.shape[0] % 8, 8):
        b.push_frames(A[i:i + 8])
    for i in range(A.shape[0] - A.shape[0] % 8, A.shape[0]):
        b.push_frame(A[i])

    ca = np.stack(a.committed_frames)
    cb = np.stack(b.committed_frames)
    assert ca.shape == cb.shape
    # same state evolution, different jit programs -> fp-noise difference
    np.testing.assert_allclose(ca, cb, rtol=1e-4, atol=1e-6)
