"""STFT/iSTFT/consistency vs reference goldens + batching properties."""
import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import LWS, get_consistency, istft, stft


def test_stft_matches_reference(golden):
    S = stft(jnp.asarray(golden.x), int(golden.fsize), int(golden.fshift),
             golden.awin, perfectrec=True)
    assert S.shape == golden.S.shape
    np.testing.assert_allclose(np.asarray(S), golden.S, atol=1e-9)


def test_istft_matches_reference(golden):
    x = istft(jnp.asarray(golden.S), int(golden.fshift), golden.swin, perfectrec=True)
    np.testing.assert_allclose(np.asarray(x), golden.istft_S, atol=1e-9)


def test_consistency_matches_reference(golden):
    c = get_consistency(jnp.asarray(golden.S), int(golden.fsize), int(golden.fshift),
                        golden.awin, golden.swin, perfectrec=True)
    # S is already consistent, so both values only measure fp rounding noise
    # (~300 dB); require agreement only in that regime.
    if float(golden.consistency_S) > 250:
        assert float(c) > 250
    else:
        np.testing.assert_allclose(float(c), float(golden.consistency_S), atol=1e-4)
    cA = get_consistency(jnp.abs(jnp.asarray(golden.S)).astype(jnp.complex128),
                         int(golden.fsize), int(golden.fshift),
                         golden.awin, golden.swin, perfectrec=True)
    np.testing.assert_allclose(float(cA), float(golden.consistency_A), atol=1e-4)


def test_perfect_reconstruction(golden):
    """COLA analysis-synthesis round trip recovers the signal."""
    x = jnp.asarray(golden.x)
    S = stft(x, int(golden.fsize), int(golden.fshift), golden.awin, perfectrec=True)
    y = istft(S, int(golden.fshift), golden.swin, perfectrec=True)
    n = min(x.shape[-1], y.shape[-1])
    np.testing.assert_allclose(np.asarray(y)[:n], np.asarray(x)[:n], atol=1e-10)


def test_stft_batched_equals_loop(golden_q4):
    g = golden_q4
    rng = np.random.default_rng(0)
    xs = np.stack([g.x, rng.standard_normal(len(g.x))])
    Sb = stft(jnp.asarray(xs), int(g.fsize), int(g.fshift), g.awin, perfectrec=True)
    for i in range(2):
        Si = stft(jnp.asarray(xs[i]), int(g.fsize), int(g.fshift), g.awin, perfectrec=True)
        np.testing.assert_allclose(np.asarray(Sb[i]), np.asarray(Si), atol=1e-12)
    # batched istft and consistency
    yb = istft(Sb, int(g.fshift), g.swin, perfectrec=True)
    assert yb.shape[0] == 2
    cb = get_consistency(Sb, int(g.fsize), int(g.fshift), g.awin, g.swin, perfectrec=True)
    assert cb.shape == (2,)


def test_stft_nonperfectrec_layout():
    """Frame-count arithmetic for perfectrec=False (python/lws.pyx:70-77)."""
    x = jnp.asarray(np.random.default_rng(1).standard_normal(1000))
    S = stft(x, 256, 128, np.hanning(256), perfectrec=False)
    # padded to  (len - fsize) % fshift == 0 -> M = (1024-256)/128+1 = 7
    assert S.shape == (7, 129)


def test_wav_io_roundtrip(tmp_path):
    from lws_jax.io import read_wav, write_wav
    sr = 16000
    x = 0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)
    p = tmp_path / "t.wav"
    write_wav(p, x, sr, normalize=False)
    y, sr2 = read_wav(p)
    assert sr2 == sr
    np.testing.assert_allclose(y, x, atol=1e-4)
    # multi-channel round trip, mono mixdown
    write_wav(p, np.stack([x, -x]), sr, normalize=False)
    y2, _ = read_wav(p)
    assert np.abs(y2).max() < 1e-4  # (x + -x)/2


def test_framepadding_option(golden_q4):
    """framepadding=True zero-pads (Q-1)*fshift both sides before framing
    (matlab/stft.m:43-46): adds 2*(Q-1) frames and embeds the unpadded
    frames in the middle."""
    from lws_jax import LWS
    g = golden_q4
    p = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
            perfectrec=False)
    x = np.asarray(g.x)[: 40 * int(g.fshift) + int(g.fsize)]
    Q = p._Qi
    S0 = p.stft(x)
    S1 = p.stft(x, framepadding=True)
    assert S1.shape[0] == S0.shape[0] + 2 * (Q - 1)
    np.testing.assert_allclose(S1[Q - 1:Q - 1 + S0.shape[0]], S0,
                               rtol=1e-10, atol=1e-12)


def test_24bit_wav_roundtrip(tmp_path):
    """24-bit PCM WAV read support (reference's MATLAB audioread handles it)."""
    import wave
    from lws_jax.io import read_wav
    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal(1000) * 0.3, -1, 1)
    i32 = (x * 2147483647).astype(np.int64).astype(np.int32)
    b = np.zeros((1000, 3), np.uint8)
    u = i32.view(np.uint32)
    b[:, 0] = (u >> 8) & 0xFF
    b[:, 1] = (u >> 16) & 0xFF
    b[:, 2] = (u >> 24) & 0xFF
    path = tmp_path / "t24.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(3)
        f.setframerate(16000)
        f.writeframes(b.tobytes())
    y, sr = read_wav(path)
    assert sr == 16000
    np.testing.assert_allclose(y, x, atol=2 ** -23)


def test_frame_signal_overlap_add_roundtrip():
    """The shared framing/OLA helpers invert each other: overlap-adding
    unwindowed frames reproduces each sample scaled by its frame coverage
    count (the COLA identity both istft and the streaming emission rely on)."""
    import jax.numpy as jnp
    from lws_jax.stft import frame_signal, overlap_add
    rng = np.random.default_rng(7)
    for fsize, fshift in [(512, 128), (500, 160), (256, 256)]:
        M = 11
        n = (M - 1) * fshift + fsize
        x = rng.standard_normal(n)
        frames = frame_signal(jnp.asarray(x), fsize, fshift, M)
        np.testing.assert_array_equal(
            np.asarray(frames[3]), x[3 * fshift:3 * fshift + fsize])
        y = np.asarray(overlap_add(frames, fshift))[:n]
        # coverage count of sample t: frames m with m*fshift <= t < m*fshift+fsize
        t = np.arange(n)
        cover = (np.minimum(t // fshift, M - 1)
                 - np.maximum(0, (t - fsize) // fshift + 1) + 1)
        np.testing.assert_allclose(y, x * cover, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("perfectrec", [True, False])
def test_blocked_consistency_matches_oneshot(perfectrec):
    """The bounded-memory blocked consistency path (engaged automatically
    past ~16k frames; the 1-hour longform case OOMs the one-shot round
    trip on chip) computes the same metric: OLA linearity makes the
    chunked iSTFT + per-chunk error accumulation exact up to f32 seam
    addition order."""
    from lws_jax.stft import (_consistency_blocked, _consistency_jit,
                              _prep_swin)
    p = LWS(512, 128, perfectrec=perfectrec)
    rng = np.random.default_rng(0)
    S = (rng.standard_normal((2, 300, 257))
         + 1j * rng.standard_normal((2, 300, 257)))
    sr = jnp.asarray(S.real, jnp.float32)
    si = jnp.asarray(S.imag, jnp.float32)
    swin = _prep_swin(p.swin, None, p.fshift, p.fftsize)
    a = _consistency_jit(sr, si, jnp.asarray(p.awin), jnp.asarray(swin),
                         p.fsize, p.fshift, p.fftsize, perfectrec)
    # block=77 forces several ragged chunks incl. a short tail
    b = _consistency_blocked(sr, si, jnp.asarray(p.awin),
                             jnp.asarray(swin), p.fsize, p.fshift,
                             p.fftsize, perfectrec, block=77)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
