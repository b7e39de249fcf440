"""Mel filterbank / vocoder pipeline tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from lws_jax import LWS
from lws_jax.mel import (
    linear_to_mel,
    mel_filterbank,
    mel_to_linear,
    mel_vocoder_pipeline,
)


def test_filterbank_shape_and_coverage():
    fb = mel_filterbank(80, 1024, 16000)
    assert fb.shape == (80, 513)
    assert np.all(fb >= 0)
    # every filter has support; interior bins are covered
    assert np.all(fb.sum(axis=1) > 0)
    covered = fb.sum(axis=0)
    assert np.all(covered[5:-5] > 0)


def test_filterbank_htk_monotone_centres():
    fb = mel_filterbank(40, 512, 16000, htk=True, norm=None)
    centres = fb.argmax(axis=1)
    assert np.all(np.diff(centres) >= 1)


def test_mel_round_trip_smooth_spectrum():
    """Projection + pinv inversion approximately recovers smooth spectra."""
    rng = np.random.default_rng(0)
    fb = mel_filterbank(80, 1024, 16000)
    bins = np.arange(513)
    # smooth positive spectrum (mel inversion cannot recover fine structure)
    spec = np.stack([np.exp(-((bins - c) / 90.0) ** 2) + 0.1
                     for c in (60, 150, 300)])
    mel = np.asarray(linear_to_mel(spec, fb))
    rec = np.asarray(mel_to_linear(mel, fb))
    err = np.abs(rec - spec)[:, 10:-10].mean()
    assert err < 0.08, err


def test_mel_vocoder_pipeline(golden_q4):
    """80-band mel -> linear -> 3-stage LWS -> waveform, batched."""
    g = golden_q4
    sr_hz = 16000
    proc = LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
               nofuture_iterations=1, online_iterations=2, batch_iterations=10)
    S = np.abs(np.asarray(g.S))
    fb = mel_filterbank(80, proc.fftsize, sr_hz)
    mel = np.asarray(linear_to_mel(S, fb))
    mel_b = np.stack([mel, mel * 0.5])

    y = np.asarray(mel_vocoder_pipeline(mel_b, proc, fb=fb))
    assert y.ndim == 2 and y.shape[0] == 2
    assert np.isfinite(y).all() and np.abs(y).max() > 0

    pair = mel_vocoder_pipeline(mel_b, proc, fb=fb, return_spec=True)
    c = np.asarray(proc.get_consistency(pair))
    # phase recovery produced a consistent spectrogram from mel alone
    lin = mel_to_linear(mel_b, fb).astype(proc.rdtype)
    c0 = np.asarray(proc.get_consistency((lin, jnp.zeros_like(lin))))
    assert np.all(c > c0 + 5), (c, c0)
