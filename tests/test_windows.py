"""Windows/weights construction vs reference goldens (exact, float64)."""
import numpy as np

from lws_jax import (
    build_asymmetric_windows,
    create_weights,
    default_window,
    get_thresholds,
    hann,
    synthwin,
)


def test_default_window_matches_reference(golden):
    awin = default_window(int(golden.fsize), int(golden.fshift))
    np.testing.assert_allclose(awin, golden.awin, atol=1e-13)


def test_synthwin_matches_reference(golden):
    swin = synthwin(golden.awin, int(golden.fshift))
    np.testing.assert_allclose(swin, golden.swin, atol=1e-13)


def test_asymmetric_windows_match_reference(golden):
    win_ai, win_af = build_asymmetric_windows(golden.awin * golden.swin, int(golden.fshift))
    np.testing.assert_allclose(win_ai, golden.win_ai, atol=1e-13)
    np.testing.assert_allclose(win_af, golden.win_af, atol=1e-13)


def test_create_weights_matches_reference(golden):
    for name in ("W", "W_ai", "W_af"):
        if name == "W":
            W = create_weights(golden.awin, golden.swin, int(golden.fshift), int(golden.L))
        elif name == "W_ai":
            W = create_weights(golden.win_ai, golden.swin, int(golden.fshift), int(golden.L))
        else:
            W = create_weights(golden.win_af, golden.swin, int(golden.fshift), int(golden.L))
        ref = golden[name]
        assert W.shape == ref.shape
        np.testing.assert_allclose(W, ref, atol=1e-12, err_msg=name)


def test_hann_periodic_variants():
    n = 16
    w = hann(n, symmetric=False)
    assert w[0] == 0.0
    w_off = hann(n, symmetric=False, use_offset=True)
    assert w_off[0] > 0
    ws = hann(n, symmetric=True)
    np.testing.assert_allclose(ws, ws[::-1], atol=1e-15)


def test_thresholds_schedule():
    thr = get_thresholds(4, 100, 0.1, 1)
    np.testing.assert_allclose(thr, 100 * np.exp(-0.1 * np.arange(4)))
    assert len(get_thresholds(0, 1, 0.1, 1)) == 0
