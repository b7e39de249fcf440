"""Constructor warning parity with the reference (python/lws.pyx:403-406,
452-454): fftsize zero-padding boundary caveat and non-symmetric analysis
window."""
import warnings

import numpy as np
import pytest

from lws_jax import LWS


def test_fftsize_padding_warns():
    with pytest.warns(UserWarning, match="perfect reconstruction"):
        p = LWS(384, 96, fftsize=512)
    assert p.fsize == 512  # windows padded


def test_fftsize_equal_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LWS(512, 128, fftsize=512)


def test_asymmetric_window_warns():
    win = np.hanning(256)
    win[:10] *= 0.5  # break the symmetry
    with pytest.warns(UserWarning, match="not symmetric"):
        LWS(np.sqrt(win + 1e-3), 64)


def test_symmetric_window_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LWS(np.sqrt(np.hanning(256) + 1e-3), 64)


def test_asymmetric_window_silent_without_simplifications():
    win = np.hanning(256)
    win[:10] *= 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LWS(np.sqrt(win + 1e-3), 64, use_simplifications=False)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend must be"):
        LWS(512, 128, backend="tiled")


def test_streaming_unknown_backend_rejected():
    from lws_jax import StreamingLWS
    with pytest.raises(ValueError, match="backend must be"):
        StreamingLWS(LWS(512, 128, look_ahead=2), backend="pallas")


def test_default_construction_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LWS(512, 128, mode="music")
        LWS(2048, 256, backend="gpu")


def test_jacobi_mxu_default_precision_warns_quality_floor():
    # PERF.md: at the default matmul precision (TF32 on the GPU) the banded
    # matmuls floor achievable consistency
    with pytest.warns(UserWarning, match="TF32"):
        LWS(512, 128, order="jacobi_mxu")


def test_jacobi_mxu_highest_precision_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LWS(512, 128, order="jacobi_mxu", precision="highest")
