"""End-to-end phase recovery demo / timing harness.

Python equivalent of the reference MATLAB driver (matlab/run_lws.m): load or
synthesise audio, take its magnitude STFT, run the three LWS stages with
per-stage wall time and consistency prints, and write the recovered audio.

Usage:
    python examples/run_lws.py [input.wav] [output.wav]

Without arguments a synthetic tone+chirp test signal is used (the reference
ships no test file either, run_lws.m:58).
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
import lws_jax
from lws_jax.io import read_wav, write_wav
from lws_jax.device import use_compile_cache

use_compile_cache()


def main():
    if len(sys.argv) > 1:
        x, sr = read_wav(sys.argv[1])
    else:
        sr = 16000
        t = np.arange(5 * sr) / sr
        x = (0.5 * np.sin(2 * np.pi * 330 * t)
             + 0.3 * np.sin(2 * np.pi * 990 * t)
             + 0.25 * np.sin(2 * np.pi * (200 + 2500 * t / t[-1]) * t))
    out_path = sys.argv[2] if len(sys.argv) > 2 else "recovered.wav"

    # reference demo configuration: 512-pt FFT, 128 hop (Q=4), L=5
    # (matlab/run_lws.m:48-55); music mode = no-future + online + batch
    proc = lws_jax.lws(512, 128, mode="music")

    X = proc.stft(x)
    A = np.abs(X)
    print(f"spectrogram: {X.shape},  consistency of |X|: "
          f"{float(proc.get_consistency(A.astype('complex64'))):6.2f} dB")

    S = A.astype("complex64")
    for name, fn in [("no-future", proc.nofuture_lws),
                     ("online   ", proc.online_lws),
                     ("batch    ", proc.batch_lws)]:
        t0 = time.time()
        S = fn(S)
        wall = time.time() - t0
        c = float(proc.get_consistency(S))
        print(f"{name}: {wall:6.2f}s   consistency {c:6.2f} dB")

    y = np.asarray(proc.istft(S))
    write_wav(out_path, y, sr)
    print(f"wrote {out_path} ({len(y) / sr:.2f}s)")


if __name__ == "__main__":
    main()
