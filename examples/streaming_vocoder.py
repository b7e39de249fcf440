"""Streaming vocoder-serving demo: mel frames in, committed audio out.

The production TTS post-processing loop the reference enables offline
(python/lws.pyx online mode + a user-side mel inversion) as a real-time
service: an acoustic model emits mel frames, each batch of frames is
inverted to linear magnitudes, pushed through N lockstep RTISI-LA streams
(one device dispatch per block on a GPU via the online kernel's
carried-state entry), and
committed audio comes back at a fixed (look_ahead+1)-frame latency.
Per-push latency percentiles come from StreamingLWS.stats.

Usage:
    python examples/streaming_vocoder.py [n_streams] [seconds]
"""
import sys

import numpy as np

sys.path.insert(0, ".")
import lws_jax
from lws_jax.mel import linear_to_mel, mel_filterbank, mel_to_linear
from lws_jax.streaming import StreamingLWS
from lws_jax.device import use_compile_cache

use_compile_cache()


def main():
    streams = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    secs = float(sys.argv[2]) if len(sys.argv) > 2 else 5.0
    sr_hz, fsize, fshift, n_mels = 16000, 512, 128, 80

    # --- stand-in acoustic model: mel spectrograms of synthetic speech-ish
    # mixtures (in production these frames arrive from a TTS decoder)
    t = np.arange(int(secs * sr_hz)) / sr_hz
    rng = np.random.default_rng(0)
    x = np.stack([
        0.5 * np.sin(2 * np.pi * (140 + 30 * i) * t)
        + 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * 4.1 * t)
        + 0.02 * rng.standard_normal(t.size)
        for i in range(streams)
    ])
    proc = lws_jax.LWS(fsize, fshift, look_ahead=3, online_iterations=10)
    fb = mel_filterbank(n_mels, fsize, sr_hz)
    mag = np.abs(proc.stft(x))
    mel_frames = np.asarray(linear_to_mel(mag, fb))  # (S, T, n_mels)
    T = mel_frames.shape[1]
    print(f"{streams} streams x {T} mel frames ({secs:.1f}s @ {sr_hz} Hz)")

    # --- the serving loop: blocks of mel frames -> linear -> push
    stream = StreamingLWS(proc, streams=streams, emit="host")
    block = stream.block_frames if stream.backend == "gpu" else 16
    print(f"backend={stream.backend}, block={block} frames, "
          f"latency={stream.latency_frames} frames "
          f"({stream.latency_frames * fshift / sr_hz * 1000:.0f} ms)")
    # compile warm-up (first dispatch of each chunk shape compiles, which
    # takes seconds - exclude it from the serving latency report)
    warm = np.zeros((block, streams, fsize // 2 + 1))
    stream.push_frames(warm)
    stream.flush()
    stream.reset()
    stream.stats.reset()

    audio = []
    for i in range(0, T - T % block, block):
        # decoder emits a block of mel frames -> invert -> ONE device
        # dispatch for the whole block (per-frame push_frame costs a full
        # dispatch round-trip per 8 ms hop; blocks amortise it)
        lin = np.asarray(mel_to_linear(mel_frames[:, i:i + block], fb))
        out = stream.push_frames(np.moveaxis(lin, 0, 1))  # (block, S, F)
        if out.shape[-1]:
            audio.append(out)
    audio.append(stream.flush())
    y = np.concatenate([a for a in audio if a.shape[-1]], axis=-1)

    rep = stream.stats.summary(sample_rate=sr_hz)
    per_stream = rep["realtime_factor"]
    print(f"emitted {y.shape[-1] / sr_hz:.2f}s/stream; per-push latency "
          f"p50={rep['p50_s'] * 1e3:.2f}ms p95={rep['p95_s'] * 1e3:.2f}ms "
          f"p99={rep['p99_s'] * 1e3:.2f}ms; realtime x{per_stream:.1f} "
          f"per stream (x{per_stream * streams:.1f} aggregate)")


if __name__ == "__main__":
    main()
