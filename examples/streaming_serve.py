"""Serving operating points demo: the three ways to run StreamingLWS.

A host-synchronous push pays one host<->device round-trip, which dictates
the serving architecture (docs/API.md "Streaming"):

1. THROUGHPUT — emit="device" + block_frames sized to one dispatch per
   pushed chunk, prefetch on (default): pushes pipeline, each block's
   audio streams to the host asynchronously, the collector pays one tail
   sync. This is bench.py's streaming config.
2. LOW LATENCY — emit="device" + block_frames=1: pushes only enqueue,
   the consumer fetches one block behind; glass-to-glass ~ quantum +
   round-trip.
3. HOST-SYNCHRONOUS — emit="host": each push blocks for its audio and
   pays the round-trip every time.

Usage:
    python examples/streaming_serve.py [seconds]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from lws_jax import LWS
from lws_jax.streaming import StreamingLWS
from lws_jax.device import use_compile_cache

use_compile_cache()


def make_audio(streams, secs, sr_hz):
    t = np.arange(int(secs * sr_hz)) / sr_hz
    rng = np.random.default_rng(0)
    return np.stack([
        0.5 * np.sin(2 * np.pi * (140 + 30 * i) * t)
        + 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * 4.1 * t)
        + 0.02 * rng.standard_normal(t.size)
        for i in range(streams)
    ]).astype(np.float32)


def main():
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    streams, sr_hz, hop = 8, 16000, 128
    x = make_audio(streams, secs, sr_hz)
    proc = LWS(512, 128, look_ahead=3, online_iterations=10)

    # 1. throughput: one dispatch per pushed 0.5 s chunk, async collection
    s = StreamingLWS(proc, streams=streams, emit="device", block_frames=64)
    chunk = 8000
    for i in range(0, x.shape[-1], chunk):  # compile warm-up (all shapes)
        s.push_block(x[:, i:i + chunk])
    s.flush()
    s.reset()
    t0 = time.perf_counter()
    outs = [s.push_block(x[:, i:i + chunk])
            for i in range(0, x.shape[-1], chunk)]
    outs.append(s.flush())
    audio = np.concatenate([np.asarray(o) for o in outs if o.shape[-1]],
                           axis=-1)
    wall = time.perf_counter() - t0
    print(f"throughput point : {streams * secs:.0f} s of audio in "
          f"{wall * 1e3:.0f} ms  ({streams * secs / wall:.0f} audio-s/s, "
          f"{audio.shape[-1]} samples/stream out)")

    # 2. low latency: bf=1 pipelined — enqueue-only pushes; the consumer
    # runs a few blocks behind so prefetched copies are complete when
    # fetched (lag 1 costs a device wait per hop; lag ~8 = 64 ms of
    # pipeline depth absorbs the round-trip and per-dispatch overheads)
    lo = StreamingLWS(proc, streams=streams, emit="device", block_frames=1)
    for i in range(0, 16 * hop, hop):  # warm-up + fill the look-ahead
        lo.push_block(x[:, i:i + hop])
    lo.stats.reset()
    n_push, lag, pending = 64, 8, []
    t0 = time.perf_counter()
    for i in range(16 * hop, (16 + n_push) * hop, hop):
        pending.append(lo.push_block(x[:, i:i + hop]))  # enqueue (~1 ms)
        if len(pending) > lag:
            np.asarray(pending.pop(0))  # consume `lag` blocks behind
    for o in pending:
        np.asarray(o)
    amort = (time.perf_counter() - t0) / n_push
    p = lo.stats.summary()
    print(f"low-latency point: enqueue p50 {p['p50_s'] * 1e3:.2f} ms, "
          f"amortized {amort * 1e3:.2f} ms per 8 ms hop "
          f"({'REAL TIME' if amort < hop / sr_hz else 'NOT real time'}, "
          f"x{hop / sr_hz / amort:.2f})")

    # 3. host-synchronous: minimum real-time quantum bf=8 (64 ms)
    sy = StreamingLWS(proc, streams=streams, emit="host", block_frames=8)
    sy.push_block(x[:, :8 * hop * 8])  # warm-up: 8 blocks
    sy.stats.reset()
    for i in range(8 * hop * 8, min(8 * hop * 40, x.shape[-1]), 8 * hop):
        sy.push_block(x[:, i:i + 8 * hop])
    p = sy.stats.summary()
    quantum_ms = 8 * hop / sr_hz * 1e3
    print(f"host-sync point  : p50 {p['p50_s'] * 1e3:.1f} ms per "
          f"{quantum_ms:.0f} ms push "
          f"({'REAL TIME' if p['p50_s'] * 1e3 < quantum_ms else 'NOT real time'})")


if __name__ == "__main__":
    main()
