"""Benchmark harness: all five BASELINE.json configs (plus a streaming
serving config) on one GPU.

Configs (BASELINE.json "configs", reference canonical settings from
matlab/run_lws.m:48-55 / python/lws.pyx:379-383):
  1 batch     batch LWS, 32x5s 16 kHz utterances, 512/128 (Q=4), 100 iters
  2 pipeline  full 3-stage music pipeline (nofuture 1 + online 10 + batch
              100) on a 32-utterance batch at 1024-pt FFT
  3 online    online-only RTISI-LA, look-ahead 3, 10 iters, 32 streams
  4 vocoder   TTS post-processing: 1024 mel spectrograms (80-band mel ->
              pinv -> linear) -> batch LWS at 2048-pt FFT
  5 longform  48 kHz >10 min single stream, 4096-pt FFT, batch LWS
              (time-segmented kernel; the four-card sharded variant is
              checked by `chip_smoke.py --multi`)
  6 streaming real-time chunked serving through StreamingLWS.push_block
              (raw samples in, committed audio out, one dispatch per block)
  7 fastmode  config 1's workload under order="jacobi_mxu" (whole-grid
              Jacobi sweeps as banded matmuls)
  8 batch_hq  config 1's workload at the quality-first library schedule
              (in-frame re-passes; at-or-above the float64 oracle)

The "batch" headline row runs inner_passes=1 — the reference-iteration-
parity serving mode; batch_hq shows what the quality-first library
schedule costs/buys.

It measures the card: without a GPU it stops with an error. Prints ONE JSON
line on stdout: the headline metric (config 1, the BASELINE.md
100x-real-time north-star), a "configs" object holding the audio-s/s/chip of
every config, and the device (platform, device_kind, count). Details on
stderr.

Usage: python bench.py [--config N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def make_batch(B, n, sr_hz, rng):
    """Tone + chirp + noise mixtures (realistic harmonic spectrograms)."""
    t = np.arange(n) / sr_hz
    xs = []
    for i in range(B):
        f0 = 120 + 40 * (i % 8)
        x = (0.5 * np.sin(2 * np.pi * f0 * 2 * t)
             + 0.3 * np.sin(2 * np.pi * (f0 * 4.7) * t + 0.3 * i)
             + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
             + 0.05 * rng.standard_normal(n))
        xs.append(x)
    return np.stack(xs).astype(np.float32)


def _timed(fn, *args, n_rep=3, **kw):
    """Compile+warm once, then the median wall of n_rep reps, each ending
    when the device has finished (block_until_ready)."""
    import jax

    jax.block_until_ready(fn(*args, **kw))
    walls = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls))


def bench_batch():
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    B, secs, iters = 32, 5.0, 100
    rng = np.random.default_rng(0)
    x = make_batch(B, int(secs * 16000), 16000, rng)
    # serving mode at reference iteration parity: inner_passes=1 is the
    # single-pass sweep (the quality-first 3-pass default is the separate
    # batch_hq row)
    proc = LWS(512, 128, inner_passes=1)
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))
    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)
    out, wall = _timed(proc._batch_fn, *pair, thresholds=thr)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="batch", audio_s=B * secs, wall=wall, iters=iters,
                shape=tuple(amp.shape), cons=(c0, c1))


def bench_pipeline():
    import jax.numpy as jnp
    from lws_jax import LWS
    B, secs = 32, 5.0
    rng = np.random.default_rng(1)
    x = make_batch(B, int(secs * 16000), 16000, rng)
    # serving mode (inner_passes=1) as in bench_batch
    proc = LWS(1024, 256, mode="music", inner_passes=1)
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))

    def run(p):
        return proc.run_lws(p)

    out, wall = _timed(run, pair)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="pipeline", audio_s=B * secs, wall=wall,
                iters="1+10+100", shape=tuple(amp.shape), cons=(c0, c1))


def bench_online():
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    B, secs, iters = 32, 5.0, 10
    rng = np.random.default_rng(2)
    x = make_batch(B, int(secs * 16000), 16000, rng)
    proc = LWS(512, 128, look_ahead=3)
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))
    thr = jnp.asarray(get_thresholds(iters, 1, 0.1, 1), dtype=proc.rdtype)
    out, wall = _timed(proc._online_fn, *pair, thresholds=thr)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="online", audio_s=B * secs, wall=wall, iters=iters,
                shape=tuple(amp.shape), cons=(c0, c1))


def bench_vocoder():
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    from lws_jax.mel import mel_filterbank, linear_to_mel, mel_to_linear
    B, secs, iters = 1024, 2.5, 100
    sr_hz, fsize, fshift = 22050, 2048, 256
    rng = np.random.default_rng(3)
    uniq = make_batch(16, int(secs * sr_hz), sr_hz, rng)
    proc = LWS(fsize, fshift)
    sr, si = proc.stft_ri(uniq)
    mag = jnp.sqrt(sr * sr + si * si)
    fb = mel_filterbank(80, fsize, sr_hz)
    mel = linear_to_mel(mag, fb)  # the vocoder's input representation
    reps = B // mel.shape[0]
    mel = jnp.tile(mel, (reps, 1, 1))

    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)

    def run(mel_in):
        lin = mel_to_linear(mel_in, fb).astype(proc.rdtype)
        return proc._batch_fn(lin, jnp.zeros_like(lin), thresholds=thr)

    out, wall = _timed(run, mel)
    c1 = float(np.asarray(proc.get_consistency((out[0][:16], out[1][:16]))).mean())
    return dict(name="vocoder", audio_s=B * secs, wall=wall, iters=iters,
                shape=(B,) + tuple(mel.shape[-2:]), cons=(None, c1))


def bench_longform():
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    secs, iters = 630.0, 100
    sr_hz, fsize, fshift = 48000, 4096, 1024
    rng = np.random.default_rng(4)
    x = make_batch(1, int(secs * sr_hz), sr_hz, rng)
    proc = LWS(fsize, fshift)
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))
    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)
    out, wall = _timed(proc._batch_fn, *pair, thresholds=thr, n_rep=1)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="longform", audio_s=secs, wall=wall, iters=iters,
                shape=tuple(amp.shape), cons=(c0, c1))


def bench_streaming():
    """Real-time chunked serving: StreamingLWS.push_block through the
    carried-state online kernel (framing/STFT/OLA on device, raw samples
    in, committed audio out; BASELINE config 3's 'real-time chunking'
    flavour - the offline 'online' row above is the same algorithm
    batch-offline). Device emission pipelines the chunk dispatches and
    prefetch streams each block's audio to the host asynchronously; the
    final materialisation is inside the timed region. Median of 11 runs.

    Latency operating points: host-synchronous pushes at block_frames 32
    and 8 (each push's wall is its latency), and the pipelined device-emit
    mode at block_frames=1 (one 8 ms hop per dispatch), which serves in
    real time when the amortized wall per push stays under the hop.
    """
    from lws_jax import LWS
    from lws_jax.streaming import StreamingLWS
    streams, secs, iters = 8, 5.0, 10
    chunk = 8000  # 0.5 s at 16 kHz
    rng = np.random.default_rng(5)
    x = make_batch(streams, int(secs * 16000), 16000, rng)
    proc = LWS(512, 128, look_ahead=3, online_iterations=iters)
    # block_frames=64: one kernel dispatch per pushed 0.5 s chunk (62.5
    # frames), so the throughput row does not split a chunk into several
    # dispatches; bf=1 low-latency serving is the separate pipelined row
    s = StreamingLWS(proc, iterations=iters, streams=streams, emit="device",
                     block_frames=64)

    def run():
        s.reset()
        outs = []
        for i in range(0, x.shape[-1], chunk):
            outs.append(s.push_block(x[:, i:i + chunk]))
        outs.append(s.flush())
        # prefetch started each block's device->host copy at emit time, so
        # these fetches mostly find the bytes already on host; only the
        # pipeline tail is waited on (one sync, not one per block)
        return np.concatenate([np.asarray(o) for o in outs if o.shape[-1]],
                              axis=-1)

    run()  # compile warm-up
    run()
    walls = []
    for _ in range(11):
        t0 = time.time()
        run()
        walls.append(time.time() - t0)
    wall = float(np.median(walls))
    print(f"[bench] streaming rep walls (ms): "
          f"{[round(w * 1e3) for w in sorted(walls)]}", file=sys.stderr)
    # quality check (untimed): consistency of the committed spectrogram
    # (reuse the compiled stream; keep_frames only toggles host retention)
    s.reset()
    s.keep_frames = True
    for i in range(0, x.shape[-1], chunk):
        s.push_block(x[:, i:i + chunk])
    s.flush()
    com = np.stack(s.committed_frames, axis=1)  # (S, T, F)
    c1 = float(np.asarray(proc.get_consistency(com)).mean())

    # host-synchronous operating points (StreamStats p50/95/99 per push; a
    # push's wall is its real latency): bf=32 (256 ms of audio per push)
    # and bf=8 (64 ms)
    lat = {}
    for bf in (32, 8):
        sl = StreamingLWS(proc, iterations=iters, streams=streams,
                          emit="host", block_frames=bf)
        n = bf * 128 * 8  # warm-up: 8 blocks
        sl.push_block(x[:, :n])
        sl.stats.reset()
        end = n + bf * 128 * (16 if bf == 32 else 64)
        for i in range(n, min(end, x.shape[-1]), bf * 128):
            sl.push_block(x[:, i:i + bf * 128])
        smry = sl.stats.summary()
        lat[bf] = {k: smry.get(k) for k in ("p50_s", "p95_s", "p99_s")}
        lat[bf]["mode"] = "sync"

    # pipelined low-latency point: bf=1 (one 8 ms hop per dispatch),
    # device emit. Sustained real time requires amortized wall/push < hop;
    # per-push enqueue latency is what the caller blocks on.
    sp = StreamingLWS(proc, iterations=iters, streams=streams,
                      emit="device", block_frames=1)
    hop = 128
    n_warm, n_push = 16, 128
    n_win = 3  # median over windows: one window can catch a host stall
    outs = []
    for i in range(0, n_warm * hop, hop):
        outs.append(sp.push_block(x[:, i:i + hop]))
    np.asarray(outs[-1])  # drain the warm-up pipeline
    per, amorts = [], []
    pos = n_warm * hop
    for _ in range(n_win):
        t0 = time.time()
        last = None
        for _ in range(n_push):
            t1 = time.perf_counter()
            last = sp.push_block(x[:, pos:pos + hop])
            per.append(time.perf_counter() - t1)
            pos = (pos + hop) % (x.shape[-1] - hop)
        np.asarray(last)  # materialise the tail: amortized includes drain
        amorts.append((time.time() - t0) / n_push)
    amort = float(np.median(amorts))
    per = np.asarray(per)
    lat[1] = {"p50_s": float(np.percentile(per, 50)),
              "p95_s": float(np.percentile(per, 95)),
              "p99_s": float(np.percentile(per, 99)),
              "mode": "pipelined", "amortized_s": amort,
              "rt_factor": float((hop / 16000.0) / amort)}
    return dict(name="streaming", audio_s=streams * secs, wall=wall,
                iters=iters, shape=(streams, int(secs * 16000)),
                cons=(None, c1), latency=lat)


def bench_fastmode():
    """The matmul Jacobi fast mode (order="jacobi_mxu"): the batch workload
    with the frequency taps as banded matmuls over the whole grid."""
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    B, secs, iters = 32, 5.0, 100
    rng = np.random.default_rng(0)
    x = make_batch(B, int(secs * 16000), 16000, rng)
    proc = LWS(512, 128, order="jacobi_mxu")
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))
    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)
    out, wall = _timed(proc._batch_fn, *pair, thresholds=thr)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="fastmode", audio_s=B * secs, wall=wall, iters=iters,
                shape=tuple(amp.shape), cons=(c0, c1))


def bench_batch_hq():
    """Config 1's workload at the quality-first LIBRARY schedule (3
    in-frame re-passes at Q=4, at-or-above the float64 oracle on every
    bench-scale signal, QUALITY.md)."""
    import jax.numpy as jnp
    from lws_jax import LWS, get_thresholds
    B, secs, iters = 32, 5.0, 100
    rng = np.random.default_rng(0)
    x = make_batch(B, int(secs * 16000), 16000, rng)
    proc = LWS(512, 128)
    sr, si = proc.stft_ri(x)
    amp = jnp.sqrt(sr * sr + si * si)
    pair = (amp, jnp.zeros_like(amp))
    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)
    out, wall = _timed(proc._batch_fn, *pair, thresholds=thr)
    c0 = float(np.asarray(proc.get_consistency(pair)).mean())
    c1 = float(np.asarray(proc.get_consistency(out)).mean())
    return dict(name="batch_hq", audio_s=B * secs, wall=wall, iters=iters,
                shape=tuple(amp.shape), cons=(c0, c1))


BENCHES = {
    1: bench_batch,
    2: bench_pipeline,
    3: bench_online,
    4: bench_vocoder,
    5: bench_longform,
    6: bench_streaming,
    7: bench_fastmode,
    8: bench_batch_hq,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0, choices=range(0, 9),
                    help="run one config (1-8); default all")
    args = ap.parse_args()

    from lws_jax import device
    device.require_gpu()
    device.use_compile_cache()

    todo = [args.config] if args.config else sorted(BENCHES)
    rows = []
    for idx in todo:
        r = BENCHES[idx]()
        rows.append(r)
        c0, c1 = r["cons"]
        if c1 is None:
            cons = "n/a"
        elif c0 is None:
            cons = f"->{c1:.2f}"
        else:
            cons = f"{c0:.2f}->{c1:.2f}"
        print(f"[bench] {r['name']}: shape={r['shape']} iters={r['iters']} "
              f"wall={r['wall'] * 1000:.0f}ms "
              f"rate={r['audio_s'] / r['wall']:.0f} audio-s/s "
              f"consistency {cons} dB", file=sys.stderr)

    head = rows[0]
    value = head["audio_s"] / head["wall"]
    # the headline (and its 100x-real-time north-star ratio) is
    # config 1's rate; a single-config run of any other config labels the
    # metric by name and carries no vs_baseline so harnesses parsing the
    # one-JSON-line contract never record the wrong headline number
    is_headline = head["name"] == "batch"
    payload = {
        "metric": ("audio_seconds_per_second_per_chip" if is_headline
                   else f"{head['name']}_audio_seconds_per_second_per_chip"),
        "value": round(value, 1),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / 100.0, 3) if is_headline else None,
        "configs": {r["name"]: round(r["audio_s"] / r["wall"], 1) for r in rows},
    }
    dev = device.describe()
    payload.update(platform=dev["platform"], device_kind=dev["kind"],
                   device_count=dev["count"])

    def _lat_json(d):
        out = {}
        for k, v in d.items():
            if v is None:
                continue
            if k in ("p50_s", "p95_s", "p99_s"):
                out[k[:3]] = round(v * 1e3, 2)
            elif k == "amortized_s":
                out["amortized"] = round(v * 1e3, 2)
            elif k == "rt_factor":
                out["rt_factor"] = round(v, 2)
            else:
                out[k] = v
        return out

    for r in rows:
        if r.get("latency"):
            payload["streaming_latency_ms"] = {
                str(bf): _lat_json(d) for bf, d in r["latency"].items()}
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
