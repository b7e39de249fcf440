"""Smoke test of the phase-recovery path on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-3
    python chip_smoke.py --multi    # four cards: phase 4 only

Phases (any failure exits non-zero):

1. Device: JAX's first device must be a GPU; prints its kind and
   `nvidia-smi --query-gpu=name,power.limit`.
2. Kernels against the plain references at real widths (F=257, 513, 1025,
   2049): the GPU batch / no-future / online kernels and the streaming
   kernel entry, compiled for the card, against the XLA path on
   sparse-magnitude inputs (one threshold-passing bin per frame), the batch
   and no-future kernels also against the float64 C++ oracle and the online
   kernel against the reference library's sparse golden: the f32 kernels
   must reproduce the references' update sequence to f32 precision
   (tolerances 2e-3 batch, 8e-3 online).
3. The main path through the public API at the benchmark sizes: the music
   pipeline and batch_lws on 32 x 5 s at 16 kHz, the 1024 x 2.5 s mel
   vocoder, 8 streams through StreamingLWS.push_block, and the 630 s
   48 kHz long-form batch_lws. Each must keep magnitudes to float32
   precision and reach at least the XLA path's consistency gain on the
   same input, less 0.5 dB; each prints its wall and compile time.
4. (--multi) Time-sharded long-form batch_lws (cut to MULTI_LONGFORM_S
   seconds) on a data=1 x time=4 mesh with the per-shard kernel, and
   data-parallel run_lws on a data=4 mesh, each against the same work on
   one card: magnitudes must match and consistency stay within 0.25 dB.

The last line of standard output is one JSON object with the device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import make_batch  # noqa: E402
from lws_jax import LWS, device, get_thresholds, oracle  # noqa: E402
from lws_jax.mel import linear_to_mel, mel_filterbank, mel_to_linear  # noqa: E402
from lws_jax.parallel import data_parallel_run, make_mesh  # noqa: E402
from lws_jax.streaming import StreamingLWS  # noqa: E402

GEOMETRIES = [(512, 128), (1024, 256), (2048, 256), (4096, 1024)]
TOL_BATCH = 2e-3
TOL_ONLINE = 8e-3
LA = 3

failures = []


def log(msg):
    print(msg, flush=True)


def check(name, ok, detail):
    log(f"  {name}: {detail} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)


def check_err(name, got, want, tol):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    check(name, err <= tol, f"max err {err:.3e} (tol {tol:g})")


def sparse_input(T, F, rng):
    """One bin per frame above the others: threshold-passing updates never
    interact within a frame."""
    mag = np.full((T, F), 0.5)
    for m in range(T):
        mag[m, 40 + (m * 3) % 11] = 2.0
    S = mag * np.exp(2j * np.pi * rng.random((T, F)))
    S[:, 0] = mag[:, 0]
    S[:, -1] = mag[:, -1]
    return S


def timed(fn):
    """(output, first-call wall, steady wall): the first call compiles."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def cons(proc, S):
    return np.asarray(proc.get_consistency(S), np.float64)


def mag_err(S, ref_mag):
    """Largest |S| deviation from the target magnitudes, relative to the
    largest magnitude."""
    m = np.abs(np.asarray(S[0]) + 1j * np.asarray(S[1])) if isinstance(
        S, tuple) else np.abs(np.asarray(S))
    return float(np.max(np.abs(m - ref_mag)) / np.max(ref_mag))


def phase_device():
    log("phase 1: device")
    dev = device.require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    log(f"  device_kind: {dev.device_kind}; jax devices: {len(jax.devices())}")
    log(f"  nvidia-smi: {card}")
    log(f"  compile cache: {device.use_compile_cache()}")
    return card


def reference_online(golden):
    """Online kernel and streaming entry against the reference library's
    own output on its sparse golden (F=257, look-ahead 2): one active bin
    per frame, so the f32 kernel must reproduce the reference's frame-commit
    sequencing. (The float64 oracle runs the reference's in-frame raster
    order; the online schedule's threshold-0 initialisation updates every
    bin, so on no input does the oracle isolate the commit sequencing.)"""
    p2 = LWS(512, 128, L=5, look_ahead=2, dtype=jnp.float32)
    A = golden["online_sparse_in"]
    thr = golden["online_sparse_thr"]
    want = golden["online_sparse_out"]
    check_err("F=257 online LA=2 vs reference golden",
              p2.online_lws(A, thresholds=thr), want, TOL_ONLINE)
    stream = StreamingLWS(p2, thresholds=thr, mean_amp=float(np.abs(A).mean()),
                          keep_frames=True, backend="gpu")
    stream.push_frames(A)
    stream.flush()
    check_err("F=257 streaming LA=2 vs reference golden",
              np.stack(stream.committed_frames), want, TOL_ONLINE)


def load_golden():
    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "golden", "ref_q4.npz"))


def phase_kernels():
    log("phase 2: kernels vs XLA path and float64 oracle (sparse, f32)")
    rng = np.random.default_rng(99)
    golden = load_golden()
    thr = np.full(3, 2.0)
    thr_on = np.full(2, 2.0)
    for fsize, fshift in GEOMETRIES:
        p = LWS(fsize, fshift, look_ahead=LA, dtype=jnp.float32)
        px = LWS(fsize, fshift, look_ahead=LA, dtype=jnp.float32,
                 backend="xla")
        F = fsize // 2 + 1
        tag = f"F={F}/Q={p._Qi}"
        check(f"{tag} path", p._use_kernel(F), "auto backend picks the GPU "
              "kernels" if p._use_kernel(F) else "auto backend picks XLA")
        S = sparse_input(48, F, rng)
        for stage, fn, fx, want in (
                ("batch", p.batch_lws, px.batch_lws,
                 lambda: oracle.oracle_sweeps(S, p.W, thr)),
                ("nofuture", p.nofuture_lws, px.nofuture_lws,
                 lambda: oracle.oracle_sweeps(S, p.W_ai, thr,
                                              visibility=-1))):
            got = np.asarray(fn(S, thresholds=thr))
            check_err(f"{tag} {stage} vs xla", got,
                      np.asarray(fx(S, thresholds=thr)), TOL_BATCH)
            check_err(f"{tag} {stage} vs oracle", got, want(), TOL_BATCH)
        got = np.asarray(p.online_lws(S, thresholds=thr_on))
        t0 = time.perf_counter()
        want_x = np.asarray(px.online_lws(S, thresholds=thr_on))
        log(f"  {tag} online XLA reference took "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
        check_err(f"{tag} online LA={LA} vs xla", got, want_x, TOL_ONLINE)
        if fsize == 512:
            stream = StreamingLWS(p, thresholds=thr_on,
                                  mean_amp=float(np.abs(S).mean()),
                                  keep_frames=True, backend="gpu")
            stream.push_frames(S[:29])
            stream.push_frames(S[29:])
            stream.flush()
            check_err(f"{tag} streaming LA={LA} vs offline kernel",
                      np.stack(stream.committed_frames), got, TOL_ONLINE)
            reference_online(golden)
            # segmented kernel (time segments as separate programs,
            # block-Jacobi seams): quality parity with the plain kernel
            A = np.abs(np.asarray(p.stft(make_batch(1, 64000, 16000, rng))))
            pair = (jnp.asarray(A), jnp.zeros_like(jnp.asarray(A)))
            thr_d = jnp.asarray(get_thresholds(6, 1, 0.1, 1), jnp.float32)
            seg = p._batch_seg(*pair, thresholds=thr_d, segments=2,
                               sweeps_per_exchange=1)
            one = p._batch_gpu(*pair, thresholds=thr_d)
            c_s, c_1 = cons(p, seg).mean(), cons(p, one).mean()
            e = mag_err(seg, A)
            check(f"{tag} segmented kernel", e < 1e-5 and abs(c_s - c_1) < 0.5,
                  f"mag err {e:.1e}, consistency {c_s:.2f} vs unsegmented "
                  f"{c_1:.2f} dB")


def compare(tag, card, proc, ref_proc, run, A, S0=None, time_ref=False):
    """Run `run(proc, ...)` (kernel path) and `run(ref_proc, ...)` (XLA) on
    the same input; check magnitudes and the consistency gain. With
    `time_ref` the XLA path is timed like the kernel path (two calls)."""
    out, first, wall = timed(lambda: run(proc))
    log(f"  {tag}: wall {wall:.3f} s, compile {max(first - wall, 0):.1f} s "
        f"(first call {first:.1f} s) on {card}")
    if time_ref:
        ref, rfirst, rwall = timed(lambda: run(ref_proc))
        log(f"  {tag} XLA reference: wall {rwall:.3f} s, compile "
            f"{max(rfirst - rwall, 0):.1f} s on {card}")
    else:
        t0 = time.perf_counter()
        ref = jax.block_until_ready(run(ref_proc))
        log(f"  {tag} XLA reference: first call "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
    e = mag_err(out, A)
    check(f"{tag} magnitudes", e < 1e-6, f"max rel err {e:.1e}")
    c0 = cons(proc, S0 if S0 is not None else (jnp.asarray(A),
                                               jnp.zeros(A.shape, A.dtype)))
    g = (cons(proc, out) - c0).mean()
    g_ref = (cons(proc, ref) - c0).mean()
    check(f"{tag} consistency gain", g >= g_ref - 0.5,
          f"{g:.2f} dB vs XLA {g_ref:.2f} dB")
    return out


def phase_main(card):
    log("phase 3: main path at benchmark sizes")
    rng = np.random.default_rng(0)
    import lws_jax
    golden = load_golden()
    pm = lws_jax.lws(512, 128, L=5, mode="music")
    c = float(cons(pm, pm.run_lws(np.abs(golden["S"]).astype(np.complex64))))
    c_ref = float(golden["consistency_run"])
    check("music pipeline vs reference golden", c > c_ref - 0.8,
          f"{c:.2f} dB vs reference {c_ref:.2f} dB")

    # batch and pipeline: 32 x 5 s at 16 kHz, the public flow
    proc = lws_jax.lws(512, 128, mode="music")
    ref = lws_jax.lws(512, 128, mode="music", backend="xla")
    x = make_batch(32, 5 * 16000, 16000, rng)
    X = np.asarray(proc.stft(x))
    A = np.abs(X).astype(np.float32)
    log(f"  workload: 32 x 5 s at 16 kHz, spectrogram {A.shape}")
    out = compare("pipeline run_lws", card, proc, ref,
                  lambda p: p.run_lws(A.astype(np.complex64)), A,
                  time_ref=True)
    y = np.asarray(proc.istft(out))
    check("pipeline istft", bool(np.all(np.isfinite(y))) and
          y.shape[-1] >= x.shape[-1], f"audio {y.shape}")
    compare("batch_lws 100 iterations", card, proc, ref,
            lambda p: p.batch_lws(A.astype(np.complex64)), A, time_ref=True)

    # vocoder: 1024 mel spectrograms of 2.5 s at 22.05 kHz, 2048/256
    fsize, fshift, sr_hz = 2048, 256, 22050
    pv = LWS(fsize, fshift)
    pvx = LWS(fsize, fshift, backend="xla")
    uniq = make_batch(16, int(2.5 * sr_hz), sr_hz, rng)
    sr, si = pv.stft_ri(uniq)
    fb = mel_filterbank(80, fsize, sr_hz)
    with jax.default_matmul_precision("highest"):
        mel = jnp.tile(linear_to_mel(jnp.sqrt(sr * sr + si * si), fb),
                       (64, 1, 1))
        lin = jax.block_until_ready(mel_to_linear(mel, fb).astype(
            jnp.float32))
    log(f"  workload: vocoder, mel {mel.shape} -> linear {lin.shape}")
    zero = jnp.zeros_like(lin)
    compare("vocoder batch_lws", card, pv, pvx,
            lambda p: p.batch_lws((lin, zero)), np.asarray(lin),
            time_ref=True)

    # streaming: 8 streams, 0.5 s chunks, then flush
    xs = make_batch(8, 5 * 16000, 16000, rng)
    outs = {}
    for be in ("gpu", "xla"):
        ps = LWS(512, 128, look_ahead=LA)
        s = StreamingLWS(ps, streams=8, keep_frames=True, backend=be)

        def run_stream(s=s):
            s.reset()
            audio = [s.push_block(xs[:, i:i + 8000])
                     for i in range(0, xs.shape[-1], 8000)]
            audio.append(s.flush())
            return np.concatenate(audio, axis=-1)

        audio, first, wall = timed(run_stream)
        log(f"  streaming backend={be}: wall {wall:.3f} s, compile "
            f"{max(first - wall, 0):.1f} s, audio {audio.shape}"
            + (f" on {card}" if be == "gpu" else ""))
        outs[be] = (np.stack(s.committed_frames, axis=1), audio, ps)
    com, audio, ps = outs["gpu"]
    com_x = outs["xla"][0]
    check("streaming audio", bool(np.all(np.isfinite(audio))),
          f"{audio.shape}")
    e = float(np.max(np.abs(np.abs(com) - np.abs(com_x)))
              / np.max(np.abs(com_x)))
    check("streaming magnitudes", e < 1e-6, f"max rel err {e:.1e}")
    c0 = cons(ps, np.abs(com_x).astype(np.complex64))
    g = (cons(ps, com) - c0).mean()
    g_ref = (cons(ps, com_x) - c0).mean()
    check("streaming consistency gain", g >= g_ref - 0.5,
          f"{g:.2f} dB vs XLA {g_ref:.2f} dB")

    # long-form: 630 s at 48 kHz, 4096/1024 (F=2049), one stream
    pl_ = LWS(4096, 1024)
    plx = LWS(4096, 1024, backend="xla")
    xl = make_batch(1, 630 * 48000, 48000, rng)
    srl, sil = pl_.stft_ri(xl)
    Al = jnp.sqrt(srl * srl + sil * sil)
    log(f"  workload: long-form 630 s at 48 kHz, spectrogram {Al.shape}, "
        f"{pl_._auto_segments(1, Al.shape[-2])} time segments")
    compare("long-form batch_lws", card, pl_, plx,
            lambda p: p.batch_lws((Al, jnp.zeros_like(Al))), np.asarray(Al))


# four-card phase sizes: the long-form signal is cut to MULTI_LONGFORM_S
# seconds (printed) so the per-shard kernel's unsegmented sweeps stay short
MULTI_LONGFORM_S = 160
MULTI_BATCH = 32
MULTI_SECONDS = 5


def phase_multi():
    log("phase 4: four cards")
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX found {len(devs)}")
    rng = np.random.default_rng(0)
    p = LWS(4096, 1024)
    x = make_batch(1, MULTI_LONGFORM_S * 48000, 48000, rng)
    sr, si = p.stft_ri(x)
    A = jnp.sqrt(sr * sr + si * si)
    A = A[:, :A.shape[1] - A.shape[1] % 4]
    pair = (A, jnp.zeros_like(A))
    mesh_t = make_mesh(data=1, time=4)
    log(f"  long-form cut to {MULTI_LONGFORM_S} s at 48 kHz: {A.shape} on "
        f"mesh data=1 x time=4, per-shard GPU kernel: "
        f"{p._use_kernel(A.shape[-1])}")
    one, f1, w1 = timed(lambda: p.batch_lws(pair))
    sh, f4, w4 = timed(lambda: p.batch_lws(pair, mesh=mesh_t))
    log(f"  long-form batch_lws: one card wall {w1:.3f} s (first "
        f"{f1:.1f} s); time=4 mesh wall {w4:.3f} s (first {f4:.1f} s)")
    An = np.asarray(A)
    for name, o in (("one card", one), ("time-sharded", sh)):
        e = mag_err(o, An)
        check(f"long-form {name} magnitudes", e < 1e-6, f"max rel err {e:.1e}")
    c1, c4 = cons(p, one).mean(), cons(p, sh).mean()
    check("long-form sharded consistency", abs(c4 - c1) < 0.25,
          f"{c4:.2f} dB vs one card {c1:.2f} dB")

    pm = LWS(512, 128, mode="music")
    xb = make_batch(MULTI_BATCH, MULTI_SECONDS * 16000, 16000, rng)
    srb, sib = pm.stft_ri(xb)
    Ab = jnp.sqrt(srb * srb + sib * sib)
    pb = (Ab, jnp.zeros_like(Ab))
    mesh_d = make_mesh(data=4, time=1)
    def run(r, i):
        return pm.run_lws((r, i))

    one, f1, w1 = timed(lambda: pm.run_lws(pb))
    dp, f4, w4 = timed(lambda: data_parallel_run(run, pb, mesh_d))
    log(f"  run_lws {Ab.shape}: one card wall {w1:.3f} s (first {f1:.1f} s);"
        f" data=4 mesh wall {w4:.3f} s (first {f4:.1f} s)")
    e = mag_err(dp, np.asarray(Ab))
    check("data-parallel magnitudes", e < 1e-6, f"max rel err {e:.1e}")
    c1, c4 = cons(pm, one).mean(), cons(pm, dp).mean()
    check("data-parallel consistency", abs(c4 - c1) < 0.25,
          f"{c4:.2f} dB vs one card {c1:.2f} dB")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    t0 = time.perf_counter()
    card = phase_device()
    if args.multi:
        phase_multi()
    else:
        phase_kernels()
        phase_main(card)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failures:
        log(f"SMOKE FAIL: {failures}")
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device.describe()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
