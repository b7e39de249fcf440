"""Observability: per-stage metrics and device profiling.

The reference's only instrumentation is tic/toc wall time and printed
consistency values in the MATLAB demo (matlab/run_lws.m:69-91). Here the
same signals are first-class: `run_with_metrics` executes the 3-stage
pipeline returning structured per-stage numbers (wall time, consistency dB,
real-time factor), and `trace` wraps `jax.profiler` for XProf/TensorBoard
device traces of the kernels.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class StageMetrics:
    stage: str
    wall_s: float
    consistency_db: float
    audio_seconds: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_s if self.wall_s > 0 else float("inf")

    def __str__(self):
        rt = f", {self.realtime_factor:8.1f}x realtime" if self.audio_seconds else ""
        return (f"{self.stage:10s}: {self.wall_s * 1000:8.1f} ms, "
                f"{self.consistency_db:7.2f} dB{rt}")


def run_with_metrics(proc, S, sample_rate: float | None = None):
    """Run no-future -> online -> batch with per-stage instrumentation.

    S: magnitude (or complex) spectrogram(s), (..., T, F) or an (sr, si)
    pair. Returns (recovered, [StageMetrics] incl. the input baseline).
    """
    pair = proc._as_pair(S)
    n_frames = pair[0].shape[-2]
    batch = int(np.prod(pair[0].shape[:-2])) if pair[0].ndim > 2 else 1
    audio_s = (batch * n_frames * proc.fshift / sample_rate) if sample_rate else 0.0

    metrics = [StageMetrics("input", 0.0,
                            float(np.asarray(proc.get_consistency(pair)).mean()),
                            audio_s)]
    stages = [("no-future", proc.nofuture_lws),
              ("online", proc.online_lws),
              ("batch", proc.batch_lws)]
    for name, fn in stages:
        t0 = time.time()
        pair = fn(pair)
        pair[0].block_until_ready()
        wall = time.time() - t0
        metrics.append(StageMetrics(
            name, wall, float(np.asarray(proc.get_consistency(pair)).mean()),
            audio_s))
    out = pair if proc._is_pair(S) else proc._ret(pair, False)
    return out, metrics


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile of the enclosed block (view with XProf):

        with lws_jax.utils.trace("/tmp/lws_trace"):
            proc.batch_lws(S)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
