"""Checkpoint / resume / failure recovery for long-running LWS jobs.

The reference runs every stage as one uninterruptible C loop (e.g. batch
sweeps, lwslib/lwslib.cpp:375-441): a crash at sweep 95/100 of a 10-minute
48 kHz job loses everything. Here the whole iteration state of a sweep stage
is just the evolving (sr, si) phase planes plus the iteration index — the
magnitudes are invariant under LWS updates — so the job can be cut at any
sweep boundary, persisted, and resumed bit-exactly.

`resumable_lws` wraps the processor's multi-sweep stages (batch / no-future /
online) with:

- periodic atomic checkpoints (write-tmp + rename; a crash mid-write never
  corrupts the previous checkpoint),
- a config fingerprint (geometry, stage, shapes, threshold schedule) so a
  stale or mismatched checkpoint is refused instead of silently resumed,
- transient-failure retry: a chunk that dies (preempted device, a
  transient runtime error, OOM race) is re-run from the last checkpoint up to
  `max_retries` times before the error propagates.

Resuming after an interruption reproduces the uninterrupted checkpointed
run bit-for-bit (the npz round-trip is exact); chunked execution itself is
quality-identical to the single-call path (the only divergence is the
last-ulp re-derivation of the invariant magnitudes at chunk entry).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time
import warnings

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "resumable_lws",
           "CheckpointMismatch"]


class CheckpointMismatch(RuntimeError):
    """A checkpoint exists but was written by an incompatible job."""


def _fingerprint(proc, stage, shape, thresholds):
    h = hashlib.sha256()
    h.update(repr((proc.fsize, proc.fshift, proc.fftsize, stage,
                   tuple(shape), str(np.dtype(proc.rdtype)))).encode())
    h.update(np.ascontiguousarray(np.asarray(thresholds, np.float64)).tobytes())
    return h.hexdigest()[:32]


def save_checkpoint(path, sr, si, it, fingerprint=""):
    """Atomically persist the sweep state: (sr, si) planes + iteration index.

    Writes to a temp file in the target directory then renames, so readers
    never observe a half-written checkpoint.
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, sr=np.asarray(sr), si=np.asarray(si),
                     it=np.int64(it), fingerprint=np.str_(fingerprint),
                     wall=np.float64(time.time()))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path, fingerprint=None):
    """Load a checkpoint; returns (sr, si, it) or None if absent.

    With `fingerprint`, a mismatching checkpoint raises CheckpointMismatch
    (resuming sweeps of a different geometry/schedule would be silent
    corruption, the failure mode this module exists to prevent).
    """
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        got = str(z["fingerprint"])
        if fingerprint is not None and got != fingerprint:
            raise CheckpointMismatch(
                f"checkpoint {path} was written by a different job "
                f"(fingerprint {got} != expected {fingerprint}); delete it "
                "or point checkpoint_path elsewhere")
        return z["sr"], z["si"], int(z["it"])


def resumable_lws(proc, S, stage="batch", iterations=None, thresholds=None,
                  checkpoint_path=None, checkpoint_every=25, max_retries=2,
                  cleanup=True, progress=None, mesh=None, **stage_kwargs):
    """Run a multi-sweep LWS stage with periodic checkpoints and retry.

    proc: an `lws_jax.LWS` processor. S: spectrogram (complex array or
    (sr, si) pair; same conventions as the stage methods). stage: "batch",
    "nofuture" or "online". checkpoint_path: where the state npz lives; if a
    valid checkpoint exists there, the run resumes from its iteration.
    checkpoint_every: sweeps per chunk (each chunk is one device dispatch;
    smaller = finer recovery granularity, more host round-trips).
    progress: optional callback (done_iterations, total_iterations) called
    after each persisted chunk. cleanup: delete the checkpoint on success.
    mesh / **stage_kwargs: forwarded to the stage (e.g. mesh=, kernel=,
    sweeps_per_exchange= for time-sharded multi-chip batch sweeps — the
    long-job recovery story of docs/MULTIHOST.md).

    Returns the stage output in the same form as the input (complex array
    in -> complex array out, pair in -> pair out).
    """
    if stage not in ("batch", "nofuture"):
        # online RTISI-LA is a single streaming pass over frames whose
        # "iterations" are the per-frame inner loop — it does not decompose
        # into resumable threshold chunks (and is cheap relative to batch);
        # use StreamingLWS for an online stream with carryable state.
        raise ValueError(f"unsupported stage {stage!r} (batch or nofuture)")
    stage_fn = getattr(proc, f"{stage}_lws")
    if mesh is not None:
        if stage != "batch":
            raise ValueError("mesh sharding applies to the batch stage only")
        stage_kwargs = dict(stage_kwargs, mesh=mesh)
    if iterations is None:
        iterations = getattr(proc, f"{stage}_iterations")
    if thresholds is None:
        from .windows import get_thresholds
        thresholds = get_thresholds(
            iterations, *(getattr(proc, f"{stage}_{k}")
                          for k in ("alpha", "beta", "gamma")))
    thr = np.asarray(thresholds, dtype=np.float64)
    n = thr.shape[0]

    was_pair = proc._is_pair(S)
    sr, si = proc._as_pair(S)
    fp = _fingerprint(proc, stage, sr.shape, thr)

    start = 0
    if checkpoint_path is not None:
        state = load_checkpoint(checkpoint_path, fingerprint=fp)
        if state is not None:
            csr, csi, start = state
            if start > n:
                raise CheckpointMismatch(
                    f"checkpoint at iteration {start} exceeds the requested "
                    f"{n} iterations")
            sr, si = (np.asarray(csr, dtype=proc.rdtype),
                      np.asarray(csi, dtype=proc.rdtype))

    every = max(1, int(checkpoint_every))
    k = start
    while k < n:
        chunk = thr[k:k + every]
        attempt = 0
        while True:
            try:
                # keep (sr, si) bound to the pre-chunk host state until the
                # chunk has fully materialised: device faults often surface
                # lazily at np.asarray, and rebinding earlier would make the
                # retry re-run the chunk from the failed call's outputs
                # (double-applying its thresholds)
                nsr, nsi = stage_fn((sr, si), thresholds=chunk, **stage_kwargs)
                nsr, nsi = np.asarray(nsr), np.asarray(nsi)
                sr, si = nsr, nsi
                break
            except (KeyboardInterrupt, CheckpointMismatch):
                raise
            except Exception as e:  # noqa: BLE001 - device/runtime faults
                attempt += 1
                if attempt > max_retries:
                    raise
                warnings.warn(
                    f"lws_jax.checkpoint: {stage} chunk at iteration {k} "
                    f"failed ({type(e).__name__}: {e}); retry "
                    f"{attempt}/{max_retries} from last checkpoint")
        k += chunk.shape[0]
        if checkpoint_path is not None and k < n:
            save_checkpoint(checkpoint_path, sr, si, k, fingerprint=fp)
        if progress is not None:
            progress(k, n)

    if checkpoint_path is not None and cleanup and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    pair = (np.asarray(sr, dtype=proc.rdtype), np.asarray(si, dtype=proc.rdtype))
    return pair if was_pair else proc._ret(pair, False)
