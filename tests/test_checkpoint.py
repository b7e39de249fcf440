"""Checkpoint / resume / failure recovery (lws_jax/checkpoint.py).

The key guarantees under test:
- resuming an interrupted run reproduces the uninterrupted checkpointed run
  bit-for-bit (npz round-trip is exact, chunk boundaries identical),
- chunked execution is quality-identical to the single-call stage,
- a mismatched checkpoint is refused, never silently resumed,
- transient chunk failures are retried from the last good state.
"""
import os

import numpy as np
import pytest

import lws_jax
from lws_jax.checkpoint import (CheckpointMismatch, load_checkpoint,
                                resumable_lws, save_checkpoint)


@pytest.fixture(scope="module")
def proc():
    return lws_jax.LWS(512, 128, batch_iterations=12)


@pytest.fixture(scope="module")
def spec(proc):
    rng = np.random.default_rng(11)
    x = (np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)
         + 0.1 * rng.standard_normal(16000))
    return np.abs(proc.stft(x)).astype(np.complex128)


def test_chunked_matches_single_call_quality(proc, spec, tmp_path):
    full = proc.batch_lws(spec, iterations=12)
    chunked = resumable_lws(proc, spec, stage="batch", iterations=12,
                            checkpoint_path=str(tmp_path / "c.npz"),
                            checkpoint_every=5)
    c_full = float(proc.get_consistency(full))
    c_chunk = float(proc.get_consistency(chunked))
    # magnitudes invariant, phases quality-identical (chunk entry re-derives
    # the invariant magnitudes, a last-ulp effect)
    assert np.allclose(np.abs(chunked), np.abs(spec), rtol=1e-9, atol=1e-12)
    assert abs(c_full - c_chunk) < 0.05
    assert not os.path.exists(tmp_path / "c.npz")  # cleaned up on success


def test_resume_bitexact_after_interruption(proc, spec, tmp_path):
    path = str(tmp_path / "resume.npz")

    # uninterrupted checkpointed run
    ref = resumable_lws(proc, spec, stage="batch", iterations=12,
                        checkpoint_path=path, checkpoint_every=4)

    # interrupted run: the progress callback kills the job after 2 chunks
    class Boom(RuntimeError):
        pass

    def bomb(done, total):
        if done >= 8:
            raise Boom()

    with pytest.raises(Boom):
        resumable_lws(proc, spec, stage="batch", iterations=12,
                      checkpoint_path=path, checkpoint_every=4, progress=bomb)
    assert os.path.exists(path)
    _, _, it = load_checkpoint(path)
    assert it == 8

    # resume: picks up at iteration 8, runs the last chunk, matches exactly
    out = resumable_lws(proc, spec, stage="batch", iterations=12,
                        checkpoint_path=path, checkpoint_every=4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert not os.path.exists(path)


def test_fingerprint_mismatch_refused(proc, spec, tmp_path):
    path = str(tmp_path / "fp.npz")
    sr = np.zeros((3, 5), np.float32)
    save_checkpoint(path, sr, sr, 2, fingerprint="deadbeef")
    with pytest.raises(CheckpointMismatch):
        resumable_lws(proc, spec, stage="batch", iterations=12,
                      checkpoint_path=path, checkpoint_every=4)
    # explicit load without a fingerprint still works (inspection/tooling)
    got = load_checkpoint(path)
    assert got is not None and got[2] == 2


def test_transient_failure_retried(proc, spec, tmp_path, monkeypatch):
    calls = {"n": 0}
    real = proc.batch_lws

    def flaky(S, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device loss")
        return real(S, **kw)

    monkeypatch.setattr(proc, "batch_lws", flaky)
    with pytest.warns(UserWarning, match="retry 1/2"):
        out = resumable_lws(proc, spec, stage="batch", iterations=8,
                            checkpoint_path=str(tmp_path / "r.npz"),
                            checkpoint_every=4, max_retries=2)
    monkeypatch.undo()
    ref = resumable_lws(proc, spec, stage="batch", iterations=8,
                        checkpoint_path=None, checkpoint_every=4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_lazy_failure_retries_from_prechunk_state(proc, spec, tmp_path,
                                                  monkeypatch):
    """A device fault surfacing at materialisation (np.asarray of a lazily
    evaluated result, a common device transient) must retry from the
    PRE-chunk state: retrying from the failed call's outputs would apply the
    chunk's thresholds twice and silently diverge from the uninterrupted
    run."""
    armed = {"on": True}

    class LazyFault:
        """Wraps a real result; the first materialisation raises (the
        transient-fault window), later ones succeed."""

        def __init__(self, arr):
            self._arr = np.asarray(arr)

        def __array__(self, dtype=None, copy=None):
            if armed["on"]:
                armed["on"] = False
                raise RuntimeError("simulated lazy device fault")
            return self._arr if dtype is None else self._arr.astype(dtype)

    real = proc.batch_lws
    calls = {"n": 0}

    def flaky(S, **kw):
        calls["n"] += 1
        out = real(S, **kw)
        if calls["n"] == 2:
            return LazyFault(out[0]), LazyFault(out[1])
        return out

    monkeypatch.setattr(proc, "batch_lws", flaky)
    with pytest.warns(UserWarning, match="retry 1/2"):
        out = resumable_lws(proc, spec, stage="batch", iterations=8,
                            checkpoint_path=str(tmp_path / "lf.npz"),
                            checkpoint_every=4, max_retries=2)
    monkeypatch.undo()
    ref = resumable_lws(proc, spec, stage="batch", iterations=8,
                        checkpoint_path=None, checkpoint_every=4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_retries_exhausted_raises(proc, spec, monkeypatch):
    def dead(S, **kw):
        raise RuntimeError("permanent failure")

    monkeypatch.setattr(proc, "batch_lws", dead)
    with pytest.raises(RuntimeError, match="permanent failure"), \
            pytest.warns(UserWarning):
        resumable_lws(proc, spec, stage="batch", iterations=8,
                      checkpoint_every=4, max_retries=2)


def test_nofuture_stage_and_pair_io(proc, spec, tmp_path):
    pair = (np.asarray(spec.real, np.float64), np.asarray(spec.imag, np.float64))
    out = resumable_lws(proc, pair, stage="nofuture", iterations=6,
                        checkpoint_path=str(tmp_path / "nf.npz"),
                        checkpoint_every=3)
    assert isinstance(out, tuple) and len(out) == 2
    ref = proc.nofuture_lws(spec, iterations=6)
    c0 = float(proc.get_consistency(out))
    c1 = float(proc.get_consistency(ref))
    # chunk-boundary last-ulp magnitude re-derivation amplifies through the
    # chaotic GS iteration; quality-equivalence is the guarantee here (the
    # bit-exact guarantee is same-chunking resume, tested above)
    assert abs(c0 - c1) < 0.3 and c0 > 10


def test_online_stage_rejected(proc, spec):
    with pytest.raises(ValueError, match="unsupported stage"):
        resumable_lws(proc, spec, stage="online", iterations=4)


def test_mesh_passthrough_matches_direct(proc, spec, tmp_path):
    """resumable_lws(mesh=...) runs the time-sharded batch path per chunk and
    reproduces the direct mesh run (docs/MULTIHOST.md long-job recovery)."""
    import jax
    from lws_jax.parallel import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    A = spec[:spec.shape[0] - spec.shape[0] % 4][None]  # (1, T%4==0, F)
    mesh = make_mesh(data=1, time=4)
    ref = np.asarray(proc.batch_lws(A, iterations=8, mesh=mesh))
    out = np.asarray(lws_jax.resumable_lws(
        proc, A, iterations=8, checkpoint_path=str(tmp_path / "ck.npz"),
        checkpoint_every=3, mesh=mesh))
    np.testing.assert_allclose(out, ref, atol=1e-10)
    with pytest.raises(ValueError):
        lws_jax.resumable_lws(proc, A, stage="nofuture", iterations=2,
                              mesh=mesh)
