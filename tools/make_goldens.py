"""Regenerate the golden test vectors in tests/golden/*.npz from the
*reference* C core, rebuilt at run time.

Chain of trust
--------------
The reference sdist (lws-1.2.8.tar.gz, vendored read-only under
/root/reference/python/dist/) ships `lwslib/lwslib.cpp` — the actual C
compute core of Jonathan-LeRoux/lws. This tool:

  1. extracts the sdist to a temp dir and compiles `liblwsref.so` from it
     (a 3-line extern-C wrapper written here; no reference code is copied
     into this repo),
  2. prepares inputs (windows, weights, STFT, extended spectrograms) with
     the published float64 math below — the same formulas lws_jax's own
     windows.py/weights.py/stft.py implement (lws.pyx:10-206 documents
     them); operation order follows the reference so regeneration is
     bit-reproducible,
  3. drives the reference kernels via ctypes exactly as the reference's
     own Python layer does (python/lws.pyx:209-320 semantics), and
  4. writes tests/golden/ref_*.npz, or with --check regenerates into a
     temp dir and asserts the committed files are reproduced.

Usage:
    python tools/make_goldens.py --check     # verify committed goldens
    python tools/make_goldens.py --write     # overwrite tests/golden/
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tarfile
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
SDIST_CANDIDATES = [
    "/root/reference/python/dist/lws-1.2.8.tar.gz",
]

WRAPPER = 'extern "C" {\n#include "lwslib/lwslib.cpp"\n}\n'

D = ctypes.POINTER(ctypes.c_double)
I = ctypes.POINTER(ctypes.c_int)


def build_reference_core(workdir: str) -> ctypes.CDLL:
    """Extract the reference sdist and compile its C core to a shared lib."""
    sdist = next((p for p in SDIST_CANDIDATES if os.path.exists(p)), None)
    if sdist is None:
        raise FileNotFoundError(
            "reference sdist not found (looked at %s); pass --sdist" % SDIST_CANDIDATES)
    with tarfile.open(sdist) as tf:
        tf.extractall(workdir, filter="data")
    src_root = os.path.join(workdir, "lws-1.2.8")
    wrap = os.path.join(workdir, "wrap.cpp")
    with open(wrap, "w") as f:
        f.write(WRAPPER)
    so = os.path.join(workdir, "liblwsref.so")
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-I", src_root, wrap, "-o", so],
        check=True)
    return ctypes.CDLL(so)


def dp(a):
    assert a.dtype == np.float64 and a.flags.c_contiguous
    return a.ctypes.data_as(D)


def ip(a):
    assert a.dtype == np.intc and a.flags.c_contiguous
    return a.ctypes.data_as(I)


# ---------------------------------------------------------------------------
# Host-side prep: the published LWS math (Le Roux et al., DAFx 2010; the
# formulas python/lws.pyx:10-206 documents), float64, written in this tool's
# own vectorized idiom. Per-element arithmetic ORDER matches the reference
# evaluation so regeneration stays bit-stable against the committed goldens
# (the C kernels are driven with these prep outputs, so any prep drift would
# cascade). lws_jax implements the same math independently in
# windows.py / weights.py / stft.py; the golden tests compare the two, so
# keep this block free of lws_jax imports.
# ---------------------------------------------------------------------------

def hann(n, symmetric=True, use_offset=False):
    """Hann window; the symmetric form samples the cosine at half-integer
    points (odd numerators over 2n)."""
    if symmetric:
        num = np.arange(1, 2 * n, 2)
        return 0.5 * (1 - np.cos(2 * np.pi * num / (2 * n)))
    num = np.arange(n) + (1 if use_offset else 0)
    return 0.5 * (1 - np.cos(2 * np.pi * num / n))


def synthwin(awin, fshift, swin=None):
    """COLA normalizer: fold awin*swin over the Q shift offsets, divide."""
    fsize = len(awin)
    Q = -(-fsize // fshift)
    if swin is None:
        swin = awin
    prod = np.concatenate([awin * swin, np.zeros(Q * fshift - fsize)])
    fold = np.sum(prod.reshape(Q, fshift), axis=0)
    denom = np.tile(fold, Q)[:fsize]
    if denom.min() <= 0:
        raise ValueError("The normalizer is not strictly positive")
    return swin / denom


def stft(x, fsize, fshift, awin, fftsize=None, perfectrec=False):
    """Framed FFT, non-negative bins only. perfectrec pre/post zero-padding
    places the signal start on a frame boundary."""
    if fftsize is None:
        fftsize = fsize
    x = np.asarray(x, dtype=np.float64)
    if perfectrec:
        rem = fsize % fshift
        lead = fsize - (fshift if rem == 0 else rem)
        tail = (-len(x)) % fshift
        x = np.concatenate([np.zeros(lead), x, np.zeros(tail)])
        n_frames = len(x) // fshift
    else:
        tail = (-(len(x) - fsize)) % fshift
        x = np.concatenate([x, np.zeros(tail)])
        n_frames = (len(x) - fsize) // fshift + 1
    need = (n_frames - 1) * fshift + fsize
    if need > len(x):
        x = np.concatenate([x, np.zeros(need - len(x))])
    offs = fshift * np.arange(n_frames)
    frames = x[offs[:, None] + np.arange(fsize)] * awin
    return np.fft.fft(frames, n=fftsize, axis=-1)[:, :fftsize // 2 + 1]


def istft(spec, fshift, swin, fftsize=None, perfectrec=False):
    """Inverse STFT by overlap-add; each frame's full Hermitian spectrum is
    rebuilt from the non-negative bins."""
    n_frames, nbins = spec.shape
    fsize = 2 * (nbins - 1)
    if fftsize is None:
        fftsize = fsize
    if fftsize > len(swin):
        swin = np.concatenate([swin, np.zeros(fftsize - len(swin))])
    mirror = np.conj(spec[:, 1:-1][:, ::-1])
    frames = np.real(np.fft.ifft(np.concatenate([spec, mirror], axis=1),
                                 n=fftsize, axis=-1))[:, :fsize] * swin
    out = np.zeros(fshift * (n_frames - 1) + fsize)
    np.add.at(out, fshift * np.arange(n_frames)[:, None] + np.arange(fsize),
              frames)
    if perfectrec:
        rem = fsize % fshift
        lead = fsize - (fshift if rem == 0 else rem)
        out = out[lead:(fshift - fsize)]
    return out


def get_consistency(S, fsize, fshift, awin, swin, perfectrec=False):
    tmp = stft(istft(S, fshift, swin, perfectrec=perfectrec),
               fsize, fshift, awin, perfectrec=perfectrec)
    return 20 * np.log10(np.linalg.norm(S) / np.linalg.norm(tmp - S))


def extspec(S, L, Q):
    """Halo'd spectrogram: conjugate-reflected +-L frequency margins
    (Hermitian symmetry below DC / above Nyquist), Q-1 replicated edge
    frames (including their frequency margins)."""
    body = np.concatenate(
        [np.conj(S[:, L:0:-1]), S, np.conj(S[:, -2:-2 - L:-1])], axis=1)
    top = np.repeat(body[:1], Q - 1, axis=0)
    bot = np.repeat(body[-1:], Q - 1, axis=0)
    return np.concatenate([top, body, bot], axis=0)


def create_weights(awin, swin, fshift, L, use_summarized_weights=True):
    """The LWS weight tensor, (Qprime, Q, L+1) complex128: an (L+1)-row DFT
    of the per-shift window products, a -k/Qfloat phase tilt, the identity
    tap removed, and a per-row phase ramp over the Qprime bin classes."""
    T = len(awin)
    Q = -(-T // fshift)
    Qf = float(T) / float(fshift)
    n_rows = Q if (T % fshift == 0 and use_summarized_weights) else T
    ks = np.arange(L + 1)[:, None]
    # prod[t, q] = awin[t] * swin[t + q*fshift] / T, zero where the shifted
    # synthesis window runs off the end (gathered from a zero-padded copy)
    sw_ext = np.concatenate([swin, np.zeros(Q * fshift)])
    gather = np.arange(T)[:, None] + fshift * np.arange(Q)[None, :]
    prod = awin[:, None] * sw_ext[gather] / T
    dft = np.exp(-1j * 2 * np.pi * ks * np.arange(T) / T)
    core = dft.dot(prod) * np.exp(-1j * 2 * np.pi * ks * np.arange(Q) / Qf)
    core[0, 0] = core[0, 0] - 1
    phase = np.exp(1j * 2 * np.pi * np.arange(n_rows)[:, None] * np.arange(Q) / Qf)
    return (core[:, np.newaxis] * phase[np.newaxis, :]).transpose((1, 2, 0))


def build_asymmetric_windows(awin_swin, fshift):
    """RTISI-LA mirrored envelopes: partial (shifts 1..Q-1) and full shift
    sums of the combined window product, time-flipped."""
    T = len(awin_swin)
    Q = -(-T // fshift)
    w_ext = np.concatenate([awin_swin, np.zeros(Q * fshift)])
    shifted = w_ext[np.arange(T)[:, None] + fshift * np.arange(Q)[None, :]]
    win_ai = np.sum(shifted[:, 1:], axis=1)[::-1]
    win_af = np.sum(shifted, axis=1)[::-1]
    if T % fshift == 2:
        win_ai = awin_swin  # the reference's Q=2 fallback (python/lws.pyx:198)
    return win_ai, win_af


def get_thresholds(iterations, alpha, beta, gamma):
    return alpha * np.exp(-beta * np.arange(iterations) ** gamma)


# ---------------------------------------------------------------------------
# ctypes dispatch into the reference kernels (semantics of lws.pyx:209-320)
# ---------------------------------------------------------------------------

class RefCore:
    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def _prep(self, S, W, L, Q):
        if W.shape[0] != Q:
            # Fractional weights: the reference C kernels index weight row
            # N == 2*(Nreal-1) for the DC bin — one row past the array (an
            # out-of-bounds read, lwslib.cpp:408; SURVEY.md 2.5.2). Append
            # the wrap row (== row 0, the consistent phase ramp) so the
            # kernels compute the intended value on valid memory.
            W = np.concatenate([W, W[:1]], axis=0)
        Wr = np.ascontiguousarray(W.real)
        Wi = np.ascontiguousarray(W.imag)
        Wflag = np.ascontiguousarray(np.abs(W) > 1.0e-12, dtype=np.intc)
        ExtS = extspec(S.astype(np.complex128), L, Q)
        return (Wr, Wi, Wflag,
                np.ascontiguousarray(ExtS.real),
                np.ascontiguousarray(ExtS.imag),
                np.ascontiguousarray(np.abs(ExtS)))

    def _interior(self, ExtSr, ExtSi, T, Nreal, L, Q):
        sl = (slice(Q - 1, Q - 1 + T), slice(L, Nreal + L))
        return ExtSr[sl] + 1j * ExtSi[sl]

    def batch_lws(self, S, W, thresholds, use_simplifications=True, nofuture=False):
        L, Q, Qprime = W.shape[2] - 1, W.shape[1], W.shape[0]
        T, Nreal = S.shape
        Wr, Wi, Wflag, ExtSr, ExtSi, Amp = self._prep(S, W, L, Q)
        mean_amp = float(np.mean(np.abs(S)))
        pre = "NoFuture_LWS" if nofuture else "LWS"
        for thr in thresholds:
            t = ctypes.c_double(thr * mean_amp)
            if Q != Qprime or not use_simplifications:
                getattr(self.lib, pre + "fractionalQ")(
                    dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
                    Nreal, T, L, Q, t)
            elif Q == 2:
                getattr(self.lib, pre + "Q2")(
                    dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
                    Nreal, T, L, t)
            elif Q == 4:
                getattr(self.lib, pre + "Q4")(
                    dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
                    Nreal, T, L, t)
            else:
                getattr(self.lib, pre + "anyQ")(
                    dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
                    Nreal, T, L, Q, t)
        return self._interior(ExtSr, ExtSi, T, Nreal, L, Q)

    def anyq_update_custom(self, S, W, AmpCustom, threshold, nofuture=False):
        """One iteration of the *general* kernel (anyQ / fractionalQ) with a
        caller-supplied amplitude plane (single-bin exact goldens)."""
        L, Q, Qprime = W.shape[2] - 1, W.shape[1], W.shape[0]
        T, Nreal = S.shape
        Wr, Wi, Wflag, ExtSr, ExtSi, _ = self._prep(S, W, L, Q)
        Amp = np.ascontiguousarray(AmpCustom.astype(np.float64))
        pre = "NoFuture_LWS" if nofuture else "LWS"
        suf = "fractionalQ" if Qprime != Q else "anyQ"
        getattr(self.lib, pre + suf)(
            dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
            Nreal, T, L, Q, ctypes.c_double(threshold))
        return self._interior(ExtSr, ExtSi, T, Nreal, L, Q)

    def asym_update_custom(self, S, W, AmpCustom, threshold, M_upd, M0, update=2):
        L, Q = W.shape[2] - 1, W.shape[1]
        T, Nreal = S.shape
        Wr, Wi, Wflag, ExtSr, ExtSi, _ = self._prep(S, W, L, Q)
        Amp = np.ascontiguousarray(AmpCustom.astype(np.float64))
        self.lib.Asym_UpdatePhaseanyQ(
            dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), ip(Wflag), dp(Amp),
            Nreal, M_upd, M0, L, Q, ctypes.c_double(threshold), update)
        return self._interior(ExtSr, ExtSi, T, Nreal, L, Q)

    def online_lws(self, S, W, W_ai, W_af, thresholds, LA, fshift,
                   use_simplifications=True):
        L, Q, Qprime = W.shape[2] - 1, W.shape[1], W.shape[0]
        use_summarized = int((Q == Qprime) and use_simplifications)
        T, Nreal = S.shape
        Qfloat = float(2 * (Nreal - 1) / fshift)
        Wr, Wi, Wflag, ExtSr, ExtSi, Amp = self._prep(S, W, L, Q)
        if W_ai.shape[0] != Q:
            W_ai = np.concatenate([W_ai, W_ai[:1]], axis=0)  # OOB wrap row
            W_af = np.concatenate([W_af, W_af[:1]], axis=0)
        Wr_ai = np.ascontiguousarray(W_ai.real)
        Wi_ai = np.ascontiguousarray(W_ai.imag)
        Wr_af = np.ascontiguousarray(W_af.real)
        Wi_af = np.ascontiguousarray(W_af.imag)
        Wf_ai = np.ascontiguousarray(np.abs(W_ai) > 1e-12, dtype=np.intc)
        Wf_af = np.ascontiguousarray(np.abs(W_af) > 1e-12, dtype=np.intc)
        mean_amp = float(np.mean(np.abs(S)))
        thr = np.ascontiguousarray(np.asarray(thresholds, dtype=np.float64) * mean_amp)
        self.lib.TF_RTISI_LA(
            dp(ExtSr), dp(ExtSi), dp(Wr), dp(Wi), dp(Wr_ai), dp(Wi_ai),
            dp(Wr_af), dp(Wi_af), ip(Wflag), ip(Wf_ai), ip(Wf_af), dp(Amp),
            len(thresholds), LA, Nreal, T, L, Q, ctypes.c_double(Qfloat),
            use_summarized, dp(thr), 2)
        return self._interior(ExtSr, ExtSi, T, Nreal, L, Q)


# ---------------------------------------------------------------------------
# Golden generation
# ---------------------------------------------------------------------------

CONFIGS = {
    "q4": dict(fsize=512, fshift=128, L=5),
    "q2": dict(fsize=256, fshift=128, L=5),
    "q3": dict(fsize=384, fshift=128, L=5),
    "q8": dict(fsize=512, fshift=64, L=5),
    "frac": dict(fsize=512, fshift=144, L=5),
    "q4L2": dict(fsize=512, fshift=128, L=2),
}


def make_signal(n, rng, sr=16000):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1270 * t + 0.7)
            + 0.3 * np.sin(2 * np.pi * (200 + 4000 * t / t[-1]) * t)
            + 0.08 * rng.standard_normal(n))


def generate(core: RefCore, outdir: str) -> None:
    rng = np.random.default_rng(20260816)
    for name, cfg in CONFIGS.items():
        fsize, fshift, L = cfg["fsize"], cfg["fshift"], cfg["L"]
        awin = np.sqrt(hann(fsize))
        awin = np.sqrt(awin * synthwin(awin, fshift))
        swin = synthwin(awin, fshift)
        W = create_weights(awin, swin, fshift, L)
        win_ai, win_af = build_asymmetric_windows(awin * swin, fshift)
        W_ai = create_weights(win_ai, swin, fshift, L)
        W_af = create_weights(win_af, swin, fshift, L)
        Q = W.shape[1]

        x = make_signal(8000, rng)
        S = stft(x, fsize, fshift, awin, perfectrec=True)
        A = np.abs(S).astype(np.complex128)
        T, Nreal = S.shape

        def cons(Sp):
            return get_consistency(Sp, fsize, fshift, awin, swin, perfectrec=True)

        data = dict(
            fsize=fsize, fshift=fshift, L=L, Q=Q,
            awin=awin, swin=swin, win_ai=win_ai, win_af=win_af,
            W=W, W_ai=W_ai, W_af=W_af,
            x=x, S=S,
            istft_S=istft(S, fshift, swin, perfectrec=True),
            consistency_S=cons(S), consistency_A=cons(A),
        )

        # single-bin exact goldens: one bin above threshold -> Jacobi == GS
        bins = [(0, 0), (0, 3), (T // 2, 0), (T // 2, 1), (T // 2, L - 1),
                (T // 2, Nreal // 2), (T // 2, Nreal - 2), (T // 2, Nreal - 1),
                (1, 7), (T - 1, Nreal // 3), (T - 1, Nreal - 1), (2, 2),
                (3, Nreal - 3)]
        Tp, Np = T + 2 * (Q - 1), Nreal + 2 * L
        sb_batch = np.zeros(len(bins), dtype=np.complex128)
        sb_nofuture = np.zeros(len(bins), dtype=np.complex128)
        for bi, (bm, bn) in enumerate(bins):
            amp = np.full((Tp, Np), 0.5)
            amp[bm + Q - 1, bn + L] = 2.0
            sb_batch[bi] = core.anyq_update_custom(S, W, amp, 1.0)[bm, bn]
            sb_nofuture[bi] = core.anyq_update_custom(
                S, W_ai, amp, 1.0, nofuture=True)[bm, bn]
        data["sb_mn"] = np.array(bins, dtype=np.int64)
        data["sb_batch"] = sb_batch
        data["sb_nofuture"] = sb_nofuture

        # asym single-bin goldens (summarized weights only)
        if Q == W.shape[0]:
            rows, vals = [], []
            for (Mu, M0) in [(1, 0), (1, 1), (3, 4), (2, 3), (1, 2), (4, 5)]:
                for (bm, bn) in bins:
                    if bm >= Mu:
                        continue
                    amp = np.full((Tp, Np), 0.5)
                    amp[bm + Q - 1, bn + L] = 2.0
                    out = core.asym_update_custom(S, W_af, amp, 1.0, Mu, M0)
                    rows.append((Mu, M0, bm, bn))
                    vals.append(out[bm, bn])
            data["asym_cases"] = np.array(rows, dtype=np.int64)
            data["asym_vals"] = np.array(vals, dtype=np.complex128)

        # full-run goldens (reference dispatch incl. quirks), complex64
        b1 = core.batch_lws(A, W, np.zeros(1))
        b100 = core.batch_lws(A, W, get_thresholds(100, 100, 0.1, 1))
        nf1 = core.batch_lws(A, W_ai, get_thresholds(1, 1, 0.1, 1), nofuture=True)
        nf1_anyq = core.anyq_update_custom(
            A, W_ai, np.abs(extspec(A, L, Q)),
            get_thresholds(1, 1, 0.1, 1)[0] * float(np.mean(np.abs(A))),
            nofuture=True)
        on10 = core.online_lws(nf1, W, W_ai, W_af,
                               get_thresholds(10, 1, 0.1, 1), 3, fshift)
        run_out = core.batch_lws(on10, W, get_thresholds(100, 100, 0.1, 1))
        data["batch_i1_t0"] = b1.astype(np.complex64)
        data["batch_i100"] = b100.astype(np.complex64)
        data["nofuture_i1"] = nf1.astype(np.complex64)
        data["nofuture_i1_anyq"] = nf1_anyq.astype(np.complex64)
        data["online_i10"] = on10.astype(np.complex64)
        data["run_lws_out"] = run_out.astype(np.complex64)
        data["consistency_nofuture"] = cons(nf1)
        data["consistency_nofuture_anyq"] = cons(nf1_anyq)
        data["consistency_online"] = cons(on10)
        data["consistency_batch"] = cons(b100)
        data["consistency_run"] = cons(run_out)

        # deterministic short-horizon online goldens (float64, LA=2, 8
        # frames). Two flavours:
        #  - online_det: 1 iteration at threshold 0 over the full field.
        #    Bit-comparable for raster-order reimplementations (the C++
        #    oracle) — pins the TF_RTISI_LA frame-commit sequencing
        #    (lwslib.cpp:1424-1492) without fp-chaos accumulating.
        #  - online_sparse: |S| is 0.5 everywhere except ONE 2.0-magnitude
        #    bin per frame, thresholds gate updates to those bins only.
        #    With at most one updating bin per frame there are no in-frame
        #    dependencies, so the result is bit-deterministic for ANY
        #    in-frame update order (vectorized kernels included) while the
        #    cross-frame commit interleaving is fully exercised.
        S8 = S[:8]
        A8 = np.abs(S8).astype(np.complex128)
        data["online_det_in"] = A8
        data["online_det_out"] = core.online_lws(
            A8, W, W_ai, W_af, np.zeros(1), 2, fshift)
        data["online_det_la"] = 2

        det_rng = np.random.default_rng(1234)
        Tdet = 8
        mag = np.full((Tdet, Nreal), 0.5)
        nc = Nreal // 2
        active = [(m, nc + [0, 2, -1, 1, 3, -2, 0, 2][m]) for m in range(Tdet)]
        for (am_, an_) in active:
            mag[am_, an_] = 2.0
        Sdet = mag * np.exp(2j * np.pi * det_rng.random((Tdet, Nreal)))
        Sdet[:, 0] = mag[:, 0]          # DC and Nyquist are real-valued
        Sdet[:, -1] = mag[:, -1]
        thr_det = np.array([2.0, 2.0])
        data["online_sparse_in"] = Sdet
        data["online_sparse_out"] = core.online_lws(
            Sdet, W, W_ai, W_af, thr_det, 2, fshift)
        data["online_sparse_thr"] = thr_det

        np.savez_compressed(os.path.join(outdir, f"ref_{name}.npz"), **data)
        print(f"  {name}: T={T} F={Nreal} Q={Q} "
              f"cons run={data['consistency_run']:.2f} dB")


def compare(newdir: str, refdir: str) -> bool:
    """Assert the regenerated goldens reproduce the committed ones."""
    ok = True
    for name in CONFIGS:
        fn = f"ref_{name}.npz"
        new = np.load(os.path.join(newdir, fn))
        old = np.load(os.path.join(refdir, fn))
        for key in old.files:
            if key not in new.files:
                print(f"MISSING {fn}:{key}")
                ok = False
                continue
            a, b = old[key], new[key]
            if a.shape != b.shape:
                print(f"SHAPE {fn}:{key} {a.shape} vs {b.shape}")
                ok = False
            elif not np.array_equal(a, b):
                err = float(np.max(np.abs(a - b)))
                scale = float(np.max(np.abs(a))) or 1.0
                # Everything is float64 end-to-end and the generation is
                # deterministic; differences can only come from libm/BLAS
                # variation across machines. Allow tiny relative slack.
                if err / scale > 1e-9:
                    print(f"DIFF {fn}:{key} max abs err {err:.3e} (scale {scale:.3e})")
                    ok = False
        extra = set(new.files) - set(old.files)
        if extra:
            print(f"  note: {fn} regenerated with extra keys {sorted(extra)}")
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help="overwrite tests/golden/ with regenerated vectors")
    ap.add_argument("--check", action="store_true",
                    help="regenerate into a temp dir and compare to committed")
    args = ap.parse_args()
    if not (args.write or args.check):
        args.check = True

    with tempfile.TemporaryDirectory() as tmp:
        print("building reference C core from sdist ...")
        core = RefCore(build_reference_core(tmp))
        outdir = GOLDEN_DIR if args.write else os.path.join(tmp, "golden")
        os.makedirs(outdir, exist_ok=True)
        print(f"generating goldens -> {outdir}")
        generate(core, outdir)
        if args.check:
            print("comparing against committed goldens ...")
            if not compare(outdir, GOLDEN_DIR):
                print("FAIL: committed goldens not reproduced")
                sys.exit(1)
            print("OK: committed goldens reproduced")


if __name__ == "__main__":
    main()
