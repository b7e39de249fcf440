"""Multi-signal quality robustness study: lws_jax vs the reference C core.

QUALITY.md's headline table compares one golden signal per configuration;
single-signal deltas of a few tenths of a dB are basin noise (both
implementations converge to different local optima of the same objective).
This study rebuilds the actual reference core at run time
(tools/make_goldens.py chain of trust) and compares the full run_lws
pipeline over N randomized harmonic signals per configuration, float64,
equal iteration counts (nofuture 1, online 10/LA=3, batch 100 — the
reference demo settings).

Usage: python tools/quality_study.py [--signals N]   (CPU, ~5 min)
"""
import argparse
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import make_goldens as mg  # noqa: E402
from lws_jax import LWS  # noqa: E402


def study_signal(n, rng, sr=16000):
    """Randomized harmonic mixture: partials, chirp and noise all vary per
    draw (make_goldens.make_signal varies only the noise)."""
    t = np.arange(n) / sr
    f0 = rng.uniform(150, 500)
    x = np.zeros(n)
    for k, a in enumerate(rng.uniform(0.15, 0.5, size=4)):
        x += a * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 2 * np.pi))
    c0, c1 = sorted(rng.uniform(200, 5000, size=2))
    x += rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * (c0 + (c1 - c0) * t / t[-1]) * t)
    x += 0.08 * rng.standard_normal(n)
    return x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--signals", type=int, default=6)
    ap.add_argument("--inner-passes", type=int, default=1,
                    help="LWS inner_passes (in-frame centre-tap re-passes)")
    ap.add_argument("--inner-scheme", default=None,
                    help="override the LWS inner_scheme (default: per-Q auto)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as wd:
        core = mg.RefCore(mg.build_reference_core(wd))
        rows = []
        for name, cfg in mg.CONFIGS.items():
            fsize, fshift, L = cfg["fsize"], cfg["fshift"], cfg["L"]
            awin = np.sqrt(mg.hann(fsize))
            awin = np.sqrt(awin * mg.synthwin(awin, fshift))
            swin = mg.synthwin(awin, fshift)
            W = mg.create_weights(awin, swin, fshift, L)
            win_ai, win_af = mg.build_asymmetric_windows(awin * swin, fshift)
            W_ai = mg.create_weights(win_ai, swin, fshift, L)
            W_af = mg.create_weights(win_af, swin, fshift, L)

            proc = LWS(fsize, fshift, L=L, dtype=jnp.float64,
                       nofuture_iterations=1, online_iterations=10,
                       inner_passes=args.inner_passes,
                       inner_scheme=args.inner_scheme)
            rng = np.random.default_rng(hash(name) % 2 ** 31)
            deltas = []
            for s in range(args.signals):
                x = study_signal(8000, rng)
                S = mg.stft(x, fsize, fshift, awin, perfectrec=True)
                A = np.abs(S).astype(np.complex128)

                nf = core.batch_lws(A, W_ai, mg.get_thresholds(1, 1, 0.1, 1),
                                    nofuture=True)
                on = core.online_lws(nf, W, W_ai, W_af,
                                     mg.get_thresholds(10, 1, 0.1, 1), 3, fshift)
                ref = core.batch_lws(on, W, mg.get_thresholds(100, 100, 0.1, 1))
                c_ref = mg.get_consistency(ref, fsize, fshift, awin, swin,
                                           perfectrec=True)

                ours = proc.run_lws(A)
                c_ours = float(np.asarray(proc.get_consistency(ours)))
                deltas.append(c_ours - c_ref)
                print(f"  {name} sig{s}: ours {c_ours:6.2f} ref {c_ref:6.2f} "
                      f"delta {c_ours - c_ref:+.2f}", file=sys.stderr)
            d = np.asarray(deltas)
            rows.append((name, W.shape[1], d))
            print(f"{name}: mean {d.mean():+.2f} dB "
                  f"(min {d.min():+.2f}, max {d.max():+.2f}, n={len(d)})")

        alld = np.concatenate([d for _, _, d in rows])
        print(f"OVERALL: mean {alld.mean():+.2f} dB over {alld.size} runs; "
              f"{(alld > 0).sum()}/{alld.size} wins; "
              f"worst {alld.min():+.2f}, best {alld.max():+.2f}")
        return rows


if __name__ == "__main__":
    main()
