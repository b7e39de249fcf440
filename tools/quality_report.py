"""Generate the QUALITY.md parity table: lws_jax vs the reference C core at
equal iteration counts, on the golden configurations.

Run on CPU (float64): python tools/quality_report.py
"""
import glob
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lws_jax import LWS, get_thresholds  # noqa: E402


def main():
    gdir = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")
    rows = []
    for path in sorted(glob.glob(os.path.join(gdir, "ref_*.npz"))):
        name = os.path.basename(path)[4:-4]
        z = np.load(path)
        p = LWS(int(z["fsize"]), int(z["fshift"]), L=int(z["L"]),
                dtype=jnp.float64, nofuture_iterations=1, online_iterations=10)
        A = np.abs(z["S"]).astype(np.complex128)
        c = lambda s: float(np.asarray(p.get_consistency(s)))
        S0 = p.nofuture_lws(A)
        S1 = p.online_lws(S0)
        S2 = p.batch_lws(S1)
        B = p.batch_lws(A)
        rows.append((
            name, int(z["Q"]), z["W"].shape[0] != int(z["Q"]), int(z["L"]),
            c(S0), float(z["consistency_nofuture_anyq"]),
            c(S1), float(z["consistency_online"]),
            c(B), float(z["consistency_batch"]),
            c(S2), float(z["consistency_run"]),
        ))

    print("| config | Q | frac | L | nofuture (ref) | online (ref) | batch-100 (ref) | run_lws (ref) |")
    print("|---|---|---|---|---|---|---|---|")
    deltas = []
    for r in rows:
        name, Q, frac, L = r[:4]
        vals = r[4:]
        cells = " | ".join(f"{vals[i]:.2f} ({vals[i + 1]:.2f})" for i in range(0, 8, 2))
        print(f"| {name} | {Q} | {'y' if frac else ''} | {L} | {cells} |")
        deltas.append(vals[6] - vals[7])  # run_lws delta
    print()
    print(f"mean run_lws delta vs reference: {np.mean(deltas):+.2f} dB")


if __name__ == "__main__":
    main()
