"""Multi-chip LWS: data-parallel batching + time-sharded long-form sweeps.

Runs on any device mesh. Without real multi-chip hardware, simulate one on
CPU (the driver validates the same paths this way):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py

The reference library is single-threaded C; this layer is where this build
scales (SURVEY.md 2.6): utterance batches shard over the 'data' mesh axis
(no cross-item communication anywhere in LWS), and long spectrograms shard
frames over 'time' for batch sweeps with a (Q-1)-frame ppermute halo
exchange per sweep. Across several hosts, use
lws_jax.parallel.init_distributed() first and make_host_mesh() (see
docs/MULTIHOST.md).
"""
import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np
import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import lws_jax
from lws_jax.parallel import make_mesh, shard_pair, data_parallel_run


def main():
    devs = jax.devices()
    n = len(devs)
    data = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = make_mesh(data=data, time=n // data)
    print(f"devices: {n}x {devs[0].platform}, mesh: "
          f"data={mesh.shape['data']} x time={mesh.shape['time']}")

    proc = lws_jax.lws(512, 128, mode="music", batch_iterations=50)

    # --- 1. data-parallel: a batch of utterances, sharded over 'data' ------
    rng = np.random.default_rng(0)
    t = np.arange(3 * 16000) / 16000.0
    batch = np.stack([np.sin(2 * np.pi * (100 + 30 * i) * t)
                      + 0.1 * rng.standard_normal(t.size)
                      for i in range(4 * mesh.shape["data"])])
    import jax.numpy as jnp
    sr, si = proc.stft_ri(batch)                  # split planes stay on device
    amp = jnp.hypot(sr, si)
    pair = (amp, jnp.zeros_like(amp))
    out = data_parallel_run(lambda r, i: proc.run_lws((r, i)), pair, mesh)
    cons = np.asarray(proc.get_consistency(out))
    print(f"data-parallel run_lws: {batch.shape[0]} utterances, "
          f"consistency {cons.mean():.2f} dB (per-device batch "
          f"{batch.shape[0] // mesh.shape['data']})")

    # --- 2. time-sharded: one long spectrogram over the 'time' axis --------
    T = 256 * mesh.shape["time"]
    B = mesh.shape["data"]  # batch shards over 'data', frames over 'time'
    long_amp = np.abs(rng.standard_normal((B, T, 257))).astype(np.float32)
    S = proc.batch_lws((long_amp, np.zeros_like(long_amp)), mesh=mesh)
    cons = float(np.asarray(proc.get_consistency(S))[0])
    print(f"time-sharded batch_lws: T={T} frames over "
          f"{mesh.shape['time']} shards (halo exchange per sweep), "
          f"consistency {cons:.2f} dB")


if __name__ == "__main__":
    main()
