"""Multi-process execution: distributed init, host-major meshes, and a
scaling-efficiency harness.

The reference is single-threaded C; this layer is new in this build
(SURVEY.md 2.6). What the meshes have to carry:

  - LWS's only cross-device traffic is (a) nothing at all for data-parallel
    utterance batches and (b) the (Q-1)-frame halo exchange + one scalar
    psum per round for time-sharded sweeps. Halos are tiny - Q-1 frames of
    F bins, e.g. 3*2049*4 B = 24 KB per boundary for the 4096-pt long-form
    config - so the mesh follows the algorithm, not the wiring: within one
    host the cards are joined all to all by NVLink, and any card is as good
    a time-neighbour as any other.
  - Across hosts, `make_host_mesh` lays the 'time' axis out contiguously
    within each host (only the one boundary pair between consecutive hosts
    crosses the network) and 'data' across hosts (no traffic).

Launch recipe (one process per host, standard JAX multi-process):

    # on every host
    import lws_jax.parallel as par
    par.init_distributed("host0:1234", num_processes=2, process_id=i)
    mesh = par.make_host_mesh(data=1, time=jax.device_count())
    ... par.sharded_lws_sweeps(..., mesh=mesh, kernel="gpu")

`init_distributed` wraps jax.distributed.initialize; pass the coordinator
address, process count and process id (or set JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID).
"""
from __future__ import annotations

import os

import numpy as np

import jax

from .sharding import make_mesh, sharded_lws_sweeps, shard_pair

__all__ = ["init_distributed", "make_host_mesh", "scaling_report"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialise JAX multi-process execution (idempotent).

    Returns True if distributed mode is active after the call. Single-process
    runs (num_processes == 1 or nothing configured) are a no-op.

    Must be the first JAX call in the process: jax.distributed.initialize
    refuses to run once the XLA backend exists, so the idempotency check
    here deliberately avoids any device/backend query (jax.process_count()
    itself would initialise the backend and make initialisation impossible).
    A too-late call raises instead of silently degrading to N independent
    single-process jobs.
    """
    if jax.distributed.is_initialized():
        return jax.process_count() > 1  # already initialised
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # nothing configured: a single-process run
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count() > 1


def make_host_mesh(data: int = 1, time: int = 1, devices=None):
    """('data', 'time') mesh with the time axis contiguous within hosts.

    jax.devices() orders devices by process; reshaping host-major therefore
    keeps time-neighbours (the halo-exchange partners) on the same host
    wherever possible, with exactly one network boundary between
    consecutive hosts. 'data' spans hosts freely (data-parallel needs no
    communication).
    """
    if devices is None:
        devices = jax.devices()
    n = data * time
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = sorted(devices[:n], key=lambda d: (d.process_index, d.id))
    # host-major order; Fortran reshape puts consecutive devices along the
    # *time* axis (axis 1 varies fastest in C order -> use C order with
    # (data, time) so time is the fast axis)
    dev = np.asarray(devices).reshape(data, time)
    from jax.sharding import Mesh
    return Mesh(dev, ("data", "time"))


def scaling_report(proc, T_frames: int = 2048, iters: int = 20,
                   time_shards: int | None = None, kernel: str = "xla",
                   interpret: bool = False, n_rep: int = 3):
    """Measure time-sharded scaling efficiency on the available devices.

    Runs `iters` sweeps of a (T_frames, F) random-magnitude spectrogram
    unsharded on one device and time-sharded over `time_shards` devices,
    and reports wall times + efficiency = t_1 / (t_N * N). On a virtual CPU
    mesh this is a *dry-run estimate* (CPU cores share memory bandwidth),
    flagged `estimate_only`; kernel="gpu" needs a GPU (or interpret=True).

    Returns a dict (also printable as one JSON-ish line).
    """
    import time as _time

    import jax.numpy as jnp

    from ..core.stencil import split
    from ..windows import get_thresholds

    devices = jax.devices()
    n = time_shards or len(devices)
    F = proc.fftsize // 2 + 1
    T = (T_frames // n) * n
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((T, F))).astype(np.float64)
    pair = split(A + 0j, dtype=proc.rdtype)
    thr = jnp.asarray(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)

    def run(mesh, p):
        out = sharded_lws_sweeps(*p, st=proc._st_batch, thresholds=thr,
                                 mesh=mesh, kernel=kernel, interpret=interpret)
        out[0].block_until_ready()
        return out

    def best_wall(mesh, p):
        run(mesh, p)  # compile + warm
        walls = []
        for _ in range(n_rep):
            t0 = _time.time()
            run(mesh, p)
            walls.append(_time.time() - t0)
        return float(np.median(walls))

    mesh1 = make_mesh(data=1, time=1, devices=devices[:1])
    meshN = make_host_mesh(data=1, time=n, devices=devices)
    p1 = shard_pair(pair, mesh1, time_sharded=True)
    pN = shard_pair(pair, meshN, time_sharded=True)
    t1 = best_wall(mesh1, p1)
    tN = best_wall(meshN, pN)
    eff = t1 / (tN * n) if tN > 0 else float("nan")
    return {
        "T": T, "F": F, "iters": iters, "shards": n, "kernel": kernel,
        "platform": devices[0].platform,
        "wall_1dev_s": round(t1, 4), "wall_Ndev_s": round(tN, 4),
        "speedup": round(t1 / tN, 3) if tN else None,
        "efficiency": round(eff, 3),
        "estimate_only": devices[0].platform != "gpu",
    }
