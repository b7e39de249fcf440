"""Multi-chip execution: device meshes, data parallelism, time-axis sharding.

The reference is single-threaded C (SURVEY.md 2.6) - this layer is new in
this build. Two axes of parallelism:

  - 'data': independent utterances/spectrograms. Any lws_jax function works on
    inputs sharded over 'data' (leading batch dim): XLA partitions the
    program; there is no cross-item communication anywhere in LWS.
  - 'time': long spectrograms sharded along frames for batch/no-future
    sweeps. The stencil reads +-(Q-1) frames, so each sweep exchanges
    (Q-1)-frame halos with mesh neighbours via lax.ppermute (NVLink between
    the cards of one host). The +-L frequency halo is local index math and
    is never sharded. Global scalars (the per-item mean magnitude that scales
    thresholds, python/lws.pyx:240-245) use psum over 'time'.

Update ordering under time sharding: Gauss-Seidel runs *within* each shard;
across shard boundaries information propagates one halo exchange per sweep
(block-Jacobi between shards). The online (RTISI-LA) schedule is inherently
sequential along time (lwslib.cpp:1432 frame-commit order) and is only ever
data-parallel.

Edge semantics: the reference freezes the replicated edge-frame halos at
stage entry (lwslib.cpp:21-25); here the first/last shard keep that frozen
halo while interior boundaries exchange live frames each sweep.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.stencil import Stencil, freq_extend, update_frame, apply_stencil, phase_update

__all__ = ["make_mesh", "shard_pair", "sharded_lws_sweeps", "data_parallel_run"]


def make_mesh(data: int = 1, time: int = 1, devices=None) -> Mesh:
    """Create a ('data', 'time') mesh over the first data*time devices."""
    if devices is None:
        devices = jax.devices()
    n = data * time
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, time)
    return Mesh(dev, ("data", "time"))


def shard_pair(pair, mesh: Mesh, time_sharded: bool = False):
    """Place an (sr, si) pair of (..., T, F) arrays onto the mesh.

    Leading batch dims shard over 'data' (first one), the time axis over
    'time' when requested; frequency is never sharded.
    """
    ndim = jnp.asarray(pair[0]).ndim
    time_ax = "time" if time_sharded else None
    lead = ("data",) + (None,) * (ndim - 3) if ndim > 2 else ()
    sharding = NamedSharding(mesh, P(*lead, time_ax, None))
    return tuple(jax.device_put(jnp.asarray(x), sharding) for x in pair)


def data_parallel_run(fn, pair, mesh: Mesh):
    """Run any (sr, si) -> (sr, si) stage with the batch dim sharded on
    'data': each device runs `fn` on its own utterances (shard_map), so the
    GPU kernels see device-local batches. Devices along 'time' repeat the
    work of their 'data' row. Repeat calls with the same `fn` object reuse
    one compiled program."""
    return _data_parallel_fn(fn, mesh, jnp.ndim(pair[0]))(
        *shard_pair(pair, mesh))


@functools.lru_cache(maxsize=32)
def _data_parallel_fn(fn, mesh, ndim):
    spec = P("data", *([None] * (ndim - 1)))
    return jax.jit(shard_map(lambda a, b: tuple(fn(a, b)), mesh=mesh,
                             in_specs=(spec, spec), out_specs=(spec, spec),
                             check_vma=False))


def sharded_lws_sweeps(
    sr: jnp.ndarray,
    si: jnp.ndarray,
    st: Stencil,
    thresholds: jnp.ndarray,
    mesh: Mesh,
    order: str = "gs",
    inner_passes: int = 1,
    kernel: str = "xla",
    sweeps_per_exchange: int = 1,
    inner_scheme: str = "jacobi",
    interpret: bool = False,
):
    """Time-sharded batch/no-future LWS sweeps with per-sweep halo exchange.

    Input (B, T, F) is sharded (B over 'data', T over 'time'); each round
    ppermutes the (Q-1)-frame boundary halos between time-neighbours. Each
    shard must hold at least Q-1 frames.

    kernel='xla' runs the portable frame-scan (CPU/f64 tests); kernel='gpu'
    runs the GPU sweep kernel (ops/gpu_sweeps.gs_sweeps) on each local shard
    between halo exchanges (`interpret=True` runs it in the Pallas
    interpreter, for CPU validation). `sweeps_per_exchange`
    trades halo traffic for staleness: s>1 runs s full Gauss-Seidel sweeps
    on the local shard per exchange (block-Jacobi with period s across
    shards; fine when shards hold many more than Q-1 frames, SURVEY 7.3.2).
    """
    Q, L = st.Q, st.L
    F = st.n_bins
    n_time = mesh.shape["time"]
    T_total = sr.shape[-2]
    if T_total % n_time != 0:
        raise ValueError(f"T={T_total} not divisible by time={n_time}")
    if T_total // n_time < Q - 1:
        raise ValueError(f"each time shard needs >= Q-1={Q - 1} frames")
    right_perm = [(i, i + 1) for i in range(n_time - 1)]
    left_perm = [(i + 1, i) for i in range(n_time - 1)]

    if kernel == "gpu":
        return _sharded_gpu(sr, si, st, thresholds, mesh,
                            sweeps_per_exchange, inner_passes, inner_scheme,
                            interpret, right_perm, left_perm, T_total)
    if kernel != "xla":
        raise ValueError(f"unknown kernel {kernel!r}")

    def local_fn(sr_l, si_l, thr_sched):
        T_loc = sr_l.shape[-2]
        idx = lax.axis_index("time")
        amp = jnp.sqrt(sr_l * sr_l + si_l * si_l)
        amp_sum = lax.psum(jnp.sum(amp, axis=(-2, -1), keepdims=True), "time")
        mean_amp = amp_sum / (T_total * F)

        # frozen edge halos from the stage input (only used on the end shards)
        er0, ei0 = freq_extend(sr_l, si_l, L)
        reps = [1] * (er0.ndim - 2) + [Q - 1, 1]
        frozen_top = (jnp.tile(er0[..., :1, :], reps), jnp.tile(ei0[..., :1, :], reps))
        frozen_bot = (jnp.tile(er0[..., -1:, :], reps), jnp.tile(ei0[..., -1:, :], reps))

        def extend(er, ei):
            """Attach halos: ppermute live neighbour frames, frozen at the ends."""
            halos = []
            for x, ftop, fbot in ((er, frozen_top[0], frozen_bot[0]),
                                  (ei, frozen_top[1], frozen_bot[1])):
                from_left = lax.ppermute(x[..., T_loc - (Q - 1):, :], "time", right_perm)
                from_right = lax.ppermute(x[..., :Q - 1, :], "time", left_perm)
                top = jnp.where(idx == 0, ftop, from_left)
                bot = jnp.where(idx == n_time - 1, fbot, from_right)
                halos.append(jnp.concatenate([top, x, bot], axis=-2))
            return halos[0], halos[1]

        amp_t = jnp.moveaxis(amp, -2, 0)

        def one_iter(carry, thr_rel):
            cr, ci = carry
            er, ei = freq_extend(cr, ci, L)
            xr, xi = extend(er, ei)
            if order in ("jacobi", "jacobi_mxu"):
                thr = thr_rel * mean_amp
                if order == "jacobi_mxu":
                    # banded-matmul taps (core/stencil.apply_stencil_mxu):
                    # pure XLA, so it composes with the shard_map/ppermute
                    # halo exchange with no extra plumbing
                    from ..core.stencil import apply_stencil_mxu
                    tr, ti = apply_stencil_mxu(xr, xi, st)
                else:
                    tr, ti = apply_stencil(xr, xi, st)
                return phase_update(tr, ti, amp, cr, ci, thr), None
            thr = thr_rel * mean_amp[..., 0, :]

            def frame_body(x, xs):
                m, amp_m = xs
                return update_frame(x[0], x[1], m, amp_m, st, thr,
                                    inner_passes, inner_scheme), None

            (xr, xi), _ = lax.scan(frame_body, (xr, xi), (jnp.arange(T_loc), amp_t))
            return (xr[..., Q - 1:Q - 1 + T_loc, L:L + F],
                    xi[..., Q - 1:Q - 1 + T_loc, L:L + F]), None

        (sr_l, si_l), _ = lax.scan(one_iter, (sr_l, si_l), thr_sched)
        return sr_l, si_l

    spec = P("data", "time", None) if sr.ndim == 3 else P("time", None)
    fn = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec, P()),
                   out_specs=(spec, spec), check_vma=False)
    return jax.jit(fn)(sr, si, thresholds)


def _sharded_gpu(sr, si, st, thresholds, mesh, sweeps_per_exchange,
                 inner_passes, inner_scheme, interpret, right_perm,
                 left_perm, T_total):
    """Halo exchange (XLA ppermute) composed with the GPU sweep kernel:
    per round, exchange (Q-1)-frame boundary halos, then run
    `sweeps_per_exchange` exact-order Gauss-Seidel sweeps on the local shard
    with those halos frozen (ops/gpu_sweeps.gs_sweeps)."""
    from ..ops.gpu_sweeps import gs_sweeps

    Q, L = st.Q, st.L
    F = st.n_bins
    Q1 = Q - 1
    n_time = mesh.shape["time"]
    s = max(1, int(sweeps_per_exchange))
    iters = int(thresholds.shape[0])
    rounds, rem = divmod(iters, s)

    def local_fn(sr_l, si_l, thr_sched):
        idx = lax.axis_index("time")
        amp = jnp.sqrt(sr_l * sr_l + si_l * si_l)
        amp_sum = lax.psum(jnp.sum(amp, axis=(-2, -1)), "time")
        mean_amp = amp_sum / (T_total * F)  # (B,) or scalar: global mean

        # frozen stage-entry halos for the end shards (edge-frame replicas,
        # matching the reference's extended-spec edges, lwslib.cpp:21-25)
        reps = [1] * (sr_l.ndim - 2) + [Q1, 1]
        frozen = {
            "tr": jnp.tile(sr_l[..., :1, :], reps),
            "ti": jnp.tile(si_l[..., :1, :], reps),
            "br": jnp.tile(sr_l[..., -1:, :], reps),
            "bi": jnp.tile(si_l[..., -1:, :], reps),
        }

        def exchange(cr, ci):
            halos = []
            for x, ftop, fbot in ((cr, frozen["tr"], frozen["br"]),
                                  (ci, frozen["ti"], frozen["bi"])):
                from_left = lax.ppermute(x[..., -Q1:, :], "time", right_perm)
                from_right = lax.ppermute(x[..., :Q1, :], "time", left_perm)
                top = jnp.where(idx == 0, ftop, from_left)
                bot = jnp.where(idx == n_time - 1, fbot, from_right)
                halos.append((top, bot))
            return halos[0][0], halos[1][0], halos[0][1], halos[1][1]

        def run_block(cr, ci, thr_block):
            top_r, top_i, bot_r, bot_i = exchange(cr, ci)
            return gs_sweeps(
                cr, ci, st, thr_block, inner_passes=inner_passes,
                inner_scheme=inner_scheme, interpret=interpret,
                halo=(top_r, top_i, bot_r, bot_i), mean_amp=mean_amp,
                amp=amp)

        cr, ci = sr_l, si_l
        if rounds:
            def body(carry, thr_block):
                return run_block(*carry, thr_block), None
            (cr, ci), _ = lax.scan(body, (cr, ci),
                                   thr_sched[:rounds * s].reshape(rounds, s))
        if rem:
            cr, ci = run_block(cr, ci, thr_sched[rounds * s:])
        return cr, ci

    spec = P("data", "time", None) if sr.ndim == 3 else P("time", None)
    fn = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec, P()),
                   out_specs=(spec, spec), check_vma=False)
    return jax.jit(fn)(sr, si, thresholds)
