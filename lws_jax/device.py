"""Which device the program runs on, and where JAX keeps compiled code.

`gpu_available` is the one place that decides whether the GPU kernels
(ops/gpu_sweeps.py) can run: the processor, the streaming front end, the
multi-card helpers and the scripts all ask it. `require_gpu` is for the
measurement scripts: they measure the card, so they stop when there is none
instead of carrying on on the CPU.
"""
from __future__ import annotations

import os

import jax

__all__ = ["platform", "gpu_available", "require_gpu", "describe",
           "use_compile_cache", "COMPILE_CACHE_DIR"]

# the persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed, git-ignored directory inside the checkout
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def platform() -> str:
    """The default backend's platform name ("gpu", "cpu", ...)."""
    return jax.default_backend()


def gpu_available() -> bool:
    """Whether JAX's default backend is a GPU."""
    return platform() == "gpu"


def require_gpu():
    """The first GPU device; raises when JAX finds none."""
    if not gpu_available():
        raise RuntimeError(
            f"no GPU: JAX's default backend is {platform()!r}; this script "
            "measures the card and does not run on the CPU")
    return jax.devices()[0]


def describe() -> dict:
    """{"platform", "kind", "count"} of the devices JAX sees."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory:
    JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself), otherwise
    COMPILE_CACHE_DIR. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
