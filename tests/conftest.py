"""Test configuration: CPU backend with 8 virtual devices (sharding tests) and
x64 enabled (float64 parity against the reference golden vectors)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: tests run on the virtual CPU mesh
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# force CPU for tests even where an accelerator plugin is installed
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import glob  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


class Golden(dict):
    __getattr__ = dict.__getitem__


def _load(name):
    path = os.path.join(GOLDEN_DIR, f"ref_{name}.npz")
    with np.load(path) as z:
        return Golden({k: z[k] for k in z.files})


_GOLDEN_NAMES = sorted(
    os.path.basename(p)[4:-4] for p in glob.glob(os.path.join(GOLDEN_DIR, "ref_*.npz"))
)


@pytest.fixture(scope="session", params=_GOLDEN_NAMES)
def golden(request):
    """One reference golden config (q2/q3/q4/q8/frac/...)."""
    return _load(request.param)


@pytest.fixture(scope="session")
def golden_q4():
    return _load("q4")
